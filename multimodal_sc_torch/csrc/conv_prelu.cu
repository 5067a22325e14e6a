// Fused SAME K x K convolution + bias + optional per-channel PReLU, NHWC.
//
// Replaces the TPU kernel multimodal_sc_tpu/kernels/conv_block.py
// (_conv_prelu_pallas_s1 / _conv_kernel, with stride 2 through
// _space_to_depth / _weights_to_s2d). The space-to-depth rewrite was a
// Mosaic workaround for strided VMEM reads; here one kernel serves stride 1
// and 2. It computes XLA's SAME padding itself:
// lo = max((out - 1) * s + K - in, 0) / 2 (asymmetric for stride 2 on an
// even input), the rest of the window past the image reads as zero.
//
// Bound on the card: operations. On the camera encoder's shapes a layer
// does 75 to 3200 multiply-adds per output (K=5, Cin up to 128) against
// one read of its input and one write of its output. The JAX kernel puts
// every product on the MXU; here they go to the tensor cores at f32-grade
// precision by the 3xTF32 split, so the unit that bounds the kernel is the
// TF32 tensor-core rate over three (495 / 3 = 165 TFLOP/s of f32-grade
// products, against 67 TFLOP/s on the FMA units).
//
// Two kernels in this source. conv_wgmma_kernel is an implicit GEMM across
// images for Cin and Cout that are multiples of 4: M = N*OH*OW output
// pixels, N = Cout, K = K*K*Cin. A block owns 128 output pixels (of as many
// images as that takes: an 8 x 8 map has 64) and a tile of 16, 32, 64 or 128
// output channels (the narrowest that holds Cout, else 128), so a layer
// gives hundreds of blocks for 132 SMs whatever its map size. One pipeline step is one filter tap (ky, kx) and 32 input
// channels: the 128 x 32 slice of gathered input pixels and the 32 x Cout
// slice of HWIO weights are brought into a ring of shared-memory stages by
// 16-byte cp.async copies (TileLoader), so the loads of later steps are in
// flight during the math of this one; the loads keep their own (ky, kx,
// channel) position and advance it by additions, a few instructions per
// copy. Padding is a predicate of the gather: a tap that falls outside the
// image, a channel past Cin, a pixel past M and a column past Cout are
// zero-filled by cp.async itself (src-size 0), no padded copy exists.
// Shared rows are padded (36 and Cout-tile + 8 floats) so that the fragment
// reads of a warp hit 32 different banks. Every operand is split as
// hi = tf32(x) rounded to nearest (by integer arithmetic on the bits: the
// cvt.rna.tf32.f32 unit is slow), lo = x - hi, and the three products
// lo*hi, hi*lo, hi*hi are accumulated in f32, small terms first; the
// dropped lo*lo term is ~2^-22 of the product. The tensor cores truncate
// when they add to an accumulator, a bias that grows with the chain (over
// the 1200 products of a K*K*Cin = 3200 layer it reaches the 1e-4 that the
// result is held to), so the 12 tensor-core products of one pipeline step
// start from zero and the step's sum joins the running total through the
// FADD units, which round to nearest: the result stays within 2e-5 of the
// exact-f32 convolution. Bias and
// PReLU are applied to the accumulator fragments, which are stored as
// float2 along the channels of NHWC.
//
// The products run on Hopper's warpgroup mma, wgmma.m64n{16,32,64,128}k8
// TF32. Two warpgroups each own 64 pixels x the tile's channels; pixels are
// split in registers (the left operand), once each; the step's weights are
// split once per block into shared-memory planes in the layout wgmma reads,
// during the previous step's asynchronous wgmma.
//
// conv_prelu_kernel (any other channel count, e.g. the first layer's
// Cin = 3, whose 12-byte pixels cannot be copied in 16-byte chunks): one
// block per image, the zero-padded window in shared memory, a register
// tile of CT channels x PT pixels per thread on the f32 FMA units.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int CT>
__device__ __forceinline__ void load_w(const float* __restrict__ p,
                                       float (&w)[CT]) {
  if constexpr (CT % 4 == 0) {
#pragma unroll
    for (int j = 0; j < CT; j += 4) {
      float4 v = __ldg(reinterpret_cast<const float4*>(p + j));
      w[j] = v.x; w[j + 1] = v.y; w[j + 2] = v.z; w[j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < CT; ++j) w[j] = __ldg(p + j);
  }
}

template <int CT, int PT>
__global__ void conv_prelu_kernel(const float* __restrict__ x,
                                  const float* __restrict__ w,
                                  const float* __restrict__ bias,
                                  const float* __restrict__ alpha,
                                  float* __restrict__ out, int H, int W,
                                  int Cin, int OH, int OW, int Cout, int K,
                                  int stride, int pad_h, int pad_w, int Hp,
                                  int Wp) {
  extern __shared__ float xs[];  // (Hp, Wp, Cin) zero-padded window
  const int n = blockIdx.x;
  const float* xn = x + (int64_t)n * H * W * Cin;
  const int n_smem = Hp * Wp * Cin;
  for (int i = threadIdx.x; i < n_smem; i += blockDim.x) {
    int c = i % Cin;
    int t = i / Cin;
    int iy = t / Wp - pad_h;
    int ix = t % Wp - pad_w;
    xs[i] = (iy >= 0 && iy < H && ix >= 0 && ix < W)
                ? xn[((int64_t)iy * W + ix) * Cin + c]
                : 0.0f;
  }
  __syncthreads();

  // Work item: CT channels x PT neighbouring pixels of one output row.
  const int groups = Cout / CT;
  const int xgroups = (OW + PT - 1) / PT;
  const int total = OH * xgroups * groups;
  float* on = out + (int64_t)n * OH * OW * Cout;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int g = t % groups;  // neighbouring threads: neighbouring channels
    const int xg = (t / groups) % xgroups;
    const int oy = t / (groups * xgroups);
    int xoff[PT];
#pragma unroll
    for (int p = 0; p < PT; ++p) {
      // Pixels past the row's end compute on the last one, never stored.
      const int ox = min(xg * PT + p, OW - 1);
      xoff[p] = ox * stride * Cin;
    }
    float acc[PT][CT];
#pragma unroll
    for (int p = 0; p < PT; ++p)
#pragma unroll
      for (int j = 0; j < CT; ++j) acc[p][j] = 0.0f;
    for (int ky = 0; ky < K; ++ky) {
      for (int kx = 0; kx < K; ++kx) {
        const float* xr = xs + ((oy * stride + ky) * Wp + kx) * Cin;
        const float* wr = w + (int64_t)(ky * K + kx) * Cin * Cout + g * CT;
        for (int ci = 0; ci < Cin; ++ci) {
          float wv[CT];
          load_w<CT>(wr + (int64_t)ci * Cout, wv);
#pragma unroll
          for (int p = 0; p < PT; ++p) {
            const float xv = xr[xoff[p] + ci];
#pragma unroll
            for (int j = 0; j < CT; ++j)
              acc[p][j] = fmaf(xv, wv[j], acc[p][j]);
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < PT; ++p) {
      const int ox = xg * PT + p;
      if (ox >= OW) break;
      float* o = on + ((int64_t)oy * OW + ox) * Cout + g * CT;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int co = g * CT + j;
        float y = acc[p][j] + __ldg(bias + co);
        if (alpha != nullptr && y < 0.0f) y *= __ldg(alpha + co);
        o[j] = y;
      }
    }
  }
}

// ---- implicit GEMM on the tensor cores (3xTF32) ----

constexpr int BM = 128;          // output pixels of a block
constexpr int BK = 32;           // input channels of one pipeline step
constexpr int A_LD = BK + 4;     // padded rows: fragment reads hit 32 banks
constexpr int IG_THREADS = 256;

// 16 bytes global -> shared, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

// x = hi + lo for the tensor cores: hi is x rounded to TF32 (10 mantissa
// bits) to nearest, ties away from zero, which is what cvt.rna.tf32.f32
// computes, done here as an add and a mask on the bits because the
// conversion unit is slow; lo is the rest, at most half a TF32 step of x,
// handed over as it is: the tensor cores read the upper 19 bits of a
// register, so what lo loses is below 2^-21 of x.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// Two neighbouring channels of one output pixel: bias, PReLU (slope 1 when
// the layer has none), one 8-byte store.
__device__ __forceinline__ void store_pair(float* dst, float y0, float y1,
                                           float b0, float b1, float s0,
                                           float s1) {
  y0 += b0;
  y1 += b1;
  if (y0 < 0.0f) y0 *= s0;
  if (y1 < 0.0f) y1 *= s1;
  *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
}

// The asynchronous gather of one block's operands. One pipeline step is
// tap (ky, kx), channels [c0, c0 + BK): a BM x BK slice of gathered input
// pixels into As (rows of A_LD floats) and the BK x BN slice of weights into
// Bs (rows of BN + 8). The loads run ahead of the math and keep their own
// position, advanced by additions only.
template <int BN>
struct TileLoader {
  static constexpr int B_LD = BN + 8;
  static constexpr int ROWS = BM / 32;       // A rows one thread copies
  // BN / 4 threads copy one row of the weight slice, rows b_kr, b_kr +
  // B_PASS, ...
  static constexpr int B_PASS = IG_THREADS / (BN / 4);
  static constexpr int B_ITERS = BK > B_PASS ? BK / B_PASS : 1;

  const float* x;
  const float* w;
  int H, W, Cin, Cout, K;
  // The output pixels whose input this thread gathers: row tid/8 + 32 i of
  // the tile, 16-byte chunk tid%8 of its BK channels. a_base is the element
  // offset of (image, first tap's row and column, that chunk); a pixel past
  // M gets a row that no tap can bring inside the image.
  int ci_off, iy0[ROWS], ix0[ROWS], a_base[ROWS];
  int b_kr, b_col;
  float* a_dst0;
  float* b_dst0;
  int ky = 0, kx = 0, c0 = 0;

  __device__ __forceinline__ TileLoader(const float* x_, const float* w_,
                                        float* As, float* Bs, int tid, int m0,
                                        int n0, int M, int H_, int W_,
                                        int Cin_, int OH, int OW, int Cout_,
                                        int K_, int stride, int pad_h,
                                        int pad_w)
      : x(x_), w(w_), H(H_), W(W_), Cin(Cin_), Cout(Cout_), K(K_) {
    ci_off = (tid & 7) * 4;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int m = m0 + (tid >> 3) + 32 * i;
      iy0[i] = -(1 << 28);
      ix0[i] = 0;
      a_base[i] = 0;
      if (m < M) {
        const int img = m / (OH * OW);
        const int rem = m - img * (OH * OW);
        const int oy = rem / OW;
        iy0[i] = oy * stride - pad_h;
        ix0[i] = (rem - oy * OW) * stride - pad_w;
        a_base[i] = ((img * H + iy0[i]) * W + ix0[i]) * Cin + ci_off;
      }
    }
    b_kr = tid / (BN / 4);
    b_col = n0 + (tid % (BN / 4)) * 4;
    a_dst0 = As + (tid >> 3) * A_LD + ci_off;
    b_dst0 = Bs + b_kr * B_LD + (tid % (BN / 4)) * 4;
  }

  // Copies the next step's slices into `stage` and moves on.
  __device__ __forceinline__ void load(int stage) {
    const int tap_off = (ky * W + kx) * Cin + c0;
    const bool c_ok = c0 + ci_off < Cin;
    float* a_dst = a_dst0 + stage * (BM * A_LD);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const bool ok = c_ok && (unsigned)(iy0[i] + ky) < (unsigned)H &&
                      (unsigned)(ix0[i] + kx) < (unsigned)W;
      cp_async16(a_dst + 32 * i * A_LD, x + (ok ? a_base[i] + tap_off : 0),
                 ok);
    }
    const int w_row = (ky * K + kx) * Cin + c0 + b_kr;
    float* b_dst = b_dst0 + stage * (BK * B_LD);
    if (B_PASS <= BK || b_kr < BK) {   // narrow tiles: fewer rows than threads
#pragma unroll
      for (int j = 0; j < B_ITERS; ++j) {
        const bool ok = b_col < Cout && c0 + b_kr + j * B_PASS < Cin;
        cp_async16(b_dst + j * B_PASS * B_LD,
                   w + (ok ? (w_row + j * B_PASS) * Cout + b_col : 0), ok);
      }
    }
    c0 += BK;
    if (c0 >= Cin) {
      c0 = 0;
      if (++kx == K) {
        kx = 0;
        ++ky;
      }
    }
  }
};

// ---- warpgroup mma (wgmma) ----

// Shared-memory matrix descriptor of a K-major operand without swizzle: 8
// rows x 16 bytes make a core matrix of 128 contiguous bytes; `lbo` bytes
// lead from one core matrix to the next along K, `sbo` to the next 8 rows.
__device__ __forceinline__ uint64_t wgmma_desc(const float* p, uint32_t lbo,
                                               uint32_t sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3ffffu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d (64 x BN of a warpgroup, f32) = a (64 x 8, TF32, registers) * b (8 x BN,
// TF32, shared memory) + (accumulate ? d : 0), asynchronously. A thread
// holds BN / 2 of the sums.
#define WG_R8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define WG_R16 WG_R8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define WG_R32 WG_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_R64 \
  WG_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
         "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define WG_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_D8(i) WG_D4(i), WG_D4(i + 4)
#define WG_D16(i) WG_D8(i), WG_D8(i + 8)
#define WG_D32(i) WG_D16(i), WG_D16(i + 16)
#define WG_D64(i) WG_D32(i), WG_D32(i + 32)
// n: the instruction's width; a0..a3, desc, pred: the operand numbers after
// the n / 2 sums.
#define WGMMA_TF32(n, sums, outs, a0, a1, a2, a3, desc, pred)               \
  asm volatile(                                                             \
      "{\n"                                                                 \
      ".reg .pred p;\n"                                                     \
      "setp.ne.b32 p, %" pred ", 0;\n"                                      \
      "wgmma.mma_async.sync.aligned.m64n" #n "k8.f32.tf32.tf32 {" sums "}, " \
      "{%" a0 ", %" a1 ", %" a2 ", %" a3 "}, %" desc ", p, 1, 1;\n"          \
      "}\n"                                                                 \
      : outs                                                                \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc),            \
        "r"(accumulate))

template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t b_desc, int accumulate) {
  static_assert(BN == 16 || BN == 32 || BN == 64 || BN == 128, "tile width");
  if constexpr (BN == 16) {
    WGMMA_TF32(16, WG_R8, WG_D8(0), "8", "9", "10", "11", "12", "13");
  } else if constexpr (BN == 32) {
    WGMMA_TF32(32, WG_R16, WG_D16(0), "16", "17", "18", "19", "20", "21");
  } else if constexpr (BN == 64) {
    WGMMA_TF32(64, WG_R32, WG_D32(0), "32", "33", "34", "35", "36", "37");
  } else {
    WGMMA_TF32(128, WG_R64, WG_D64(0), "64", "65", "66", "67", "68", "69");
  }
}

// Keeps the compiler from moving uses of d across the asynchronous mma.
template <int N>
__device__ __forceinline__ void wgmma_operand_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The implicit GEMM on warpgroup mma, BN output channels to a block. The
// block is two warpgroups, each owning 64 of the BM output pixels and all BN
// channels: its left operand
// (64 x 8 pixels x channels per k-step) comes from registers, split there,
// and no other warp holds the same pixels, so each input value is split
// once; the right operand must lie in shared memory as TF32 with K
// contiguous, so each step's 32 x BN weight slice is split once per block
// into a hi and a lo plane laid out [k / 4][n][4] (each n's four k values
// are 16 bytes: the core-matrix rows wgmma reads). wgmma is asynchronous:
// while the 12 wgmma of a step run, the same threads split the next step's
// weights into the other pair of planes. The 12 wgmma start from zero and
// their sum joins the running total through the FADD units, which round
// to nearest; the tensor cores truncate when they add to an accumulator.
constexpr int WG_STAGES = 4;   // raw slices in flight, one more than below:
                               //   a step's weights are split a step early
constexpr size_t wgmma_smem(int bn) {
  return (size_t)(WG_STAGES * (BM * A_LD + BK * (bn + 8)) + 4 * BK * bn) *
         sizeof(float);
}

template <int BN>
__global__ void __launch_bounds__(IG_THREADS, 1)
conv_wgmma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias,
                  const float* __restrict__ alpha, float* __restrict__ out,
                  int M, int H, int W, int Cin, int OH, int OW, int Cout,
                  int K, int stride, int pad_h, int pad_w) {
  constexpr int B_LD = BN + 8, PLANE = BK * BN, NACC = BN / 2;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                          // WG_STAGES x BM x A_LD
  float* Bs = As + WG_STAGES * BM * A_LD;    // WG_STAGES x BK x B_LD, raw
  float* Bt = Bs + WG_STAGES * BK * B_LD;    // 2 x {hi, lo} x BK / 4 x BN x 4

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (warp >> 2) * 64 + (warp & 3) * 16;   // of this warp
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  TileLoader<BN> loader(x, w, As, Bs, tid, m0, n0, M, H, W, Cin, OH, OW, Cout,
                        K, stride, pad_h, pad_w);
  const int nsteps = K * K * ((Cin + BK - 1) / BK);

  // Weights of raw stage `stage`: [k][n] -> TF32 planes [k / 4][n][4] of
  // pair `pair`, each value split once; then the fence that lets wgmma,
  // which reads shared memory through the asynchronous proxy, see them.
  auto split_weights = [&](int stage, int pair) {
    const float* b_s = Bs + stage * BK * B_LD;
    float* hi_p = Bt + pair * 2 * PLANE;
#pragma unroll
    for (int item = tid; item < (BK / 4) * BN; item += IG_THREADS) {
      const int n = item % BN, c = item / BN;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_tf32(b_s[(4 * c + i) * B_LD + n], hi[i], lo[i]);
      *reinterpret_cast<uint4*>(hi_p + (c * BN + n) * 4) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(hi_p + PLANE + (c * BN + n) * 4) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  float acc[NACC], part[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;

  for (int s = 0; s < WG_STAGES - 1; ++s) {
    if (s < nsteps) loader.load(s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  asm volatile("cp.async.wait_group %0;\n" ::"n"(WG_STAGES - 2));
  __syncthreads();
  split_weights(0, 0);
  __syncthreads();

  int stage = 0;
  for (int step = 0; step < nsteps; ++step) {
    // Here the step's raw pixels and its weight planes are in place.
    const float* a_s = As + (stage * BM + row0 + g) * A_LD + t;
    uint32_t ah[BK / 8][4], al[BK / 8][4];
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      split_tf32(a_s[ks * 8], ah[ks][0], al[ks][0]);
      split_tf32(a_s[8 * A_LD + ks * 8], ah[ks][1], al[ks][1]);
      split_tf32(a_s[ks * 8 + 4], ah[ks][2], al[ks][2]);
      split_tf32(a_s[8 * A_LD + ks * 8 + 4], ah[ks][3], al[ks][3]);
    }
    const float* hi_p = Bt + (step & 1) * 2 * PLANE;
    wgmma_operand_fence(part);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      // A k-step is two [n][4] slabs: BN * 16 bytes from one to the next
      // along K, 128 bytes from one 8-channel group to the next.
      const uint64_t d_hi = wgmma_desc(hi_p + 2 * ks * BN * 4, BN * 16, 128);
      const uint64_t d_lo =
          wgmma_desc(hi_p + PLANE + 2 * ks * BN * 4, BN * 16, 128);
      wgmma_tf32<BN>(part, al[ks], d_hi, ks > 0);
      wgmma_tf32<BN>(part, ah[ks], d_lo, 1);
      wgmma_tf32<BN>(part, ah[ks], d_hi, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");

    // While they run: the next step's copies have landed; every warp is
    // past its reads of the stage the new copies overwrite (raw pixels of
    // step - 1) and past its wait for the wgmma of step - 1, which read
    // the planes the next split overwrites.
    const int next = stage + 1 == WG_STAGES ? 0 : stage + 1;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(WG_STAGES - 3));
    __syncthreads();
    if (step + WG_STAGES - 1 < nsteps)
      loader.load(stage == 0 ? WG_STAGES - 1 : stage - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    if (step + 1 < nsteps) split_weights(next, (step + 1) & 1);

    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wgmma_operand_fence(part);
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] += part[i];
    __syncthreads();   // the next planes are complete
    stage = next;
  }

  // Epilogue: accumulator 4 j + 2 half + e is row g + 8 half of the warp's
  // 16, channel 8 j + 2 t + e.
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + j * 8 + 2 * t;
    if (n >= Cout) continue;
    const float b0 = __ldg(bias + n), b1 = __ldg(bias + n + 1);
    const float s0 = alpha != nullptr ? __ldg(alpha + n) : 1.0f;
    const float s1 = alpha != nullptr ? __ldg(alpha + n + 1) : 1.0f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + row0 + g + 8 * half;
      if (m >= M) continue;
      store_pair(out + (int64_t)m * Cout + n, acc[4 * j + 2 * half],
                 acc[4 * j + 2 * half + 1], b0, b1, s0, s1);
    }
  }
}

template <int BN>
int launch_wgmma(const float* x, const float* w, const float* b,
                 const float* a, float* out, int M, int H, int W, int Cin,
                 int OH, int OW, int Cout, int K, int stride, int pad_h,
                 int pad_w, cudaStream_t stream) {
  constexpr size_t smem = wgmma_smem(BN);
  auto kernel = conv_wgmma_kernel<BN>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  kernel<<<grid, IG_THREADS, smem, stream>>>(
      x, w, b, a, out, M, H, W, Cin, OH, OW, Cout, K, stride, pad_h, pad_w);
  return (int)cudaGetLastError();
}

constexpr int kThreads = 256;

template <int CT, int PT>
int launch(const float* x, const float* w, const float* b, const float* a,
           float* out, int N, int H, int W, int Cin, int OH, int OW,
           int Cout, int K, int stride, int pad_h, int pad_w, int Hp, int Wp,
           size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      conv_prelu_kernel<CT, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  conv_prelu_kernel<CT, PT><<<N, kThreads, smem, stream>>>(
      x, w, b, a, out, H, W, Cin, OH, OW, Cout, K, stride, pad_h, pad_w, Hp,
      Wp);
  return (int)cudaGetLastError();
}

}  // namespace

// alpha may be null (no PReLU). Output (N, ceil(H/s), ceil(W/s), Cout).
// x, w and out 16-byte aligned. The caller picks the path: tensor_cores
// (the implicit GEMM; refused unless both channel counts are multiples of
// 4) or the per-image path, whose padded window must fit a block's shared
// memory.
extern "C" int conv_prelu_launch(const float* x, const float* w,
                                 const float* b, const float* alpha,
                                 float* out, int N, int H, int W, int Cin,
                                 int Cout, int K, int stride,
                                 int tensor_cores, cudaStream_t stream) {
  if (N <= 0) return 0;
  const int OH = (H + stride - 1) / stride;
  const int OW = (W + stride - 1) / stride;
  const int tot_h = (OH - 1) * stride + K - H;
  const int tot_w = (OW - 1) * stride + K - W;
  const int pad_h = (tot_h > 0 ? tot_h : 0) / 2;
  const int pad_w = (tot_w > 0 ? tot_w : 0) / 2;
  if (tensor_cores) {
    if (Cin % 4 || Cout % 4) return (int)cudaErrorInvalidValue;
    const int64_t M = (int64_t)N * OH * OW;
    // The kernel indexes pixels, inputs and weights with 32-bit offsets.
    if (M > 2147483647LL - BM || (Cout + 127) / 128 > 65535 ||
        (int64_t)N * H * W * Cin > 2147483647LL ||
        (int64_t)K * K * Cin * Cout > 2147483647LL)
      return (int)cudaErrorInvalidValue;
#define WGMMA_LAUNCH(BN)                                                    \
  return launch_wgmma<BN>(x, w, b, alpha, out, (int)M, H, W, Cin, OH, OW,   \
                          Cout, K, stride, pad_h, pad_w, stream)
    if (Cout <= 16) WGMMA_LAUNCH(16);
    if (Cout <= 32) WGMMA_LAUNCH(32);
    if (Cout <= 64) WGMMA_LAUNCH(64);
    WGMMA_LAUNCH(128);
#undef WGMMA_LAUNCH
  }
  const int Hp = (OH - 1) * stride + K;
  const int Wp = (OW - 1) * stride + K;
  const size_t smem = (size_t)Hp * Wp * Cin * sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  // Register tile (CT channels x PT pixels): the largest that still gives
  // every thread of the block a work item; else the one with most items.
  const int tiles[6][2] = {{8, 4}, {8, 2}, {4, 2}, {8, 1}, {4, 1}, {1, 1}};
  int pick = -1, best = -1;
  for (int i = 0; i < 6; ++i) {
    const int ct = tiles[i][0], pt = tiles[i][1];
    if (Cout % ct) continue;
    const int items = OH * ((OW + pt - 1) / pt) * (Cout / ct);
    if (items >= kThreads) { pick = i; break; }
    if (best < 0 || items > OH * ((OW + tiles[best][1] - 1) / tiles[best][1]) *
                                (Cout / tiles[best][0]))
      best = i;
  }
  if (pick < 0) pick = best;
#define CONV_LAUNCH(CT, PT)                                                  \
  return launch<CT, PT>(x, w, b, alpha, out, N, H, W, Cin, OH, OW, Cout, K, \
                        stride, pad_h, pad_w, Hp, Wp, smem, stream)
  switch (pick) {
    case 0: CONV_LAUNCH(8, 4);
    case 1: CONV_LAUNCH(8, 2);
    case 2: CONV_LAUNCH(4, 2);
    case 3: CONV_LAUNCH(8, 1);
    case 4: CONV_LAUNCH(4, 1);
    default: CONV_LAUNCH(1, 1);
  }
#undef CONV_LAUNCH
}
