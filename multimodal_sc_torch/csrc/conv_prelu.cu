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
// Cin = 3, whose 12-byte pixels cannot be copied in 16-byte chunks, or the
// decoder's Cout = 3): a block per image and band of output rows, the
// band's zero-padded window ((band - 1) * stride + K rows of the padded
// image) in shared memory, a register tile of CT channels x PT pixels per
// thread on the f32 FMA units. With Cout = 3 the work is bound by bytes and
// a tensor-core tile would leave 13 of its 16 columns idle. The band comes
// from the caller (kernels/conv_block.py band_plan): small enough that the
// window stays near 56 KB, so several blocks share an SM, and that a batch
// of 32-64 images still gives at least 132 blocks. Each output sums its
// taps (ky, kx, channel) in the same order whatever the band, so the
// results do not depend on it.
//
// bf16 I/O (train.bf16). The TPU kernel reads bf16 activations and weights,
// sums their products in f32, adds the bias, applies the PReLU and rounds
// once at the store. A bf16 x bf16 product is exact in f32, so the 3xTF32
// split would triple the work for nothing, and the bound becomes the bf16
// tensor-core rate (989 TFLOP/s):
//
//   * conv_mma_bf16_kernel (Cin and Cout multiples of 8, the 16-byte copies
//     of 8 bf16): the same implicit GEMM, M = N*OH*OW pixels, N = Cout, K =
//     K*K*Cin, on mma.sync.m16n8k16 with bf16 operands and f32 sums. A
//     block owns 128 pixels x a tile of 16-128 channels (as above); one
//     pipeline step is one tap and 32 input channels (two k-steps of 16),
//     copied by cp.async into a ring of three stages: 128 x 32 gathered
//     pixels (rows of 40 bf16, so the eight rows an ldmatrix reads fall in
//     eight bank groups) and 32 x BN weights (rows of BN + 8). Each of the
//     eight warps owns 16 pixels x all BN channels: per k-step one ldmatrix
//     of its pixels and BN / 16 transposed ldmatrix of the weights. Each
//     mma's 16 products start from zero and join the pixel's sum through
//     the FADD units, which round to nearest (a chain of tensor-core sums
//     truncates). Channels past Cin, taps outside the image and pixels past
//     M are zero-filled by cp.async; bias and PReLU in f32, one rounding,
//     two channels a 4-byte store.
//   * conv_prelu_kernel<bf16> (any other channel count: the first layer's
//     Cin = 3, the decoder's Cout = 3): the banded kernel, its window of
//     the padded input converted to f32 on the way into shared memory, the
//     weights, bias and slopes converted as they are read, the sum rounded
//     once at the store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_mma.cuh"
#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

// An element of x, w, bias or alpha as f32 (bf16 widens exactly), read
// through the read-only cache; an f32 result stored as E.
__device__ __forceinline__ float ldg_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f32(const bf16* p) {
  return __uint_as_float(
      (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int CT, typename E>
__device__ __forceinline__ void load_w(const E* __restrict__ p,
                                       float (&w)[CT]) {
  if constexpr (CT % 4 == 0 && std::is_same_v<E, float>) {
#pragma unroll
    for (int j = 0; j < CT; j += 4) {
      float4 v = __ldg(reinterpret_cast<const float4*>(p + j));
      w[j] = v.x; w[j + 1] = v.y; w[j + 2] = v.z; w[j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < CT; ++j) w[j] = ldg_f32(p + j);
  }
}

template <typename E, int CT, int PT>
__global__ void conv_prelu_kernel(const E* __restrict__ x,
                                  const E* __restrict__ w,
                                  const E* __restrict__ bias,
                                  const E* __restrict__ alpha,
                                  E* __restrict__ out, int H, int W,
                                  int Cin, int OH, int OW, int Cout, int K,
                                  int stride, int pad_h, int pad_w, int Wp,
                                  int band, int bands) {
  // (Hb, Wp, Cs) zero-padded window of output rows [oy0, oy0 + rows); a
  // pixel takes Cs = Cin | 1 floats, an odd stride, so the 32 neighbouring
  // pixels a warp reads at one channel lie in 32 different banks.
  extern __shared__ float xs[];
  const int Cs = Cin | 1;
  const int n = blockIdx.x / bands;
  const int oy0 = (blockIdx.x % bands) * band;
  const int rows = min(band, OH - oy0);
  const int Hb = (rows - 1) * stride + K;
  const E* xn = x + (int64_t)n * H * W * Cin;
  const int n_load = Hb * Wp * Cin;
  for (int i = threadIdx.x; i < n_load; i += blockDim.x) {
    int c = i % Cin;
    int t = i / Cin;
    int iy = oy0 * stride + t / Wp - pad_h;
    int ix = t % Wp - pad_w;
    xs[t * Cs + c] = (iy >= 0 && iy < H && ix >= 0 && ix < W)
                ? to_f32(xn[((int64_t)iy * W + ix) * Cin + c])
                : 0.0f;
  }
  __syncthreads();

  // Work item: CT channels x PT neighbouring pixels of one output row.
  const int groups = Cout / CT;
  const int xgroups = (OW + PT - 1) / PT;
  const int total = rows * xgroups * groups;
  E* on = out + ((int64_t)n * OH + oy0) * OW * Cout;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int g = t % groups;  // neighbouring threads: neighbouring channels
    const int xg = (t / groups) % xgroups;
    const int oy = t / (groups * xgroups);  // row within the band
    int xoff[PT];
#pragma unroll
    for (int p = 0; p < PT; ++p) {
      // Pixels past the row's end compute on the last one, never stored.
      const int ox = min(xg * PT + p, OW - 1);
      xoff[p] = ox * stride * Cs;
    }
    float acc[PT][CT];
#pragma unroll
    for (int p = 0; p < PT; ++p)
#pragma unroll
      for (int j = 0; j < CT; ++j) acc[p][j] = 0.0f;
    for (int ky = 0; ky < K; ++ky) {
      for (int kx = 0; kx < K; ++kx) {
        const float* xr = xs + ((oy * stride + ky) * Wp + kx) * Cs;
        const E* wr = w + (int64_t)(ky * K + kx) * Cin * Cout + g * CT;
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
      E* o = on + ((int64_t)oy * OW + ox) * Cout + g * CT;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int co = g * CT + j;
        float y = acc[p][j] + ldg_f32(bias + co);
        if (alpha != nullptr && y < 0.0f) y *= ldg_f32(alpha + co);
        store_f32(o + j, y);
      }
    }
  }
}

// ---- implicit GEMM on the tensor cores (3xTF32) ----

constexpr int BM = 128;          // output pixels of a block
constexpr int BK = 32;           // input channels of one pipeline step
constexpr int A_LD = BK + 4;     // padded rows: fragment reads hit 32 banks
constexpr int IG_THREADS = 256;

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

// ---- implicit GEMM on the tensor cores, bf16 operands (bf16 I/O) ----

constexpr int HB_STAGES = 3;        // pipeline steps in flight
constexpr int HB_LDA = BK + 8;      // bf16 of a shared pixel row (80 bytes)

constexpr size_t mma_bf16_smem(int bn) {
  return (size_t)HB_STAGES * (BM * HB_LDA + BK * (bn + 8)) * sizeof(bf16);
}

template <int BN>
__global__ void __launch_bounds__(IG_THREADS)
conv_mma_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     const bf16* __restrict__ bias,
                     const bf16* __restrict__ alpha, bf16* __restrict__ out,
                     int M, int H, int W, int Cin, int OH, int OW, int Cout,
                     int K, int stride, int pad_h, int pad_w) {
  constexpr int LDB = BN + 8;
  constexpr int A_ROWS = BM * (BK / 8) / IG_THREADS;     // 2 chunks a thread
  constexpr int B_CHUNKS = BK * (BN / 8);                // of the weights
  constexpr int B_ITERS = (B_CHUNKS + IG_THREADS - 1) / IG_THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);   // HB_STAGES x BM x HB_LDA
  bf16* Bs = As + HB_STAGES * BM * HB_LDA;        // HB_STAGES x BK x LDB

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int li = lane & 7, lb = (lane >> 3) & 1, lc = lane >> 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // The gather: this thread copies 16-byte chunk tid % 4 (8 channels) of
  // pixel rows tid / 4 + 64 i; a pixel past M gets a row no tap brings
  // inside the image.
  const int ci_off = (tid & 3) * 8;
  int iy0[A_ROWS], ix0[A_ROWS], a_base[A_ROWS];
#pragma unroll
  for (int i = 0; i < A_ROWS; ++i) {
    const int m = m0 + (tid >> 2) + 64 * i;
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
  int ky = 0, kx = 0, c0 = 0;   // the next step to copy
  auto load = [&](int stage) {
    const int tap_off = (ky * W + kx) * Cin + c0;
    const bool c_ok = c0 + ci_off < Cin;
    bf16* a_dst = As + (stage * BM + (tid >> 2)) * HB_LDA + ci_off;
#pragma unroll
    for (int i = 0; i < A_ROWS; ++i) {
      const bool ok = c_ok && (unsigned)(iy0[i] + ky) < (unsigned)H &&
                      (unsigned)(ix0[i] + kx) < (unsigned)W;
      cp_async16(reinterpret_cast<float*>(a_dst + 64 * i * HB_LDA),
                 reinterpret_cast<const float*>(
                     x + (ok ? a_base[i] + tap_off : 0)),
                 ok);
    }
    const int w_row = (ky * K + kx) * Cin + c0;
#pragma unroll
    for (int j = 0; j < B_ITERS; ++j) {
      const int c = tid + j * IG_THREADS;
      if (c < B_CHUNKS) {
        const int kr = c / (BN / 8), col = (c % (BN / 8)) * 8;
        const bool ok = n0 + col < Cout && c0 + kr < Cin;
        cp_async16(reinterpret_cast<float*>(Bs + (stage * BK + kr) * LDB +
                                            col),
                   reinterpret_cast<const float*>(
                       w + (ok ? (int64_t)(w_row + kr) * Cout + n0 + col
                               : 0)),
                   ok);
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
  };

  const int nsteps = K * K * ((Cin + BK - 1) / BK);
  for (int s = 0; s < HB_STAGES - 1; ++s) {
    if (s < nsteps) load(s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  float acc[BN / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int step = 0; step < nsteps; ++step) {
    // This step's copies have landed, and every warp is done with the
    // stage the next copies overwrite (the previous step's).
    asm volatile("cp.async.wait_group %0;\n" ::"n"(HB_STAGES - 2));
    __syncthreads();
    if (step + HB_STAGES - 1 < nsteps)
      load((step + HB_STAGES - 1) % HB_STAGES);
    asm volatile("cp.async.commit_group;\n" ::);
    const int stage = step % HB_STAGES;
    const bf16* a_s = As + (stage * BM + 16 * warp) * HB_LDA;
    const bf16* b_s = Bs + stage * BK * LDB;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, a_s + (li + 8 * lb) * HB_LDA + 16 * ks + 8 * lc);
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t f[4];   // the weights of n-tiles 2 np and 2 np + 1
        ldsm_x4_t(f, b_s + (16 * ks + li + 8 * lb) * LDB + 8 * (2 * np + lc));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_bf16(part, a, f[2 * h], f[2 * h + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[2 * np + h][e] += part[e];
        }
      }
    }
  }

  // Epilogue: acc[j][2 half + e] is pixel 16 warp + g + 8 half, channel
  // n0 + 8 j + 2 t + e.
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + j * 8 + 2 * t;
    if (n >= Cout) continue;
    const float b0 = ldg_f32(bias + n), b1 = ldg_f32(bias + n + 1);
    const float s0 = alpha != nullptr ? ldg_f32(alpha + n) : 1.0f;
    const float s1 = alpha != nullptr ? ldg_f32(alpha + n + 1) : 1.0f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + 16 * warp + g + 8 * half;
      if (m >= M) continue;
      float y0 = acc[j][2 * half] + b0, y1 = acc[j][2 * half + 1] + b1;
      if (y0 < 0.0f) y0 *= s0;
      if (y1 < 0.0f) y1 *= s1;
      *reinterpret_cast<uint32_t*>(out + (int64_t)m * Cout + n) =
          pack_bf16(y0, y1);
    }
  }
}

template <int BN>
int launch_mma_bf16(const bf16* x, const bf16* w, const bf16* b,
                    const bf16* a, bf16* out, int M, int H, int W, int Cin,
                    int OH, int OW, int Cout, int K, int stride, int pad_h,
                    int pad_w, cudaStream_t stream) {
  constexpr size_t smem = mma_bf16_smem(BN);
  auto kernel = conv_mma_bf16_kernel<BN>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  kernel<<<grid, IG_THREADS, smem, stream>>>(
      x, w, b, a, out, M, H, W, Cin, OH, OW, Cout, K, stride, pad_h, pad_w);
  return (int)cudaGetLastError();
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

template <typename E, int CT, int PT>
int launch(const E* x, const E* w, const E* b, const E* a, E* out, int N,
           int H, int W, int Cin, int OH, int OW, int Cout, int K, int stride,
           int pad_h, int pad_w, int Wp, int band, size_t smem,
           cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      conv_prelu_kernel<E, CT, PT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int bands = (OH + band - 1) / band;
  conv_prelu_kernel<E, CT, PT><<<N * bands, kThreads, smem, stream>>>(
      x, w, b, a, out, H, W, Cin, OH, OW, Cout, K, stride, pad_h, pad_w, Wp,
      band, bands);
  return (int)cudaGetLastError();
}

template <typename E>
int conv_launch(const E* x, const E* w, const E* b, const E* alpha, E* out,
                int N, int H, int W, int Cin, int Cout, int K, int stride,
                int tensor_cores, int band, cudaStream_t stream) {
  constexpr bool kF32 = std::is_same_v<E, float>;
  if (N <= 0) return 0;
  const int OH = (H + stride - 1) / stride;
  const int OW = (W + stride - 1) / stride;
  const int tot_h = (OH - 1) * stride + K - H;
  const int tot_w = (OW - 1) * stride + K - W;
  const int pad_h = (tot_h > 0 ? tot_h : 0) / 2;
  const int pad_w = (tot_w > 0 ? tot_w : 0) / 2;
  if (tensor_cores) {
    // 16-byte copies: 4 f32 or 8 bf16 channels.
    const int chunk = kF32 ? 4 : 8;
    if (Cin % chunk || Cout % chunk) return (int)cudaErrorInvalidValue;
    const int64_t M = (int64_t)N * OH * OW;
    // The kernel indexes pixels, inputs and weights with 32-bit offsets.
    if (M > 2147483647LL - BM || (Cout + 127) / 128 > 65535 ||
        (int64_t)N * H * W * Cin > 2147483647LL ||
        (int64_t)K * K * Cin * Cout > 2147483647LL)
      return (int)cudaErrorInvalidValue;
#define TC_LAUNCH(BN)                                                         \
  if constexpr (kF32)                                                         \
    return launch_wgmma<BN>(x, w, b, alpha, out, (int)M, H, W, Cin, OH, OW,   \
                            Cout, K, stride, pad_h, pad_w, stream);           \
  else                                                                        \
    return launch_mma_bf16<BN>(x, w, b, alpha, out, (int)M, H, W, Cin, OH,    \
                               OW, Cout, K, stride, pad_h, pad_w, stream)
    if (Cout <= 16) TC_LAUNCH(16);
    if (Cout <= 32) TC_LAUNCH(32);
    if (Cout <= 64) TC_LAUNCH(64);
    TC_LAUNCH(128);
#undef TC_LAUNCH
  }
  if (band < 1 || band > OH) return (int)cudaErrorInvalidValue;
  const int Wp = (OW - 1) * stride + K;
  const size_t smem = (size_t)((band - 1) * stride + K) * Wp * (Cin | 1) *
                      sizeof(float);
  if (smem > 232448 || (int64_t)N * ((OH + band - 1) / band) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  // Register tile (CT channels x PT pixels): the largest that still gives
  // every thread of the block a work item; else the one with most items.
  // Three channels (the decoder's RGB output) take a tile of 3: one shared
  // load serves 3 products.
  const int tiles[8][2] = {{8, 4}, {8, 2}, {4, 2}, {8, 1},
                           {4, 1}, {3, 2}, {3, 1}, {1, 1}};
  int pick = -1, best = -1;
  for (int i = 0; i < 8; ++i) {
    const int ct = tiles[i][0], pt = tiles[i][1];
    if (Cout % ct) continue;
    const int items = band * ((OW + pt - 1) / pt) * (Cout / ct);
    if (items >= kThreads) { pick = i; break; }
    if (best < 0 ||
        items > band * ((OW + tiles[best][1] - 1) / tiles[best][1]) *
                    (Cout / tiles[best][0]))
      best = i;
  }
  if (pick < 0) pick = best;
#define CONV_LAUNCH(CT, PT)                                                \
  return launch<E, CT, PT>(x, w, b, alpha, out, N, H, W, Cin, OH, OW, Cout, \
                           K, stride, pad_h, pad_w, Wp, band, smem, stream)
  switch (pick) {
    case 0: CONV_LAUNCH(8, 4);
    case 1: CONV_LAUNCH(8, 2);
    case 2: CONV_LAUNCH(4, 2);
    case 3: CONV_LAUNCH(8, 1);
    case 4: CONV_LAUNCH(4, 1);
    case 5: CONV_LAUNCH(3, 2);
    case 6: CONV_LAUNCH(3, 1);
    default: CONV_LAUNCH(1, 1);
  }
#undef CONV_LAUNCH
}

}  // namespace

// alpha may be null (no PReLU). Output (N, ceil(H/s), ceil(W/s), Cout).
// x, w and out 16-byte aligned. The caller picks the path: tensor_cores
// (the implicit GEMM; refused unless both channel counts are multiples of
// 4) or the banded path, with `band` output rows a block, whose padded
// window must fit a block's shared memory.
extern "C" int conv_prelu_launch(const float* x, const float* w,
                                 const float* b, const float* alpha,
                                 float* out, int N, int H, int W, int Cin,
                                 int Cout, int K, int stride,
                                 int tensor_cores, int band,
                                 cudaStream_t stream) {
  return conv_launch<float>(x, w, b, alpha, out, N, H, W, Cin, Cout, K,
                            stride, tensor_cores, band, stream);
}

// The same on bf16 x, w, b, alpha and out (train.bf16): the implicit GEMM
// on bf16 mma.sync (channel counts multiples of 8) or the banded path.
extern "C" int conv_prelu_bf16_launch(const void* x, const void* w,
                                      const void* b, const void* alpha,
                                      void* out, int N, int H, int W,
                                      int Cin, int Cout, int K, int stride,
                                      int tensor_cores, int band,
                                      cudaStream_t stream) {
  return conv_launch<bf16>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(b), static_cast<const bf16*>(alpha),
      static_cast<bf16*>(out), N, H, W, Cin, Cout, K, stride, tensor_cores,
      band, stream);
}
