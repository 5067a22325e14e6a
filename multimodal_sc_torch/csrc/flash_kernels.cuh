// Device code of the f32-grade softmax-attention kernels on f32 tensors:
// forward, dQ and dK/dV (3xTF32 on the tensor cores; the backward at head
// width 128 on the f32 FMA units) on any (batch, head, row)-strided layout.
// flash_attention.cu documents the design and launches all three on
// (B, H, L, D) tensors; attention_packed.cu launches them as its f32 mode on
// the packed (B, L, H*d) layout, which is the same thing under other
// strides. The kernels on bf16 tensors are in flash_bf16.cuh.
//
// The tensor-core kernels are templated on the element type T of their
// tensors (lse and delta stay f32). T = float is the f32 instance; T = bf16
// is the packed kernels' f32 mode on bf16 tensors (mxu_bf16=False, as the
// TPU kernel computes it on bf16 arrays): every value is read in bf16 and
// widened exactly, the arithmetic is the f32 instance's, the output and dQ
// are rounded once at the store, and dK and dV follow the TPU kernel's
// blocking: each 128-query block's f32 sum is rounded to bf16 and added to
// a running bf16 sum, which is rounded again (its _init / _accum). Raw
// tiles of bf16 rows arrive by 8-byte cp.async and widen as they are split;
// every `if constexpr` on T leaves the f32 instance's code as it was.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "elem_io.cuh"
#include "tensor_core.cuh"

namespace flash {

constexpr int W = 32;          // head-dim columns a lane keeps in registers
constexpr int NC = W / 4;      // 16-byte chunks per lane
constexpr int KT = 32;         // rows of a shared-memory tile
constexpr int THREADS = 128;
constexpr float NEG = -1e30f;  // score of a key past Lk, and the first max

struct Strides {               // of a (B, H, L, D) tensor, in floats; D: 1
  long long b, h, l;
};

template <typename P>
__device__ __forceinline__ P* at(P* p, Strides s, int b, int h, int64_t row) {
  return p + b * s.b + h * s.h + row * s.l;
}

// Rows [0, n_valid) x columns [0, D) of src (row stride `stride` elements)
// into a shared f32 KT x DT tile; everything else reads as zeros.
template <int DT>
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          int64_t stride, int n_valid, int D,
                                          float* dst) {
  constexpr int C = DT / 4;
  for (int i = threadIdx.x; i < KT * C; i += THREADS) {
    const int r = i / C, c = i % C;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_valid && c * 4 < D) v = io::ld4(src + r * stride + 4 * c);
    reinterpret_cast<float4*>(dst)[i] = v;
  }
}

// This lane's 32 columns of a row in device memory; zeros when !valid and
// past D.
template <int LPR>
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         bool valid, int seg, int D,
                                         float (&dst)[W]) {
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = i * LPR + seg;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid && c * 4 < D) v = io::ld4(src + 4 * c);
    dst[4 * i] = v.x;
    dst[4 * i + 1] = v.y;
    dst[4 * i + 2] = v.z;
    dst[4 * i + 3] = v.w;
  }
}

// src * f into this lane's columns of a row in device memory.
template <int LPR>
__device__ __forceinline__ void store_row(float* dst, int seg, int D,
                                          const float (&src)[W], float f) {
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = i * LPR + seg;
    if (c * 4 < D)
      io::st4(dst + 4 * c,
              make_float4(src[4 * i] * f, src[4 * i + 1] * f,
                          src[4 * i + 2] * f, src[4 * i + 3] * f));
  }
}

// Sum over the LPR lanes that share a row; every lane gets the same bits.
template <int LPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Register row . shared row, over the whole head dim.
template <int LPR>
__device__ __forceinline__ float dot_row(const float (&a)[W], const float* row,
                                         int seg) {
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const float4 b4 = reinterpret_cast<const float4*>(row)[i * LPR + seg];
    acc = fmaf(a[4 * i], b4.x, acc);
    acc = fmaf(a[4 * i + 1], b4.y, acc);
    acc = fmaf(a[4 * i + 2], b4.z, acc);
    acc = fmaf(a[4 * i + 3], b4.w, acc);
  }
  return row_sum<LPR>(acc);
}

// acc += w * shared row (this lane's columns).
template <int LPR>
__device__ __forceinline__ void axpy_row(float w, const float* row, int seg,
                                         float (&acc)[W]) {
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const float4 b4 = reinterpret_cast<const float4*>(row)[i * LPR + seg];
    acc[4 * i] = fmaf(w, b4.x, acc[4 * i]);
    acc[4 * i + 1] = fmaf(w, b4.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(w, b4.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(w, b4.w, acc[4 * i + 3]);
  }
}

// The element type of a launcher below is named, never deduced: the
// launchers of flash_bf16.cuh take bf16 pointers under the same names, and
// flash_attention.cu picks between the two by its pointers' type.
template <typename T>
struct named {
  using type = T;
};
template <typename T>
using named_t = typename named<T>::type;

// Four neighbouring values global -> shared, asynchronously: 16 bytes of
// f32 or 8 of bf16; zeros when !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  cp_async16(dst, src, valid);
}
__device__ __forceinline__ void cp_async4(io::bf16* dst, const io::bf16* src,
                                          bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = valid ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

// Four neighbouring values of a raw shared tile, widened to f32.
__device__ __forceinline__ float4 raw4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 raw4(const io::bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = io::widen2(u.x), b = io::widen2(u.y);
  return make_float4(a.x, a.y, b.x, b.y);
}

// ---- forward, f32-grade, on the TF32 tensor cores (3xTF32, wgmma) ----

constexpr int TQ = 64;         // query rows of a forward block (a warpgroup)

// Keys of a forward tile at compiled width DT (16 at DT = 128, where shared
// memory runs out).
__host__ __device__ constexpr int fwd_keys(int DT) { return DT > 64 ? 16 : 32; }

// Words of one plane of a forward tile. K planes [d / 4][key][4]: the core
// matrices (8 keys x 4 columns) of one group of 4 columns lie together, the
// groups 16 bytes apart beyond that, so the 16-byte stores of neighbouring
// column groups hit different banks. V planes [slot / 4][d / 8][8][4] with
// 16 bytes after every core matrix (8 columns x 4 key slots), for the same
// reason. Q planes (DT = 128) like K, over the block's 64 rows.
__host__ __device__ constexpr int k_plane(int DT) {
  return DT / 4 * (fwd_keys(DT) * 4 + 4);
}
__host__ __device__ constexpr int v_plane(int DT) {
  return fwd_keys(DT) / 4 * (DT / 8) * 36;
}
__host__ __device__ constexpr int q_plane(int DT) { return DT / 4 * (TQ * 4 + 4); }

// Dynamic shared memory of the forward at compiled width DT: two stages of
// raw K and V tiles, two sets of their hi and lo planes, and for DT = 128
// the split Q rows.
constexpr size_t fwd_smem(int DT) {
  return (size_t)(4 * fwd_keys(DT) * (DT + 4) +
                  2 * (2 * k_plane(DT) + 2 * v_plane(DT)) +
                  (DT > 64 ? 2 * q_plane(DT) : 0)) *
         sizeof(float);
}

// A tile's key slot in the V planes: within each 8 keys, key 2i goes to slot
// i and key 2i + 1 to slot i + 4, the order in which the S accumulator
// hands its keys to the A operand of P V (below).
__device__ __forceinline__ int v_slot(int key) {
  return (key & ~7) + ((key & 7) >> 1) + 4 * (key & 1);
}

// One block, a warpgroup of four warps, per (batch*head, 64 queries); warp
// w holds queries [16w, 16w + 16) of the block in every accumulator.
// Raw rows of element type T, f32 planes: a bf16 raw stage fills half the
// bytes the f32 one does, and the planes lie where they do for f32.
template <int DT, typename T = float>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
                 Strides so, int H, int Lq, int Lk, int D, int row_blocks,
                 float scale) {
  constexpr int TK = fwd_keys(DT);
  constexpr int RLD = DT + 4;           // raw rows
  constexpr int KS = DT / 8;            // k-steps over the head dim
  constexpr int PS = TK / 8;            // k-steps over a tile's keys
  constexpr int C4 = DT / 4;            // 16-byte chunks of a row
  constexpr int RAW = TK * RLD;
  constexpr int KP = k_plane(DT), VP = v_plane(DT);
  constexpr int SET = 2 * KP + 2 * VP;  // K hi, K lo, V hi, V lo
  constexpr bool Q_REGS = DT <= 64;     // DT = 128: Q planes in shared
  extern __shared__ __align__(16) float smem[];
  T* raw = reinterpret_cast<T*>(smem);  // [stage][K, V][TK][RLD]
  uint32_t* planes = reinterpret_cast<uint32_t*>(smem + 4 * RAW);
  uint32_t* qplanes = planes + 2 * SET; // [hi, lo], DT = 128 only

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / row_blocks;
  const int b = bh / H, h = bh % H;
  const int row0 = (blockIdx.x % row_blocks) * TQ + warp * 16;
  const T* kb = at(k, sk, b, h, 0);
  const T* vb = at(v, sv, b, h, 0);
  const int ntiles = (Lk + TK - 1) / TK;

  // Raw K and V rows of key tile `tile` into stage `stage`; keys past Lk
  // and columns past D are zero-filled by the copy itself. Thread tid
  // copies chunks tid, tid + THREADS, ... of each, and split() below splits
  // the same chunks, so its own wait for its copies is all the ordering the
  // raw stages need.
  auto load = [&](int tile, int stage) {
    T* dk = raw + stage * 2 * RAW;
    const int k0 = tile * TK;
#pragma unroll
    for (int it = 0; it < TK * C4 / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / C4, c = (i % C4) * 4;
      const bool ok = k0 + r < Lk && c < D;
      cp_async4(dk + r * RLD + c, ok ? kb + (k0 + r) * sk.l + c : kb, ok);
      cp_async4(dk + RAW + r * RLD + c, ok ? vb + (k0 + r) * sv.l + c : vb,
                ok);
    }
  };
  // This thread's raw chunks of stage `stage` into the hi and lo planes of
  // set `set`, each value split once for the whole block; then the fence
  // that lets wgmma, which reads shared memory through the asynchronous
  // proxy, see them.
  auto split = [&](int stage, int set) {
    const T* src = raw + stage * 2 * RAW;
    uint32_t* kp = planes + set * SET;
    uint32_t* vp = kp + 2 * KP;
#pragma unroll
    for (int it = 0; it < TK * C4 / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / C4, c = (i % C4) * 4;
      uint4 hi, lo;
      float4 x = raw4(src + r * RLD + c);
      split_tf32(x.x, hi.x, lo.x);
      split_tf32(x.y, hi.y, lo.y);
      split_tf32(x.z, hi.z, lo.z);
      split_tf32(x.w, hi.w, lo.w);
      const int ka = (c / 4) * (TK * 4 + 4) + r * 4;
      *reinterpret_cast<uint4*>(kp + ka) = hi;
      *reinterpret_cast<uint4*>(kp + KP + ka) = lo;
      x = raw4(src + RAW + r * RLD + c);
      split_tf32(x.x, hi.x, lo.x);
      split_tf32(x.y, hi.y, lo.y);
      split_tf32(x.z, hi.z, lo.z);
      split_tf32(x.w, hi.w, lo.w);
      const int s = v_slot(r);
      // Columns c .. c + 3 lie in one core matrix, rows c % 8 .. + 3.
      const int va = (s / 4) * (DT / 8) * 36 + (c / 8) * 36 + (c % 8) * 4 +
                     (s & 3);
      vp[va] = hi.x;
      vp[va + 4] = hi.y;
      vp[va + 8] = hi.z;
      vp[va + 12] = hi.w;
      vp[VP + va] = lo.x;
      vp[VP + va + 4] = lo.y;
      vp[VP + va + 8] = lo.z;
      vp[VP + va + 12] = lo.w;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };
  // Tiles 0 and 1 in flight; tile 0 split into plane set 0; tile 2 into
  // the stage tile 0 left.
  load(0, 0);
  asm volatile("cp.async.commit_group;\n" ::);
  if (ntiles > 1) load(1, 1);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  split(0, 0);
  if (ntiles > 2) load(2, 0);
  asm volatile("cp.async.commit_group;\n" ::);

  // q * scale, split once: the A fragments of each k-step (a0: row g,
  // column t; a1: row g + 8; a2, a3: column t + 4) in registers or, at
  // DT = 128, planes of the block's rows in shared memory.
  const T* qrow = at(q, sq, b, h, row0);
  uint32_t qh[Q_REGS ? KS : 1][4], ql[Q_REGS ? KS : 1][4];
  if constexpr (Q_REGS) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = g + 8 * (r & 1), col = 8 * ks + t + 4 * (r >> 1);
        const float x =
            row0 + row < Lq && col < D ? io::ld1(qrow + row * sq.l + col) : 0.f;
        split_tf32(x * scale, qh[ks][r], ql[ks][r]);
      }
  } else {
#pragma unroll
    for (int it = 0; it < 16 * C4 / 32; ++it) {
      const int i = lane + it * 32;
      const int r = i / C4, c = (i % C4) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < Lq && c < D) x = io::ld4(qrow + r * sq.l + c);
      uint4 hi, lo;
      split_tf32(x.x * scale, hi.x, lo.x);
      split_tf32(x.y * scale, hi.y, lo.y);
      split_tf32(x.z * scale, hi.z, lo.z);
      split_tf32(x.w * scale, hi.w, lo.w);
      const int qa = (c / 4) * (TQ * 4 + 4) + (warp * 16 + r) * 4;
      *reinterpret_cast<uint4*>(qplanes + qa) = hi;
      *reinterpret_cast<uint4*>(qplanes + q_plane(DT) + qa) = lo;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }

  // Accumulator element 4 j + 2 r + e: row g + 8 r of the warp's 16, column
  // (key or head-dim column) 8 j + 2 t + e.
  float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};   // rows g, g + 8
  float o[DT / 2];
#pragma unroll
  for (int i = 0; i < DT / 2; ++i) o[i] = 0.0f;

  for (int j = 0; j < ntiles; ++j) {
    // One barrier per tile: past it the planes of tile j are complete and
    // every warp is done with those of j - 1, which the split of tile j + 1
    // now overwrites while the tensor cores work on tile j.
    __syncthreads();
    const uint32_t* kp = planes + (j & 1) * SET;
    const uint32_t* vp = kp + 2 * KP;

    // S = (q scale) K^T, 64 queries x TK keys, in one chain of tensor-core
    // sums over the head dim.
    float s[TK / 2];
    wgmma_operand_fence(s);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      // A k-step is two groups of 4 columns.
      const uint64_t bh = wgmma_desc(reinterpret_cast<const float*>(
                                         kp + 2 * ks * (TK * 4 + 4)),
                                     TK * 16 + 16, 128);
      const uint64_t bl = wgmma_desc(reinterpret_cast<const float*>(
                                         kp + KP + 2 * ks * (TK * 4 + 4)),
                                     TK * 16 + 16, 128);
      if constexpr (Q_REGS) {
        wgmma_tf32<TK>(s, ql[ks], bh, ks > 0);
        wgmma_tf32<TK>(s, qh[ks], bl, 1);
        wgmma_tf32<TK>(s, qh[ks], bh, 1);
      } else {
        const uint64_t ah = wgmma_desc(reinterpret_cast<const float*>(
                                           qplanes + 2 * ks * (TQ * 4 + 4)),
                                       TQ * 16 + 16, 128);
        const uint64_t al = wgmma_desc(
            reinterpret_cast<const float*>(qplanes + q_plane(DT) +
                                           2 * ks * (TQ * 4 + 4)),
            TQ * 16 + 16, 128);
        wgmma_tf32_ss<TK>(s, al, bh, ks > 0);
        wgmma_tf32_ss<TK>(s, ah, bl, 1);
        wgmma_tf32_ss<TK>(s, ah, bh, 1);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // While the tensor cores run: split tile j + 1 into the other plane
    // set, and start the copy of tile j + 3 into the stage it leaves.
    if (j + 1 < ntiles) {
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");   // own tile j+1
      split((j + 1) & 1, (j + 1) & 1);
    }
    if (j + 3 < ntiles) load(j + 3, (j + 1) & 1);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wgmma_operand_fence(s);

    // Online softmax, exactly the running max and denominator of the plain
    // two-pass form: keys past Lk score NEG (probability exactly 0). A
    // row's four lanes share its max; each keeps its part of the sum.
    const int nk = Lk - j * TK;
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG;
#pragma unroll
      for (int nt = 0; nt < PS; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (8 * nt + 2 * t + e >= nk) s[4 * nt + 2 * r + e] = NEG;
          mx = fmaxf(mx, s[4 * nt + 2 * r + e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = expf(m[r] - m_new);   // 0 on the first tile
      float sum = 0.0f;
#pragma unroll
      for (int nt = 0; nt < PS; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[4 * nt + 2 * r + e] - m_new);
          s[4 * nt + 2 * r + e] = p;
          sum += p;
        }
      l[r] = l[r] * alpha[r] + sum;
      m[r] = m_new;
    }

    // P V: the accumulator holds keys 2t, 2t + 1 of each 8-key tile; as the
    // A operand of a k-step its slots t and t + 4 stand for those two keys,
    // the order v_slot() gave V's rows. The tile's product starts from zero
    // and joins the running output through the FADD units, which round to
    // nearest (the tensor cores truncate when they accumulate).
    uint32_t ph[PS][4], pl[PS][4];
#pragma unroll
    for (int nt = 0; nt < PS; ++nt) {
      split_tf32(s[4 * nt], ph[nt][0], pl[nt][0]);
      split_tf32(s[4 * nt + 2], ph[nt][1], pl[nt][1]);
      split_tf32(s[4 * nt + 1], ph[nt][2], pl[nt][2]);
      split_tf32(s[4 * nt + 3], ph[nt][3], pl[nt][3]);
    }
    float part[DT / 2];
    wgmma_operand_fence(part);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int nt = 0; nt < PS; ++nt) {
      // A k-step is two groups of 4 key slots, (DT / 8) * 36 words apart.
      const float* vh =
          reinterpret_cast<const float*>(vp + 2 * nt * (DT / 8) * 36);
      const uint64_t bh = wgmma_desc(vh, DT / 8 * 144, 144);
      const uint64_t bl = wgmma_desc(vh + VP, DT / 8 * 144, 144);
      wgmma_tf32<DT>(part, pl[nt], bh, nt > 0);
      wgmma_tf32<DT>(part, ph[nt], bl, 1);
      wgmma_tf32<DT>(part, ph[nt], bh, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wgmma_operand_fence(part);
#pragma unroll
    for (int i = 0; i < DT / 2; ++i)
      o[i] = o[i] * alpha[(i >> 1) & 1] + part[i];
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = row0 + g + 8 * r;
    if (row >= Lq) continue;
    const float lc = fmaxf(lr, 1e-30f), inv = 1.0f / lc;
    T* dst = at(out, so, b, h, row);
#pragma unroll
    for (int nd = 0; nd < DT / 8; ++nd) {
      const int col = 8 * nd + 2 * t;
      if (col < D)
        io::st2(dst + col, o[4 * nd + 2 * r] * inv,
                o[4 * nd + 2 * r + 1] * inv);
    }
    if (t == 0 && lse != nullptr) lse[(int64_t)bh * Lq + row] = m[r] + logf(lc);
  }
}

// The forward on (batch, head, row)-strided tensors of f32 (or, at DT <=
// 64, bf16); lse may be null.
template <int DT, typename T = float>
int launch_fwd(const named_t<T>* q, const named_t<T>* k, const named_t<T>* v,
               named_t<T>* out, float* lse, Strides sq, Strides sk, Strides sv, Strides so,
               int B, int H, int Lq, int Lk, int D, float scale,
               cudaStream_t stream) {
  static_assert(!io::is_bf16<T> || DT <= 64, "bf16 I/O at widths 32, 64");
  constexpr size_t smem = fwd_smem(DT);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<DT, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int rb = (Lq + TQ - 1) / TQ;
  flash_fwd_kernel<DT, T><<<(unsigned)((int64_t)B * H * rb), THREADS, smem,
                            stream>>>(q, k, v, out, lse, sq, sk, sv, so, H,
                                      Lq, Lk, D, rb, scale);
  return (int)cudaGetLastError();
}

// ---- backward, f32-grade, on the TF32 tensor cores (3xTF32, wgmma) ----
//
// Two kernels, as on the TPU: dQ (which also writes delta) and dK/dV. Each
// block is two warpgroups over 128 of its own rows (queries, keys), 64 to
// a warpgroup, and streams the other side's rows in tiles of BT by
// cp.async, which both warpgroups share: each thread splits the chunks it
// copied into TF32 hi and lo planes laid out as wgmma's shared-memory
// operands, once per block, and reloads them as soon as it has split them.
// The dQ kernel keeps two plane sets, so tile j + 1 is split while the
// tensor cores work on tile j (one barrier a tile); the dK/dV kernel one
// (two barriers a tile). The block's own rows are A operands: q scale in
// registers (dQ kernel), dO, k scale and v in shared planes read by
// descriptor. Per tile: S and dP (or their transposes), each one chain of
// tensor-core products over the head dim; P and dS in registers in the
// accumulator layout, which is the A layout of the products over the
// tile's rows (their B planes are the tile transposed, rows in the order
// v_slot gives them); each tile's product starts from zero and joins the
// running dQ, dK or dV through the FADD units (the tensor cores truncate
// when they accumulate). Compiled widths 32 and 64; width 128 keeps the
// FMA-unit kernels below, its accumulators and planes do not fit.

constexpr int BT = 32;   // streamed rows of a backward tile
constexpr int BWG = 2;   // warpgroups of a backward block
constexpr int BTH = 128 * BWG;   // its threads
constexpr int BR = 64 * BWG;     // its own rows, 64 to a warpgroup

// Words of one plane (hi or lo). d-plane: a tile as the B operand of a
// product over the head dim, [d / 4][row][4], groups 4 words apart beyond
// (as k_plane). t-plane: a tile transposed, the B operand of a product over
// its rows, [slot / 4][d / 8][8][4] with 4 words after each core matrix (as
// v_plane). r-plane: the block's rows as an A operand (as q_plane).
__host__ __device__ constexpr int bd_plane(int DT) { return DT / 4 * (BT * 4 + 4); }
__host__ __device__ constexpr int bt_plane(int DT) { return BT / 4 * (DT / 8) * 36; }
__host__ __device__ constexpr int br_plane(int DT) { return DT / 4 * (BR * 4 + 4); }

// A plane set (hi and lo of each plane) of the dQ kernel: K and V d-planes,
// the K t-plane; of the dK/dV kernel: Q and dO d-planes and t-planes, the
// tile's lse and delta. The dQ kernel keeps two sets, the dK/dV kernel one
// (its own rows take two r-planes, and two sets would not fit).
__host__ __device__ constexpr int dq_set(int DT) {
  return 4 * bd_plane(DT) + 2 * bt_plane(DT);
}
__host__ __device__ constexpr int dkv_set(int DT) {
  return 4 * bd_plane(DT) + 4 * bt_plane(DT) + 2 * BT;
}
// One raw stage of two tiles, the plane sets, the block's r-planes (dO;
// k scale and v) and, for dQ, the rows' delta.
constexpr size_t dq_smem(int DT) {
  return (size_t)(2 * BT * (DT + 4) + 2 * dq_set(DT) + 2 * br_plane(DT) +
                  BR) * sizeof(float);
}
constexpr size_t dkv_smem(int DT) {
  return (size_t)(2 * BT * (DT + 4) + dkv_set(DT) + 4 * br_plane(DT)) *
         sizeof(float);
}

__device__ __forceinline__ void wgmma_sync() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_begin() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Four columns c .. c + 3 of row r, split, into a d-plane over `ROWS` rows
// (hi at p, lo at p + plane).
template <int ROWS>
__device__ __forceinline__ void put_d(uint32_t* p, int plane, int r, int c,
                                      float4 x) {
  uint4 hi, lo;
  split_tf32(x.x, hi.x, lo.x);
  split_tf32(x.y, hi.y, lo.y);
  split_tf32(x.z, hi.z, lo.z);
  split_tf32(x.w, hi.w, lo.w);
  const int a = (c / 4) * (ROWS * 4 + 4) + r * 4;
  *reinterpret_cast<uint4*>(p + a) = hi;
  *reinterpret_cast<uint4*>(p + plane + a) = lo;
}

// The same into a t-plane: row r of the tile becomes slot v_slot(r).
template <int DT>
__device__ __forceinline__ void put_t(uint32_t* p, int plane, int r, int c,
                                      float4 x) {
  uint4 hi, lo;
  split_tf32(x.x, hi.x, lo.x);
  split_tf32(x.y, hi.y, lo.y);
  split_tf32(x.z, hi.z, lo.z);
  split_tf32(x.w, hi.w, lo.w);
  const int s = v_slot(r);
  // Columns c .. c + 3 lie in one core matrix, rows c % 8 .. + 3.
  const int a = (s / 4) * (DT / 8) * 36 + (c / 8) * 36 + (c % 8) * 4 + (s & 3);
  p[a] = hi.x;
  p[a + 4] = hi.y;
  p[a + 8] = hi.z;
  p[a + 12] = hi.w;
  p[plane + a] = lo.x;
  p[plane + a + 4] = lo.y;
  p[plane + a + 8] = lo.z;
  p[plane + a + 12] = lo.w;
}

// Raw rows [r0, r0 + BT) of two (batch, head) slices into the raw stage
// (two tiles of BT x (DT + 4)); rows past n and columns past D are
// zero-filled. Thread tid copies chunks tid, tid + BTH, ... of each;
// split_pair() splits the same ones, so the thread's own cp.async wait
// orders them. One commit group.
template <int DT, typename T>
__device__ __forceinline__ void load_pair(T* raw, const T* a, long long sa,
                                          const T* b, long long sb, int r0,
                                          int n, int D) {
  constexpr int RLD = DT + 4, C4 = DT / 4;
#pragma unroll
  for (int it = 0; it < BT * C4 / BTH; ++it) {
    const int i = threadIdx.x + it * BTH;
    const int r = i / C4, c = (i % C4) * 4;
    const bool ok = r0 + r < n && c < D;
    cp_async4(raw + r * RLD + c, ok ? a + (r0 + r) * sa + c : a, ok);
    cp_async4(raw + BT * RLD + r * RLD + c, ok ? b + (r0 + r) * sb + c : b,
              ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// This thread's raw chunks of the two tiles into their planes: the first
// into a d-plane and a t-plane, the second into a d-plane and, if bt is
// not null, a t-plane.
template <int DT, typename T>
__device__ __forceinline__ void split_pair(const T* raw, uint32_t* ad,
                                           uint32_t* at_, uint32_t* bd,
                                           uint32_t* bt) {
  constexpr int RLD = DT + 4, C4 = DT / 4;
  constexpr int DP = bd_plane(DT), TP = bt_plane(DT);
#pragma unroll
  for (int it = 0; it < BT * C4 / BTH; ++it) {
    const int i = threadIdx.x + it * BTH;
    const int r = i / C4, c = (i % C4) * 4;
    float4 x = raw4(raw + r * RLD + c);
    put_d<BT>(ad, DP, r, c, x);
    put_t<DT>(at_, TP, r, c, x);
    x = raw4(raw + BT * RLD + r * RLD + c);
    put_d<BT>(bd, DP, r, c, x);
    if (bt != nullptr) put_t<DT>(bt, TP, r, c, x);
  }
}

// Rows [r0, r0 + BR) of x times f into the r-plane xr (hi, lo), zeros past
// n and D; with z (rows of x's shape), also each row's sum of x z into
// sums[row].
template <int DT, typename T>
__device__ __forceinline__ void put_rows(const T* x, long long sx, float f,
                                         const T* z, long long sz, int r0,
                                         int n, int D, uint32_t* xr,
                                         float* sums) {
  constexpr int C4 = DT / 4;
#pragma unroll
  for (int it = 0; it < BR * C4 / BTH; ++it) {
    const int i = threadIdx.x + it * BTH;
    const int r = i / C4, c = (i % C4) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (r0 + r < n && c < D) {
      a = io::ld4(x + (r0 + r) * sx + c);
      if (z != nullptr) b = io::ld4(z + (r0 + r) * sz + c);
    }
    put_d<BR>(xr, br_plane(DT), r, c,
              make_float4(a.x * f, a.y * f, a.z * f, a.w * f));
    if (z != nullptr) {
      // A row's C4 chunks are C4 neighbouring lanes.
      float part = a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
#pragma unroll
      for (int off = C4 / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (c == 0) sums[r] = part;
    }
  }
}

// acc (64 x BT) = rows (r-planes ra, from this warpgroup's first row) .
// tile^T (d-planes td), one chain of 3xTF32 products over the head dim;
// issued, not waited for.
template <int DT>
__device__ __forceinline__ void rows_by_tile(float (&acc)[BT / 2],
                                             const uint32_t* ra,
                                             const uint32_t* td) {
  constexpr int RP = br_plane(DT), DP = bd_plane(DT);
#pragma unroll
  for (int ks = 0; ks < DT / 8; ++ks) {
    // A k-step is two groups of 4 columns.
    const uint32_t* a = ra + 2 * ks * (BR * 4 + 4);   // 4 words a row
    const uint32_t* b = td + 2 * ks * (BT * 4 + 4);
    const uint64_t ah = wgmma_desc(reinterpret_cast<const float*>(a),
                                   BR * 16 + 16, 128);
    const uint64_t al = wgmma_desc(reinterpret_cast<const float*>(a + RP),
                                   BR * 16 + 16, 128);
    const uint64_t bh = wgmma_desc(reinterpret_cast<const float*>(b),
                                   BT * 16 + 16, 128);
    const uint64_t bl = wgmma_desc(reinterpret_cast<const float*>(b + DP),
                                   BT * 16 + 16, 128);
    wgmma_tf32_ss<BT>(acc, al, bh, ks > 0);
    wgmma_tf32_ss<BT>(acc, ah, bl, 1);
    wgmma_tf32_ss<BT>(acc, ah, bh, 1);
  }
}

// part (64 x DT) = x (64 x BT, the accumulator layout of rows_by_tile) .
// tile (t-planes tt), a product over the tile's rows from zero; issued
// (after the fences its register operands need), not waited for.
template <int DT>
__device__ __forceinline__ void acc_by_tile(float (&part)[DT / 2],
                                            const float (&x)[BT / 2],
                                            const uint32_t* tt) {
  constexpr int TP = bt_plane(DT);
  // The accumulator holds columns 2t, 2t + 1 of each 8-column tile; as the
  // A operand of a k-step its slots t and t + 4 stand for those two, the
  // order v_slot() gave the t-planes' rows.
  uint32_t xh[BT / 8][4], xl[BT / 8][4];
#pragma unroll
  for (int nt = 0; nt < BT / 8; ++nt) {
    split_tf32(x[4 * nt], xh[nt][0], xl[nt][0]);
    split_tf32(x[4 * nt + 2], xh[nt][1], xl[nt][1]);
    split_tf32(x[4 * nt + 1], xh[nt][2], xl[nt][2]);
    split_tf32(x[4 * nt + 3], xh[nt][3], xl[nt][3]);
  }
  wgmma_operand_fence(part);
  wgmma_begin();
#pragma unroll
  for (int nt = 0; nt < BT / 8; ++nt) {
    // A k-step is two groups of 4 slots, (DT / 8) * 36 words apart.
    const float* b = reinterpret_cast<const float*>(tt + 2 * nt * (DT / 8) * 36);
    const uint64_t bh = wgmma_desc(b, DT / 8 * 144, 144);
    const uint64_t bl = wgmma_desc(b + TP, DT / 8 * 144, 144);
    wgmma_tf32<DT>(part, xl[nt], bh, nt > 0);
    wgmma_tf32<DT>(part, xh[nt], bl, 1);
    wgmma_tf32<DT>(part, xh[nt], bh, 1);
  }
}

// dQ = dS K scale and delta = rowsum(dO O), one block per (batch*head, BR
// queries), key tiles of BT.
template <int DT, typename T = float>
__global__ void __launch_bounds__(BTH)
flash_bwd_dq_tc_kernel(const T* __restrict__ q,
                       const T* __restrict__ k,
                       const T* __restrict__ v,
                       const T* __restrict__ o,
                       const T* __restrict__ dout,
                       const float* __restrict__ lse, T* __restrict__ dq,
                       float* __restrict__ delta, Strides sq, Strides sk,
                       Strides sv, Strides so, Strides sdo, Strides sdq, int H,
                       int Lq, int Lk, int D, int row_blocks, float scale) {
  constexpr int KS = DT / 8;
  constexpr int DP = bd_plane(DT), TP = bt_plane(DT), SET = dq_set(DT);
  extern __shared__ __align__(16) float smem[];
  T* raw = reinterpret_cast<T*>(smem);   // [K, V][BT][DT + 4]
  uint32_t* sets = reinterpret_cast<uint32_t*>(smem + 2 * BT * (DT + 4));
  uint32_t* dor = sets + 2 * SET;        // dO of the block's rows
  float* delta_s = reinterpret_cast<float*>(dor + 2 * br_plane(DT));
  // Plane set s: K d-plane, V d-plane, K t-plane (hi, lo each).
  auto kd = [&](int s) { return sets + s * SET; };
  auto vd = [&](int s) { return sets + s * SET + 2 * DP; };
  auto kt = [&](int s) { return sets + s * SET + 4 * DP; };

  // Warp w of the block holds rows 16 w .. + 15 of every accumulator of
  // its warpgroup w / 4.
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / row_blocks;
  const int b = bh / H, h = bh % H;
  const int row0 = (blockIdx.x % row_blocks) * BR;
  const uint32_t* dor_wg = dor + (warp / 4) * 64 * 4;   // its rows' planes
  const T* kb = at(k, sk, b, h, 0);
  const T* vb = at(v, sv, b, h, 0);
  const int ntiles = (Lk + BT - 1) / BT;

  // Tile 0 into plane set 0, tile 1 in flight. delta = rowsum(dO O) of the
  // widened values.
  load_pair<DT, T>(raw, kb, sk.l, vb, sv.l, 0, Lk, D);
  put_rows<DT, T>(at(dout, sdo, b, h, 0), sdo.l, 1.0f, at(o, so, b, h, 0),
                  so.l, row0, Lq, D, dor, delta_s);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  split_pair<DT, T>(raw, kd(0), kt(0), vd(0), nullptr);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (ntiles > 1) load_pair<DT, T>(raw, kb, sk.l, vb, sv.l, BT, Lk, D);

  // q scale, split once: the A fragments of each k-step (a0: row g, column
  // t; a1: row g + 8; a2, a3: column t + 4).
  const int wrow0 = row0 + warp * 16;
  const T* qrow = at(q, sq, b, h, wrow0);
  uint32_t qh[KS][4], ql[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = g + 8 * (r & 1), col = 8 * ks + t + 4 * (r >> 1);
      const float x =
          wrow0 + row < Lq && col < D ? io::ld1(qrow + row * sq.l + col) : 0.f;
      split_tf32(x * scale, qh[ks][r], ql[ks][r]);
    }
  __syncthreads();   // delta_s, dO's planes and plane set 0 complete
  // This thread's rows g, g + 8 of its warp's 16: lse (+inf past Lq, so P
  // = 0 there) and delta.
  float ls[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = warp * 16 + g + 8 * r, row = row0 + i;
    ls[r] = row < Lq ? lse[(int64_t)bh * Lq + row] : INFINITY;
    dl[r] = delta_s[i];
    if (t == 0 && row < Lq) delta[(int64_t)bh * Lq + row] = dl[r];
  }

  float acc[DT / 2];
#pragma unroll
  for (int i = 0; i < DT / 2; ++i) acc[i] = 0.0f;
  for (int j = 0; j < ntiles; ++j) {
    // One barrier per tile: past it plane set j & 1 holds tile j and every
    // warp is done with tile j - 1's set, which the split of tile j + 1 now
    // overwrites while the tensor cores work on tile j.
    __syncthreads();
    const int cur = j & 1;
    // S = (q scale) K^T and dP = dO V^T, 64 queries x BT keys.
    float s[BT / 2], dp[BT / 2];
    wgmma_operand_fence(s);
    wgmma_operand_fence(dp);
    wgmma_begin();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint32_t* p = kd(cur) + 2 * ks * (BT * 4 + 4);
      const uint64_t bh_ = wgmma_desc(reinterpret_cast<const float*>(p),
                                      BT * 16 + 16, 128);
      const uint64_t bl_ = wgmma_desc(reinterpret_cast<const float*>(p + DP),
                                      BT * 16 + 16, 128);
      wgmma_tf32<BT>(s, ql[ks], bh_, ks > 0);
      wgmma_tf32<BT>(s, qh[ks], bl_, 1);
      wgmma_tf32<BT>(s, qh[ks], bh_, 1);
    }
    rows_by_tile<DT>(dp, dor_wg, vd(cur));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (j + 1 < ntiles) {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");   // own tile j+1
      split_pair<DT, T>(raw, kd(cur ^ 1), kt(cur ^ 1), vd(cur ^ 1),
                        nullptr);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (j + 2 < ntiles)
        load_pair<DT, T>(raw, kb, sk.l, vb, sv.l, (j + 2) * BT, Lk, D);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wgmma_operand_fence(s);
    wgmma_operand_fence(dp);
    // dS = P (dP - delta), P = exp(S - lse); keys past Lk get P = 0.
    // Element 4 nt + 2 r + e: row g + 8 r, key 8 nt + 2 t + e.
    const int nk = Lk - j * BT;
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * nt + 2 * r + e;
          const float p = 8 * nt + 2 * t + e < nk ? expf(s[x] - ls[r]) : 0.0f;
          s[x] = p * (dp[x] - dl[r]);
        }
    // dQ += dS K over the tile's keys.
    float part[DT / 2];
    acc_by_tile<DT>(part, s, kt(cur));
    wgmma_sync();
    wgmma_operand_fence(part);
#pragma unroll
    for (int i = 0; i < DT / 2; ++i) acc[i] += part[i];
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow0 + g + 8 * r;
    if (row >= Lq) continue;
    T* dst = at(dq, sdq, b, h, row);
#pragma unroll
    for (int nd = 0; nd < DT / 8; ++nd) {
      const int col = 8 * nd + 2 * t;
      if (col < D)
        io::st2(dst + col, acc[4 * nd + 2 * r] * scale,
                acc[4 * nd + 2 * r + 1] * scale);
    }
  }
}

// Queries of the TPU kernel's block, over which its backward sums dK and dV
// before it rounds them to a bf16 output (its min(128, round_up(Lq, 8))).
constexpr int BLOCK_Q = 128;

// dK = dS^T Q scale and dV = P^T dO, one block per (batch*head, BR keys),
// query tiles of BT; no atomics. One plane set: the next tile is split
// after the tensor cores are done with this one (two barriers a tile), its
// copy in flight meanwhile. With bf16 I/O the f32 sums of each BLOCK_Q
// queries (BLOCK_Q / BT tiles counted from query 0, the last block cut at
// Lq) are rounded into running bf16 sums held in registers, a bf16 pair a
// word: the first block's sum as it is, each later one added to the
// running sum and rounded again.
template <int DT, typename T = float>
__global__ void __launch_bounds__(BTH)
flash_bwd_dkv_tc_kernel(const T* __restrict__ q,
                        const T* __restrict__ k,
                        const T* __restrict__ v,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        T* __restrict__ dk, T* __restrict__ dv,
                        Strides sq, Strides sk, Strides sv, Strides sdo,
                        Strides sdk, Strides sdv, int H, int Lq, int Lk, int D,
                        int row_blocks, float scale) {
  constexpr int DP = bd_plane(DT), TP = bt_plane(DT), RP = br_plane(DT);
  constexpr bool BLOCKED = io::is_bf16<T>;
  extern __shared__ __align__(16) float smem[];
  T* raw = reinterpret_cast<T*>(smem);   // [Q, dO][BT][DT + 4]
  uint32_t* qd = reinterpret_cast<uint32_t*>(smem + 2 * BT * (DT + 4));
  uint32_t* dod = qd + 2 * DP;           // Q, dO d-planes, t-planes (hi, lo)
  uint32_t* qt = dod + 2 * DP;
  uint32_t* dot = qt + 2 * TP;
  float* stats = reinterpret_cast<float*>(dot + 2 * TP);   // lse, delta
  uint32_t* kr = reinterpret_cast<uint32_t*>(stats + 2 * BT);   // k scale
  uint32_t* vr = kr + 2 * RP;            // v

  // Warp w of the block holds rows (keys) 16 w .. + 15 of every
  // accumulator of its warpgroup w / 4.
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / row_blocks;
  const int b = bh / H, h = bh % H;
  const int key0 = (blockIdx.x % row_blocks) * BR;
  const uint32_t* kr_wg = kr + (warp / 4) * 64 * 4;
  const uint32_t* vr_wg = vr + (warp / 4) * 64 * 4;
  const T* qb = at(q, sq, b, h, 0);
  const T* dob = at(dout, sdo, b, h, 0);
  const float* lse_b = lse + (int64_t)bh * Lq;
  const float* delta_b = delta + (int64_t)bh * Lq;
  const int ntiles = (Lq + BT - 1) / BT;

  // Tile j from the raw stage into the planes, with its lse and delta (a
  // query past Lq gets lse = +inf, so its probabilities are exactly 0);
  // then the copy of tile j + 1 into the raw stage.
  auto next_tile = [&](int j) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");   // own tile j
    split_pair<DT, T>(raw, qd, qt, dod, dot);
    if (tid < BT) {
      const int qq = j * BT + tid;
      stats[tid] = qq < Lq ? lse_b[qq] : INFINITY;
      stats[BT + tid] = qq < Lq ? delta_b[qq] : 0.0f;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (j + 1 < ntiles)
      load_pair<DT, T>(raw, qb, sq.l, dob, sdo.l, (j + 1) * BT, Lq, D);
  };
  load_pair<DT, T>(raw, qb, sq.l, dob, sdo.l, 0, Lq, D);
  put_rows<DT, T>(at(k, sk, b, h, 0), sk.l, scale, nullptr, 0, key0, Lk, D,
                  kr, nullptr);
  put_rows<DT, T>(at(v, sv, b, h, 0), sv.l, 1.0f, nullptr, 0, key0, Lk, D,
                  vr, nullptr);
  next_tile(0);

  float dka[DT / 2], dva[DT / 2];
#pragma unroll
  for (int i = 0; i < DT / 2; ++i) dka[i] = dva[i] = 0.0f;
  // Running bf16 sums (bf16 I/O): word i holds the pair of accumulator
  // elements 2i, 2i + 1 (one row, two neighbouring columns).
  uint32_t dkr[DT / 4], dvr[DT / 4];
  // The block's f32 sums into the running ones; the sums restart at zero.
  auto flush = [&](bool first) {
#pragma unroll
    for (int i = 0; i < DT / 4; ++i) {
      const __nv_bfloat162 pk =
          __floats2bfloat162_rn(dka[2 * i] * scale, dka[2 * i + 1] * scale);
      const __nv_bfloat162 pv =
          __floats2bfloat162_rn(dva[2 * i], dva[2 * i + 1]);
      uint32_t wk = *reinterpret_cast<const uint32_t*>(&pk);
      uint32_t wv = *reinterpret_cast<const uint32_t*>(&pv);
      if (!first) {
        const float2 ak = io::widen2(dkr[i]), bk = io::widen2(wk);
        const float2 av = io::widen2(dvr[i]), bv = io::widen2(wv);
        const __nv_bfloat162 sk2 =
            __floats2bfloat162_rn(ak.x + bk.x, ak.y + bk.y);
        const __nv_bfloat162 sv2 =
            __floats2bfloat162_rn(av.x + bv.x, av.y + bv.y);
        wk = *reinterpret_cast<const uint32_t*>(&sk2);
        wv = *reinterpret_cast<const uint32_t*>(&sv2);
      }
      dkr[i] = wk;
      dvr[i] = wv;
      dka[2 * i] = dka[2 * i + 1] = dva[2 * i] = dva[2 * i + 1] = 0.0f;
    }
  };
  for (int j = 0; j < ntiles; ++j) {
    if (j > 0) {
      __syncthreads();   // every warp is done with tile j - 1's planes
      next_tile(j);
    }
    __syncthreads();     // the planes hold tile j
    // S^T = (k scale) Q^T and dP^T = V dO^T, 64 keys x BT queries.
    float st[BT / 2], dpt[BT / 2];
    wgmma_operand_fence(st);
    wgmma_operand_fence(dpt);
    wgmma_begin();
    rows_by_tile<DT>(st, kr_wg, qd);
    rows_by_tile<DT>(dpt, vr_wg, dod);
    wgmma_sync();
    wgmma_operand_fence(st);
    wgmma_operand_fence(dpt);
    // P^T = exp(S^T - lse), dS^T = P^T (dP^T - delta); element 4 nt + 2 r
    // + e: key g + 8 r, query 8 nt + 2 t + e. Keys past Lk compute on zero
    // rows and store nothing.
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * nt + 2 * t + e;
        const float ls = stats[col], dl = stats[BT + col];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int x = 4 * nt + 2 * r + e;
          st[x] = expf(st[x] - ls);
          dpt[x] = st[x] * (dpt[x] - dl);
        }
      }
    // dV += P^T dO, dK += dS^T Q over the tile's queries.
    float part[DT / 2];
    acc_by_tile<DT>(part, st, dot);
    wgmma_sync();
    wgmma_operand_fence(part);
#pragma unroll
    for (int i = 0; i < DT / 2; ++i) dva[i] += part[i];
    acc_by_tile<DT>(part, dpt, qt);
    wgmma_sync();
    wgmma_operand_fence(part);
#pragma unroll
    for (int i = 0; i < DT / 2; ++i) dka[i] += part[i];
    if constexpr (BLOCKED) {
      if ((j + 1) % (BLOCK_Q / BT) == 0 || j + 1 == ntiles)
        flush(j < BLOCK_Q / BT);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + warp * 16 + g + 8 * r;
    if (key >= Lk) continue;
    T* ddk = at(dk, sdk, b, h, key);
    T* ddv = at(dv, sdv, b, h, key);
#pragma unroll
    for (int nd = 0; nd < DT / 8; ++nd) {
      const int col = 8 * nd + 2 * t;
      if (col < D) {
        if constexpr (BLOCKED) {
          *reinterpret_cast<uint32_t*>(ddk + col) = dkr[2 * nd + r];
          *reinterpret_cast<uint32_t*>(ddv + col) = dvr[2 * nd + r];
        } else {
          io::st2(ddk + col, dka[4 * nd + 2 * r] * scale,
                  dka[4 * nd + 2 * r + 1] * scale);
          io::st2(ddv + col, dva[4 * nd + 2 * r], dva[4 * nd + 2 * r + 1]);
        }
      }
    }
  }
}

// ---- backward on the f32 FMA units (compiled width 128) ----

template <int DT>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ dq,
                    float* __restrict__ delta, Strides sq, Strides sk,
                    Strides sv, Strides so, Strides sdo, Strides sdq, int H,
                    int Lq, int Lk, int D, int row_blocks, float scale) {
  constexpr int LPR = DT / W;
  constexpr int ROWS = THREADS / LPR;
  __shared__ __align__(16) float ks[KT * DT];
  __shared__ __align__(16) float vs[KT * DT];

  const int bh = blockIdx.x / row_blocks;
  const int b = bh / H, h = bh % H;
  const int row = (blockIdx.x % row_blocks) * ROWS + threadIdx.x / LPR;
  const int seg = threadIdx.x % LPR;
  const bool has_row = row < Lq;

  float qr[W], dor[W], acc[W];
  load_row<LPR>(at(q, sq, b, h, row), has_row, seg, D, qr);
  load_row<LPR>(at(dout, sdo, b, h, row), has_row, seg, D, dor);
  float dl = 0.0f;
  {
    float orow[W];
    load_row<LPR>(at(o, so, b, h, row), has_row, seg, D, orow);
#pragma unroll
    for (int d = 0; d < W; ++d) {
      dl = fmaf(dor[d], orow[d], dl);
      acc[d] = 0.0f;
    }
    dl = row_sum<LPR>(dl);
  }
  const float ls = has_row ? lse[(int64_t)bh * Lq + row] : 0.0f;
  if (has_row && seg == 0) delta[(int64_t)bh * Lq + row] = dl;
  const float* kb = at(k, sk, b, h, 0);
  const float* vb = at(v, sv, b, h, 0);

  for (int k0 = 0; k0 < Lk; k0 += KT) {
    const int nk = min(KT, Lk - k0);
    __syncthreads();
    load_tile<DT>(kb + k0 * sk.l, sk.l, nk, D, ks);
    load_tile<DT>(vb + k0 * sv.l, sv.l, nk, D, vs);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      const float s = dot_row<LPR>(qr, ks + j * DT, seg) * scale;
      const float p = expf(s - ls);
      const float dp = dot_row<LPR>(dor, vs + j * DT, seg);
      axpy_row<LPR>(p * (dp - dl), ks + j * DT, seg, acc);
    }
  }
  if (has_row) store_row<LPR>(at(dq, sdq, b, h, row), seg, D, acc, scale);
}

template <int DT>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, Strides sq, Strides sk,
                     Strides sv, Strides sdo, Strides sdk, Strides sdv, int H,
                     int Lq, int Lk, int D, int row_blocks, float scale) {
  constexpr int LPR = DT / W;
  constexpr int ROWS = THREADS / LPR;
  __shared__ __align__(16) float qs[KT * DT];
  __shared__ __align__(16) float dos[KT * DT];
  __shared__ float lse_s[KT];
  __shared__ float delta_s[KT];

  const int bh = blockIdx.x / row_blocks;
  const int b = bh / H, h = bh % H;
  const int key = (blockIdx.x % row_blocks) * ROWS + threadIdx.x / LPR;
  const int seg = threadIdx.x % LPR;
  const bool has_key = key < Lk;

  float kr[W], vr[W], acc_dk[W], acc_dv[W];
  load_row<LPR>(at(k, sk, b, h, key), has_key, seg, D, kr);
  load_row<LPR>(at(v, sv, b, h, key), has_key, seg, D, vr);
#pragma unroll
  for (int d = 0; d < W; ++d) {
    acc_dk[d] = 0.0f;
    acc_dv[d] = 0.0f;
  }
  const float* qb = at(q, sq, b, h, 0);
  const float* dob = at(dout, sdo, b, h, 0);
  const float* lse_b = lse + (int64_t)bh * Lq;
  const float* delta_b = delta + (int64_t)bh * Lq;

  for (int q0 = 0; q0 < Lq; q0 += KT) {
    const int nq = min(KT, Lq - q0);
    __syncthreads();
    load_tile<DT>(qb + q0 * sq.l, sq.l, nq, D, qs);
    load_tile<DT>(dob + q0 * sdo.l, sdo.l, nq, D, dos);
    if (threadIdx.x < KT) {
      const bool ok = threadIdx.x < nq;
      lse_s[threadIdx.x] = ok ? lse_b[q0 + threadIdx.x] : 0.0f;
      delta_s[threadIdx.x] = ok ? delta_b[q0 + threadIdx.x] : 0.0f;
    }
    __syncthreads();
    // Lanes past Lk compute on zero keys and store nothing.
#pragma unroll 2
    for (int i = 0; i < nq; ++i) {
      const float s = dot_row<LPR>(kr, qs + i * DT, seg) * scale;
      const float p = expf(s - lse_s[i]);
      const float dp = dot_row<LPR>(vr, dos + i * DT, seg);
      axpy_row<LPR>(p, dos + i * DT, seg, acc_dv);
      axpy_row<LPR>(p * (dp - delta_s[i]), qs + i * DT, seg, acc_dk);
    }
  }
  if (has_key) {
    store_row<LPR>(at(dk, sdk, b, h, key), seg, D, acc_dk, scale);
    store_row<LPR>(at(dv, sdv, b, h, key), seg, D, acc_dv, 1.0f);
  }
}

// The backward kernels on (batch, head, row)-strided tensors: on the tensor
// cores at compiled widths 32 and 64, on the FMA units at 128.
template <int DT, typename T = float>
int launch_bwd_dq(const named_t<T>* q, const named_t<T>* k,
                  const named_t<T>* v, const named_t<T>* o,
                  const named_t<T>* dout, const float* lse, named_t<T>* dq,
                  float* delta,
                  Strides sq, Strides sk, Strides sv,
                  Strides so, Strides sdo, Strides sdq, int B, int H, int Lq,
                  int Lk, int D, float scale, cudaStream_t stream) {
  static_assert(!io::is_bf16<T> || DT <= 64, "bf16 I/O at widths 32, 64");
  const int rows = DT <= 64 ? BR : THREADS / (DT / W);
  const int rb = (Lq + rows - 1) / rows;
  const int64_t blocks = (int64_t)B * H * rb;
  if (blocks >= 2147483647LL) return (int)cudaErrorInvalidValue;
  if constexpr (DT <= 64) {
    constexpr size_t smem = dq_smem(DT);
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_tc_kernel<DT, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    flash_bwd_dq_tc_kernel<DT, T><<<(unsigned)blocks, BTH, smem, stream>>>(
        q, k, v, o, dout, lse, dq, delta, sq, sk, sv, so, sdo, sdq, H, Lq, Lk,
        D, rb, scale);
  } else {
    flash_bwd_dq_kernel<DT><<<(unsigned)blocks, THREADS, 0, stream>>>(
        q, k, v, o, dout, lse, dq, delta, sq, sk, sv, so, sdo, sdq, H, Lq, Lk,
        D, rb, scale);
  }
  return (int)cudaGetLastError();
}

template <int DT, typename T = float>
int launch_bwd_dkv(const named_t<T>* q, const named_t<T>* k,
                   const named_t<T>* v, const named_t<T>* dout,
                   const float* lse, const float* delta, named_t<T>* dk,
                   named_t<T>* dv,
                   Strides sq, Strides sk, Strides sv,
                   Strides sdo, Strides sdk, Strides sdv, int B, int H, int Lq,
                   int Lk, int D, float scale, cudaStream_t stream) {
  static_assert(!io::is_bf16<T> || DT <= 64, "bf16 I/O at widths 32, 64");
  const int rows = DT <= 64 ? BR : THREADS / (DT / W);
  const int rb = (Lk + rows - 1) / rows;
  const int64_t blocks = (int64_t)B * H * rb;
  if (blocks >= 2147483647LL) return (int)cudaErrorInvalidValue;
  if constexpr (DT <= 64) {
    constexpr size_t smem = dkv_smem(DT);
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkv_tc_kernel<DT, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    flash_bwd_dkv_tc_kernel<DT, T><<<(unsigned)blocks, BTH, smem, stream>>>(
        q, k, v, dout, lse, delta, dk, dv, sq, sk, sv, sdo, sdk, sdv, H, Lq,
        Lk, D, rb, scale);
  } else {
    flash_bwd_dkv_kernel<DT><<<(unsigned)blocks, THREADS, 0, stream>>>(
        q, k, v, dout, lse, delta, dk, dv, sq, sk, sv, sdo, sdk, sdv, H, Lq,
        Lk, D, rb, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace flash
