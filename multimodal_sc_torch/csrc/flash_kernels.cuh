// Device code of the f32-grade softmax-attention kernels: forward (3xTF32
// on the tensor cores), dQ and dK/dV (f32 FMA units) on any (batch, head,
// row)-strided layout. flash_attention.cu documents the design and
// launches all three on (B, H, L, D) tensors; attention_packed.cu launches
// them as its f32 mode on the packed (B, L, H*d) layout, which is the same
// thing under other strides.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

__device__ __forceinline__ const float* at(const float* p, Strides s, int b,
                                           int h, int64_t row) {
  return p + b * s.b + h * s.h + row * s.l;
}

__device__ __forceinline__ float* at(float* p, Strides s, int b, int h,
                                     int64_t row) {
  return p + b * s.b + h * s.h + row * s.l;
}

// Rows [0, n_valid) x columns [0, D) of src (row stride `stride` floats)
// into a shared KT x DT tile; everything else reads as zeros.
template <int DT>
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          int64_t stride, int n_valid, int D,
                                          float* dst) {
  constexpr int C = DT / 4;
  for (int i = threadIdx.x; i < KT * C; i += THREADS) {
    const int r = i / C, c = i % C;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_valid && c * 4 < D)
      v = __ldg(reinterpret_cast<const float4*>(src + r * stride) + c);
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
    if (valid && c * 4 < D)
      v = __ldg(reinterpret_cast<const float4*>(src) + c);
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
      reinterpret_cast<float4*>(dst)[c] =
          make_float4(src[4 * i] * f, src[4 * i + 1] * f, src[4 * i + 2] * f,
                      src[4 * i + 3] * f);
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
template <int DT>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
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
  float* raw = smem;                    // [stage][K, V][TK][RLD]
  uint32_t* planes = reinterpret_cast<uint32_t*>(smem + 4 * RAW);
  uint32_t* qplanes = planes + 2 * SET; // [hi, lo], DT = 128 only

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / row_blocks;
  const int b = bh / H, h = bh % H;
  const int row0 = (blockIdx.x % row_blocks) * TQ + warp * 16;
  const float* kb = at(k, sk, b, h, 0);
  const float* vb = at(v, sv, b, h, 0);
  const int ntiles = (Lk + TK - 1) / TK;

  // Raw K and V rows of key tile `tile` into stage `stage`; keys past Lk
  // and columns past D are zero-filled by the copy itself. Thread tid
  // copies chunks tid, tid + THREADS, ... of each, and split() below splits
  // the same chunks, so its own wait for its copies is all the ordering the
  // raw stages need.
  auto load = [&](int tile, int stage) {
    float* dk = raw + stage * 2 * RAW;
    const int k0 = tile * TK;
#pragma unroll
    for (int it = 0; it < TK * C4 / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / C4, c = (i % C4) * 4;
      const bool ok = k0 + r < Lk && c < D;
      cp_async16(dk + r * RLD + c, ok ? kb + (k0 + r) * sk.l + c : kb, ok);
      cp_async16(dk + RAW + r * RLD + c, ok ? vb + (k0 + r) * sv.l + c : vb,
                 ok);
    }
  };
  // This thread's raw chunks of stage `stage` into the hi and lo planes of
  // set `set`, each value split once for the whole block; then the fence
  // that lets wgmma, which reads shared memory through the asynchronous
  // proxy, see them.
  auto split = [&](int stage, int set) {
    const float* src = raw + stage * 2 * RAW;
    uint32_t* kp = planes + set * SET;
    uint32_t* vp = kp + 2 * KP;
#pragma unroll
    for (int it = 0; it < TK * C4 / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / C4, c = (i % C4) * 4;
      uint4 hi, lo;
      float4 x = *reinterpret_cast<const float4*>(src + r * RLD + c);
      split_tf32(x.x, hi.x, lo.x);
      split_tf32(x.y, hi.y, lo.y);
      split_tf32(x.z, hi.z, lo.z);
      split_tf32(x.w, hi.w, lo.w);
      const int ka = (c / 4) * (TK * 4 + 4) + r * 4;
      *reinterpret_cast<uint4*>(kp + ka) = hi;
      *reinterpret_cast<uint4*>(kp + KP + ka) = lo;
      x = *reinterpret_cast<const float4*>(src + RAW + r * RLD + c);
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
  const float* qrow = at(q, sq, b, h, row0);
  uint32_t qh[Q_REGS ? KS : 1][4], ql[Q_REGS ? KS : 1][4];
  if constexpr (Q_REGS) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = g + 8 * (r & 1), col = 8 * ks + t + 4 * (r >> 1);
        const float x =
            row0 + row < Lq && col < D ? __ldg(qrow + row * sq.l + col) : 0.f;
        split_tf32(x * scale, qh[ks][r], ql[ks][r]);
      }
  } else {
#pragma unroll
    for (int it = 0; it < 16 * C4 / 32; ++it) {
      const int i = lane + it * 32;
      const int r = i / C4, c = (i % C4) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < Lq && c < D)
        x = __ldg(reinterpret_cast<const float4*>(qrow + r * sq.l + c));
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
    float* dst = at(out, so, b, h, row);
#pragma unroll
    for (int nd = 0; nd < DT / 8; ++nd) {
      const int col = 8 * nd + 2 * t;
      if (col < D)
        *reinterpret_cast<float2*>(dst + col) =
            make_float2(o[4 * nd + 2 * r] * inv, o[4 * nd + 2 * r + 1] * inv);
    }
    if (t == 0 && lse != nullptr) lse[(int64_t)bh * Lq + row] = m[r] + logf(lc);
  }
}

// The forward on (batch, head, row)-strided tensors; lse may be null.
template <int DT>
int launch_fwd(const float* q, const float* k, const float* v, float* out,
               float* lse, Strides sq, Strides sk, Strides sv, Strides so,
               int B, int H, int Lq, int Lk, int D, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = fwd_smem(DT);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int rb = (Lq + TQ - 1) / TQ;
  flash_fwd_kernel<DT><<<(unsigned)((int64_t)B * H * rb), THREADS, smem,
                         stream>>>(q, k, v, out, lse, sq, sk, sv, so, H, Lq,
                                   Lk, D, rb, scale);
  return (int)cudaGetLastError();
}

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
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
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

}  // namespace flash
