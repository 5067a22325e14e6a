// Device code of the flash attention kernels on bf16 tensors (train.bf16):
// forward, dQ and dK/dV on bf16 wgmma, counterparts of
// multimodal_sc_tpu/kernels/attention.py's _flash_attention_fwd_impl and
// _flash_attention_bwd_impl handed bf16 arrays. flash_attention.cu
// documents the design and launches them; flash_kernels.cuh holds the f32
// kernels.
//
// What they compute is the f32 kernels' function on bf16 values: every
// value widened to f32; the forward's q scale in f32, the backward's scale
// applied after q K^T; the online softmax, P and dS in f32; every sum in
// f32; the output, dQ, dK and dV rounded to bf16 once, at the store; lse
// and delta f32. Each product runs on the bf16 tensor cores (m64nNk16, f32
// sums) as exactly as its operands allow: one pass where both operands are
// bf16 values (q K^T, dO V^T, and (q scale) K^T where the scale is a power
// of two), three where one operand is f32 (P, dS, q scale), that operand
// split into bf16 hi, mid and lo (bw::split3), the small pieces first.
// The products of bf16 values are exact in f32, so every product is exact
// up to the tensor cores' f32 sums.

#pragma once

#include <math.h>

#include "bf16_wgmma.cuh"
#include "elem_io.cuh"
#include "flash_kernels.cuh"

namespace flash_bf16 {

using bw::bf16;
using flash::at;
using flash::NEG;
using flash::Strides;

constexpr int THREADS = 128;   // a warpgroup
constexpr int ROWS = 64;       // a block's own rows: queries, or keys
constexpr int STAGES = 3;      // streamed tiles: j in use, j + 1, j + 2 coming
constexpr int FWD_KEYS = 64;   // keys of a forward tile
constexpr float LOG2E = 1.4426950408889634f;

// Rows of a backward tile (keys of the dQ kernel, queries of the dK/dV
// kernel): 32 at compiled width 128, where the accumulators of dK and dV
// take 128 registers.
__host__ __device__ constexpr int bwd_rows(int DT) {
  return DT > 64 ? 32 : 64;
}

// Dynamic shared memory: 1024 bytes to align the tiles (the swizzle is
// read on address bits), three stages of two streamed tiles, the block's
// own rows (np pieces of q scale; q and dO; k and v) and, backward, the
// rows' delta (dQ) or each stage's lse and delta (dK/dV).
constexpr size_t fwd_smem(int DT, int np) {
  return 1024 + (size_t)(2 * STAGES * FWD_KEYS + np * ROWS) * DT * 2;
}
constexpr size_t dq_smem(int DT) {
  return 1024 + (size_t)(2 * STAGES * bwd_rows(DT) + 2 * ROWS) * DT * 2 +
         ROWS * sizeof(float);
}
constexpr size_t dkv_smem(int DT) {
  return 1024 + (size_t)(2 * STAGES * bwd_rows(DT) + 2 * ROWS) * DT * 2 +
         STAGES * 2 * bwd_rows(DT) * sizeof(float);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (bw::smem_addr(p) & 1023)) & 1023);
}

// Rows [r0, r0 + R) x columns [0, DT) of src (row stride ld elements) into
// the swizzled R x DT tile at shared address dst by cp.async, 16-byte
// chunks when vec16 (D a multiple of 8, rows 16-byte aligned), else 8-byte
// ones; rows past n and columns past D zero-filled. The loops stay rolled:
// unrolled, the compiler keeps every chunk's addresses of both paths live
// across the kernel's key loop (some 70 registers, a block fewer an SM).
template <int R, int DT>
__device__ __forceinline__ void copy_tile(uint32_t dst, const bf16* src,
                                          long long ld, int r0, int n, int D,
                                          bool vec16) {
  if (vec16) {
    constexpr int C = DT / 8;
#pragma unroll 1
    for (int it = 0; it < R * C / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS;
      const int r = i / C, c = (i % C) * 8;
      const bool ok = r0 + r < n && c < D;
      bw::cp_async16(dst + bw::tile_off<R, DT>(r, c),
                     ok ? src + (r0 + r) * ld + c : src, ok);
    }
  } else {
    constexpr int C = DT / 4;
#pragma unroll 1
    for (int it = 0; it < R * C / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS;
      const int r = i / C, c = (i % C) * 4;
      const bool ok = r0 + r < n && c < D;
      bw::cp_async8(dst + bw::tile_off<R, DT>(r, c),
                    ok ? src + (r0 + r) * ld + c : src, ok);
    }
  }
}

// Rows [r0, r0 + 64) of x times f, widened, into np bf16 pieces (hi; with
// np = 3 also mid and lo) at dst, dst + one tile, ...: the block's own rows
// as the K-major A operand of its products. Zeros past n and D. Every load
// is issued before the first store: a store to shared memory between them
// would hold each load behind it (the compiler cannot tell the two apart),
// eight latencies of device memory in a row.
template <int DT>
__device__ __forceinline__ void put_rows(uint8_t* dst, const bf16* x,
                                         long long ld, float f, int np,
                                         int r0, int n, int D) {
  constexpr int C = DT / 4, TILE = ROWS * DT * 2, N = ROWS * C / THREADS;
  float4 a[N];
#pragma unroll
  for (int it = 0; it < N; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / C, c = (i % C) * 4;
    a[it] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n && c < D) a[it] = io::ld4(x + (r0 + r) * ld + c);
  }
#pragma unroll
  for (int it = 0; it < N; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / C, c = (i % C) * 4;
    uint32_t h0, m0, l0, h1, m1, l1;
    bw::split3(a[it].x * f, a[it].y * f, h0, m0, l0);
    bw::split3(a[it].z * f, a[it].w * f, h1, m1, l1);
    uint8_t* p = dst + bw::tile_off<ROWS, DT>(r, c);
    *reinterpret_cast<uint2*>(p) = make_uint2(h0, h1);
    if (np > 1) {
      *reinterpret_cast<uint2*>(p + TILE) = make_uint2(m0, m1);
      *reinterpret_cast<uint2*>(p + 2 * TILE) = make_uint2(l0, l1);
    }
  }
}

// delta = rowsum(dO O) of rows [r0, r0 + 64) into sums[64], the widened
// values summed in the order the f32 kernels of this width sum them
// (flash_bwd_dq_tc_kernel's put_rows below 128, flash_bwd_dq_kernel at
// 128), so the two agree bit for bit.
template <int DT>
__device__ __forceinline__ void row_deltas(const bf16* dout, long long ldo,
                                           const bf16* o, long long ldv,
                                           int r0, int n, int D,
                                           float* sums) {
  if constexpr (DT <= 64) {
    constexpr int C4 = DT / 4;   // a row's chunks: C4 neighbouring lanes
    constexpr int N = ROWS * C4 / THREADS;
    float4 a[N], b[N];           // every load first, as in put_rows
#pragma unroll
    for (int it = 0; it < N; ++it) {
      const int i = threadIdx.x + it * THREADS;
      const int r = i / C4, c = (i % C4) * 4;
      a[it] = b[it] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < n && c < D) {
        a[it] = io::ld4(dout + (r0 + r) * ldo + c);
        b[it] = io::ld4(o + (r0 + r) * ldv + c);
      }
    }
#pragma unroll
    for (int it = 0; it < N; ++it) {
      const int i = threadIdx.x + it * THREADS;
      const int r = i / C4, c = (i % C4) * 4;
      float part = a[it].x * b[it].x + a[it].y * b[it].y +
                   a[it].z * b[it].z + a[it].w * b[it].w;
#pragma unroll
      for (int off = C4 / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (c == 0) sums[r] = part;
    }
  } else {
    // Four lanes a row, lane s holding chunks s, s + 4, ..., one fma chain.
    constexpr int LPR = 4, NC = DT / 4 / LPR;
#pragma unroll
    for (int it = 0; it < ROWS * LPR / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS;
      const int r = i / LPR, seg = i % LPR;
      float dl = 0.0f;
#pragma unroll
      for (int kc = 0; kc < NC; ++kc) {
        const int c = 4 * (kc * LPR + seg);
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
        if (r0 + r < n && c < D) {
          a = io::ld4(dout + (r0 + r) * ldo + c);
          b = io::ld4(o + (r0 + r) * ldv + c);
        }
        dl = fmaf(a.x, b.x, dl);
        dl = fmaf(a.y, b.y, dl);
        dl = fmaf(a.z, b.z, dl);
        dl = fmaf(a.w, b.w, dl);
      }
      dl += __shfl_xor_sync(0xffffffffu, dl, 2);
      dl += __shfl_xor_sync(0xffffffffu, dl, 1);
      if (seg == 0) sums[r] = dl;
    }
  }
}

// The f32 accumulator x (64 x 16 PK, element 4 nt + 2 r + e: row g + 8 r,
// column 8 nt + 2 t + e) as the A operand of PK k-steps over its columns:
// k-step kk's register i holds elements 8 kk + 2 i and + 1 (the m16n8k16
// A fragment), in three bf16 pieces.
template <int PK>
__device__ __forceinline__ void a_pieces(const float (&x)[8 * PK],
                                         uint32_t (&hi)[PK][4],
                                         uint32_t (&mid)[PK][4],
                                         uint32_t (&lo)[PK][4]) {
#pragma unroll
  for (int kk = 0; kk < PK; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      bw::split3(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1], hi[kk][i],
                 mid[kk][i], lo[kk][i]);
}

// acc (64 x DT) += x (64 x 16 PK, f32 accumulator layout) . tile (the
// 16 PK x DT tile at shared address t, read MN-major): three passes a
// k-step, lo, mid, hi; waited for.
template <int PK, int DT>
__device__ __forceinline__ void acc_by_tile(float (&acc)[DT / 2],
                                            const float (&x)[8 * PK],
                                            uint32_t t) {
  uint32_t hi[PK][4], mid[PK][4], lo[PK][4];
  a_pieces<PK>(x, hi, mid, lo);
  wgmma_operand_fence(acc);
  bw::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < PK; ++kk) {
    const uint64_t b = bw::mnmajor<16 * PK, DT>(t, kk);
    bw::wgmma_bf16<DT, 1>(acc, lo[kk], b, 1);
    bw::wgmma_bf16<DT, 1>(acc, mid[kk], b, 1);
    bw::wgmma_bf16<DT, 1>(acc, hi[kk], b, 1);
  }
  bw::wgmma_commit_wait();
  wgmma_operand_fence(acc);
}

// acc (64 x BN) = rows (the block's 64 x DT tile at shared address a) .
// tile^T (the BN x DT tile at b, read K-major), one pass a k-step over the
// head dim; issued, not waited for.
template <int BN, int DT>
__device__ __forceinline__ void rows_by_tile(float (&acc)[BN / 2], uint32_t a,
                                             uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < DT / 16; ++ks)
    bw::wgmma_bf16_ss<BN, 0>(acc, bw::kmajor<ROWS, DT>(a, ks),
                             bw::kmajor<BN, DT>(b, ks), ks > 0);
}

// ---- forward: one block, a warpgroup, per (batch*head, 64 queries) ----

template <int DT, typename OT>
__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, OT* __restrict__ out,
                      float* __restrict__ lse, Strides sq, Strides sk,
                      Strides sv, Strides so, int H, int Lq, int Lk, int D,
                      int row_blocks, float scale, int npq, int vec16) {
  constexpr int TK = FWD_KEYS, PK = TK / 16;
  constexpr int TILE = TK * DT * 2, QT = ROWS * DT * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const uint32_t s0 = bw::smem_addr(sm);
  // [stage][K, V] tiles, then the pieces of q scale.
  auto kt = [&](int st) { return s0 + 2 * st * TILE; };
  auto vt = [&](int st) { return s0 + (2 * st + 1) * TILE; };
  const uint32_t qa = s0 + 2 * STAGES * TILE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / row_blocks;
  const int b = bh / H, h = bh % H;
  const int row0 = (blockIdx.x % row_blocks) * ROWS;
  const bf16* kb = at(k, sk, b, h, 0);
  const bf16* vb = at(v, sv, b, h, 0);
  const int ntiles = (Lk + TK - 1) / TK;

  auto load = [&](int tile, int st) {
    copy_tile<TK, DT>(kt(st), kb, sk.l, tile * TK, Lk, D, vec16);
    copy_tile<TK, DT>(vt(st), vb, sv.l, tile * TK, Lk, D, vec16);
  };
  // Tiles 0 and 1 in flight while q scale is split into its pieces.
  load(0, 0);
  bw::cp_async_commit();
  if (ntiles > 1) load(1, 1);
  bw::cp_async_commit();
  put_rows<DT>(sm + 2 * STAGES * TILE, at(q, sq, b, h, 0), sq.l, scale, npq,
               row0, Lq, D);

  // Accumulator element 4 j + 2 r + e: row g + 8 r of the warp's 16, column
  // (key or head-dim column) 8 j + 2 t + e.
  float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};   // rows g, g + 8
  float o[DT / 2];
#pragma unroll
  for (int i = 0; i < DT / 2; ++i) o[i] = 0.0f;

  for (int j = 0; j < ntiles; ++j) {
    const int st = j % STAGES;
    // One barrier a tile: past it tile j is in shared memory and every warp
    // is done with tile j - 1, whose stage takes tile j + 2 below.
    bw::cp_async_wait1();
    bw::fence_async_shared();
    __syncthreads();

    // S = (q scale) K^T, 64 queries x TK keys, one chain over the head dim;
    // the copy of tile j + 2 is issued while it runs.
    float s[TK / 2];
    wgmma_operand_fence(s);
    bw::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DT / 16; ++ks) {
      const uint64_t bk = bw::kmajor<TK, DT>(kt(st), ks);
      if (npq > 1) {
        bw::wgmma_bf16_ss<TK, 0>(s, bw::kmajor<ROWS, DT>(qa + 2 * QT, ks), bk,
                                 ks > 0);
        bw::wgmma_bf16_ss<TK, 0>(s, bw::kmajor<ROWS, DT>(qa + QT, ks), bk, 1);
      }
      bw::wgmma_bf16_ss<TK, 0>(s, bw::kmajor<ROWS, DT>(qa, ks), bk,
                               ks > 0 || npq > 1);
    }
    bw::wgmma_commit();
    if (j + 2 < ntiles) load(j + 2, (j + 2) % STAGES);
    bw::cp_async_commit();
    bw::wgmma_wait();
    wgmma_operand_fence(s);

    // Online softmax, the running max and denominator of the f32 kernel:
    // keys past Lk score NEG (probability exactly 0). A row's four lanes
    // share its max; each keeps its part of the sum.
    const int nk = Lk - j * TK;
    if (nk < TK) {   // the ragged last tile
#pragma unroll
      for (int x = 0; x < TK / 2; ++x)
        if (8 * (x / 4) + 2 * t + (x & 1) >= nk) s[x] = NEG;
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG;
#pragma unroll
      for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          mx = fmaxf(mx, s[4 * nt + 2 * r + e]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = expf(m[r] - m_new);   // 0 on the first tile
      // exp(s - m) as 2^(s log2 e - m log2 e), one fma and the exp2 unit:
      // within about 1e-6 of expf's (8% off the forward's time at the
      // c3 arm-F shape, scripts/torch_flash_bf16_variants.py).
      const float ml = m_new * LOG2E;
      float sum = 0.0f;
#pragma unroll
      for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(fmaf(s[4 * nt + 2 * r + e], LOG2E, -ml));
          s[4 * nt + 2 * r + e] = p;
          sum += p;
        }
      l[r] = l[r] * alpha[r] + sum;
      m[r] = m_new;
    }
    // O = O alpha + P V: P (f32, in registers as S left it) in three bf16
    // pieces, V read MN-major as it landed.
#pragma unroll
    for (int i = 0; i < DT / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    acc_by_tile<PK, DT>(o, s, vt(st));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = row0 + warp * 16 + g + 8 * r;
    if (row >= Lq) continue;
    const float lc = fmaxf(lr, 1e-30f), inv = 1.0f / lc;
    OT* dst = at(out, so, b, h, row);
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

// ---- dQ = dS K scale and delta = rowsum(dO O): one block, a warpgroup, per
// (batch*head, 64 queries), key tiles of bwd_rows(DT) ----

template <int DT, typename OT>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ o,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse, OT* __restrict__ dq,
                         float* __restrict__ delta, Strides sq, Strides sk,
                         Strides sv, Strides so, Strides sdo, Strides sdq,
                         int H, int Lq, int Lk, int D, int row_blocks,
                         float scale, int vec16) {
  constexpr int BT = bwd_rows(DT), PK = BT / 16;
  constexpr int TILE = BT * DT * 2, RT = ROWS * DT * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const uint32_t s0 = bw::smem_addr(sm);
  // [stage][K, V] tiles, the block's q and dO, its rows' delta.
  auto kt = [&](int st) { return s0 + 2 * st * TILE; };
  auto vt = [&](int st) { return s0 + (2 * st + 1) * TILE; };
  const uint32_t qr = s0 + 2 * STAGES * TILE, dor = qr + RT;
  float* delta_s = reinterpret_cast<float*>(sm + 2 * STAGES * TILE + 2 * RT);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / row_blocks;
  const int b = bh / H, h = bh % H;
  const int row0 = (blockIdx.x % row_blocks) * ROWS;
  const bf16* kb = at(k, sk, b, h, 0);
  const bf16* vb = at(v, sv, b, h, 0);
  const int ntiles = (Lk + BT - 1) / BT;

  auto load = [&](int tile, int st) {
    copy_tile<BT, DT>(kt(st), kb, sk.l, tile * BT, Lk, D, vec16);
    copy_tile<BT, DT>(vt(st), vb, sv.l, tile * BT, Lk, D, vec16);
  };
  load(0, 0);
  bw::cp_async_commit();
  if (ntiles > 1) load(1, 1);
  bw::cp_async_commit();
  const bf16* dob = at(dout, sdo, b, h, 0);
  put_rows<DT>(sm + 2 * STAGES * TILE, at(q, sq, b, h, 0), sq.l, 1.0f, 1,
               row0, Lq, D);
  put_rows<DT>(sm + 2 * STAGES * TILE + RT, dob, sdo.l, 1.0f, 1, row0, Lq, D);
  row_deltas<DT>(dob, sdo.l, at(o, so, b, h, 0), so.l, row0, Lq, D, delta_s);
  __syncthreads();   // delta_s complete
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
    const int st = j % STAGES;
    bw::cp_async_wait1();
    bw::fence_async_shared();
    __syncthreads();
    // S = q K^T and dP = dO V^T, 64 queries x BT keys; the copy of tile
    // j + 2 is issued while they run.
    float s[BT / 2], dp[BT / 2];
    wgmma_operand_fence(s);
    wgmma_operand_fence(dp);
    bw::wgmma_fence();
    rows_by_tile<BT, DT>(s, qr, kt(st));
    rows_by_tile<BT, DT>(dp, dor, vt(st));
    bw::wgmma_commit();
    if (j + 2 < ntiles) load(j + 2, (j + 2) % STAGES);
    bw::cp_async_commit();
    bw::wgmma_wait();
    wgmma_operand_fence(s);
    wgmma_operand_fence(dp);
    // dS = P (dP - delta), P = exp(S scale - lse); keys past Lk get P = 0.
    const int nk = Lk - j * BT;
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * nt + 2 * r + e;
          const float p = 8 * nt + 2 * t + e < nk
                              ? expf(__fmul_rn(s[x], scale) - ls[r])
                              : 0.0f;
          s[x] = p * (dp[x] - dl[r]);
        }
    // dQ += dS K over the tile's keys, K read MN-major.
    acc_by_tile<PK, DT>(acc, s, kt(st));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + g + 8 * r;
    if (row >= Lq) continue;
    OT* dst = at(dq, sdq, b, h, row);
#pragma unroll
    for (int nd = 0; nd < DT / 8; ++nd) {
      const int col = 8 * nd + 2 * t;
      if (col < D)
        io::st2(dst + col, acc[4 * nd + 2 * r] * scale,
                acc[4 * nd + 2 * r + 1] * scale);
    }
  }
}

// ---- dK = dS^T Q scale and dV = P^T dO: one block, a warpgroup, per
// (batch*head, 64 keys), query tiles of bwd_rows(DT); no atomics ----

// Three blocks an SM below width 128 (at most 168 registers: dK and dV
// take 64 of them; 16 bytes spill), which ran it 8% faster than two.
template <int DT, typename OT>
__global__ void __launch_bounds__(THREADS, DT > 64 ? 1 : 3)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          OT* __restrict__ dk, OT* __restrict__ dv,
                          Strides sq, Strides sk, Strides sv, Strides sdo,
                          Strides sdk, Strides sdv, int H, int Lq, int Lk,
                          int D, int row_blocks, float scale, int vec16) {
  constexpr int BT = bwd_rows(DT), PK = BT / 16;
  constexpr int TILE = BT * DT * 2, RT = ROWS * DT * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const uint32_t s0 = bw::smem_addr(sm);
  // [stage][Q, dO] tiles, the block's k and v, [stage][lse, delta].
  auto qt = [&](int st) { return s0 + 2 * st * TILE; };
  auto dot = [&](int st) { return s0 + (2 * st + 1) * TILE; };
  const uint32_t kr = s0 + 2 * STAGES * TILE, vr = kr + RT;
  const uint32_t stats0 = vr + RT;
  const float* stats = reinterpret_cast<const float*>(
      sm + 2 * STAGES * TILE + 2 * RT);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / row_blocks;
  const int b = bh / H, h = bh % H;
  const int key0 = (blockIdx.x % row_blocks) * ROWS;
  const bf16* qb = at(q, sq, b, h, 0);
  const bf16* dob = at(dout, sdo, b, h, 0);
  const float* lse_b = lse + (int64_t)bh * Lq;
  const float* delta_b = delta + (int64_t)bh * Lq;
  const int ntiles = (Lq + BT - 1) / BT;

  // Query tile `tile` into stage st, with its lse and delta (zeros past
  // Lq, where P is set to 0).
  auto load = [&](int tile, int st) {
    copy_tile<BT, DT>(qt(st), qb, sq.l, tile * BT, Lq, D, vec16);
    copy_tile<BT, DT>(dot(st), dob, sdo.l, tile * BT, Lq, D, vec16);
    if (tid < 2 * BT) {
      const int i = tid % BT, qq = tile * BT + i;
      const float* src = tid < BT ? lse_b : delta_b;
      bw::cp_async4(stats0 + (st * 2 * BT + tid) * 4,
                    qq < Lq ? src + qq : src, qq < Lq);
    }
  };
  load(0, 0);
  bw::cp_async_commit();
  if (ntiles > 1) load(1, 1);
  bw::cp_async_commit();
  put_rows<DT>(sm + 2 * STAGES * TILE, at(k, sk, b, h, 0), sk.l, 1.0f, 1,
               key0, Lk, D);
  put_rows<DT>(sm + 2 * STAGES * TILE + RT, at(v, sv, b, h, 0), sv.l, 1.0f,
               1, key0, Lk, D);

  float dka[DT / 2], dva[DT / 2];
#pragma unroll
  for (int i = 0; i < DT / 2; ++i) dka[i] = dva[i] = 0.0f;
  for (int j = 0; j < ntiles; ++j) {
    const int st = j % STAGES;
    bw::cp_async_wait1();
    bw::fence_async_shared();
    __syncthreads();
    // S^T = k Q^T and dP^T = v dO^T, 64 keys x BT queries; the copy of tile
    // j + 2 is issued while they run.
    float st_[BT / 2], dpt[BT / 2];
    wgmma_operand_fence(st_);
    wgmma_operand_fence(dpt);
    bw::wgmma_fence();
    rows_by_tile<BT, DT>(st_, kr, qt(st));
    rows_by_tile<BT, DT>(dpt, vr, dot(st));
    bw::wgmma_commit();
    if (j + 2 < ntiles) load(j + 2, (j + 2) % STAGES);
    bw::cp_async_commit();
    bw::wgmma_wait();
    wgmma_operand_fence(st_);
    wgmma_operand_fence(dpt);
    // P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - delta); element 4 nt
    // + 2 r + e: key g + 8 r, query 8 nt + 2 t + e. Keys past Lk compute on
    // zero rows and store nothing.
    const float* ls = stats + st * 2 * BT;
    const int nq = Lq - j * BT;
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * nt + 2 * t + e;
        const float lq = ls[col], dlq = ls[BT + col];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int x = 4 * nt + 2 * r + e;
          const float p =
              col < nq ? expf(__fmul_rn(st_[x], scale) - lq) : 0.0f;
          st_[x] = p;
          dpt[x] = p * (dpt[x] - dlq);
        }
      }
    // dV += P^T dO, dK += dS^T Q over the tile's queries, read MN-major.
    acc_by_tile<PK, DT>(dva, st_, dot(st));
    acc_by_tile<PK, DT>(dka, dpt, qt(st));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + warp * 16 + g + 8 * r;
    if (key >= Lk) continue;
    OT* ddk = at(dk, sdk, b, h, key);
    OT* ddv = at(dv, sdv, b, h, key);
#pragma unroll
    for (int nd = 0; nd < DT / 8; ++nd) {
      const int col = 8 * nd + 2 * t;
      if (col < D) {
        io::st2(ddk + col, dka[4 * nd + 2 * r] * scale,
                dka[4 * nd + 2 * r + 1] * scale);
        io::st2(ddv + col, dva[4 * nd + 2 * r], dva[4 * nd + 2 * r + 1]);
      }
    }
  }
}

// ---- launchers on (batch, head, row)-strided bf16 tensors ----
//
// OT, the type of the output, dQ, dK and dV: bf16 (train.bf16), or f32,
// the same sums before their one rounding (chip_smoke.py holds the bf16
// results to it).

// Rows of a tensor can be copied 16 bytes at a time: base 16-byte aligned,
// every stride a multiple of 8 elements.
inline bool rows16(const void* p, Strides s) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && s.b % 8 == 0 &&
         s.h % 8 == 0 && s.l % 8 == 0;
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int DT, typename OT>
int launch_fwd(const bf16* q, const bf16* k, const bf16* v, OT* out,
               float* lse, Strides sq, Strides sk, Strides sv, Strides so,
               int B, int H, int Lq, int Lk, int D, float scale,
               cudaStream_t stream) {
  // q scale is a bf16 value, one piece, where the scale is a power of two.
  int e2;
  const int npq = frexpf(scale, &e2) == 0.5f ? 1 : 3;
  const int vec16 = D % 8 == 0 && rows16(k, sk) && rows16(v, sv);
  const size_t smem = fwd_smem(DT, npq);
  int e = set_smem(flash_fwd_bf16_kernel<DT, OT>, fwd_smem(DT, 3));
  if (e) return e;
  const int rb = (Lq + ROWS - 1) / ROWS;
  const unsigned blocks = (unsigned)((int64_t)B * H * rb);
  flash_fwd_bf16_kernel<DT, OT><<<blocks, THREADS, smem, stream>>>(
      q, k, v, out, lse, sq, sk, sv, so, H, Lq, Lk, D, rb, scale, npq, vec16);
  return (int)cudaGetLastError();
}

template <int DT, typename OT>
int launch_bwd_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                  const bf16* dout, const float* lse, OT* dq, float* delta,
                  Strides sq, Strides sk, Strides sv, Strides so, Strides sdo,
                  Strides sdq, int B, int H, int Lq, int Lk, int D,
                  float scale, cudaStream_t stream) {
  const int vec16 = D % 8 == 0 && rows16(k, sk) && rows16(v, sv);
  int e = set_smem(flash_bwd_dq_bf16_kernel<DT, OT>, dq_smem(DT));
  if (e) return e;
  const int rb = (Lq + ROWS - 1) / ROWS;
  const unsigned blocks = (unsigned)((int64_t)B * H * rb);
  flash_bwd_dq_bf16_kernel<DT, OT><<<blocks, THREADS, dq_smem(DT), stream>>>(
      q, k, v, o, dout, lse, dq, delta, sq, sk, sv, so, sdo, sdq, H, Lq, Lk,
      D, rb, scale, vec16);
  return (int)cudaGetLastError();
}

template <int DT, typename OT>
int launch_bwd_dkv(const bf16* q, const bf16* k, const bf16* v,
                   const bf16* dout, const float* lse, const float* delta,
                   OT* dk, OT* dv, Strides sq, Strides sk, Strides sv,
                   Strides sdo, Strides sdk, Strides sdv, int B, int H, int Lq,
                   int Lk, int D, float scale, cudaStream_t stream) {
  const int vec16 = D % 8 == 0 && rows16(q, sq) && rows16(dout, sdo);
  int e = set_smem(flash_bwd_dkv_bf16_kernel<DT, OT>, dkv_smem(DT));
  if (e) return e;
  const int rb = (Lk + ROWS - 1) / ROWS;
  const unsigned blocks = (unsigned)((int64_t)B * H * rb);
  flash_bwd_dkv_bf16_kernel<DT, OT><<<blocks, THREADS, dkv_smem(DT), stream>>>(
      q, k, v, dout, lse, delta, dk, dv, sq, sk, sv, sdo, sdk, sdv, H, Lq, Lk,
      D, rb, scale, vec16);
  return (int)cudaGetLastError();
}

}  // namespace flash_bf16
