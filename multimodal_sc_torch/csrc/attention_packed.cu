// Multi-head softmax attention on the packed (B, L, H*d) layout, forward and
// backward:
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h] * scale) v[b, j, h]
// with head h the d columns [h*d, (h+1)*d) of the model dim.
//
// Replaces the TPU kernels of multimodal_sc_tpu/kernels/attention_packed.py:
// _fwd_impl / _fwd_kernel (forward) and _bwd_impl / _bwd_kernel (backward).
// There one program per (batch element, 128-lane group, q-block) held the
// whole K and V in VMEM and reached each head with lane-masked full-width
// matmuls; the backward accumulated dk/dv across q-blocks in a grid that ran
// in order. Neither carries over: a block here has 227 KB of shared memory
// (f32 K and V at Lk = 256 alone are 256 KB), blocks run in no order, and a
// head's d columns are indexed directly, no mask.
//
// Forward, one launch: one block (4 warps) per (32 query rows, batch
// element, 128-column group). A warp owns one head of the group (more when
// d < 32, and warps idle when d = 64), a lane owns one query row kept in
// registers; K and V stream through shared memory in tiles of 32 keys, read
// by all lanes at once (a broadcast). The softmax is the plain two-pass one
// of the TPU kernel: pass 1 streams K for the row max and the sum, pass 2
// streams K and V and accumulates normalised probabilities times V, so
// any Lk works (packed_eligible allows 4096) and no score is stored.
//
// The forward also writes lse = m + log l of its softmax, (B, heads, Lq),
// when the caller wants a gradient: the backward never recomputes the
// statistics.
//
// Backward, bf16 mode (the main paths'): bwd_mma_kernel, on the tensor
// cores. In this mode every matmul operand is a bf16 number and every sum
// f32 by definition (below), which is what mma.sync.m16n8k16 computes, so
// the operands are rounded once on their way into shared memory (half the
// bytes) and the five products S, dP, dV, dK, dQ are each formed once:
//   * One block per (key split of NW*16 keys, batch element, head); a head
//     is a strided d-column slice of the packed rows, read in place. K and
//     V of the split stay in shared memory for the block's life; Q and dO
//     pass through it 64 rows at a time, and delta = sum_d dO*O (from the
//     unrounded values) is folded into that load.
//   * Phase 1: warp w owns keys [16w, 16w+16) and holds its K and V
//     fragments and its dK, dV accumulators in registers. For each 16
//     queries it forms S^T = K Q^T and dP^T = V dO^T (keys x queries), then
//     P = exp(S*scale - lse), dS = P (dP - delta) scale in the accumulator
//     layout, which is also the A-operand layout of the next products with
//     the queries as contraction: dV += P^T dO and dK += dS^T Q take their
//     left operands straight from registers (P and dS rounded to bf16
//     there) and their right ones by ldmatrix.trans.
//   * dQ = dS K contracts over keys, across warps: each warp stores its
//     rounded dS^T tile to shared memory; phase 2 reads the (keys x 64
//     queries) tile back with ldmatrix.trans as the left operand, K with
//     ldmatrix.trans as the right one, one 16-query x 16-column piece per
//     warp, and writes the dQ rows. No atomics: with one key split (Lk <=
//     256, the main-path shapes) dQ is written once; longer Lk writes one
//     partial dQ per split to scratch and a second small kernel adds them
//     in a fixed order, so the bits are the same from run to run.
//   * Shared rows are padded by 16 bytes (d = 32: 80-byte rows), so the
//     eight row addresses of an ldmatrix hit eight different bank groups.
//     d = 8 is half a k-step: rows are zero-filled to 16 columns. Keys past
//     Lk get P = 0 by predicate; query rows past Lq get lse = +inf, hence
//     P = 0, and store nothing.
// Backward, f32 mode (exact f32; the route comparisons and kernel checks):
// the dQ and dK/dV kernels of flash_kernels.cuh on the FMA units, given the
// packed layout as (batch, head, row) strides. A row there is owned by
// d/32 neighbouring lanes, so no head dim spills.
// Keys past Lk are never scored (the TPU kernel masks them with -1e30);
// query rows past Lq are computed on zeros and never stored; no padded copy
// of any input exists.
//
// Precision mirrors the TPU kernel's _mm: with bf16 on, every matmul
// operand (q, k, v, dO, the NORMALISED probabilities, dS) is rounded to bf16
// (to nearest even) and every sum is kept in f32; delta and the softmax
// statistics are f32 of the unrounded dO, O and the rounded q, k. With bf16
// off everything is exact f32.
//
// Bound on the card. Forward at c4 (B = 1024, dm = 128) needs 4 B Lq Lk dm
// FLOPs against 4 (2 Lq + 2 Lk) dm B bytes: 8-64 FLOP/byte, under the bf16
// tensor-core break-even (~295), so the least time is set by the bytes; the
// backward, 10 B Lq Lk dm FLOPs against twice the bytes, likewise. The
// forward still computes on the f32 FMA units (CUDA cores) and does the
// Q K^T product twice (two-pass softmax), so it is bound by its operations;
// its tensor-core version is later work. The bf16 backward's products are
// on the tensor cores; what bounds it is the traffic between shared memory
// and registers (ldmatrix) and the f32 loads of its operands.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_kernels.cuh"

namespace {

constexpr int GW = 128;   // columns of one lane group
constexpr int RT = 32;    // rows per tile (query rows or keys)

template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

// Rows [0, n_valid) x GW columns from src (row stride `stride` floats) into
// a shared RT x GW tile, rounded in bf16 mode; missing rows read as zeros.
template <bool BF16>
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          int64_t stride, int n_valid,
                                          float* dst) {
  for (int i = threadIdx.x; i < RT * GW / 4; i += blockDim.x) {
    const int r = i / (GW / 4), c4 = i % (GW / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_valid)
      v = __ldg(reinterpret_cast<const float4*>(src + r * stride) + c4);
    v.x = rnd<BF16>(v.x);
    v.y = rnd<BF16>(v.y);
    v.z = rnd<BF16>(v.z);
    v.w = rnd<BF16>(v.w);
    reinterpret_cast<float4*>(dst)[i] = v;
  }
}

// D contiguous floats of a row (16-byte aligned) into registers; zeros when
// !valid.
template <int D, bool BF16>
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         bool valid, float (&dst)[D]) {
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid) v = __ldg(reinterpret_cast<const float4*>(src + d));
    dst[d] = rnd<BF16>(v.x);
    dst[d + 1] = rnd<BF16>(v.y);
    dst[d + 2] = rnd<BF16>(v.z);
    dst[d + 3] = rnd<BF16>(v.w);
  }
}

template <int D>
__device__ __forceinline__ void store_row(float* dst, const float (&src)[D]) {
#pragma unroll
  for (int d = 0; d < D; d += 4)
    *reinterpret_cast<float4*>(dst + d) =
        make_float4(src[d], src[d + 1], src[d + 2], src[d + 3]);
}

// Register row . shared row (16-byte aligned).
template <int D>
__device__ __forceinline__ float dot_row(const float (&a)[D], const float* b) {
  float acc = 0.0f;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 b4 = *reinterpret_cast<const float4*>(b + d);
    acc = fmaf(a[d], b4.x, acc);
    acc = fmaf(a[d + 1], b4.y, acc);
    acc = fmaf(a[d + 2], b4.z, acc);
    acc = fmaf(a[d + 3], b4.w, acc);
  }
  return acc;
}

// acc += w * shared row.
template <int D>
__device__ __forceinline__ void axpy_row(float w, const float* b,
                                         float (&acc)[D]) {
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 b4 = *reinterpret_cast<const float4*>(b + d);
    acc[d] = fmaf(w, b4.x, acc[d]);
    acc[d + 1] = fmaf(w, b4.y, acc[d + 1]);
    acc[d + 2] = fmaf(w, b4.z, acc[d + 2]);
    acc[d + 3] = fmaf(w, b4.w, acc[d + 3]);
  }
}

// Pass 1 of the softmax for this lane's query row, for each head of its
// warp: m = max_j s_j, l = sum_j exp(s_j - m) over all Lk keys, s = q.k *
// scale. K (this group's columns of one batch element) streams through the
// shared tile ks. Every thread of the block must call it (barriers inside).
template <int D, int HPW, bool BF16>
__device__ __forceinline__ void softmax_stats(
    const float* __restrict__ kb, int64_t stride, int Lk, float scale,
    const float (&q)[HPW][D], int hoff, bool active, float* ks,
    float (&m)[HPW], float (&l)[HPW]) {
#pragma unroll
  for (int hh = 0; hh < HPW; ++hh) {
    m[hh] = -INFINITY;
    l[hh] = 0.0f;
  }
  for (int k0 = 0; k0 < Lk; k0 += RT) {
    const int nk = min(RT, Lk - k0);
    __syncthreads();   // previous tile fully consumed
    load_tile<BF16>(kb + (int64_t)k0 * stride, stride, nk, ks);
    __syncthreads();
    if (!active) continue;
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh) {
      const float* kh = ks + hoff + hh * D;
      float s[RT];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const float a = dot_row<D>(q[hh], kh + j * GW);
        s[j] = j < nk ? a * scale : -INFINITY;
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m[hh], mx);
      float acc = l[hh] * expf(m[hh] - m_new);   // 0 on the first tile
#pragma unroll
      for (int j = 0; j < RT; ++j) acc += expf(s[j] - m_new);   // 0 past Lk
      l[hh] = acc;
      m[hh] = m_new;
    }
  }
}

template <int D, bool BF16>
__global__ void __launch_bounds__(128)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ out,
           float* __restrict__ lse, int Lq, int Lk, int dm, int heads,
           float scale) {
  constexpr int H = GW / D;                   // heads in one group
  constexpr int HPW = H >= 4 ? H / 4 : 1;     // heads per warp
  __shared__ __align__(16) float ks[RT * GW];
  __shared__ __align__(16) float vs[RT * GW];

  const int b = blockIdx.y, g = blockIdx.z;
  const int q0 = blockIdx.x * RT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool active = warp * HPW < H;
  const bool has_row = active && q0 + lane < Lq;
  const int hoff = warp * HPW * D;            // first column of this warp
  const int64_t stride = dm;
  const int64_t row = ((int64_t)b * Lq + q0 + lane) * stride + g * GW + hoff;
  const float* kb = k + (int64_t)b * Lk * stride + g * GW;
  const float* vb = v + (int64_t)b * Lk * stride + g * GW;

  float qr[HPW][D];
#pragma unroll
  for (int hh = 0; hh < HPW; ++hh)
    load_row<D, BF16>(q + row + hh * D, has_row, qr[hh]);

  float m[HPW], l[HPW];
  softmax_stats<D, HPW, BF16>(kb, stride, Lk, scale, qr, hoff, active, ks, m,
                              l);

  float o[HPW][D], inv[HPW];
#pragma unroll
  for (int hh = 0; hh < HPW; ++hh) {
    inv[hh] = 1.0f / l[hh];
#pragma unroll
    for (int d = 0; d < D; ++d) o[hh][d] = 0.0f;
  }
  for (int k0 = 0; k0 < Lk; k0 += RT) {
    const int nk = min(RT, Lk - k0);
    __syncthreads();
    load_tile<BF16>(kb + (int64_t)k0 * stride, stride, nk, ks);
    load_tile<BF16>(vb + (int64_t)k0 * stride, stride, nk, vs);
    __syncthreads();
    if (!active) continue;
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh) {
      const float* kh = ks + hoff + hh * D;
      const float* vh = vs + hoff + hh * D;
      for (int j = 0; j < nk; ++j) {
        const float s = dot_row<D>(qr[hh], kh + j * GW) * scale;
        const float p = rnd<BF16>(expf(s - m[hh]) * inv[hh]);
        axpy_row<D>(p, vh + j * GW, o[hh]);
      }
    }
  }
  if (has_row) {
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh) {
      store_row<D>(out + row + hh * D, o[hh]);
      // lse = m + log l, from the two values the second pass kept.
      if (lse != nullptr)
        lse[((int64_t)b * heads + g * H + warp * HPW + hh) * Lq + q0 + lane] =
            m[hh] - logf(inv[hh]);
    }
  }
}

// ---- backward, bf16 mode, on the tensor cores ----

constexpr int QT = 64;    // query rows staged per tile
constexpr int PAD = 8;    // bf16 elements (16 bytes) of padding per shared row

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo: low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four 8 x 8 bf16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8. Register j holds matrix j: row lane / 4,
// columns 2 (lane % 4) and + 1; transposed with .trans.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4],
                                          const __nv_bfloat16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// c += a (16 x 16, row) * b (16 x 8, col): bf16 operands, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [0, n_valid) x D columns of src (row stride `stride` floats) into a
// shared ROWS x (DP + PAD) bf16 tile, rounded to nearest even; rows past
// n_valid and columns [D, DP) read as zeros.
template <int D, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_tile_bf16(const float* __restrict__ src,
                                               int64_t stride, int n_valid,
                                               __nv_bfloat16* dst) {
  constexpr int DP = D < 16 ? 16 : D, LD = DP + PAD, C4 = DP / 4;
  for (int i = threadIdx.x; i < ROWS * C4; i += NTHREADS) {
    const int r = i / C4, c = (i % C4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_valid && c < D)
      v = __ldg(reinterpret_cast<const float4*>(src + r * stride + c));
    *reinterpret_cast<uint2*>(dst + r * LD + c) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

constexpr size_t bwd_mma_smem(int D, int NW) {
  const int LD = (D < 16 ? 16 : D) + PAD, KB = NW * 16;
  return (size_t)(2 * KB * LD + 2 * QT * LD + KB * (QT + PAD)) * 2 +
         2 * QT * sizeof(float);
}

// dq_dst: dq itself with one key split, else the scratch for the partial
// dQ of each split, `split_stride` floats apart.
template <int D, int NW>
__global__ void __launch_bounds__(NW * 32, (NW == 8 && D < 64) ? 2 : 1)
bwd_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ o,
               const float* __restrict__ dout, const float* __restrict__ lse,
               float* __restrict__ dq_dst, float* __restrict__ dk,
               float* __restrict__ dv, int Lq, int Lk, int dm, int heads,
               float scale, int64_t split_stride) {
  constexpr int DP = D < 16 ? 16 : D;   // columns of a shared row
  constexpr int LD = DP + PAD;          // its length with padding
  constexpr int KB = NW * 16;           // keys of a block
  constexpr int ND = D / 8;             // 8-column tiles of the head dim
  constexpr int KD = DP / 16;           // k-steps over the head dim
  constexpr int SLD = QT + PAD;
  constexpr int NTHREADS = NW * 32;
  constexpr int C4 = DP / 4;            // float4 chunks (and lanes) per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // KB x LD
  __nv_bfloat16* Vs = Ks + KB * LD;
  __nv_bfloat16* Qs = Vs + KB * LD;                                // QT x LD
  __nv_bfloat16* dOs = Qs + QT * LD;
  __nv_bfloat16* dSs = dOs + QT * LD;   // KB x SLD: dS^T, [key][query]
  float* lse_s = reinterpret_cast<float*>(dSs + KB * SLD);         // QT
  float* delta_s = lse_s + QT;

  const int split = blockIdx.x, b = blockIdx.y, head = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // Row and column offsets of this lane's ldmatrix address: li within an
  // 8 x 8 matrix, (lb, lc) the two bits that pick the matrix.
  const int li = lane & 7, lb = (lane >> 3) & 1, lc = lane >> 4;
  const int key0 = split * KB;
  const int nkeys = min(KB, Lk - key0);
  const int64_t stride = dm;
  const int64_t col = (int64_t)head * D;
  const float* qb = q + (int64_t)b * Lq * stride + col;
  const float* ob = o + (int64_t)b * Lq * stride + col;
  const float* dob = dout + (int64_t)b * Lq * stride + col;
  const float* lse_b = lse + ((int64_t)b * heads + head) * Lq;
  const int64_t krow0 = ((int64_t)b * Lk + key0) * stride + col;
  float* dqb = dq_dst + split * split_stride + (int64_t)b * Lq * stride + col;

  load_tile_bf16<D, KB, NTHREADS>(k + krow0, stride, nkeys, Ks);
  load_tile_bf16<D, KB, NTHREADS>(v + krow0, stride, nkeys, Vs);
  __syncthreads();

  const int wkey = warp * 16;           // this warp's keys within the block
  const bool active = wkey < nkeys;
  const bool key_lo = wkey + g < nkeys, key_hi = wkey + g + 8 < nkeys;
  uint32_t kf[KD][4], vf[KD][4];        // K, V as left operands [key][d]
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    const int off = (wkey + li + 8 * lb) * LD + kd * 16 + 8 * lc;
    ldsm_x4(kf[kd], Ks + off);
    ldsm_x4(vf[kd], Vs + off);
  }
  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[nd][j] = dv_acc[nd][j] = 0.0f;
  const int nkt = (nkeys + 15) / 16;    // 16-key tiles that hold a key

  for (int q0 = 0; q0 < Lq; q0 += QT) {
    const int nq = min(QT, Lq - q0);
    // Stage Q and dO (the previous tile's readers are past the barrier that
    // ended phase 1), with delta = sum_d dO * O of the unrounded values.
    load_tile_bf16<D, QT, NTHREADS>(qb + (int64_t)q0 * stride, stride, nq, Qs);
    constexpr int ITEMS = QT * C4;
#pragma unroll
    for (int it = 0; it < (ITEMS + NTHREADS - 1) / NTHREADS; ++it) {
      const int i = tid + it * NTHREADS;
      const int r = i / C4, c = (i % C4) * 4;
      const bool in = i < ITEMS;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), y = a;
      if (in && r < nq && c < D) {
        const int64_t at = (int64_t)(q0 + r) * stride + c;
        a = __ldg(reinterpret_cast<const float4*>(dob + at));
        y = __ldg(reinterpret_cast<const float4*>(ob + at));
      }
      float part = a.x * y.x + a.y * y.y + a.z * y.z + a.w * y.w;
#pragma unroll
      for (int off = C4 / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (in) {
        *reinterpret_cast<uint2*>(dOs + r * LD + c) =
            make_uint2(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w));
        if (c == 0) delta_s[r] = part;
      }
    }
    // A row past Lq gets lse = +inf: its probabilities are exactly 0.
    if (tid < QT) lse_s[tid] = tid < nq ? lse_b[q0 + tid] : INFINITY;
    __syncthreads();

    // Phase 1: this warp's 16 keys against the tile, 16 queries at a time.
    if (active) {
#pragma unroll 1
      for (int qs0 = 0; qs0 < nq; qs0 += 16) {
        float st[2][4], dpt[2][4];      // S^T, dP^T: 16 keys x 2 x 8 queries
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) st[nt][j] = dpt[nt][j] = 0.0f;
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          // Right operands [d][query] are the staged rows as they lie.
          const int off = (qs0 + li + 8 * lc) * LD + kd * 16 + 8 * lb;
          uint32_t f[4];
          ldsm_x4(f, Qs + off);
          mma_bf16(st[0], kf[kd], f[0], f[1]);
          mma_bf16(st[1], kf[kd], f[2], f[3]);
          ldsm_x4(f, dOs + off);
          mma_bf16(dpt[0], vf[kd], f[0], f[1]);
          mma_bf16(dpt[1], vf[kd], f[2], f[3]);
        }
        // Fragment: rows (keys) g and g + 8, columns (queries) 2t, 2t + 1
        // of each 8-query tile; as a left operand [key][16 queries] the
        // two tiles are registers {0, 1} and {2, 3}.
        uint32_t pa[4], dsa[4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int qq = qs0 + nt * 8 + 2 * t;
          const float2 ls = *reinterpret_cast<const float2*>(lse_s + qq);
          const float2 dl = *reinterpret_cast<const float2*>(delta_s + qq);
          const float p0 = key_lo ? expf(st[nt][0] * scale - ls.x) : 0.0f;
          const float p1 = key_lo ? expf(st[nt][1] * scale - ls.y) : 0.0f;
          const float p2 = key_hi ? expf(st[nt][2] * scale - ls.x) : 0.0f;
          const float p3 = key_hi ? expf(st[nt][3] * scale - ls.y) : 0.0f;
          pa[2 * nt] = pack_bf16(p0, p1);
          pa[2 * nt + 1] = pack_bf16(p2, p3);
          dsa[2 * nt] = pack_bf16(p0 * (dpt[nt][0] - dl.x) * scale,
                                  p1 * (dpt[nt][1] - dl.y) * scale);
          dsa[2 * nt + 1] = pack_bf16(p2 * (dpt[nt][2] - dl.x) * scale,
                                      p3 * (dpt[nt][3] - dl.y) * scale);
          *reinterpret_cast<uint32_t*>(dSs + (wkey + g) * SLD + qq) =
              dsa[2 * nt];
          *reinterpret_cast<uint32_t*>(dSs + (wkey + g + 8) * SLD + qq) =
              dsa[2 * nt + 1];
        }
        // dV += P^T dO, dK += dS^T Q: right operands [query][d] transposed
        // on the way out of shared memory, two 8-column tiles per load.
#pragma unroll
        for (int nd = 0; nd < ND; nd += 2) {
          const int off = (qs0 + li + 8 * lb) * LD + 8 * (nd + lc);
          uint32_t f[4];
          ldsm_x4_t(f, dOs + off);
          mma_bf16(dv_acc[nd], pa, f[0], f[1]);
          if (nd + 1 < ND) mma_bf16(dv_acc[nd + 1], pa, f[2], f[3]);
          ldsm_x4_t(f, Qs + off);
          mma_bf16(dk_acc[nd], dsa, f[0], f[1]);
          if (nd + 1 < ND) mma_bf16(dk_acc[nd + 1], dsa, f[2], f[3]);
        }
      }
    }
    __syncthreads();

    // Phase 2: dQ tile = dS (queries x keys) K (keys x d). Warp w takes the
    // 16 queries w % 4 and 16-column pieces w / 4, w / 4 + NW / 4, ...
    const int mt = warp & 3;
    if (mt * 16 < nq) {
      for (int nd = (warp >> 2) * 2; nd < ND; nd += NW / 2) {
        float acc[2][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[0][j] = acc[1][j] = 0.0f;
        for (int kt = 0; kt < nkt; ++kt) {
          uint32_t a[4], f[4];
          ldsm_x4_t(a, dSs + (kt * 16 + li + 8 * lc) * SLD + mt * 16 + 8 * lb);
          ldsm_x4_t(f, Ks + (kt * 16 + li + 8 * lb) * LD + 8 * (nd + lc));
          mma_bf16(acc[0], a, f[0], f[1]);
          if (nd + 1 < ND) mma_bf16(acc[1], a, f[2], f[3]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (nd + j >= ND) break;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = q0 + mt * 16 + g + 8 * half;
            if (row < Lq)
              *reinterpret_cast<float2*>(dqb + (int64_t)row * stride +
                                         8 * (nd + j) + 2 * t) =
                  make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
          }
        }
      }
    }
    // The next tile's phase 1 overwrites dSs only after the barrier that
    // follows its loads, which every warp reaches after this phase.
  }

  if (active) {
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (!(half ? key_hi : key_lo)) continue;
        const int64_t at =
            krow0 + (int64_t)(wkey + g + 8 * half) * stride + 8 * nd + 2 * t;
        *reinterpret_cast<float2*>(dk + at) =
            make_float2(dk_acc[nd][2 * half], dk_acc[nd][2 * half + 1]);
        *reinterpret_cast<float2*>(dv + at) =
            make_float2(dv_acc[nd][2 * half], dv_acc[nd][2 * half + 1]);
      }
    }
  }
}

// dq = the sum of the key splits' partial dQ, in the order of the splits.
__global__ void sum_splits_kernel(const float4* __restrict__ part,
                                  float4* __restrict__ dq, int64_t n4,
                                  int splits) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 a = part[i];
  for (int s = 1; s < splits; ++s) {
    const float4 b = part[s * n4 + i];
    a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
  }
  dq[i] = a;
}

// Warps (of 16 keys each) of a bf16-mode backward block: 16 when that
// holds the whole of a longer Lk in one block; d = 64 keeps 8, whose
// accumulators then have 255 registers to live in.
int bwd_warps(int Lk, int D) { return (Lk > 128 && D < 64) ? 16 : 8; }

int bwd_splits(int Lk, int D) {
  const int kb = bwd_warps(Lk, D) * 16;
  return (Lk + kb - 1) / kb;
}

template <int D, int NW>
int launch_bwd_mma(const float* q, const float* k, const float* v,
                   const float* o, const float* dout, const float* lse,
                   float* dq, float* dk, float* dv, float* scratch, int B,
                   int Lq, int Lk, int dm, int heads, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = bwd_mma_smem(D, NW);
  cudaError_t e = cudaFuncSetAttribute(
      bwd_mma_kernel<D, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int splits = (Lk + NW * 16 - 1) / (NW * 16);
  const int64_t n = (int64_t)B * Lq * dm;
  dim3 grid(splits, B, heads);
  bwd_mma_kernel<D, NW><<<grid, NW * 32, smem, stream>>>(
      q, k, v, o, dout, lse, splits > 1 ? scratch : dq, dk, dv, Lq, Lk, dm,
      heads, scale, splits > 1 ? n : 0);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const int64_t n4 = n / 4;
  sum_splits_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(scratch), reinterpret_cast<float4*>(dq),
      n4, splits);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd_bf16(const float* q, const float* k, const float* v,
                    const float* o, const float* dout, const float* lse,
                    float* dq, float* dk, float* dv, float* scratch, int B,
                    int Lq, int Lk, int dm, int heads, float scale,
                    cudaStream_t stream) {
  if constexpr (D < 64) {
    if (bwd_warps(Lk, D) == 16)
      return launch_bwd_mma<D, 16>(q, k, v, o, dout, lse, dq, dk, dv, scratch,
                                   B, Lq, Lk, dm, heads, scale, stream);
  }
  return launch_bwd_mma<D, 8>(q, k, v, o, dout, lse, dq, dk, dv, scratch, B,
                              Lq, Lk, dm, heads, scale, stream);
}

// ---- backward, f32 mode: the strided f32 kernels on the packed layout ----

template <int DT>
int launch_bwd_f32(const float* q, const float* k, const float* v,
                   const float* o, const float* dout, const float* lse,
                   float* dq, float* dk, float* dv, float* delta, int B,
                   int Lq, int Lk, int dm, int heads, float scale,
                   cudaStream_t stream) {
  const int D = dm / heads;
  const int rows = flash::THREADS / (DT / flash::W);
  const int rb_q = (Lq + rows - 1) / rows, rb_k = (Lk + rows - 1) / rows;
  const int64_t bh = (int64_t)B * heads;
  if (bh * (rb_q > rb_k ? rb_q : rb_k) >= 2147483647LL)
    return (int)cudaErrorInvalidValue;
  // (B, L, heads * D) read as (B, heads, L, D): batch, head, row strides.
  const flash::Strides sq{(long long)Lq * dm, D, dm};
  const flash::Strides sk{(long long)Lk * dm, D, dm};
  flash::flash_bwd_dq_kernel<DT><<<(unsigned)(bh * rb_q), flash::THREADS, 0,
                                   stream>>>(
      q, k, v, o, dout, lse, dq, delta, sq, sk, sk, sq, sq, sq, heads, Lq, Lk,
      D, rb_q, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash::flash_bwd_dkv_kernel<DT><<<(unsigned)(bh * rb_k), flash::THREADS, 0,
                                    stream>>>(
      q, k, v, dout, lse, delta, dk, dv, sq, sk, sk, sq, sk, sk, heads, Lq,
      Lk, D, rb_k, scale);
  return (int)cudaGetLastError();
}

template <int D, bool BF16>
int launch_fwd(const float* q, const float* k, const float* v, float* out,
               float* lse, int B, int Lq, int Lk, int dm, int heads,
               float scale, cudaStream_t stream) {
  dim3 grid((Lq + RT - 1) / RT, B, dm / GW);
  fwd_kernel<D, BF16><<<grid, 128, 0, stream>>>(q, k, v, out, lse, Lq, Lk, dm,
                                                 heads, scale);
  return (int)cudaGetLastError();
}

bool shape_ok(int B, int dm, int heads) {
  return B <= 65535 && heads > 0 && heads <= 65535 && dm % GW == 0 &&
         dm / GW <= 65535 && dm % heads == 0;
}

}  // namespace

#define DISPATCH_HEAD_DIM(D_, CALL)                 \
  switch (D_) {                                     \
    case 8: { constexpr int D = 8; return CALL; }   \
    case 16: { constexpr int D = 16; return CALL; } \
    case 32: { constexpr int D = 32; return CALL; } \
    case 64: { constexpr int D = 64; return CALL; } \
    default: return (int)cudaErrorInvalidValue;     \
  }

// q, out (B, Lq, dm), k, v (B, Lk, dm): f32, contiguous, 16-byte aligned;
// dm a multiple of 128, head dim dm / heads in {8, 16, 32, 64}. lse, if not
// null, receives the softmax's logsumexp, (B, heads, Lq).
extern "C" int packed_attention_fwd_launch(
    const float* q, const float* k, const float* v, float* out, float* lse,
    int B, int Lq, int Lk, int dm, int heads, float scale, int bf16,
    cudaStream_t stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0) return 0;
  if (!shape_ok(B, dm, heads)) return (int)cudaErrorInvalidValue;
  if (bf16) {
    DISPATCH_HEAD_DIM(dm / heads, (launch_fwd<D, true>(
        q, k, v, out, lse, B, Lq, Lk, dm, heads, scale, stream)))
  }
  DISPATCH_HEAD_DIM(dm / heads, (launch_fwd<D, false>(
      q, k, v, out, lse, B, Lq, Lk, dm, heads, scale, stream)))
}

// Key splits of the bf16-mode backward for this shape: with more than one
// it needs `splits * B * Lq * dm` floats of scratch.
extern "C" int packed_attention_bwd_splits(int Lk, int dm, int heads) {
  return bwd_splits(Lk, dm / heads);
}

// As the forward, plus o = its output, lse = its logsumexp and dout
// (B, Lq, dm); writes dq (B, Lq, dm), dk, dv (B, Lk, dm). scratch: in f32
// mode B * heads * Lq floats (delta); in bf16 mode the partial dQ of the
// key splits when there is more than one, else unused.
extern "C" int packed_attention_bwd_launch(
    const float* q, const float* k, const float* v, const float* o,
    const float* dout, const float* lse, float* dq, float* dk, float* dv,
    float* scratch, int B, int Lq, int Lk, int dm, int heads, float scale,
    int bf16, cudaStream_t stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0) return 0;
  if (!shape_ok(B, dm, heads)) return (int)cudaErrorInvalidValue;
  if (bf16) {
    DISPATCH_HEAD_DIM(dm / heads, (launch_bwd_bf16<D>(
        q, k, v, o, dout, lse, dq, dk, dv, scratch, B, Lq, Lk, dm, heads,
        scale, stream)))
  }
  if (dm / heads <= 32)
    return launch_bwd_f32<32>(q, k, v, o, dout, lse, dq, dk, dv, scratch, B,
                              Lq, Lk, dm, heads, scale, stream);
  return launch_bwd_f32<64>(q, k, v, o, dout, lse, dq, dk, dv, scratch, B, Lq,
                            Lk, dm, heads, scale, stream);
}
