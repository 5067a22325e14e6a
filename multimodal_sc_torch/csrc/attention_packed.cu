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
// Precision mirrors the TPU kernel's _mm: with bf16 on (the mode of every
// main path), every matmul operand (q, k, v, dO, the NORMALISED
// probabilities, dS) is rounded to bf16 (to nearest even) and every sum is
// kept in f32; delta and the softmax statistics are f32 of the unrounded
// dO, O and the rounded q, k. That is exactly what mma.sync.m16n8k16 bf16
// computes, so both bf16-mode kernels run on the tensor cores with their
// operands rounded once on the way into shared memory (half the bytes).
// With bf16 off everything is f32-grade: the f32 mode launches the strided
// kernels of flash_kernels.cuh on the packed layout through (batch, head,
// row) strides, forward and backward on 3xTF32 tensor cores.
//
// Bound on the card. The forward at c4 (B = 1024, dm = 128) and c3 needs
// 4 B Lq Lk dm FLOPs against 4 (2 Lq + 2 Lk) dm B bytes: 8-64 FLOP/byte,
// far under the bf16 tensor-core break-even (~295), so the least time is
// set by the bytes; the backward, 10 B Lq Lk dm FLOPs against twice the
// bytes, likewise. What bounds both kernels in practice is the traffic
// between shared memory and registers (ldmatrix), the exponentials and the
// f32 loads of their operands, not the products.
//
// Forward, bf16 mode on f32 tensors: fwd_mma_kernel, one block of 4 warps
// per (128 query rows, batch element, head); a head is a strided d-column
// slice of the packed rows, read in place, so no warp idles whatever d is.
// K and V of the (batch, head) are rounded to bf16 and staged once into
// padded shared rows (Lk <= 256, every main-path shape: at d = 32 about 40
// KB); a longer Lk re-stages them 256 keys at a time per pass. Warps take
// 16-row query tiles in turn, Q in registers as the left operand. The softmax keeps the plain two passes, because the
// definition rounds the NORMALISED probability to bf16 (an online softmax
// would round exp(s - m_running) instead): pass 1 forms S = Q K^T on the
// tensor cores (K rows by ldmatrix as the right operand) and takes each
// row's max and sum in the accumulator layout, joined across the row's
// four lanes by shuffles, giving lse; pass 2 forms S again (nearly free at
// this intensity), P = exp(S scale - lse) rounded to bf16 straight into
// the left-operand registers of O += P V (the accumulator layout of two
// 8-key tiles is the A layout of one 16-key k-step), V by ldmatrix.trans.
// Keys past Lk get P = 0 by predicate, rows past Lq store nothing, d = 8
// zero-fills half a k-step; lse is written in the epilogue.
//
// Backward, bf16 mode: bwd_mma_kernel. The five products S, dP, dV, dK, dQ
// are each formed once:
//   * One block per (key split of NW*16 keys, batch element, head). K and
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
//   * Keys past Lk get P = 0 by predicate; query rows past Lq get lse =
//     +inf, hence P = 0, and store nothing.
// Shared rows of both kernels are padded by 16 bytes (d = 32: 80-byte
// rows), so the eight row addresses of an ldmatrix hit eight different
// bank groups; d = 8 is half a k-step, its rows zero-filled to 16 columns.
// No padded copy of any input exists in device memory.
//
// bf16 I/O (train.bf16): q, k, v, O and dO are read in bf16 (exact as the
// bf16 operands they already were) and the output, dq, dk and dv written
// in bf16, as the TPU kernel does when handed bf16 arrays. The forward is
// fwd_wgmma_bf16_kernel (packed_fwd_bf16.cuh: bf16 wgmma, one pass while
// Lk <= 256, S formed once). The backward is bwd_wgmma_bf16_kernel
// (packed_bwd_bf16.cuh: bf16 wgmma, a warpgroup a 64-key tile) while Lk <=
// 256, past that bwd_mma_kernel's bf16-I/O instance. The output and dQ are
// summed in f32 and rounded once at the store (with several key splits the
// partial dQ stay f32 in the scratch and their fixed-order sum is
// rounded); lse stays f32.
// dK and dV follow the TPU kernel's blocking: it keeps dk/dv in the output
// dtype across its 128-query grid steps (_accum), so each block's partial
// is rounded to bf16 and added to the running bf16 sum, which is rounded
// again. Here a block is two 64-query tiles: each warp rounds its dK, dV
// accumulators into a running bf16 pair after every second tile (and after
// the last), the first block's partial taken as it is. The TPU kernel
// pads Lq to its blocks with zero rows, which add exact zeros; rows past
// Lq here are P = 0 as well.
//
// f32 mode on bf16 tensors (mxu_bf16=False with bf16 I/O, mode kF32Bf16Io:
// no main path, the kernels' own entry points): the flash kernels' bf16-I/O
// instances (flash_kernels.cuh, T = bf16). Every value is read in bf16 and
// widened exactly, the arithmetic is the f32 mode's, the output and dQ are
// rounded once at the store, lse and delta stay f32, and dK and dV are
// summed per 128-query block and rounded into running bf16 sums, as the TPU
// kernel computes them on bf16 arrays with bf16=False.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "elem_io.cuh"
#include "flash_kernels.cuh"
#include "packed_bwd_bf16.cuh"
#include "packed_fwd_bf16.cuh"

namespace {

constexpr int GW = 128;   // columns of one lane group

// ---- bf16 mode: what the forward and backward kernels share ----

constexpr int QT = 64;    // query rows staged per tile
constexpr int PAD = 8;    // bf16 elements (16 bytes) of padding per shared row

// Rows [0, n_valid) x D columns of src (row stride `stride` elements) into
// the first `rows` rows of a shared (DP + PAD)-wide bf16 tile, rounded to
// nearest even; rows past n_valid and columns [D, DP) read as zeros.
template <int D, int NTHREADS, typename T>
__device__ __forceinline__ void load_tile_bf16(const T* __restrict__ src,
                                               int64_t stride, int n_valid,
                                               int rows, __nv_bfloat16* dst) {
  constexpr int DP = D < 16 ? 16 : D, LD = DP + PAD, C4 = DP / 4;
  for (int i = threadIdx.x; i < rows * C4; i += NTHREADS) {
    const int r = i / C4, c = (i % C4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_valid && c < D) v = io::ld4(src + r * stride + c);
    *reinterpret_cast<uint2*>(dst + r * LD + c) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

// ---- forward, bf16 mode, on the tensor cores ----

constexpr int FNW = 4;      // warps of a forward block
constexpr int FQ = 128;     // its query rows: 16-row tiles, two per warp
constexpr int KC = 256;     // keys held in shared memory at a time

// kc: keys of the shared K and V tiles, Lk rounded up to 16, at most KC.
constexpr size_t fwd_mma_smem(int D, int kc) {
  return (size_t)2 * kc * ((D < 16 ? 16 : D) + PAD) * 2;
}

// Register budget: at d = 32 (every main-path shape) no hint, which ptxas
// answers with 64 registers, no spill and eight blocks a multiprocessor
// (what the c4 shapes at Lk = 65 want; a cap of 64 spills); at the other
// widths the hint of two blocks, without which ptxas spills a few bytes at
// d = 16 and 64.
template <int D>
__global__ void __launch_bounds__(FNW * 32, D == 32 ? 0 : 2)
fwd_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ out,
               float* __restrict__ lse, int Lq, int Lk, int dm, int heads,
               float scale, int kc) {
  constexpr int DP = D < 16 ? 16 : D;   // columns of a shared row
  constexpr int LD = DP + PAD;
  constexpr int ND = D / 8;             // 8-column tiles of the head dim
  constexpr int KD = DP / 16;           // k-steps over the head dim
  constexpr int NTHREADS = FNW * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // kc x LD
  __nv_bfloat16* Vs = Ks + kc * LD;

  const int b = blockIdx.y, head = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int li = lane & 7, lb = (lane >> 3) & 1, lc = lane >> 4;
  const int64_t stride = dm;
  const int64_t col = (int64_t)head * D;
  const float* kb = k + (int64_t)b * Lk * stride + col;
  const float* vb = v + (int64_t)b * Lk * stride + col;
  const bool resident = Lk <= kc;       // K and V staged once for both passes

  // K (and V) rows [c0, c0 + kc) into shared memory, rounded to bf16. Every
  // thread of the block calls it.
  auto stage = [&](int c0, bool with_v) {
    const int n = min(kc, Lk - c0), rows = (n + 15) & ~15;
    __syncthreads();   // the previous rows are fully read
    load_tile_bf16<D, NTHREADS>(kb + c0 * stride, stride, n, rows, Ks);
    if (with_v)
      load_tile_bf16<D, NTHREADS>(vb + c0 * stride, stride, n, rows, Vs);
    __syncthreads();
  };
  if (resident) stage(0, true);

  // Warps take the block's 16-row query tiles in turn; each makes the same
  // number of turns, so the barriers of stage() line up.
#pragma unroll 1
  for (int qt = warp; qt < FQ / 16; qt += FNW) {
    const int row0 = blockIdx.x * FQ + qt * 16;
    const bool active = row0 < Lq;
    // Q as the left operand, rounded on the way from device memory: a0 =
    // rows g, columns 2t, 2t + 1 of the k-step; a1 rows g + 8; a2, a3
    // columns + 8. Rows past Lq and columns past D are zeros.
    uint32_t qa[KD][4];
    const float* qb = q + ((int64_t)b * Lq + row0) * stride + col;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = g + 8 * (r & 1), c = 16 * kd + 2 * t + 8 * (r >> 1);
        float2 x = make_float2(0.f, 0.f);
        if (row0 + row < Lq && c < D) x = io::ld2(qb + row * stride + c);
        qa[kd][r] = pack_bf16(x.x, x.y);
      }

    // S for 16 keys from shared row `key`: two 8-key tiles, rows (queries)
    // g and g + 8, keys 2t and 2t + 1 of each.
    auto scores = [&](int key, float (&s)[2][4]) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = 0.0f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t f[4];   // K rows as they lie are the right operand [d][key]
        ldsm_x4(f, Ks + (key + li + 8 * lc) * LD + kd * 16 + 8 * lb);
        mma_bf16(s[0], qa[kd], f[0], f[1]);
        mma_bf16(s[1], qa[kd], f[2], f[3]);
      }
    };

    // Pass 1: the row max m and sum l of exp(s - m) over all Lk keys, each
    // lane over its own keys (a running max per lane), then joined across
    // the row's four lanes: lse = m + log l.
    float m[2] = {flash::NEG, flash::NEG}, l[2] = {0.0f, 0.0f};
    for (int c0 = 0; c0 < Lk; c0 += kc) {
      if (!resident) stage(c0, false);
      const int nk = min(kc, Lk - c0);
      if (!active) continue;
#pragma unroll 1
      for (int ks = 0; ks < nk; ks += 16) {
        float s[2][4];
        scores(ks, s);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x[4], mx = m[r];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool ok = ks + 8 * nt + 2 * t + e < nk;
              x[2 * nt + e] = ok ? s[nt][2 * r + e] * scale : -INFINITY;
              mx = fmaxf(mx, x[2 * nt + e]);
            }
          float acc = l[r] * expf(m[r] - mx);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc += expf(x[i] - mx);   // 0 masked
          l[r] = acc;
          m[r] = mx;
        }
      }
    }
    float ls[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
        const float mm = fmaxf(m[r], mo);
        l[r] = l[r] * expf(m[r] - mm) + lo * expf(mo - mm);
        m[r] = mm;
      }
      ls[r] = m[r] + logf(l[r]);
    }

    // Pass 2: S again, the normalised P = exp(S scale - lse) rounded to
    // bf16 straight into the left-operand registers of O += P V (the
    // accumulator layout of two 8-key tiles is the A layout of one 16-key
    // k-step); V by ldmatrix.trans, two 8-column tiles per load.
    float o[ND][4];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[nd][i] = 0.0f;
    for (int c0 = 0; c0 < Lk; c0 += kc) {
      if (!resident) stage(c0, true);
      const int nk = min(kc, Lk - c0);
      if (!active) continue;
#pragma unroll 1
      for (int ks = 0; ks < nk; ks += 16) {
        float s[2][4];
        scores(ks, s);
        uint32_t pa[4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const bool ok0 = ks + 8 * nt + 2 * t < nk;
          const bool ok1 = ks + 8 * nt + 2 * t + 1 < nk;
          const float p0 = ok0 ? expf(s[nt][0] * scale - ls[0]) : 0.0f;
          const float p1 = ok1 ? expf(s[nt][1] * scale - ls[0]) : 0.0f;
          const float p2 = ok0 ? expf(s[nt][2] * scale - ls[1]) : 0.0f;
          const float p3 = ok1 ? expf(s[nt][3] * scale - ls[1]) : 0.0f;
          pa[2 * nt] = pack_bf16(p0, p1);
          pa[2 * nt + 1] = pack_bf16(p2, p3);
        }
#pragma unroll
        for (int nd = 0; nd < ND; nd += 2) {
          uint32_t f[4];
          ldsm_x4_t(f, Vs + (ks + li + 8 * lb) * LD + 8 * (nd + lc));
          mma_bf16(o[nd], pa, f[0], f[1]);
          if (nd + 1 < ND) mma_bf16(o[nd + 1], pa, f[2], f[3]);
        }
      }
    }

    if (!active) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row >= Lq) continue;
      float* dst = out + ((int64_t)b * Lq + row) * stride + col;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
        io::st2(dst + 8 * nd + 2 * t, o[nd][2 * r], o[nd][2 * r + 1]);
      if (t == 0 && lse != nullptr)
        lse[((int64_t)b * heads + head) * Lq + row] = ls[r];
    }
  }
}

// ---- backward, bf16 mode, on the tensor cores ----

constexpr size_t bwd_mma_smem(int D, int NW) {
  const int LD = (D < 16 ? 16 : D) + PAD, KB = NW * 16;
  return (size_t)(2 * KB * LD + 2 * QT * LD + KB * (QT + PAD)) * 2 +
         2 * QT * sizeof(float);
}

// bf16 pair `run` + the pair (a, b) rounded to bf16, rounded again (the
// first block: the rounded pair alone).
__device__ __forceinline__ uint32_t accum_bf16(uint32_t run, float a, float b,
                                               bool first) {
  const uint32_t part = pack_bf16(a, b);
  if (first) return part;
  const float2 r = io::widen2(run), p = io::widen2(part);
  return pack_bf16(r.x + p.x, r.y + p.y);
}

constexpr int BQ = 128;   // the TPU kernel's query block (dK, dV rounding)
static_assert(BQ % QT == 0, "a query block is whole tiles");

// dq_part: null with one key split (dq written in place), else the f32
// scratch for the partial dQ of each split, `split_stride` floats apart.
template <typename T, int D, int NW>
__global__ void __launch_bounds__(NW * 32, (NW == 8 && D < 64) ? 2 : 1)
bwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ o,
               const T* __restrict__ dout, const float* __restrict__ lse,
               T* __restrict__ dq, float* __restrict__ dq_part,
               T* __restrict__ dk, T* __restrict__ dv, int Lq, int Lk, int dm,
               int heads, float scale, int64_t split_stride) {
  constexpr bool IO_BF16 = io::is_bf16<T>;
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
  const T* qb = q + (int64_t)b * Lq * stride + col;
  const T* ob = o + (int64_t)b * Lq * stride + col;
  const T* dob = dout + (int64_t)b * Lq * stride + col;
  const float* lse_b = lse + ((int64_t)b * heads + head) * Lq;
  const int64_t krow0 = ((int64_t)b * Lk + key0) * stride + col;
  T* dqb = dq + (int64_t)b * Lq * stride + col;
  float* dqp = dq_part == nullptr ? nullptr
               : dq_part + split * split_stride + (int64_t)b * Lq * stride + col;

  load_tile_bf16<D, NTHREADS>(k + krow0, stride, nkeys, KB, Ks);
  load_tile_bf16<D, NTHREADS>(v + krow0, stride, nkeys, KB, Vs);
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
  // bf16 I/O: the running bf16 sums of dK and dV over the query blocks
  // done, as pairs (accumulator elements 2 h, 2 h + 1); the accumulators
  // then hold the current block's partial.
  uint32_t dk_run[ND][2] = {}, dv_run[ND][2] = {};
  auto flush = [&](bool first) {
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        dk_run[nd][h] = accum_bf16(dk_run[nd][h], dk_acc[nd][2 * h],
                                   dk_acc[nd][2 * h + 1], first);
        dv_run[nd][h] = accum_bf16(dv_run[nd][h], dv_acc[nd][2 * h],
                                   dv_acc[nd][2 * h + 1], first);
        dk_acc[nd][2 * h] = dk_acc[nd][2 * h + 1] = 0.0f;
        dv_acc[nd][2 * h] = dv_acc[nd][2 * h + 1] = 0.0f;
      }
  };

  for (int q0 = 0; q0 < Lq; q0 += QT) {
    const int nq = min(QT, Lq - q0);
    // Stage Q and dO (the previous tile's readers are past the barrier that
    // ended phase 1), with delta = sum_d dO * O of the unrounded values.
    load_tile_bf16<D, NTHREADS>(qb + (int64_t)q0 * stride, stride, nq, QT,
                                Qs);
    constexpr int ITEMS = QT * C4;
#pragma unroll
    for (int it = 0; it < (ITEMS + NTHREADS - 1) / NTHREADS; ++it) {
      const int i = tid + it * NTHREADS;
      const int r = i / C4, c = (i % C4) * 4;
      const bool in = i < ITEMS;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), y = a;
      if (in && r < nq && c < D) {
        const int64_t at = (int64_t)(q0 + r) * stride + c;
        a = io::ld4(dob + at);
        y = io::ld4(ob + at);
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
      if constexpr (IO_BF16) {
        if ((q0 + QT) % BQ == 0 || q0 + QT >= Lq) flush(q0 < BQ);
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
            if (row >= Lq) continue;
            const int64_t at = (int64_t)row * stride + 8 * (nd + j) + 2 * t;
            if (dqp != nullptr)
              *reinterpret_cast<float2*>(dqp + at) =
                  make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
            else
              io::st2(dqb + at, acc[j][2 * half], acc[j][2 * half + 1]);
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
        if constexpr (IO_BF16) {
          *reinterpret_cast<uint32_t*>(dk + at) = dk_run[nd][half];
          *reinterpret_cast<uint32_t*>(dv + at) = dv_run[nd][half];
        } else {
          io::st2(dk + at, dk_acc[nd][2 * half], dk_acc[nd][2 * half + 1]);
          io::st2(dv + at, dv_acc[nd][2 * half], dv_acc[nd][2 * half + 1]);
        }
      }
    }
  }
}

// dq = the sum of the key splits' partial dQ, in the order of the splits
// (f32), rounded once to T.
template <typename T>
__global__ void sum_splits_kernel(const float4* __restrict__ part,
                                  T* __restrict__ dq, int64_t n4,
                                  int splits) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 a = part[i];
  for (int s = 1; s < splits; ++s) {
    const float4 b = part[s * n4 + i];
    a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
  }
  io::st4(dq + 4 * i, a);
}

// Warps (of 16 keys each) of a bf16-mode backward block: 16 when that
// holds the whole of a longer Lk in one block; d = 64 keeps 8, whose
// accumulators then have 255 registers to live in.
int bwd_warps(int Lk, int D) { return (Lk > 128 && D < 64) ? 16 : 8; }

int bwd_splits(int Lk, int D) {
  const int kb = bwd_warps(Lk, D) * 16;
  return (Lk + kb - 1) / kb;
}

template <typename T, int D, int NW>
int launch_bwd_mma(const T* q, const T* k, const T* v, const T* o,
                   const T* dout, const float* lse, T* dq, T* dk, T* dv,
                   float* scratch, int B, int Lq, int Lk, int dm, int heads,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = bwd_mma_smem(D, NW);
  cudaError_t e = cudaFuncSetAttribute(
      bwd_mma_kernel<T, D, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int splits = (Lk + NW * 16 - 1) / (NW * 16);
  const int64_t n = (int64_t)B * Lq * dm;
  dim3 grid(splits, B, heads);
  bwd_mma_kernel<T, D, NW><<<grid, NW * 32, smem, stream>>>(
      q, k, v, o, dout, lse, dq, splits > 1 ? scratch : nullptr, dk, dv, Lq,
      Lk, dm, heads, scale, splits > 1 ? n : 0);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const int64_t n4 = n / 4;
  sum_splits_kernel<T><<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(scratch), dq, n4, splits);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_bwd_bf16(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const float* lse,
                    void* dq, void* dk, void* dv, float* scratch, int B,
                    int Lq, int Lk, int dm, int heads, float scale,
                    cudaStream_t stream) {
  const T *q_ = static_cast<const T*>(q), *k_ = static_cast<const T*>(k),
          *v_ = static_cast<const T*>(v), *o_ = static_cast<const T*>(o),
          *do_ = static_cast<const T*>(dout);
  T *dq_ = static_cast<T*>(dq), *dk_ = static_cast<T*>(dk),
    *dv_ = static_cast<T*>(dv);
  if constexpr (D < 64) {
    if (bwd_warps(Lk, D) == 16)
      return launch_bwd_mma<T, D, 16>(q_, k_, v_, o_, do_, lse, dq_, dk_, dv_,
                                      scratch, B, Lq, Lk, dm, heads, scale,
                                      stream);
  }
  return launch_bwd_mma<T, D, 8>(q_, k_, v_, o_, do_, lse, dq_, dk_, dv_,
                                 scratch, B, Lq, Lk, dm, heads, scale, stream);
}

// The bf16 wgmma backward (Lk <= 256): bf16 tensors, or (the checks) the
// bf16 mode's f32 tensors.
template <typename T, int D>
int launch_bwd_wgmma(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     void* dq, void* dk, void* dv, int B, int Lq, int Lk,
                     int dm, int heads, float scale, cudaStream_t stream) {
  return packed_bwd_bf16::launch_bwd<T, D>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), B, Lq, Lk, dm, heads, scale,
      stream);
}

// ---- backward, f32 mode: the strided flash kernels on the packed layout,
// on f32 tensors (T = float) or bf16 ones (T = bf16) ----

template <int DT, typename T>
int launch_bwd_f32(const void* q_, const void* k_, const void* v_,
                   const void* o_, const void* dout_, const float* lse,
                   void* dq_, void* dk_, void* dv_, float* delta, int B,
                   int Lq, int Lk, int dm, int heads, float scale,
                   cudaStream_t stream) {
  const T *q = static_cast<const T*>(q_), *k = static_cast<const T*>(k_),
          *v = static_cast<const T*>(v_), *o = static_cast<const T*>(o_),
          *dout = static_cast<const T*>(dout_);
  T *dq = static_cast<T*>(dq_), *dk = static_cast<T*>(dk_),
    *dv = static_cast<T*>(dv_);
  const int D = dm / heads;
  // (B, L, heads * D) read as (B, heads, L, D): batch, head, row strides.
  const flash::Strides sq{(long long)Lq * dm, D, dm};
  const flash::Strides sk{(long long)Lk * dm, D, dm};
  const int e = flash::launch_bwd_dq<DT, T>(q, k, v, o, dout, lse, dq, delta,
                                            sq, sk, sk, sq, sq, sq, B, heads,
                                            Lq, Lk, D, scale, stream);
  if (e != 0) return e;
  return flash::launch_bwd_dkv<DT, T>(q, k, v, dout, lse, delta, dk, dv, sq,
                                      sk, sk, sq, sk, sk, B, heads, Lq, Lk, D,
                                      scale, stream);
}

// bf16 mode on f32 tensors.
template <int D>
int launch_fwd_mma(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Lq, int Lk, int dm, int heads,
                   float scale, cudaStream_t stream) {
  const int kc = Lk < KC ? (Lk + 15) & ~15 : KC;
  const size_t smem = fwd_mma_smem(D, kc);
  cudaError_t e = cudaFuncSetAttribute(
      fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)fwd_mma_smem(D, KC));
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Lq + FQ - 1) / FQ, B, heads);
  fwd_mma_kernel<D><<<grid, FNW * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, Lq, Lk, dm,
      heads, scale, kc);
  return (int)cudaGetLastError();
}

// bf16 tensors: the bf16 wgmma forward.
template <int D>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* out,
                     float* lse, int B, int Lq, int Lk, int dm, int heads,
                     float scale, cudaStream_t stream) {
  return packed_bf16::launch_fwd<D>(
      static_cast<const io::bf16*>(q), static_cast<const io::bf16*>(k),
      static_cast<const io::bf16*>(v), static_cast<io::bf16*>(out), lse, B,
      Lq, Lk, dm, heads, scale, stream);
}

// f32 mode: the strided forward of flash_kernels.cuh on the packed layout,
// on f32 tensors (T = float) or bf16 ones (T = bf16).
template <int DT, typename T>
int launch_fwd_f32(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Lq, int Lk, int dm, int heads,
                   float scale, cudaStream_t stream) {
  const int D = dm / heads;
  if ((int64_t)B * heads * ((Lq + flash::TQ - 1) / flash::TQ) >= 2147483647LL)
    return (int)cudaErrorInvalidValue;
  // (B, L, heads * D) read as (B, heads, L, D): batch, head, row strides.
  const flash::Strides sq{(long long)Lq * dm, D, dm};
  const flash::Strides sk{(long long)Lk * dm, D, dm};
  return flash::launch_fwd<DT, T>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, sq, sk, sk, sq, B,
      heads, Lq, Lk, D, scale, stream);
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

// The launchers' mode: f32 operands and I/O, bf16 operands with f32 I/O,
// bf16 operands and I/O, or f32 operands with bf16 I/O.
enum Mode { kF32 = 0, kBf16 = 1, kBf16Io = 2, kF32Bf16Io = 3 };

// q, out (B, Lq, dm), k, v (B, Lk, dm): contiguous, 16-byte aligned; bf16
// in modes kBf16Io and kF32Bf16Io, else f32; dm a multiple of 128, head dim
// dm / heads in {8, 16, 32, 64}. lse, if not null, receives the softmax's
// logsumexp, (B, heads, Lq), f32.
extern "C" int packed_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int B, int Lq, int Lk, int dm, int heads, float scale, int mode,
    cudaStream_t stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0) return 0;
  if (!shape_ok(B, dm, heads) || mode < kF32 || mode > kF32Bf16Io)
    return (int)cudaErrorInvalidValue;
  if (mode == kBf16Io) {
    DISPATCH_HEAD_DIM(dm / heads, (launch_fwd_wgmma<D>(
        q, k, v, out, lse, B, Lq, Lk, dm, heads, scale, stream)))
  }
  if (mode == kBf16) {
    DISPATCH_HEAD_DIM(dm / heads, (launch_fwd_mma<D>(
        q, k, v, out, lse, B, Lq, Lk, dm, heads, scale, stream)))
  }
  if (mode == kF32Bf16Io) {
    DISPATCH_HEAD_DIM(dm / heads, (launch_fwd_f32<(D <= 32 ? 32 : 64),
                                                  io::bf16>(
        q, k, v, out, lse, B, Lq, Lk, dm, heads, scale, stream)))
  }
  DISPATCH_HEAD_DIM(dm / heads, (launch_fwd_f32<(D <= 32 ? 32 : 64), float>(
      q, k, v, out, lse, B, Lq, Lk, dm, heads, scale, stream)))
}

// Key splits of the bf16-mode backward for this shape: with more than one
// it needs `splits * B * Lq * dm` floats of scratch.
extern "C" int packed_attention_bwd_splits(int Lk, int dm, int heads) {
  return bwd_splits(Lk, dm / heads);
}

// The bf16 mode's backward kernels: by the rule (bf16 I/O with Lk <= 256
// the wgmma kernel, else bwd_mma_kernel), or one named by the checks.
enum BwdKernel { kByRule = 0, kWgmma = 1, kMma = 2 };

// As the forward, plus o = its output, lse = its logsumexp and dout
// (B, Lq, dm); writes dq (B, Lq, dm), dk, dv (B, Lk, dm), all in the
// forward's element type. scratch (f32): in the f32 modes B * heads * Lq
// floats (delta); in bf16 mode on bwd_mma_kernel the partial dQ of the key
// splits when there is more than one, else unused. kernel (bf16 modes): a
// BwdKernel; the wgmma kernel takes Lk <= 256.
extern "C" int packed_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    float* scratch, int B, int Lq, int Lk, int dm, int heads, float scale,
    int mode, int kernel, cudaStream_t stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0) return 0;
  if (!shape_ok(B, dm, heads) || mode < kF32 || mode > kF32Bf16Io ||
      kernel < kByRule || kernel > kMma ||
      ((mode == kF32 || mode == kF32Bf16Io) && kernel != kByRule))
    return (int)cudaErrorInvalidValue;
  if (kernel == kWgmma || (kernel == kByRule && mode == kBf16Io &&
                           Lk <= packed_bwd_bf16::MAX_WG *
                                     packed_bwd_bf16::KEYS)) {
    if (mode == kBf16Io) {
      DISPATCH_HEAD_DIM(dm / heads, (launch_bwd_wgmma<io::bf16, D>(
          q, k, v, o, dout, lse, dq, dk, dv, B, Lq, Lk, dm, heads, scale,
          stream)))
    }
    DISPATCH_HEAD_DIM(dm / heads, (launch_bwd_wgmma<float, D>(
        q, k, v, o, dout, lse, dq, dk, dv, B, Lq, Lk, dm, heads, scale,
        stream)))
  }
  if (mode == kBf16Io) {
    DISPATCH_HEAD_DIM(dm / heads, (launch_bwd_bf16<io::bf16, D>(
        q, k, v, o, dout, lse, dq, dk, dv, scratch, B, Lq, Lk, dm, heads,
        scale, stream)))
  }
  if (mode == kBf16) {
    DISPATCH_HEAD_DIM(dm / heads, (launch_bwd_bf16<float, D>(
        q, k, v, o, dout, lse, dq, dk, dv, scratch, B, Lq, Lk, dm, heads,
        scale, stream)))
  }
  if (mode == kF32Bf16Io) {
    if (dm / heads <= 32)
      return launch_bwd_f32<32, io::bf16>(q, k, v, o, dout, lse, dq, dk, dv,
                                          scratch, B, Lq, Lk, dm, heads,
                                          scale, stream);
    return launch_bwd_f32<64, io::bf16>(q, k, v, o, dout, lse, dq, dk, dv,
                                        scratch, B, Lq, Lk, dm, heads, scale,
                                        stream);
  }
  if (dm / heads <= 32)
    return launch_bwd_f32<32, float>(q, k, v, o, dout, lse, dq, dk, dv,
                                     scratch, B, Lq, Lk, dm, heads, scale,
                                     stream);
  return launch_bwd_f32<64, float>(q, k, v, o, dout, lse, dq, dk, dv, scratch,
                                   B, Lq, Lk, dm, heads, scale, stream);
}
