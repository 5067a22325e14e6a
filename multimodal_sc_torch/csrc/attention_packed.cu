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
// Backward, two grid launches on one stream, no atomics, so the result is
// the same from run to run:
//   1. bwd_dq_kernel, blocks as the forward: recomputes the softmax
//      statistics (nothing but q, k, v, out is saved), writes logsumexp and
//      delta = sum_d dO*O over THIS head's columns to a scratch buffer the
//      wrapper allocates (B, H, Lq) x 2, then streams K and V again for dq.
//   2. bwd_dkv_kernel: one block per (32 keys, batch element, group); a lane
//      owns one key row (k, v, dk, dv in registers) and the block loops over
//      all query rows itself, 32 at a time through shared memory, so dk and
//      dv are written once.
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
// tensor-core break-even (~295), so the least time is set by the bytes.
// This first version computes on the f32 FMA units (CUDA cores) and does
// the Q K^T product twice (two-pass softmax), so it is bound by its
// operations; operands stay in registers and shared memory (float4 loads)
// so the FMA pipe is the limit. Tensor cores (mma / wgmma) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
           const float* __restrict__ v, float* __restrict__ out, int Lq,
           int Lk, int dm, float scale) {
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
    for (int hh = 0; hh < HPW; ++hh) store_row<D>(out + row + hh * D, o[hh]);
  }
}

// Backward launch 1: dq, and the per-(head, row) logsumexp and delta.
template <int D, bool BF16>
__global__ void __launch_bounds__(128)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ o,
              const float* __restrict__ dout, float* __restrict__ dq,
              float* __restrict__ lse, float* __restrict__ delta, int Lq,
              int Lk, int dm, int heads, float scale) {
  constexpr int H = GW / D;
  constexpr int HPW = H >= 4 ? H / 4 : 1;
  __shared__ __align__(16) float ks[RT * GW];
  __shared__ __align__(16) float vs[RT * GW];

  const int b = blockIdx.y, g = blockIdx.z;
  const int q0 = blockIdx.x * RT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool active = warp * HPW < H;
  const bool has_row = active && q0 + lane < Lq;
  const int hoff = warp * HPW * D;
  const int64_t stride = dm;
  const int64_t row = ((int64_t)b * Lq + q0 + lane) * stride + g * GW + hoff;
  const float* kb = k + (int64_t)b * Lk * stride + g * GW;
  const float* vb = v + (int64_t)b * Lk * stride + g * GW;

  float qr[HPW][D], dor[HPW][D], dl[HPW];
#pragma unroll
  for (int hh = 0; hh < HPW; ++hh) {
    load_row<D, BF16>(q + row + hh * D, has_row, qr[hh]);
    // delta from the unrounded dO and O; dO is then rounded as an operand.
    float orow[D];
    load_row<D, false>(dout + row + hh * D, has_row, dor[hh]);
    load_row<D, false>(o + row + hh * D, has_row, orow);
    float acc = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      acc = fmaf(dor[hh][d], orow[d], acc);
      dor[hh][d] = rnd<BF16>(dor[hh][d]);
    }
    dl[hh] = acc;
  }

  float m[HPW], l[HPW];
  softmax_stats<D, HPW, BF16>(kb, stride, Lk, scale, qr, hoff, active, ks, m,
                              l);
  float ls[HPW], acc_dq[HPW][D];
#pragma unroll
  for (int hh = 0; hh < HPW; ++hh) {
    ls[hh] = m[hh] + logf(l[hh]);
    if (has_row) {
      const int head = g * H + warp * HPW + hh;
      const int64_t at = ((int64_t)b * heads + head) * Lq + q0 + lane;
      lse[at] = ls[hh];
      delta[at] = dl[hh];
    }
#pragma unroll
    for (int d = 0; d < D; ++d) acc_dq[hh][d] = 0.0f;
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
        const float p = expf(s - ls[hh]);
        const float dp = dot_row<D>(dor[hh], vh + j * GW);
        const float ds = rnd<BF16>(p * (dp - dl[hh]) * scale);
        axpy_row<D>(ds, kh + j * GW, acc_dq[hh]);
      }
    }
  }
  if (has_row) {
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh)
      store_row<D>(dq + row + hh * D, acc_dq[hh]);
  }
}

// Backward launch 2: dk and dv of 32 keys, looping over every query row.
template <int D, bool BF16>
__global__ void __launch_bounds__(128)
bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, int Lq, int Lk,
               int dm, int heads, float scale) {
  constexpr int H = GW / D;
  constexpr int HPW = H >= 4 ? H / 4 : 1;
  __shared__ __align__(16) float qs[RT * GW];
  __shared__ __align__(16) float dos[RT * GW];
  __shared__ float lse_s[H * RT];
  __shared__ float delta_s[H * RT];

  const int b = blockIdx.y, g = blockIdx.z;
  const int k0 = blockIdx.x * RT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool active = warp * HPW < H;
  const bool has_key = active && k0 + lane < Lk;
  const int hoff = warp * HPW * D;
  const int64_t stride = dm;
  const int64_t row = ((int64_t)b * Lk + k0 + lane) * stride + g * GW + hoff;
  const float* qb = q + (int64_t)b * Lq * stride + g * GW;
  const float* dob = dout + (int64_t)b * Lq * stride + g * GW;
  const int64_t stat0 = ((int64_t)b * heads + g * H) * Lq;

  float kr[HPW][D], vr[HPW][D], acc_dk[HPW][D], acc_dv[HPW][D];
#pragma unroll
  for (int hh = 0; hh < HPW; ++hh) {
    load_row<D, BF16>(k + row + hh * D, has_key, kr[hh]);
    load_row<D, BF16>(v + row + hh * D, has_key, vr[hh]);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      acc_dk[hh][d] = 0.0f;
      acc_dv[hh][d] = 0.0f;
    }
  }

  for (int q0 = 0; q0 < Lq; q0 += RT) {
    const int nq = min(RT, Lq - q0);
    __syncthreads();
    load_tile<BF16>(qb + (int64_t)q0 * stride, stride, nq, qs);
    load_tile<BF16>(dob + (int64_t)q0 * stride, stride, nq, dos);
    for (int i = threadIdx.x; i < H * RT; i += blockDim.x) {
      const int h = i / RT, r = i % RT;
      const bool ok = r < nq;
      lse_s[i] = ok ? lse[stat0 + (int64_t)h * Lq + q0 + r] : 0.0f;
      delta_s[i] = ok ? delta[stat0 + (int64_t)h * Lq + q0 + r] : 0.0f;
    }
    __syncthreads();
    // Lanes past Lk compute on zero keys and store nothing.
    if (!active) continue;
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh) {
      const int h = warp * HPW + hh;
      const float* qh = qs + hoff + hh * D;
      const float* doh = dos + hoff + hh * D;
      for (int i = 0; i < nq; ++i) {
        const float s = dot_row<D>(kr[hh], qh + i * GW) * scale;
        const float p = expf(s - lse_s[h * RT + i]);
        const float dp = dot_row<D>(vr[hh], doh + i * GW);
        const float ds = p * (dp - delta_s[h * RT + i]) * scale;
        axpy_row<D>(rnd<BF16>(p), doh + i * GW, acc_dv[hh]);
        axpy_row<D>(rnd<BF16>(ds), qh + i * GW, acc_dk[hh]);
      }
    }
  }
  if (has_key) {
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh) {
      store_row<D>(dk + row + hh * D, acc_dk[hh]);
      store_row<D>(dv + row + hh * D, acc_dv[hh]);
    }
  }
}

template <int D, bool BF16>
int launch_fwd(const float* q, const float* k, const float* v, float* out,
               int B, int Lq, int Lk, int dm, float scale,
               cudaStream_t stream) {
  dim3 grid((Lq + RT - 1) / RT, B, dm / GW);
  fwd_kernel<D, BF16><<<grid, 128, 0, stream>>>(q, k, v, out, Lq, Lk, dm,
                                                 scale);
  return (int)cudaGetLastError();
}

template <int D, bool BF16>
int launch_bwd(const float* q, const float* k, const float* v, const float* o,
               const float* dout, float* dq, float* dk, float* dv, float* lse,
               float* delta, int B, int Lq, int Lk, int dm, int heads,
               float scale, cudaStream_t stream) {
  dim3 grid_q((Lq + RT - 1) / RT, B, dm / GW);
  bwd_dq_kernel<D, BF16><<<grid_q, 128, 0, stream>>>(
      q, k, v, o, dout, dq, lse, delta, Lq, Lk, dm, heads, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 grid_k((Lk + RT - 1) / RT, B, dm / GW);
  bwd_dkv_kernel<D, BF16><<<grid_k, 128, 0, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, Lq, Lk, dm, heads, scale);
  return (int)cudaGetLastError();
}

bool shape_ok(int B, int dm, int heads) {
  return B <= 65535 && heads > 0 && dm % GW == 0 && dm / GW <= 65535 &&
         dm % heads == 0;
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
// dm a multiple of 128, head dim dm / heads in {8, 16, 32, 64}.
extern "C" int packed_attention_fwd_launch(
    const float* q, const float* k, const float* v, float* out, int B, int Lq,
    int Lk, int dm, int heads, float scale, int bf16, cudaStream_t stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0) return 0;
  if (!shape_ok(B, dm, heads)) return (int)cudaErrorInvalidValue;
  if (bf16) {
    DISPATCH_HEAD_DIM(dm / heads, (launch_fwd<D, true>(
        q, k, v, out, B, Lq, Lk, dm, scale, stream)))
  }
  DISPATCH_HEAD_DIM(dm / heads, (launch_fwd<D, false>(
      q, k, v, out, B, Lq, Lk, dm, scale, stream)))
}

// As above, plus o = the forward's output and dout (B, Lq, dm); writes dq
// (B, Lq, dm), dk, dv (B, Lk, dm); lse and delta are scratch (B, heads, Lq).
extern "C" int packed_attention_bwd_launch(
    const float* q, const float* k, const float* v, const float* o,
    const float* dout, float* dq, float* dk, float* dv, float* lse,
    float* delta, int B, int Lq, int Lk, int dm, int heads, float scale,
    int bf16, cudaStream_t stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0) return 0;
  if (!shape_ok(B, dm, heads)) return (int)cudaErrorInvalidValue;
  if (bf16) {
    DISPATCH_HEAD_DIM(dm / heads, (launch_bwd<D, true>(
        q, k, v, o, dout, dq, dk, dv, lse, delta, B, Lq, Lk, dm, heads, scale,
        stream)))
  }
  DISPATCH_HEAD_DIM(dm / heads, (launch_bwd<D, false>(
      q, k, v, o, dout, dq, dk, dv, lse, delta, B, Lq, Lk, dm, heads, scale,
      stream)))
}
