// Device code of the f32 softmax-attention kernels: forward, dQ and dK/dV
// on any (batch, head, row)-strided layout. flash_attention.cu documents
// the design and launches all three on (B, H, L, D) tensors;
// attention_packed.cu launches the two backward kernels on the packed
// (B, L, H*d) layout, which is the same thing under other strides.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

template <int DT>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
                 Strides so, int H, int Lq, int Lk, int D, int row_blocks,
                 float scale) {
  constexpr int LPR = DT / W;
  constexpr int ROWS = THREADS / LPR;
  __shared__ __align__(16) float ks[KT * DT];
  __shared__ __align__(16) float vs[KT * DT];

  const int bh = blockIdx.x / row_blocks;
  const int b = bh / H, h = bh % H;
  const int row = (blockIdx.x % row_blocks) * ROWS + threadIdx.x / LPR;
  const int seg = threadIdx.x % LPR;
  const bool has_row = row < Lq;

  float qr[W], acc[W];
  load_row<LPR>(at(q, sq, b, h, row), has_row, seg, D, qr);
#pragma unroll
  for (int d = 0; d < W; ++d) {
    qr[d] *= scale;
    acc[d] = 0.0f;
  }
  float m = NEG, l = 0.0f;
  const float* kb = at(k, sk, b, h, 0);
  const float* vb = at(v, sv, b, h, 0);

  for (int k0 = 0; k0 < Lk; k0 += KT) {
    const int nk = min(KT, Lk - k0);
    __syncthreads();   // the previous tile is fully consumed
    load_tile<DT>(kb + k0 * sk.l, sk.l, nk, D, ks);
    load_tile<DT>(vb + k0 * sv.l, sv.l, nk, D, vs);
    __syncthreads();
    float s[KT];
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float a = dot_row<LPR>(qr, ks + j * DT, seg);
      s[j] = j < nk ? a : NEG;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);   // 0 on the first tile
    l *= alpha;
#pragma unroll
    for (int d = 0; d < W; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float p = expf(s[j] - m_new);   // exactly 0 past Lk
      l += p;
      axpy_row<LPR>(p, vs + j * DT, seg, acc);
    }
    m = m_new;
  }
  if (has_row) {
    const float lc = fmaxf(l, 1e-30f);
    store_row<LPR>(at(out, so, b, h, row), seg, D, acc, 1.0f / lc);
    if (seg == 0) lse[(int64_t)bh * Lq + row] = m + logf(lc);
  }
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
