// Softmax attention on the (B, H, L, D) layout, forward and backward:
//   out[b, h, i] = softmax_j(q[b, h, i] . k[b, h, j] * scale) v[b, h, j]
// for any Lq, Lk and any head dim D <= 128 that is a multiple of 4.
//
// Replaces the three TPU kernels of multimodal_sc_tpu/kernels/attention.py:
// _flash_kernel (forward, out + logsumexp), _bwd_dq_kernel (dQ) and
// _bwd_dkv_kernel (fused dK/dV). There q, k, v were first copied into
// (B*H, L, 128) buffers padded to 128 lanes and 128-row blocks, and one
// program held the whole padded K and V of its (batch, head) in VMEM. None
// of that carries over: no padded copy of any operand exists here, tensors
// are read where they lie through (batch, head, row) strides (so the
// transposed views an attention module hands in need no .contiguous()), K
// and V stream through shared memory 32 rows at a time, the ragged ends of
// Lq and Lk are predicates, and the logsumexp is a plain (B, H, Lq) array.
//
// Work split, the same in all three kernels: a block is 128 threads; a row
// (a query in the forward and dQ kernels, a key in the dK/dV kernel) is
// owned by LPR = DT / 32 neighbouring lanes, DT in {32, 64, 128} the
// compiled width D is rounded up to (columns past D read as zeros and are
// never stored). Each lane keeps 32 columns of its row in registers, the
// 16-byte chunks c = i * LPR + lane_in_row, so the lanes of one row read
// neighbouring chunks of a shared-memory row (no bank conflict) and finish
// a dot product with LPR - 1 shuffle steps. Register use therefore does not
// grow with D: 32 floats per operand row whatever the head dim.
//
//   flash_fwd_kernel   one block per (batch*head, 128/LPR queries): online
//                      softmax over K tiles with a running max m and
//                      denominator l, rescaling the accumulator once per
//                      tile; writes out = acc / max(l, 1e-30) and
//                      lse = m + log(max(l, 1e-30)).
//   flash_bwd_dq_kernel  same blocks: delta = sum_d dO*O for its row (also
//                      written to a (B, H, Lq) scratch for the next kernel),
//                      P = exp(S*scale - lse) recomputed per tile,
//                      dS = P (dO V^T - delta), dQ = dS K * scale.
//   flash_bwd_dkv_kernel one block per (batch*head, 128/LPR keys) that loops
//                      over ALL query rows itself, 32 at a time through
//                      shared memory: dV = P^T dO, dK = dS^T Q * scale are
//                      written once, no atomics, the same bits every run.
//
// All arithmetic is f32 (the TPU kernels cast every operand to f32 too).
// Keys past Lk are scored -1e30 (probability exactly 0), rows past Lq or Lk
// compute on zeros and store nothing.
//
// Bound on the card: 4 B H Lq Lk D operations forward, 6 and 8 times
// B H Lq Lk D in the two backward kernels, against 4 B H (2 Lq + 2 Lk) D
// bytes and up: at Lk = 256 that is 64 operations per byte and more, above
// the f32 break-even of the card (67 TFLOP/s over 3.35 TB/s = 20), so the
// f32 FMA rate bounds it. This version runs on the FMA units from
// registers and broadcast shared-memory reads (one 16-byte load feeds four
// FMAs per lane); tensor cores are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

// Blocks of 128 / (DT / 32) rows covering L rows.
int row_blocks_for(int L, int DT) {
  const int rows = THREADS / (DT / W);
  return (L + rows - 1) / rows;
}

bool shape_ok(int B, int H, int Lq, int Lk, int D) {
  const int64_t bh = (int64_t)B * H;
  // One grid dimension holds batch*head x row blocks (at least Lq / 128).
  const int64_t longest = Lq > Lk ? Lq : Lk;
  return H > 0 && D > 0 && D % 4 == 0 && D <= 128 &&
         bh * (longest / 32 + 1) < 2147483647LL;
}

template <int DT>
int launch_fwd(const float* q, const float* k, const float* v, float* out,
               float* lse, const long long* st, int B, int H, int Lq, int Lk,
               int D, float scale, cudaStream_t stream) {
  const int rb = row_blocks_for(Lq, DT);
  flash_fwd_kernel<DT><<<B * H * rb, THREADS, 0, stream>>>(
      q, k, v, out, lse, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), H, Lq, Lk, D, rb, scale);
  return (int)cudaGetLastError();
}

template <int DT>
int launch_bwd_dq(const float* q, const float* k, const float* v,
                  const float* o, const float* dout, const float* lse,
                  float* dq, float* delta, const long long* st, int B, int H,
                  int Lq, int Lk, int D, float scale, cudaStream_t stream) {
  const int rb = row_blocks_for(Lq, DT);
  flash_bwd_dq_kernel<DT><<<B * H * rb, THREADS, 0, stream>>>(
      q, k, v, o, dout, lse, dq, delta, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), strides_at(st, 4),
      strides_at(st, 5), H, Lq, Lk, D, rb, scale);
  return (int)cudaGetLastError();
}

template <int DT>
int launch_bwd_dkv(const float* q, const float* k, const float* v,
                   const float* dout, const float* lse, const float* delta,
                   float* dk, float* dv, const long long* st, int B, int H,
                   int Lq, int Lk, int D, float scale, cudaStream_t stream) {
  const int rb = row_blocks_for(Lk, DT);
  flash_bwd_dkv_kernel<DT><<<B * H * rb, THREADS, 0, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), strides_at(st, 4),
      strides_at(st, 5), H, Lq, Lk, D, rb, scale);
  return (int)cudaGetLastError();
}

}  // namespace

#define DISPATCH_HEAD_TILE(D_, CALL)                      \
  if ((D_) <= 32) { constexpr int DT = 32; return CALL; } \
  if ((D_) <= 64) { constexpr int DT = 64; return CALL; } \
  { constexpr int DT = 128; return CALL; }

// q, out (B, H, Lq, D), k, v (B, H, Lk, D): f32, last dim contiguous, every
// other stride a multiple of 4 floats and every base 16-byte aligned.
// `strides`: (batch, head, row) strides in floats of q, k, v, out, on the
// host. lse (B, H, Lq) f32 contiguous. D a multiple of 4, at most 128.
extern "C" int flash_attention_fwd_launch(
    const float* q, const float* k, const float* v, float* out, float* lse,
    const long long* strides, int B, int H, int Lq, int Lk, int D, float scale,
    cudaStream_t stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0) return 0;
  if (!shape_ok(B, H, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  DISPATCH_HEAD_TILE(D, (launch_fwd<DT>(q, k, v, out, lse, strides, B, H, Lq,
                                        Lk, D, scale, stream)))
}

// dQ: as above, plus o = the forward's output, dout (B, H, Lq, D) and the
// forward's lse; writes dq (B, H, Lq, D) and delta (B, H, Lq) = rowsum(dO*O)
// for the dK/dV kernel. `strides`: of q, k, v, o, dout, dq.
extern "C" int flash_attention_bwd_dq_launch(
    const float* q, const float* k, const float* v, const float* o,
    const float* dout, const float* lse, float* dq, float* delta,
    const long long* strides, int B, int H, int Lq, int Lk, int D, float scale,
    cudaStream_t stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0) return 0;
  if (!shape_ok(B, H, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  DISPATCH_HEAD_TILE(D, (launch_bwd_dq<DT>(q, k, v, o, dout, lse, dq, delta,
                                           strides, B, H, Lq, Lk, D, scale,
                                           stream)))
}

// dK and dV (B, H, Lk, D) from the forward's lse and the dQ kernel's delta.
// `strides`: of q, k, v, dout, dk, dv.
extern "C" int flash_attention_bwd_dkv_launch(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* delta, float* dk, float* dv,
    const long long* strides, int B, int H, int Lq, int Lk, int D, float scale,
    cudaStream_t stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0) return 0;
  if (!shape_ok(B, H, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  DISPATCH_HEAD_TILE(D, (launch_bwd_dkv<DT>(q, k, v, dout, lse, delta, dk, dv,
                                            strides, B, H, Lq, Lk, D, scale,
                                            stream)))
}
