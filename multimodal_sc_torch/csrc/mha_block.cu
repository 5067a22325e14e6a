// Whole-MHA-span fused block:
//   out = x_q + softmax(LN_q(x_q) Wq (LN_kv(x_kv) Wk)^T * scale)
//               LN_kv(x_kv) Wv Wo + bo
// with the heads packed in the 128-wide model dim.
//
// Replaces the TPU kernel multimodal_sc_tpu/kernels/mha_block.py
// (_fwd_impl / _block_kernel). On the TPU one program per batch element
// held the whole K and V in VMEM and ran lane-masked full-width matmuls per
// head. Here a block has at most 227 KB of shared memory, and f32 K and V
// for Lk = 256 alone take 256 KB, so the work is cut in two launches:
//   1. kv_proj_kernel: LN_kv + the K and V projections, 32 rows per block,
//      into a scratch buffer the wrapper allocates (B, Lk, 128) x 2;
//   2. attn_kernel: one block per (batch element, tile of 32 query rows):
//      LN_q + Q projection into shared memory, then K/V streamed in tiles
//      of 32 keys with an online softmax (running max and denominator), so
//      any Lk works (block_eligible allows up to 2048); then the output
//      projection with the residual and bo fused, written once.
// Each warp owns one head (or more when d < 32); each lane owns one query
// row, so a score is a dot product of a row kept in registers with a key
// read from shared memory by every lane at once (a broadcast). Keys past
// Lk are never scored (the JAX kernel masks them with -1e30); query rows
// past Lq are computed on zeros and never stored.
//
// Precision mirrors the JAX kernel's _mm: with bf16 on, every matmul
// operand (LN outputs, weights, q, k, v, probabilities, the attention
// output) is rounded to bf16 (round to nearest even) and every sum is
// accumulated in f32; with bf16 off everything is exact f32. One
// difference in rounding order: the JAX kernel rounds the normalised
// probabilities, this one the unnormalised ones and divides at the end.
//
// Bound on the card. At the c4 shapes (B = 1024, (Lq, Lk) in {65, 256}^2)
// a batch element costs ~2 * (Lq + 2 Lk + Lq) * 128^2 + 4 Lq Lk 128 FLOPs
// against 128 * (2 Lq + Lk) * 4 bytes moved: 130-256 FLOP/byte, far above
// the f32 CUDA-core break-even (~20) and just below the bf16 tensor-core
// one (~295), so the least time is set by the bytes, and this first
// version, on the f32 FMA units (CUDA cores) and not the tensor cores, is
// bound by its operations: its design keeps operands in registers and
// shared memory (weights through the read-only cache, float4 shared
// loads) so the FMA pipe is the limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DM = 128;     // model dim: one 128-wide lane group
constexpr int RT = 32;      // rows per tile (query rows, kv rows, keys)
constexpr float kEps = 1e-6f;

template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LayerNorm of rows [row0, row0 + RT) of src (n_valid of them real) into
// dst (RT x DM, shared); missing rows read as zeros. One warp per row.
template <bool BF16>
__device__ void ln_tile(const float* __restrict__ src, int64_t row0,
                        int n_valid, const float* __restrict__ s,
                        const float* __restrict__ b, float* dst) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const float4 sc = __ldg(reinterpret_cast<const float4*>(s) + lane);
  const float4 bi = __ldg(reinterpret_cast<const float4*>(b) + lane);
  for (int r = warp; r < RT; r += nw) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_valid)
      v = __ldg(reinterpret_cast<const float4*>(src + (row0 + r) * DM) + lane);
    const float mu = warp_sum(v.x + v.y + v.z + v.w) * (1.0f / DM);
    const float dx = v.x - mu, dy = v.y - mu, dz = v.z - mu, dw = v.w - mu;
    const float var =
        warp_sum(dx * dx + dy * dy + dz * dz + dw * dw) * (1.0f / DM);
    const float rs = rsqrtf(var + kEps);
    float4 o;
    o.x = rnd<BF16>(dx * rs * sc.x + bi.x);
    o.y = rnd<BF16>(dy * rs * sc.y + bi.y);
    o.z = rnd<BF16>(dz * rs * sc.z + bi.z);
    o.w = rnd<BF16>(dw * rs * sc.w + bi.w);
    reinterpret_cast<float4*>(dst + r * DM)[lane] = o;
  }
}

// acc[r] = sum_i src[r][i] * W[i][c] for the RT rows of a shared tile;
// W (DM x DM, row-major (in, out)) read through the read-only cache.
template <bool BF16>
__device__ __forceinline__ void proj_col(const float* src,
                                         const float* __restrict__ W, int c,
                                         float (&acc)[RT]) {
#pragma unroll
  for (int r = 0; r < RT; ++r) acc[r] = 0.0f;
  for (int i = 0; i < DM; i += 4) {
    const float w0 = rnd<BF16>(__ldg(W + (i + 0) * DM + c));
    const float w1 = rnd<BF16>(__ldg(W + (i + 1) * DM + c));
    const float w2 = rnd<BF16>(__ldg(W + (i + 2) * DM + c));
    const float w3 = rnd<BF16>(__ldg(W + (i + 3) * DM + c));
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(src + r * DM + i);
      float a = acc[r];
      a = fmaf(x.x, w0, a);
      a = fmaf(x.y, w1, a);
      a = fmaf(x.z, w2, a);
      a = fmaf(x.w, w3, a);
      acc[r] = a;
    }
  }
}

// Launch 1: K = LN_kv(x_kv) Wk + bk, V = LN_kv(x_kv) Wv + bv over the
// flattened B * Lk rows. K and V are stored already rounded (bf16 mode):
// they are used only as matmul operands.
template <bool BF16>
__global__ void __launch_bounds__(128)
kv_proj_kernel(const float* __restrict__ xkv, const float* __restrict__ lns,
               const float* __restrict__ lnb, const float* __restrict__ wk,
               const float* __restrict__ bk, const float* __restrict__ wv,
               const float* __restrict__ bv, float* __restrict__ kout,
               float* __restrict__ vout, int64_t rows) {
  __shared__ __align__(16) float xs[RT * DM];
  const int64_t row0 = (int64_t)blockIdx.x * RT;
  const int n_valid = rows - row0 < RT ? (int)(rows - row0) : RT;
  ln_tile<BF16>(xkv, row0, n_valid, lns, lnb, xs);
  __syncthreads();
  const int c = threadIdx.x;
  float acc[RT];
  proj_col<BF16>(xs, wk, c, acc);
  const float bkc = __ldg(bk + c);
  for (int r = 0; r < n_valid; ++r)
    kout[(row0 + r) * DM + c] = rnd<BF16>(acc[r] + bkc);
  proj_col<BF16>(xs, wv, c, acc);
  const float bvc = __ldg(bv + c);
  for (int r = 0; r < n_valid; ++r)
    vout[(row0 + r) * DM + c] = rnd<BF16>(acc[r] + bvc);
}

// Launch 2: one block (4 warps) per (query tile, batch element).
template <int D, bool BF16>
__global__ void __launch_bounds__(128)
attn_kernel(const float* __restrict__ xq, const float* __restrict__ lns,
            const float* __restrict__ lnb, const float* __restrict__ wq,
            const float* __restrict__ bq, const float* __restrict__ kbuf,
            const float* __restrict__ vbuf, const float* __restrict__ wo,
            const float* __restrict__ bo, float* __restrict__ out, int Lq,
            int Lk, float scale) {
  constexpr int H = DM / D;                   // heads
  constexpr int HPW = H >= 4 ? H / 4 : 1;     // heads per warp
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                 // LN_q(x_q) tile, later the attention out
  float* qs = xs + RT * DM;         // q tile
  float* ks = qs + RT * DM;         // key tile
  float* vs = ks + RT * DM;         // value tile

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * RT;
  const int nq = min(RT, Lq - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = threadIdx.x;
  const float* xqb = xq + (int64_t)b * Lq * DM;
  const float* kb = kbuf + (int64_t)b * Lk * DM;
  const float* vb = vbuf + (int64_t)b * Lk * DM;

  ln_tile<BF16>(xqb, q0, nq, lns, lnb, xs);
  __syncthreads();
  {
    float acc[RT];
    proj_col<BF16>(xs, wq, c, acc);
    const float bqc = __ldg(bq + c);
#pragma unroll
    for (int r = 0; r < RT; ++r) qs[r * DM + c] = rnd<BF16>(acc[r] + bqc);
  }
  __syncthreads();

  // Per-lane state: this lane's query row, for each head of this warp.
  const bool active = warp * HPW < H;
  float q[HPW][D], o[HPW][D], m[HPW], l[HPW];
#pragma unroll
  for (int hh = 0; hh < HPW; ++hh) {
    const int h = warp * HPW + hh;
    m[hh] = -INFINITY;
    l[hh] = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      q[hh][d] = active ? qs[lane * DM + h * D + d] : 0.0f;
      o[hh][d] = 0.0f;
    }
  }

  for (int k0 = 0; k0 < Lk; k0 += RT) {
    const int nk = min(RT, Lk - k0);
    __syncthreads();   // previous tile fully consumed
    for (int i = threadIdx.x; i < RT * DM / 4; i += blockDim.x) {
      const int r = i / (DM / 4);
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (r < nk) {
        kv = __ldg(reinterpret_cast<const float4*>(kb + (int64_t)k0 * DM) + i);
        vv = __ldg(reinterpret_cast<const float4*>(vb + (int64_t)k0 * DM) + i);
      }
      reinterpret_cast<float4*>(ks)[i] = kv;
      reinterpret_cast<float4*>(vs)[i] = vv;
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh) {
      const int hoff = (warp * HPW + hh) * D;
      float s[RT];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const float* kr = ks + j * DM + hoff;
        float a = 0.0f;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
          a = fmaf(q[hh][d], k4.x, a);
          a = fmaf(q[hh][d + 1], k4.y, a);
          a = fmaf(q[hh][d + 2], k4.z, a);
          a = fmaf(q[hh][d + 3], k4.w, a);
        }
        s[j] = j < nk ? a * scale : -INFINITY;
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m[hh], mx);
      const float corr = expf(m[hh] - m_new);   // 0 on the first tile
      l[hh] *= corr;
#pragma unroll
      for (int d = 0; d < D; ++d) o[hh][d] *= corr;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const float p = expf(s[j] - m_new);      // 0 for keys past Lk
        l[hh] += p;
        const float pr = rnd<BF16>(p);
        const float* vr = vs + j * DM + hoff;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(vr + d);
          o[hh][d] = fmaf(pr, v4.x, o[hh][d]);
          o[hh][d + 1] = fmaf(pr, v4.y, o[hh][d + 1]);
          o[hh][d + 2] = fmaf(pr, v4.z, o[hh][d + 2]);
          o[hh][d + 3] = fmaf(pr, v4.w, o[hh][d + 3]);
        }
      }
      m[hh] = m_new;
    }
  }

  // Attention output (normalised, rounded) into xs, then out-projection.
  if (active) {
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh) {
      const int hoff = (warp * HPW + hh) * D;
      const float inv = 1.0f / l[hh];
#pragma unroll
      for (int d = 0; d < D; ++d)
        xs[lane * DM + hoff + d] = rnd<BF16>(o[hh][d] * inv);
    }
  }
  __syncthreads();
  float acc[RT];
  proj_col<BF16>(xs, wo, c, acc);
  const float boc = __ldg(bo + c);
  float* ob = out + (int64_t)b * Lq * DM;
  for (int r = 0; r < nq; ++r) {
    const int64_t off = (int64_t)(q0 + r) * DM + c;
    ob[off] = (xqb[off] + acc[r]) + boc;
  }
}

template <int D, bool BF16>
int launch_attn(const float* xq, const float* lns, const float* lnb,
                const float* wq, const float* bq, const float* kbuf,
                const float* vbuf, const float* wo, const float* bo,
                float* out, int B, int Lq, int Lk, float scale,
                cudaStream_t stream) {
  const size_t smem = 4 * RT * DM * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      attn_kernel<D, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Lq + RT - 1) / RT, B);
  attn_kernel<D, BF16><<<grid, 128, smem, stream>>>(
      xq, lns, lnb, wq, bq, kbuf, vbuf, wo, bo, out, Lq, Lk, scale);
  return (int)cudaGetLastError();
}

template <bool BF16>
int launch_all(const float* xq, const float* xkv, const float* lnqs,
               const float* lnqb, const float* lnks, const float* lnkb,
               const float* wq, const float* bq, const float* wk,
               const float* bk, const float* wv, const float* bv,
               const float* wo, const float* bo, float* kbuf, float* vbuf,
               float* out, int B, int Lq, int Lk, int heads, float scale,
               cudaStream_t stream) {
  const int64_t rows = (int64_t)B * Lk;
  kv_proj_kernel<BF16><<<(unsigned)((rows + RT - 1) / RT), 128, 0, stream>>>(
      xkv, lnks, lnkb, wk, bk, wv, bv, kbuf, vbuf, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  switch (DM / heads) {
    case 8:
      return launch_attn<8, BF16>(xq, lnqs, lnqb, wq, bq, kbuf, vbuf, wo, bo,
                                  out, B, Lq, Lk, scale, stream);
    case 16:
      return launch_attn<16, BF16>(xq, lnqs, lnqb, wq, bq, kbuf, vbuf, wo,
                                   bo, out, B, Lq, Lk, scale, stream);
    case 32:
      return launch_attn<32, BF16>(xq, lnqs, lnqb, wq, bq, kbuf, vbuf, wo,
                                   bo, out, B, Lq, Lk, scale, stream);
    case 64:
      return launch_attn<64, BF16>(xq, lnqs, lnqb, wq, bq, kbuf, vbuf, wo,
                                   bo, out, B, Lq, Lk, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x_q (B, Lq, 128), x_kv (B, Lk, 128), weights (128, 128) (in, out),
// vectors (128,), scratch kbuf / vbuf (B, Lk, 128), out (B, Lq, 128); all
// f32, contiguous, 16-byte aligned. heads in {2, 4, 8, 16}.
extern "C" int mha_block_launch(
    const float* xq, const float* xkv, const float* lnqs, const float* lnqb,
    const float* lnks, const float* lnkb, const float* wq, const float* bq,
    const float* wk, const float* bk, const float* wv, const float* bv,
    const float* wo, const float* bo, float* kbuf, float* vbuf, float* out,
    int B, int Lq, int Lk, int heads, float scale, int bf16,
    cudaStream_t stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0) return 0;
  if (bf16)
    return launch_all<true>(xq, xkv, lnqs, lnqb, lnks, lnkb, wq, bq, wk, bk,
                            wv, bv, wo, bo, kbuf, vbuf, out, B, Lq, Lk, heads,
                            scale, stream);
  return launch_all<false>(xq, xkv, lnqs, lnqb, lnks, lnkb, wq, bq, wk, bk,
                           wv, bv, wo, bo, kbuf, vbuf, out, B, Lq, Lk, heads,
                           scale, stream);
}
