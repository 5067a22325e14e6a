// Whole-MHA-span fused block:
//   out = x_q + softmax(LN_q(x_q) Wq (LN_kv(x_kv) Wk)^T * scale)
//               LN_kv(x_kv) Wv Wo + bo
// with the heads packed in the 128-wide model dim.
//
// Replaces the TPU kernel multimodal_sc_tpu/kernels/mha_block.py
// (_fwd_impl / _block_kernel). On the TPU one program per batch element
// held the whole K and V in VMEM and ran lane-masked full-width matmuls per
// head, with bf16 operands and f32 sums (its _mm): the LN outputs, the four
// weights, q, k, v, the NORMALISED probabilities and the concatenated head
// outputs are rounded to bf16; the softmax is f32; out = (x_q + acc Wo) +
// bo in f32.
//
// Bound on the card. At the c4 shapes (B = 1024, (Lq, Lk) in {65, 256}^2)
// a batch element costs ~2 (2 Lq + 2 Lk) 128^2 + 4 Lq Lk 128 FLOPs against
// 128 (2 Lq + Lk) 4 bytes: 130-256 FLOP/byte, just below the bf16
// tensor-core break-even (~295), so the bytes set the least time. The
// kernel keeps every intermediate on chip and runs every product on the
// tensor cores; what bounds it in practice is the softmax's exponentials
// (two passes) and the shared-memory traffic that feeds mma.sync.
//
// bf16 mode (the mode of every main path): mha_mma_kernel, one launch, one
// block of 16 warps per batch element (16 for latency hiding: a block's
// 207 KB of shared memory leaves one block a multiprocessor).
//   * K and V of the element stay in shared memory, in bf16 (Lk = 256:
//     2 x 68 KB with padding; every main-path shape). LN_kv runs on 64 rows
//     at a time into a bf16 tile, and the K and V projections read it as
//     the left operand of bf16 mma.sync.m16n8k16 (ldmatrix); the weights
//     are the right operand, rounded to bf16 once per call by a small
//     kernel (pack_weights_kernel) into the order of the fragments (128 KB
//     of scratch, read from L2), each warp 16 columns of [Wk | Wv] for all
//     64 rows. Bias added in f32, k and v rounded once on the way into
//     shared memory: no other scratch in device memory. LN statistics are
//     taken in f64 (see ln_rows); the f32 rows of each LayerNorm arrive by
//     cp.async into a 32 KB tile during the phase before it.
//   * Then the queries, 64 rows at a time: LN_q into the bf16 tile, the Q
//     projection (each warp 32 rows x 16 columns), q rounded into a second
//     tile.
//   * Attention per (16-row m-tile, head): a warp owns one head and one
//     m-tile of it (two at 8 heads, four at 16), so K and V fragments
//     loaded once serve all of them. The softmax keeps the definition's two
//     passes, as the packed forward does: pass 1 forms S = q K^T (f32 sums
//     of bf16 products) 16 keys at a time and takes each row's max and sum
//     in the accumulator layout, joined across the row's four lanes by
//     shuffles, giving lse; pass 2 forms S again, the normalised P =
//     exp(S scale - lse) rounded to bf16 straight into the left-operand
//     registers of P V (V by ldmatrix.trans). The exponentials are taken
//     in base 2 (ex2.approx of s scale log2(e)). Keys past Lk get P = 0 by
//     predicate. A warp's head outputs, already normalised, are rounded
//     into the bf16 tile at their head's columns.
//   * The output projection reads that tile (each warp 32 rows x 16
//     columns); the residual x_q and bo are added in f32 and the rows
//     written once.
//   * Every tensor-core product starts from zero at each k-step (16 terms)
//     and joins its sum through the FADD units, which round to nearest: a
//     chain of sums in the accumulator truncates, and here
//     a k or v whose bf16 rounding flips moves every output of its batch
//     element.
//   * Lk > 256 (block_eligible allows up to 2048; no main-path shape): K
//     (pass 1) and K and V (pass 2) are projected again 256 keys at a time
//     for each query tile.
// Shared rows are 128 + 8 bf16 (272 bytes), so the eight row addresses of
// an ldmatrix hit eight different bank groups. Head dim 8 is half a k-step:
// the q fragment's other half is zeroed.
//
// bf16 I/O (train.bf16): x_q, x_kv and the output in bf16, the twelve
// parameters f32, as the TPU kernel takes them (its activation dtype in
// and out, f32 sums). The same mha_mma_kernel, told so by `io_bf16`: the
// rows arrive by cp.async as bf16 (half the bytes) and the LayerNorms
// widen them on read, exactly; the residual is the widened bf16 x_q; the
// output (x_q + acc Wo) + bo is rounded to bf16 once at the store. The
// weight scratch and every intermediate are as in the f32-I/O mode.
//
// f32 mode (mxu_bf16=False: the checks only, no main path): the first
// design on the f32 FMA units, two launches:
//   1. kv_proj_kernel: LN_kv + the K and V projections, 32 rows per block,
//      into a scratch buffer the wrapper allocates (B, Lk, 128) x 2;
//   2. attn_kernel: one block per (batch element, 32 query rows): LN_q + Q
//      projection into shared memory, then K/V streamed in tiles of 32 keys
//      with an online softmax; then the output projection. A warp owns a
//      head (more when d < 32), a lane a query row.
// Both are templated on the activation type T. With bf16 activations (T =
// bf16, io_bf16 in the f32 mode) they compute as the TPU kernel does on
// bf16 arrays with bf16=False: x_q and x_kv are widened exactly as the
// LayerNorms read them, the LayerNorms, the projections, the softmax, the
// biases and the residual (the widened x_q) stay f32, K and V scratch
// stays f32, and the output (x_q + acc Wo) + bo is rounded to bf16 once at
// the store. T = float is the f32 instance as it was.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "elem_io.cuh"
#include "mha_bf16.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int DM = 128;     // model dim: one 128-wide lane group
constexpr float kEps = 1e-6f;
constexpr float NEG = -1e30f;   // the first running max

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- bf16 mode, on the tensor cores ----

constexpr int NW = 16;          // warps of a block
constexpr int NT = NW * 32;
constexpr int RB = 64;          // rows of an LN / projection tile
constexpr int KC = 256;         // keys held in shared memory at a time
constexpr int LD = DM + 8;      // bf16 of a shared row, 16 bytes of padding

using bf16 = __nv_bfloat16;

// 2^x in one MUFU.EX2 (2 ulp; results below 2^-126 flush to zero, which a
// probability rounded to bf16 and summed with the rest does not miss).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LayerNorm of rows [0, n) of the f32 tile rs (RB x DM) into the RB rows
// of dst, rounded to bf16; rows past n are zeros. Warp w takes rows w,
// w + NW, ...
// Statistics and the normalised value are taken in f64 and rounded to f32
// once, so each output is the correctly rounded f32 LayerNorm, whose bf16
// rounding the plain version reproduces (an f32 LayerNorm differs by an
// ulp with the order of its sums, and one flipped bf16 rounding of x_kv's
// would move every output of the batch element).
__device__ __forceinline__ void ln_rows(const float* rs, int n,
                                        const float* __restrict__ s,
                                        const float* __restrict__ b,
                                        bf16* dst, bool io_bf16) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float4 sc = __ldg(reinterpret_cast<const float4*>(s) + lane);
  const float4 bi = __ldg(reinterpret_cast<const float4*>(b) + lane);
#pragma unroll 1
  for (int i = 0; i < RB / NW; ++i) {
    const int r = warp + i * NW;
    uint2 o = make_uint2(0u, 0u);
    if (r < n) {
      float4 v;
      if (io_bf16) {   // the tile holds bf16 rows (half of it)
        const uint2 u = reinterpret_cast<const uint2*>(
            reinterpret_cast<const bf16*>(rs) + r * DM)[lane];
        v = make_float4(__uint_as_float(u.x << 16),
                        __uint_as_float(u.x & 0xffff0000u),
                        __uint_as_float(u.y << 16),
                        __uint_as_float(u.y & 0xffff0000u));
      } else {
        v = reinterpret_cast<const float4*>(rs + r * DM)[lane];
      }
      const double x[4] = {v.x, v.y, v.z, v.w};
      const double mu = warp_sum_f64(x[0] + x[1] + x[2] + x[3]) / DM;
      const double d[4] = {x[0] - mu, x[1] - mu, x[2] - mu, x[3] - mu};
      const double var =
          warp_sum_f64(d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + d[3] * d[3]) /
          DM;
      const double rsd = 1.0 / sqrt(var + (double)kEps);
      o = make_uint2(
          pack_bf16(__double2float_rn(d[0] * rsd * sc.x + bi.x),
                    __double2float_rn(d[1] * rsd * sc.y + bi.y)),
          pack_bf16(__double2float_rn(d[2] * rsd * sc.z + bi.z),
                    __double2float_rn(d[3] * rsd * sc.w + bi.w)));
    }
    *reinterpret_cast<uint2*>(dst + r * LD + 4 * lane) = o;
  }
}

// Rows [0, n) of src (row stride DM elements of `esz` bytes) into the
// tile rs (RB rows of DM f32, or of DM bf16 in its first half) by
// asynchronous 16-byte copies, zeros past n; one commit group.
__device__ __forceinline__ void fetch_rows(const char* __restrict__ src,
                                           int n, int esz, float* rs) {
  const int per_row = DM * esz / 16;
  char* dst = reinterpret_cast<char*>(rs);
  for (int i = threadIdx.x; i < RB * per_row; i += NT) {
    const bool ok = i / per_row < n;
    cp_async16(reinterpret_cast<float*>(dst + 16 * i),
               reinterpret_cast<const float*>(ok ? src + 16 * i : src), ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The four weights rounded to bf16 once per call, in the order project()
// reads them: for matrix w (Wq, Wk, Wv, Wo), k-step ks, 8-column tile nt
// and lane (g, t) the right-operand pair {b0, b1} = {W[16 ks + 2t, + 1][8 nt
// + g], W[16 ks + 2t + 8, + 9][8 nt + g]}, 4 x 8 x 16 x 32 of them (128 KB).
constexpr int FRAGS = 8 * 16 * 32;   // of one matrix

__global__ void __launch_bounds__(256)
pack_weights_kernel(const float* __restrict__ wq, const float* __restrict__ wk,
                    const float* __restrict__ wv, const float* __restrict__ wo,
                    uint2* __restrict__ frag) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 4 * FRAGS) return;
  const int lane = i & 31, nt = (i >> 5) & 15, ks = (i >> 9) & 7, w = i >> 12;
  const float* W = w == 0 ? wq : w == 1 ? wk : w == 2 ? wv : wo;
  const float* p = W + (16 * ks + 2 * (lane & 3)) * DM + 8 * nt + (lane >> 2);
  frag[i] = make_uint2(pack_bf16(__ldg(p), __ldg(p + DM)),
                       pack_bf16(__ldg(p + 8 * DM), __ldg(p + 9 * DM)));
}

// acc[m][j] = xs (RB x DM, bf16) . W[:, n0 + 8 j, + 8) over m-tiles m0 + m
// < mtiles: this warp's MW x NJ tiles of a projection, W's fragments (from
// pack_weights_kernel) in registers while the m-tiles pass. Each k-step's
// products start from zero and join the sum through the FADD units, which
// round to nearest: a chain of tensor-core sums truncates.
template <int MW, int NJ>
__device__ __forceinline__ void project(const bf16* xs, int m0, int mtiles,
                                        const uint2* __restrict__ W, int n0,
                                        float (&acc)[MW][NJ][4]) {
  const int lane = threadIdx.x & 31;
  const int li = lane & 7, lb = (lane >> 3) & 1, lc = lane >> 4;
  uint2 wb[8][NJ];
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      wb[ks][j] = __ldg(W + (ks * 16 + n0 / 8 + j) * 32 + lane);
#pragma unroll
  for (int m = 0; m < MW; ++m) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.0f;
    if (m0 + m >= mtiles) continue;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, xs + (16 * (m0 + m) + li + 8 * lb) * LD + 16 * ks + 8 * lc);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(part, a, wb[ks][j].x, wb[ks][j].y);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][j][i] += part[i];
      }
    }
  }
}

// acc + bias, rounded to bf16, into the rows of m-tiles m0 + m < mtiles of
// dst at columns n0 + 8 j + 2 t, + 1.
template <int MW, int NJ>
__device__ __forceinline__ void store_bf16(const float (&acc)[MW][NJ][4],
                                           int m0, int mtiles,
                                           const float* __restrict__ bias,
                                           int n0, bf16* dst) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = n0 + 8 * j + 2 * t;
    const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + c));
#pragma unroll
    for (int m = 0; m < MW; ++m) {
      if (m0 + m >= mtiles) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(dst + (16 * (m0 + m) + g + 8 * h) * LD +
                                     c) =
            pack_bf16(acc[m][j][2 * h] + bv.x, acc[m][j][2 * h + 1] + bv.y);
    }
  }
}

// Shared memory of a block whose K and V tiles hold kc keys.
constexpr size_t mma_smem(int kc) {
  return (size_t)(2 * kc + 2 * RB) * LD * sizeof(bf16) +
         (size_t)RB * DM * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
mha_mma_kernel(const void* __restrict__ xq, const void* __restrict__ xkv,
               const float* __restrict__ lnqs, const float* __restrict__ lnqb,
               const float* __restrict__ lnks, const float* __restrict__ lnkb,
               const uint2* __restrict__ frag, const float* __restrict__ bq,
               const float* __restrict__ bk, const float* __restrict__ bv,
               const float* __restrict__ bo, void* __restrict__ out, int Lq,
               int Lk, float scale, int kc, int io_bf16) {
  constexpr int H = DM / D;
  // A query tile's 4 m-tiles x H heads, ordered head-major, MT to a warp
  // (one head each); at 2 heads the last 8 warps have none.
  constexpr int MT = H >= 16 ? 4 : (H == 8 ? 2 : 1);
  constexpr int ND = D / 8;                 // 8-column tiles of a head
  constexpr int KD = D < 16 ? 1 : D / 16;   // k-steps over a head
  const uint2* wq = frag;
  const uint2* wk = frag + FRAGS;
  const uint2* wv = frag + 2 * FRAGS;
  const uint2* wo = frag + 3 * FRAGS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // kc x LD
  bf16* Vs = Ks + kc * LD;
  bf16* Xs = Vs + kc * LD;    // RB x LD: LN rows, then the attention output
  bf16* Qs = Xs + RB * LD;    // RB x LD: q
  float* Rs = reinterpret_cast<float*>(Qs + RB * LD);   // RB x DM: LN input

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int li = lane & 7, lb = (lane >> 3) & 1, lc = lane >> 4;
  // Rows of x_q and x_kv (and the output) are DM elements of esz bytes.
  const bool bf16_io = io_bf16 != 0;
  const int esz = bf16_io ? 2 : 4;
  const int64_t row_bytes = (int64_t)DM * esz;
  const char* xqb = static_cast<const char*>(xq) +
                    (int64_t)blockIdx.x * Lq * row_bytes;
  const char* xkvb = static_cast<const char*>(xkv) +
                     (int64_t)blockIdx.x * Lk * row_bytes;
  const bool resident = Lk <= kc;       // K and V projected once
  const float scale2 = scale * 1.4426950408889634f;   // log2(e)
  // This warp's head and m-tiles mt0 .. mt0 + MT - 1 of every query tile.
  const int head = warp * MT / 4, mt0 = (warp * MT) & 3;
  const bool has_head = head < H;
  // A 64 x 128 projection: warp w takes m-tiles 2 (w / 8), + 1 and columns
  // 16 (w % 8) .. + 15.
  const int pm0 = 2 * (warp >> 3), pn0 = 16 * (warp & 7);

  // The LayerNorm of n rows of src into Xs. Their f32 rows reach Rs by
  // cp.async: with K and V resident the rows of the next LayerNorm in the
  // block's order (x_kv's chunks, then x_q's tiles) are fetched as soon as
  // these are read, under the work between; else they are fetched here.
  auto layer_norm = [&](const char* src, int n, const float* sc,
                        const float* bi, const char* next, int next_n) {
    if (!resident) fetch_rows(src, n, esz, Rs);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();   // Rs landed; Xs (and Ks, Vs, Qs) fully read
    ln_rows(Rs, n, sc, bi, Xs, bf16_io);
    __syncthreads();
    if (resident && next_n > 0) fetch_rows(next, next_n, esz, Rs);
  };
  if (resident) fetch_rows(xkvb, min(RB, Lk), esz, Rs);

  // K (and V) of keys [c0, c0 + min(kc, Lk - c0)) into Ks (and Vs), 64
  // rows at a time. Every thread of the block calls it.
  auto stage = [&](int c0, bool with_v) {
    const int n = min(kc, Lk - c0);
    for (int r0 = 0; r0 < n; r0 += RB) {
      const int nr = min(RB, n - r0), mtiles = (nr + 15) / 16;
      const bool last = r0 + RB >= n;   // then x_q's first tile is next
      layer_norm(xkvb + (c0 + r0) * row_bytes, nr, lnks, lnkb,
                 last ? xqb : xkvb + (c0 + r0 + RB) * row_bytes,
                 last ? min(RB, Lq) : min(RB, n - r0 - RB));
      if (with_v) {
        // Warps 0-7: 16 columns of K for all 64 rows; warps 8-15: of V.
        const bool is_v = warp >= NW / 2;
        float acc[4][2][4];
        project<4, 2>(Xs, 0, mtiles, is_v ? wv : wk, pn0, acc);
        store_bf16<4, 2>(acc, 0, mtiles, is_v ? bv : bk, pn0,
                         (is_v ? Vs : Ks) + r0 * LD);
      } else {
        float acc[2][2][4];
        project<2, 2>(Xs, pm0, mtiles, wk, pn0, acc);
        store_bf16<2, 2>(acc, pm0, mtiles, bk, pn0, Ks + r0 * LD);
      }
    }
    __syncthreads();
  };
  if (resident) stage(0, true);

  // Column of the head's first k-step in a shared row (at D = 8 a k-step
  // spans two heads, and the q fragment's other half is zeroed).
  const int kcol = D < 16 ? (head & ~1) * 8 : head * D;
  const int vcol = head * D;

  for (int q0 = 0; q0 < Lq; q0 += RB) {
    const int nq = min(RB, Lq - q0), mtiles = (nq + 15) / 16;
    layer_norm(xqb + q0 * row_bytes, nq, lnqs, lnqb,
               xqb + (q0 + RB) * row_bytes, min(RB, Lq - q0 - RB));
    {
      float acc[2][2][4];
      project<2, 2>(Xs, pm0, mtiles, wq, pn0, acc);
      store_bf16<2, 2>(acc, pm0, mtiles, bq, pn0, Qs);
    }
    __syncthreads();   // Qs complete; Xs free
    const bool busy = has_head && mt0 < mtiles;

    // q of the warp's m-tiles as left operands.
    uint32_t qa[MT][KD][4];
    if (busy) {
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          ldsm_x4(qa[j][kd], Qs + (16 * (mt0 + j) + li + 8 * lb) * LD +
                                 kcol + 16 * kd + 8 * lc);
          if constexpr (D == 8) {
            const int z = (head & 1) ? 0 : 2;   // the other head's columns
            qa[j][kd][z] = qa[j][kd][z + 1] = 0u;
          }
        }
    }
    // S of the 16 keys from shared row `key`, for each of the warp's
    // m-tiles: two 8-key tiles, rows (queries) g and g + 8, keys 2t and
    // 2t + 1 (a chain of D / 16 k-steps; as in the packed forward, its
    // truncation moves no result measurably).
    auto scores = [&](int key, float (&s)[MT][2][4]) {
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int e = 0; e < 8; ++e) s[j][e >> 2][e & 3] = 0.0f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t f[4];   // K rows as they lie are the right operand
        ldsm_x4(f, Ks + (key + li + 8 * lc) * LD + kcol + 16 * kd + 8 * lb);
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          if (mt0 + j >= mtiles) continue;
          mma_bf16(s[j][0], qa[j][kd], f[0], f[1]);
          mma_bf16(s[j][1], qa[j][kd], f[2], f[3]);
        }
      }
    };
    // Pass 1: each row's max m and sum l of 2^(x - m) over all Lk keys, x
    // = s scale log2(e) (the softmax in base 2: one MUFU.EX2 and a multiply
    // per exponential), each lane over its own keys, then joined across the
    // row's four lanes: lse2 = m + log2 l.
    float ls[MT][2];
    {
      float m[MT][2], l[MT][2];
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) m[j][r] = NEG, l[j][r] = 0.0f;
      for (int c0 = 0; c0 < Lk; c0 += kc) {
        if (!resident) stage(c0, false);
        const int nk = min(kc, Lk - c0);
        if (!busy) continue;
#pragma unroll 1
        for (int ks = 0; ks < nk; ks += 16) {
          float s[MT][2][4];
          scores(ks, s);
#pragma unroll
          for (int j = 0; j < MT; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float x[4], mx = m[j][r];
#pragma unroll
              for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const bool ok = ks + 8 * nt + 2 * t + e < nk;
                  x[2 * nt + e] = ok ? s[j][nt][2 * r + e] * scale2 : -INFINITY;
                  mx = fmaxf(mx, x[2 * nt + e]);
                }
              float acc = l[j][r] * ex2(m[j][r] - mx);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc += ex2(x[e] - mx);
              l[j][r] = acc;
              m[j][r] = mx;
            }
        }
      }
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            const float mo = __shfl_xor_sync(0xffffffffu, m[j][r], off);
            const float lo = __shfl_xor_sync(0xffffffffu, l[j][r], off);
            const float mx = fmaxf(m[j][r], mo);
            l[j][r] = l[j][r] * ex2(m[j][r] - mx) + lo * ex2(mo - mx);
            m[j][r] = mx;
          }
        }
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) ls[j][r] = m[j][r] + log2f(l[j][r]);
    }

    // Pass 2: S again, the normalised P = 2^(x - lse2) rounded to
    // bf16 straight into the left-operand registers of P V (the
    // accumulator layout of two 8-key tiles is the A layout of one 16-key
    // k-step); V by ldmatrix.trans, two 8-column tiles per load. Each
    // 16 keys' P V starts from zero and joins O through the FADD units.
    float o[MT][ND][4];
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][nd][e] = 0.0f;
    for (int c0 = 0; c0 < Lk; c0 += kc) {
      if (!resident) stage(c0, true);
      const int nk = min(kc, Lk - c0);
      if (!busy) continue;
#pragma unroll 1
      for (int ks = 0; ks < nk; ks += 16) {
        float s[MT][2][4];
        scores(ks, s);
        uint32_t pa[MT][4];
#pragma unroll
        for (int j = 0; j < MT; ++j)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const bool ok0 = ks + 8 * nt + 2 * t < nk;
            const bool ok1 = ks + 8 * nt + 2 * t + 1 < nk;
            const float l0 = ls[j][0], l1 = ls[j][1];
            pa[j][2 * nt] = pack_bf16(
                ok0 ? ex2(s[j][nt][0] * scale2 - l0) : 0.0f,
                ok1 ? ex2(s[j][nt][1] * scale2 - l0) : 0.0f);
            pa[j][2 * nt + 1] = pack_bf16(
                ok0 ? ex2(s[j][nt][2] * scale2 - l1) : 0.0f,
                ok1 ? ex2(s[j][nt][3] * scale2 - l1) : 0.0f);
          }
#pragma unroll
        for (int nd = 0; nd < ND; nd += 2) {
          uint32_t f[4];
          ldsm_x4_t(f, Vs + (ks + li + 8 * lb) * LD + vcol + 8 * (nd + lc));
#pragma unroll
          for (int j = 0; j < MT; ++j) {
            if (mt0 + j >= mtiles) continue;
#pragma unroll
            for (int h = 0; h < 2 && nd + h < ND; ++h) {
              float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
              mma_bf16(part, pa[j], f[2 * h], f[2 * h + 1]);
#pragma unroll
              for (int e = 0; e < 4; ++e) o[j][nd + h][e] += part[e];
            }
          }
        }
      }
    }
    // The head's outputs, rounded, into Xs at its columns (no warp reads
    // Xs between the Q projection's barrier and the next one).
    if (busy) {
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        if (mt0 + j >= mtiles) continue;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<uint32_t*>(
                Xs + (16 * (mt0 + j) + g + 8 * r) * LD + vcol + 8 * nd +
                2 * t) = pack_bf16(o[j][nd][2 * r], o[j][nd][2 * r + 1]);
      }
    }
    __syncthreads();

    // Output projection, residual and bias in f32, rows written once.
    float acc[2][2][4];
    project<2, 2>(Xs, pm0, mtiles, wo, pn0, acc);
#pragma unroll
    for (int jn = 0; jn < 2; ++jn) {
      const int c = pn0 + 8 * jn + 2 * t;
      const float2 bb = __ldg(reinterpret_cast<const float2*>(bo + c));
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = q0 + 16 * (pm0 + m) + g + 8 * r;
          if (pm0 + m >= mtiles || row >= Lq) continue;
          const int64_t at = (int64_t)row * DM + c;
          const int64_t o_at = (int64_t)blockIdx.x * Lq * DM + at;
          if (bf16_io) {
            const uint32_t u = __ldg(reinterpret_cast<const unsigned int*>(
                reinterpret_cast<const bf16*>(xqb) + at));
            *reinterpret_cast<uint32_t*>(static_cast<bf16*>(out) + o_at) =
                pack_bf16(
                    (__uint_as_float(u << 16) + acc[m][jn][2 * r]) + bb.x,
                    (__uint_as_float(u & 0xffff0000u) +
                     acc[m][jn][2 * r + 1]) + bb.y);
          } else {
            const float2 x = __ldg(reinterpret_cast<const float2*>(
                reinterpret_cast<const float*>(xqb) + at));
            *reinterpret_cast<float2*>(static_cast<float*>(out) + o_at) =
                make_float2((x.x + acc[m][jn][2 * r]) + bb.x,
                            (x.y + acc[m][jn][2 * r + 1]) + bb.y);
          }
        }
    }
  }
}

// frag: 4 * FRAGS uint2 (128 KB) of scratch for the rounded weights.
template <int D>
int launch_mma(const void* xq, const void* xkv, const float* lnqs,
               const float* lnqb, const float* lnks, const float* lnkb,
               const float* wq, const float* bq, const float* wk,
               const float* bk, const float* wv, const float* bv,
               const float* wo, const float* bo, uint2* frag, void* out,
               int B, int Lq, int Lk, float scale, int io_bf16,
               cudaStream_t stream) {
  pack_weights_kernel<<<4 * FRAGS / 256, 256, 0, stream>>>(wq, wk, wv, wo,
                                                           frag);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int kc = Lk < KC ? (Lk + 15) & ~15 : KC;
  e = cudaFuncSetAttribute(mha_mma_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)mma_smem(KC));
  if (e != cudaSuccess) return (int)e;
  mha_mma_kernel<D><<<B, NT, mma_smem(kc), stream>>>(
      xq, xkv, lnqs, lnqb, lnks, lnkb, frag, bq, bk, bv, bo, out, Lq, Lk,
      scale, kc, io_bf16);
  return (int)cudaGetLastError();
}

// ---- f32 mode, on the FMA units ----

constexpr int RT = 32;      // rows per tile (query rows, kv rows, keys)

// LayerNorm of rows [row0, row0 + RT) of src (f32 or bf16, widened; n_valid
// of them real) into dst (RT x DM, shared, f32); missing rows read as
// zeros. One warp per row.
template <typename T>
__device__ void ln_tile(const T* __restrict__ src, int64_t row0,
                        int n_valid, const float* __restrict__ s,
                        const float* __restrict__ b, float* dst) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const float4 sc = __ldg(reinterpret_cast<const float4*>(s) + lane);
  const float4 bi = __ldg(reinterpret_cast<const float4*>(b) + lane);
  for (int r = warp; r < RT; r += nw) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_valid) v = io::ld4(src + (row0 + r) * DM + 4 * lane);
    const float mu = warp_sum(v.x + v.y + v.z + v.w) * (1.0f / DM);
    const float dx = v.x - mu, dy = v.y - mu, dz = v.z - mu, dw = v.w - mu;
    const float var =
        warp_sum(dx * dx + dy * dy + dz * dz + dw * dw) * (1.0f / DM);
    const float rs = rsqrtf(var + kEps);
    reinterpret_cast<float4*>(dst + r * DM)[lane] =
        make_float4(dx * rs * sc.x + bi.x, dy * rs * sc.y + bi.y,
                    dz * rs * sc.z + bi.z, dw * rs * sc.w + bi.w);
  }
}

// acc[r] = sum_i src[r][i] * W[i][c] for the RT rows of a shared tile;
// W (DM x DM, row-major (in, out)) read through the read-only cache.
__device__ __forceinline__ void proj_col(const float* src,
                                         const float* __restrict__ W, int c,
                                         float (&acc)[RT]) {
#pragma unroll
  for (int r = 0; r < RT; ++r) acc[r] = 0.0f;
  for (int i = 0; i < DM; i += 4) {
    const float w0 = __ldg(W + (i + 0) * DM + c);
    const float w1 = __ldg(W + (i + 1) * DM + c);
    const float w2 = __ldg(W + (i + 2) * DM + c);
    const float w3 = __ldg(W + (i + 3) * DM + c);
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
// flattened B * Lk rows; x_kv of T, K and V f32.
template <typename T>
__global__ void __launch_bounds__(128)
kv_proj_kernel(const T* __restrict__ xkv, const float* __restrict__ lns,
               const float* __restrict__ lnb, const float* __restrict__ wk,
               const float* __restrict__ bk, const float* __restrict__ wv,
               const float* __restrict__ bv, float* __restrict__ kout,
               float* __restrict__ vout, int64_t rows) {
  __shared__ __align__(16) float xs[RT * DM];
  const int64_t row0 = (int64_t)blockIdx.x * RT;
  const int n_valid = rows - row0 < RT ? (int)(rows - row0) : RT;
  ln_tile(xkv, row0, n_valid, lns, lnb, xs);
  __syncthreads();
  const int c = threadIdx.x;
  float acc[RT];
  proj_col(xs, wk, c, acc);
  const float bkc = __ldg(bk + c);
  for (int r = 0; r < n_valid; ++r) kout[(row0 + r) * DM + c] = acc[r] + bkc;
  proj_col(xs, wv, c, acc);
  const float bvc = __ldg(bv + c);
  for (int r = 0; r < n_valid; ++r) vout[(row0 + r) * DM + c] = acc[r] + bvc;
}

// Launch 2: one block (4 warps) per (query tile, batch element); x_q and
// out of T.
template <int D, typename T>
__global__ void __launch_bounds__(128)
attn_kernel(const T* __restrict__ xq, const float* __restrict__ lns,
            const float* __restrict__ lnb, const float* __restrict__ wq,
            const float* __restrict__ bq, const float* __restrict__ kbuf,
            const float* __restrict__ vbuf, const float* __restrict__ wo,
            const float* __restrict__ bo, T* __restrict__ out, int Lq,
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
  const T* xqb = xq + (int64_t)b * Lq * DM;
  const float* kb = kbuf + (int64_t)b * Lk * DM;
  const float* vb = vbuf + (int64_t)b * Lk * DM;

  ln_tile(xqb, q0, nq, lns, lnb, xs);
  __syncthreads();
  {
    float acc[RT];
    proj_col(xs, wq, c, acc);
    const float bqc = __ldg(bq + c);
#pragma unroll
    for (int r = 0; r < RT; ++r) qs[r * DM + c] = acc[r] + bqc;
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
        const float* vr = vs + j * DM + hoff;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(vr + d);
          o[hh][d] = fmaf(p, v4.x, o[hh][d]);
          o[hh][d + 1] = fmaf(p, v4.y, o[hh][d + 1]);
          o[hh][d + 2] = fmaf(p, v4.z, o[hh][d + 2]);
          o[hh][d + 3] = fmaf(p, v4.w, o[hh][d + 3]);
        }
      }
      m[hh] = m_new;
    }
  }

  // Attention output (normalised) into xs, then out-projection.
  if (active) {
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh) {
      const int hoff = (warp * HPW + hh) * D;
      const float inv = 1.0f / l[hh];
#pragma unroll
      for (int d = 0; d < D; ++d) xs[lane * DM + hoff + d] = o[hh][d] * inv;
    }
  }
  __syncthreads();
  float acc[RT];
  proj_col(xs, wo, c, acc);
  const float boc = __ldg(bo + c);
  T* ob = out + (int64_t)b * Lq * DM;
  for (int r = 0; r < nq; ++r) {
    const int64_t off = (int64_t)(q0 + r) * DM + c;
    if constexpr (io::is_bf16<T>)
      ob[off] = __float2bfloat16_rn((__bfloat162float(xqb[off]) + acc[r]) +
                                    boc);
    else
      ob[off] = (xqb[off] + acc[r]) + boc;
  }
}

// x_q, x_kv and out of T (f32, or bf16 activations).
template <int D, typename T>
int launch_f32(const void* xq_, const void* xkv_, const float* lnqs,
               const float* lnqb, const float* lnks, const float* lnkb,
               const float* wq, const float* bq, const float* wk,
               const float* bk, const float* wv, const float* bv,
               const float* wo, const float* bo, float* kbuf, float* vbuf,
               void* out_, int B, int Lq, int Lk, float scale,
               cudaStream_t stream) {
  if (B > 65535) return (int)cudaErrorInvalidValue;
  const T* xq = static_cast<const T*>(xq_);
  const T* xkv = static_cast<const T*>(xkv_);
  T* out = static_cast<T*>(out_);
  const int64_t rows = (int64_t)B * Lk;
  kv_proj_kernel<T><<<(unsigned)((rows + RT - 1) / RT), 128, 0, stream>>>(
      xkv, lnks, lnkb, wk, bk, wv, bv, kbuf, vbuf, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = 4 * RT * DM * sizeof(float);
  e = cudaFuncSetAttribute(attn_kernel<D, T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Lq + RT - 1) / RT, B);
  attn_kernel<D, T><<<grid, 128, smem, stream>>>(xq, lnqs, lnqb, wq, bq,
                                                 kbuf, vbuf, wo, bo, out, Lq,
                                                 Lk, scale);
  return (int)cudaGetLastError();
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

// x_q (B, Lq, 128), x_kv (B, Lk, 128), weights (128, 128) (in, out),
// vectors (128,), out (B, Lq, 128); contiguous, 16-byte aligned. The
// weights and vectors f32; x_q, x_kv and out f32, or bf16 under io_bf16
// (either mode). heads in {2, 4, 8, 16}. Scratch: in f32 mode kbuf and
// vbuf, (B, Lk, 128) each; in bf16 mode kbuf, 32768 floats (128 KB) for
// the rounded weights, and vbuf is not read (may be null).
extern "C" int mha_block_launch(
    const void* xq, const void* xkv, const float* lnqs, const float* lnqb,
    const float* lnks, const float* lnkb, const float* wq, const float* bq,
    const float* wk, const float* bk, const float* wv, const float* bv,
    const float* wo, const float* bo, float* kbuf, float* vbuf, void* out,
    int B, int Lq, int Lk, int heads, float scale, int bf16, int io_bf16,
    cudaStream_t stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0) return 0;
  if (heads <= 0 || DM % heads) return (int)cudaErrorInvalidValue;
  if (bf16) {
    DISPATCH_HEAD_DIM(DM / heads, (launch_mma<D>(
        xq, xkv, lnqs, lnqb, lnks, lnkb, wq, bq, wk, bk, wv, bv, wo, bo,
        reinterpret_cast<uint2*>(kbuf), out, B, Lq, Lk, scale, io_bf16,
        stream)))
  }
  if (io_bf16) {
    DISPATCH_HEAD_DIM(DM / heads, (launch_f32<D, __nv_bfloat16>(
        xq, xkv, lnqs, lnqb, lnks, lnkb, wq, bq, wk, bk, wv, bv, wo, bo,
        kbuf, vbuf, out, B, Lq, Lk, scale, stream)))
  }
  DISPATCH_HEAD_DIM(DM / heads, (launch_f32<D, float>(
      xq, xkv, lnqs, lnqb, lnks, lnkb, wq, bq, wk, bk, wv, bv, wo, bo, kbuf,
      vbuf, out, B, Lq, Lk, scale, stream)))
}

// bf16 I/O at Lk <= 256 on bf16 wgmma (mha_bf16.cuh): x_q, x_kv and out
// bf16, the weights and vectors f32, as mha_block_launch takes them;
// scratch 32768 floats (128 KB) for the rounded weight tiles.
extern "C" int mha_wgmma_bf16_launch(
    const void* xq, const void* xkv, const float* lnqs, const float* lnqb,
    const float* lnks, const float* lnkb, const float* wq, const float* bq,
    const float* wk, const float* bk, const float* wv, const float* bv,
    const float* wo, const float* bo, float* scratch, void* out, int B,
    int Lq, int Lk, int heads, float scale, cudaStream_t stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0) return 0;
  if (heads <= 0 || DM % heads ||
      Lk > mha_bf16::MAX_CHUNKS * mha_bf16::CHUNK)
    return (int)cudaErrorInvalidValue;
  DISPATCH_HEAD_DIM(DM / heads, (mha_bf16::launch<D>(
      static_cast<const __nv_bfloat16*>(xq),
      static_cast<const __nv_bfloat16*>(xkv), lnqs, lnqb, lnks, lnkb, wq, bq,
      wk, bk, wv, bv, wo, bo, reinterpret_cast<uint8_t*>(scratch),
      static_cast<__nv_bfloat16*>(out), B, Lq, Lk, scale, stream)))
}
