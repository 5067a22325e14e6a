// mha_block's bf16-I/O instance on bf16 wgmma: mha_wgmma_bf16_kernel,
// counterpart of multimodal_sc_tpu/kernels/mha_block.py's _fwd_impl (:149)
// -> pl.pallas_call (:172) of _block_kernel (:114) handed bf16 activations
// (:117-118, :175). mha_block.cu launches it for every bf16-I/O call with
// Lk <= 256 (every c4, c4_vq, c4_digital and c5 shape); with f32
// activations, and past 256 keys (fog + V2X's 512), mha_mma_kernel runs as
// before.
//
// What it computes is mha_block_reference_bf16, the plain version:
//   out = bf16((x_q + bf16(att) bf16(Wo)) + bo),
//   att = softmax(q k^T scale) v per head, q, k, v = bf16(LN Wx + bx),
// each LayerNorm correctly rounded to f32 (statistics and the normalised
// value in f64), then to bf16; the weights rounded to bf16 once; P
// NORMALISED in f32 before its rounding to bf16, in mha_mma_kernel's form
// P = 2^(s c - lse2), c = scale log2(e), lse2 = m c + log2(sum of
// 2^(s c - m c)), m the row max; every sum in f32.
//
// Bound on the card. At c4's shapes a batch element moves 2 (2 Lq + Lk)
// 128 bytes and does 2 (2 Lq + 2 Lk) 128^2 + 4 Lq Lk 128 FLOPs: bytes and
// bf16 tensor-core operations weigh about the same (PERF.md section 6, row
// 1 bf16). A kernel that keeps everything on chip also pays the softmax's
// two exponentials a score on the exp2 unit and the f64 LayerNorm; with two
// warpgroups an SM this one is bound by neither but by the latency of its
// chains (scripts/torch_mha_bf16_stamps.py and _variants.py: PERF.md).
// mha_mma_kernel, which this replaces for these shapes, formed S twice
// (two passes), fed bf16 mma.sync from ldmatrix and read the weights from
// L2 for every 64-row tile. Here:
//
//   * A block a batch element (small batches split its 64-row query tiles
//     over several blocks, each projecting K and V itself: a query row's
//     arithmetic is the same in any split, so are its bits), two
//     warpgroups that take its 64-row tiles in turn, one block an SM (K,
//     V and the weights fill the shared memory).
//   * The four weights are rounded once a call by pack_images_kernel into
//     the bytes of a 128 x 128 shared tile that wgmma reads K-major (W^T,
//     the 128-byte swizzle) and copied into shared memory by cp.async as
//     they lie: Wk and Wv for the K and V projections, then Wq and Wo in
//     their place (while Lk <= 128 all four fit at once).
//   * x rows arrive by cp.async into a warpgroup's 16 KB staging tile, the
//     next tile's while this one computes. The LayerNorm (one row's 128
//     values over a quad of lanes, f64 sums joined by shuffles) writes its
//     bf16 values straight into the A fragments of the projection, so the
//     four projections are wgmma.m64n128k16 with A in registers and B the
//     weight tile: 8 k-steps, run two at a time (32 terms) in the
//     tensor-core accumulator from zero and joined to the f32 sum by adds
//     in order (PROJ_CHAIN: a chain in the accumulator truncates, and a
//     longer one flips more roundings of q, k and v). K and V (+ bias,
//     rounded) are stored into swizzled tiles of up to 256 keys that S and
//     P V read by descriptor (K K-major, V MN-major: no transposed copy);
//     q (+ bias, rounded) goes into the staging tile, each warp its own 16
//     rows, from which a head's k-steps are read as the A fragments of S.
//   * S once a (64 queries, head), all its keys in registers
//     (wgmma.m64n64k16 a 64-key chunk, one chain over the head dim); the
//     row max and sum from those registers (chunks wholly inside Lk
//     without a branch), then P in mha_mma_kernel's form rounded to bf16
//     straight into the A registers of P V (its k-steps chained over all
//     keys), a chunk's P packed while the chunk before multiplies. Keys
//     past Lk get P = 0; warps whose 16 query rows all lie past Lq skip the
//     exponentials.
//   * The head outputs, rounded, go into the staging tile over their head's
//     q, which the output projection then reads as its A operand; residual
//     and bias in f32, one rounding at the store.
//   * Every wgmma is issued unconditionally, and no chain's registers are
//     read while another chain is in flight: otherwise ptxas serializes
//     all of a kernel's wgmma (its warning C7514).
//
// Head dims 8 and 16: S takes the head's k-step (at 8 the other head's
// half of q zeroed, as in mha_mma_kernel), P V a 32-column tile of V of
// which the head's columns are kept.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_wgmma.cuh"

namespace mha_bf16 {

using bw::bf16;

constexpr int DM = 128;           // model dim: one 128-wide lane group
constexpr int ROWS = 64;          // rows of a warpgroup's tile
constexpr int CHUNK = 64;         // keys of one S product
constexpr int MAX_CHUNKS = 4;     // keys held at once: 256
constexpr int WGS = 2;            // warpgroups of a block
constexpr int THREADS = 128 * WGS;
constexpr int W_BYTES = DM * DM * 2;      // a bf16 weight tile
constexpr int ST_BYTES = ROWS * DM * 2;   // a warpgroup's staging tile
constexpr float NEG = -1e30f;     // a masked score
constexpr float LOG2E = 1.4426950408889634f;
constexpr double EPS = 1e-6;
// k-steps (16 terms each) a projection sums in the tensor-core accumulator
// before joining its f32 sum by an add: 2 (mha_mma_kernel: 1; PERF.md gives
// the shares of differing outputs at 1, 2 and 8, the whole sum in one
// chain).
constexpr int PROJ_CHAIN = 2;

// Weight tiles resident at once: all four while the K and V tiles leave
// room (Lk <= 128), else two (Wk and Wv, then Wq and Wo).
__host__ __device__ constexpr int weight_slots(int nc) {
  return nc <= 2 ? 4 : 2;
}

// Dynamic shared memory: 1024 bytes to align the tiles (the swizzle is read
// on address bits), K and V tiles of nc * 64 keys, the weight slots, one
// staging tile a warpgroup.
constexpr size_t smem_bytes(int nc) {
  return 1024 + 2 * (size_t)nc * CHUNK * DM * 2 +
         (size_t)weight_slots(nc) * W_BYTES + (size_t)WGS * ST_BYTES;
}

// 2^x in one MUFU.EX2 (2 ulp; results below 2^-126 flush to zero).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 values as one bf16 pair, a in the low half.
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return bw::bits(__floats2bfloat162_rn(a, b));
}

__device__ __forceinline__ float2 widen2(uint32_t u) {
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

// The four weights (in, out) rounded to bf16 into the tiles the kernel
// copies as they lie: tile w (Wq, Wk, Wv, Wo) holds W^T, row n and column
// k = W[k][n], a 128 x 128 tile read K-major in the 128-byte swizzle; 8
// consecutive k (16 bytes) a thread, a warp's lanes on neighbouring n (its
// reads of a row of W coalesced).
__global__ void __launch_bounds__(256)
pack_images_kernel(const float* __restrict__ wq, const float* __restrict__ wk,
                   const float* __restrict__ wv, const float* __restrict__ wo,
                   uint8_t* __restrict__ img) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 4 * DM * DM / 8) return;
  const int n = i & (DM - 1), k0 = 8 * ((i >> 7) & 15), w = i >> 11;
  const float* W = w == 0 ? wq : w == 1 ? wk : w == 2 ? wv : wo;
  uint32_t u[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    u[e] = pack2(__ldg(W + (k0 + 2 * e) * DM + n),
                 __ldg(W + (k0 + 2 * e + 1) * DM + n));
  *reinterpret_cast<uint4*>(img + w * W_BYTES + bw::tile_off<DM, DM>(n, k0)) =
      make_uint4(u[0], u[1], u[2], u[3]);
}

// One block a batch element, or a run of its query tiles (qsplit blocks an
// element). NC: 64-key chunks of the K and V tiles (Lk <= 64 NC).
template <int D, int NC>
__global__ void __launch_bounds__(THREADS, 1)
mha_wgmma_bf16_kernel(const bf16* __restrict__ xq,
                      const bf16* __restrict__ xkv,
                      const float* __restrict__ lnqs,
                      const float* __restrict__ lnqb,
                      const float* __restrict__ lnks,
                      const float* __restrict__ lnkb,
                      const uint8_t* __restrict__ img,
                      const float* __restrict__ bq,
                      const float* __restrict__ bk,
                      const float* __restrict__ bv,
                      const float* __restrict__ bo, bf16* __restrict__ out,
                      int Lq, int Lk, float scale, int qsplit) {
  constexpr int H = DM / D;
  constexpr int KR = NC * CHUNK;              // key rows of the K, V tiles
  constexpr int KD = D < 16 ? 1 : D / 16;     // k-steps of S over a head
  constexpr int ON = D < 32 ? 32 : D;         // columns of a head's P V
  constexpr int SLOTS = weight_slots(NC);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm =
      smem_raw + ((1024 - (bw::smem_addr(smem_raw) & 1023)) & 1023);
  // K and V tiles (KR rows x 128 columns in four 32-column atoms of the
  // 64-byte swizzle), the weight slots, the staging tiles.
  const uint32_t kt = bw::smem_addr(sm), vt = kt + KR * DM * 2;
  const uint32_t wt = vt + KR * DM * 2;
  const uint32_t w_k = SLOTS == 4 ? wt + W_BYTES : wt, w_v = w_k + W_BYTES;
  const uint32_t w_q = wt, w_o = wt + (SLOTS - 1) * W_BYTES;

  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const uint32_t st = wt + SLOTS * W_BYTES + wg * ST_BYTES;
  uint8_t* stp = sm + (st - kt);
  const int b = blockIdx.x / qsplit, part = blockIdx.x % qsplit;
  const int ntiles = (Lq + ROWS - 1) / ROWS;
  const int tile0 = ntiles * part / qsplit;
  const int tile1 = ntiles * (part + 1) / qsplit;
  const int nkc = (Lk + CHUNK - 1) / CHUNK;
  const bf16* xqb = xq + (int64_t)b * Lq * DM;
  const bf16* xkvb = xkv + (int64_t)b * Lk * DM;
  const float scale2 = scale * LOG2E;

  auto wg_sync = [&]() {
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  };
  // Rows [r0, r0 + 64) of x (L rows) into this warpgroup's staging tile
  // (the 128-byte swizzle), zeros past L; one commit group.
  auto stage = [&](const bf16* x, int r0, int L) {
    const int n = min(ROWS, L - r0);
#pragma unroll 1
    for (int i = wtid; i < ROWS * DM / 8; i += 128) {
      const int r = i >> 4, c = 8 * (i & 15);
      const bool ok = r < n;
      bw::cp_async16(st + bw::tile_off<ROWS, DM>(r, c),
                     ok ? x + (int64_t)(r0 + r) * DM + c : x, ok);
    }
    bw::cp_async_commit();
  };
  // Weight tile w (0 Wq, 1 Wk, 2 Wv, 3 Wo) into the slot at dst, by every
  // thread of the block; committed with the caller's next group.
  auto copy_weight = [&](uint32_t dst, int w) {
    const uint8_t* src = img + w * W_BYTES;
#pragma unroll 1
    for (int i = tid; i < W_BYTES / 16; i += THREADS)
      bw::cp_async16(dst + 16 * i, src + 16 * i, true);
  };
  auto quad_sum = [&](double x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
  };

  // The LayerNorm of the staged rows [0, n) into the A fragments of the
  // warpgroup's 64 x 128 product: a[j] is k-step j of the warp's 16 rows
  // (rows g, g + 8 of it; columns 16 j + 2 t, + 1 and 16 j + 8 + 2 t, + 1),
  // each value the correctly rounded f32 LayerNorm (f64 statistics and
  // value, rounded once) rounded to bf16; rows past n are zeros. A row's
  // 128 values lie on the four lanes of a quad; its sums run in four
  // chains (the sum of bf16 values is exact in f64 in any order). Warps
  // whose rows all lie past n skip the arithmetic.
  auto layer_norm = [&](int n, const float* __restrict__ sc,
                        const float* __restrict__ bi, uint32_t (&a)[8][4]) {
    if (16 * warp >= n) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) a[j][i] = 0u;
      return;
    }
    // Rows g and g + 8 side by side (x[rh]: element 2 i + e is column
    // 8 i + 2 t + e), their chains independent.
    double x[2][32];
#pragma unroll
    for (int rh = 0; rh < 2; ++rh)
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float2 v = widen2(*reinterpret_cast<const uint32_t*>(
            stp + bw::tile_off<ROWS, DM>(16 * warp + g + 8 * rh,
                                         8 * i + 2 * t)));
        x[rh][2 * i] = v.x;
        x[rh][2 * i + 1] = v.y;
      }
    double part[2][4], mu[2], rsd[2];
#pragma unroll
    for (int rh = 0; rh < 2; ++rh)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[rh][i] = 0.0;
#pragma unroll
    for (int i = 0; i < 32; ++i)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) part[rh][i & 3] += x[rh][i];
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      mu[rh] = quad_sum((part[rh][0] + part[rh][1]) +
                        (part[rh][2] + part[rh][3])) * (1.0 / DM);
#pragma unroll
      for (int i = 0; i < 4; ++i) part[rh][i] = 0.0;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        x[rh][i] -= mu[rh];
        part[rh][i & 3] = fma(x[rh][i], x[rh][i], part[rh][i & 3]);
      }
#pragma unroll
    for (int rh = 0; rh < 2; ++rh)
      rsd[rh] = rsqrt(quad_sum((part[rh][0] + part[rh][1]) +
                               (part[rh][2] + part[rh][3])) * (1.0 / DM) +
                      EPS);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float2 s2 =
          __ldg(reinterpret_cast<const float2*>(sc + 8 * i + 2 * t));
      const float2 b2 =
          __ldg(reinterpret_cast<const float2*>(bi + 8 * i + 2 * t));
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        // (x - mu) rsd scale + bias, each operation rounded in f64, then
        // once to f32.
        const float y0 = __double2float_rn(__dadd_rn(
            __dmul_rn(__dmul_rn(x[rh][2 * i], rsd[rh]), s2.x), b2.x));
        const float y1 = __double2float_rn(__dadd_rn(
            __dmul_rn(__dmul_rn(x[rh][2 * i + 1], rsd[rh]), s2.y), b2.y));
        // Column 8 i + 2 t: k-step i / 2, register 2 (i % 2) + rh.
        a[i >> 1][2 * (i & 1) + rh] =
            16 * warp + g + 8 * rh < n ? pack2(y0, y1) : 0u;
      }
    }
  };

  // acc = the warpgroup's 64 rows . a 128 x 128 weight tile, 8 k-steps
  // issued by step(part, ks, accumulate), PROJ_CHAIN of them a chain from
  // zero joined to the f32 sum by adds in order.
  auto project = [&](auto step, float (&acc)[DM / 2]) {
    float part[DM / 2];
#pragma unroll
    for (int k0 = 0; k0 < 8; k0 += PROJ_CHAIN) {
      wgmma_operand_fence(part);
      bw::wgmma_fence();
#pragma unroll
      for (int ks = k0; ks < k0 + PROJ_CHAIN; ++ks) step(part, ks, ks > k0);
      bw::wgmma_commit_wait();
      wgmma_operand_fence(part);
#pragma unroll
      for (int i = 0; i < DM / 2; ++i)
        acc[i] = k0 == 0 ? part[i] : acc[i] + part[i];
    }
  };
  // k-steps of a product with A the fragments a (registers) or the staging
  // tile (the head outputs, read K-major), B the weight tile at w.
  auto by_frags = [&](const uint32_t (&a)[8][4], uint32_t w) {
    return [&a, w](float (&d)[DM / 2], int ks, int accumulate) {
      bw::wgmma_bf16<DM, 0>(d, a[ks], bw::kmajor<DM, DM>(w, ks), accumulate);
    };
  };
  auto by_staged = [&](uint32_t w) {
    return [st, w](float (&d)[DM / 2], int ks, int accumulate) {
      bw::wgmma_bf16_ss<DM, 0>(d, bw::kmajor<ROWS, DM>(st, ks),
                               bw::kmajor<DM, DM>(w, ks), accumulate);
    };
  };
  // This thread's 16 column pairs 8 nt + 2 t, + 1 of a bias vector, loaded
  // ahead of the product that needs them.
  auto load_bias = [&](const float* __restrict__ bias, float2 (&bb)[DM / 8]) {
#pragma unroll
    for (int nt = 0; nt < DM / 8; ++nt)
      bb[nt] = __ldg(reinterpret_cast<const float2*>(bias + 8 * nt + 2 * t));
  };
  // acc + bias rounded into rows row0 + (this warp's 16) of the K or V tile
  // at shared offset `tile`. Accumulator element 4 nt + 2 r + e: row g + 8 r
  // of the warp's 16, column 8 nt + 2 t + e.
  auto store_keys = [&](const float (&acc)[DM / 2], const float2 (&bb)[DM / 8],
                        uint32_t tile, int row0) {
#pragma unroll
    for (int nt = 0; nt < DM / 8; ++nt) {
      const int col = 8 * nt + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(
            sm + (tile - kt) +
            bw::tile_off<KR, 32>(row0 + 16 * warp + g + 8 * r, col)) =
            pack2(acc[4 * nt + 2 * r] + bb[nt].x,
                  acc[4 * nt + 2 * r + 1] + bb[nt].y);
    }
  };

  // ---- K and V: chunk c of 64 keys to warpgroup c % 2 ----
  const int first_tile = tile0 + wg;   // this warpgroup's first query tile
  if constexpr (SLOTS == 4) {
    copy_weight(w_q, 0);
    copy_weight(w_o, 3);
  }
  copy_weight(w_k, 1);
  copy_weight(w_v, 2);
  if (wg < nkc)
    stage(xkvb, wg * CHUNK, Lk);
  else if (first_tile < tile1)
    stage(xqb, first_tile * ROWS, Lq);
  else
    bw::cp_async_commit();
  bw::cp_async_wait<0>();
  bw::fence_async_shared();
  __syncthreads();   // the weights and every warpgroup's first rows landed
  {
    uint32_t a[8][4];
    float acc[DM / 2];
#pragma unroll 1
    for (int c = wg; c < nkc; c += WGS) {
      if (c != wg) {   // the rows staged in the iteration before
        bw::cp_async_wait<0>();
        wg_sync();
      }
      layer_norm(min(CHUNK, Lk - c * CHUNK), lnks, lnkb, a);
      wg_sync();   // every warp has read the staged rows
      if (c + WGS < nkc)
        stage(xkvb, (c + WGS) * CHUNK, Lk);
      else if (first_tile < tile1)
        stage(xqb, first_tile * ROWS, Lq);
      float2 bb[DM / 8];
      load_bias(bk, bb);
      project(by_frags(a, w_k), acc);
      store_keys(acc, bb, kt, c * CHUNK);
      load_bias(bv, bb);
      project(by_frags(a, w_v), acc);
      store_keys(acc, bb, vt, c * CHUNK);
    }
  }
  bw::fence_async_shared();   // K and V stores seen by wgmma
  __syncthreads();            // K and V whole; Wk and Wv read
  if constexpr (SLOTS == 2) {
    copy_weight(w_q, 0);
    copy_weight(w_o, 3);
    bw::cp_async_commit();
  }
  bw::cp_async_wait<0>();
  bw::fence_async_shared();
  __syncthreads();   // Wq, Wo and every warpgroup's first query rows landed

  // ---- query tiles: tile0 + wg, + 2, ... ----
  // S of a (64 queries, head) chunk c: element 4 nt + 2 r + e is row g + 8 r
  // of the warp's 16, key 64 c + 8 nt + 2 t + e.
  float s[NC][CHUNK / 2];
  // Scores of keys past Lk set to NEG (probability 0), by a select in the
  // chunks that reach past Lk.
  auto mask = [&]() {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (c * CHUNK + CHUNK > Lk) {
#pragma unroll
        for (int x = 0; x < CHUNK / 2; ++x) {
          const int key = c * CHUNK + 8 * (x / 4) + 2 * t + (x & 1);
          s[c][x] = key < Lk ? s[c][x] : NEG;
        }
      }
  };
  // lse2 of rows g, g + 8: m c + log2 of the sum of 2^(s c - m c) over the
  // row's keys, m the row max, c = scale log2(e); each row's four lanes
  // joined by shuffles, the max and the sum each in several chains. Chunks
  // wholly inside Lk run without a branch; in the chunk that reaches past
  // it, groups of 8 keys wholly past Lk are skipped, every lane alike.
  auto row_lse2 = [&](float (&ls)[2]) {
    float mx[2][2] = {{NEG, NEG}, {NEG, NEG}};
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int nt = 0; nt < CHUNK / 8; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          mx[r][nt & 1] =
              fmaxf(mx[r][nt & 1],
                    fmaxf(s[c][4 * nt + 2 * r], s[c][4 * nt + 2 * r + 1]));
    float m2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = fmaxf(mx[r][0], mx[r][1]);
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      m2[r] = m * scale2;
    }
    float p[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    auto group = [&](const float (&sc)[CHUNK / 2], int nt) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          p[r][2 * (nt & 1) + e] +=
              ex2(fmaf(sc[4 * nt + 2 * r + e], scale2, -m2[r]));
    };
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c * CHUNK + CHUNK <= Lk) {
#pragma unroll
        for (int nt = 0; nt < CHUNK / 8; ++nt) group(s[c], nt);
      } else {
#pragma unroll
        for (int nt = 0; nt < CHUNK / 8; ++nt)
          if (c * CHUNK + 8 * nt < Lk) group(s[c], nt);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = (p[r][0] + p[r][1]) + (p[r][2] + p[r][3]);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      ls[r] = m2[r] + log2f(sum);
    }
  };
  // Chunk c of s <- P = 2^(s c - lse2) in place; 0 past Lk. A chunk wholly
  // inside Lk runs without a branch; in the one that reaches past it,
  // groups of 8 keys wholly past Lk are skipped, every lane alike.
  auto probs = [&](float (&sc)[CHUNK / 2], int c, const float (&ls)[2]) {
    auto group = [&](int nt) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * nt + 2 * r + e];
          x = ex2(fmaf(x, scale2, -ls[r]));
        }
    };
    if (c * CHUNK + CHUNK <= Lk) {
#pragma unroll
      for (int nt = 0; nt < CHUNK / 8; ++nt) group(nt);
    } else {
#pragma unroll
      for (int nt = 0; nt < CHUNK / 8; ++nt) {
        if (c * CHUNK + 8 * nt < Lk) {
          group(nt);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[4 * nt + j] = 0.0f;
        }
      }
    }
  };
  // P rounded to bf16 into the A operands of chunk c's four P V k-steps:
  // k-step kk's register i holds elements 8 kk + 2 i and + 1 of the chunk.
  auto pack_p = [&](const float (&p)[CHUNK / 2], uint32_t (&pa)[4][4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kk][i] = pack2(p[8 * kk + 2 * i], p[8 * kk + 2 * i + 1]);
  };

#pragma unroll 1
  for (int tile = first_tile; tile < tile1; tile += WGS) {
    if (tile != first_tile) {   // the rows staged by the tile before
      bw::cp_async_wait<0>();
      wg_sync();
    }
    const int row0 = tile * ROWS;
    {
      uint32_t a[8][4];
      float acc[DM / 2];
      float2 bb[DM / 8];
      layer_norm(min(ROWS, Lq - row0), lnqs, lnqb, a);
      load_bias(bq, bb);
      project(by_frags(a, w_q), acc);
      wg_sync();   // every warp has read the staged rows: the tile is free
      // q + bq, rounded, into the staging tile: each warp's 16 rows, which
      // only that warp reads (as the A fragments of S) and then overwrites
      // head by head with the head outputs.
#pragma unroll
      for (int nt = 0; nt < DM / 8; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<uint32_t*>(
              stp + bw::tile_off<ROWS, DM>(16 * warp + g + 8 * r,
                                           8 * nt + 2 * t)) =
              pack2(acc[4 * nt + 2 * r] + bb[nt].x,
                    acc[4 * nt + 2 * r + 1] + bb[nt].y);
      __syncwarp();
    }
    const bool live = row0 + 16 * warp < Lq;   // a query row in the warp

#pragma unroll 1
    for (int h = 0; h < H; ++h) {
      // q of the head as the A fragments of its k-steps, from the warp's
      // rows of the staging tile: register i of k-step ks holds row g + 8
      // (i % 2), columns 16 ks + 8 (i / 2) + 2 t, + 1.
      const int ks0 = D >= 16 ? h * KD : h >> 1;
      uint32_t qh[KD][4];
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qh[kd][i] = *reinterpret_cast<const uint32_t*>(
              stp + bw::tile_off<ROWS, DM>(
                        16 * warp + g + 8 * (i & 1),
                        16 * (ks0 + kd) + 8 * (i >> 1) + 2 * t));
      if constexpr (D == 8) {   // the k-step's other head's columns
        const int z = (h & 1) ? 0 : 2;
        qh[0][z] = qh[0][z + 1] = 0u;
      }
      // S = q K^T, every chunk; issued together, waited for.
#pragma unroll
      for (int c = 0; c < NC; ++c) wgmma_operand_fence(s[c]);
      bw::wgmma_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int kd = 0; kd < KD; ++kd)
          bw::wgmma_bf16<CHUNK, 0>(
              s[c], qh[kd], bw::kmajor<KR, 32>(kt + c * CHUNK * 64, ks0 + kd),
              kd > 0);
      bw::wgmma_commit_wait();
#pragma unroll
      for (int c = 0; c < NC; ++c) wgmma_operand_fence(s[c]);
      float ls[2] = {0.0f, 0.0f};
      if (live) {
        mask();
        row_lse2(ls);
      } else {   // P = 0: the warp's wgmma still take part
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int x = 0; x < CHUNK / 2; ++x) s[c][x] = 0.0f;
      }
      // O = P V over every chunk, V's 32-column atom(s) of the head read
      // MN-major. Chunk by chunk: its P taken and packed into one of two
      // buffers, its k-steps issued while the next chunk's P is taken; a
      // buffer is reused once the chunk that read it is waited for.
      const int atom = h * D / 32;
      float o[ON / 2];
      uint32_t pa0[4][4], pa1[4][4];
      auto chunk = [&](int c, uint32_t (&pa)[4][4]) {
        if (c >= 2) bw::wgmma_wait_pending<1>();
        if (live) probs(s[c], c, ls);
        pack_p(s[c], pa);
        bw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          bw::wgmma_bf16<ON, 1>(
              o, pa[kk], bw::mnmajor<KR, 32>(vt + atom * (KR * 64), 4 * c + kk),
              c > 0 || kk > 0);
        bw::wgmma_commit();
      };
      wgmma_operand_fence(o);
#pragma unroll
      for (int c = 0; c < NC; c += 2) {
        chunk(c, pa0);
        if (c + 1 < NC) chunk(c + 1, pa1);
      }
      bw::wgmma_wait();
      wgmma_operand_fence(o);
      // The head's outputs, rounded, into the staging tile at its columns,
      // over its q (each lane writes what it read; at head dim 8 the next
      // head's q fragment zeroes these columns; at head dims 8 and 16 the
      // product's other heads' columns are dropped).
      const int lo = (h * D % 32) / 8;
#pragma unroll
      for (int nt = 0; nt < ON / 8; ++nt) {
        if (D < 32 && (nt < lo || nt >= lo + D / 8)) continue;
        const int col = 32 * atom + 8 * nt + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<uint32_t*>(
              stp + bw::tile_off<ROWS, DM>(16 * warp + g + 8 * r, col)) =
              pack2(o[4 * nt + 2 * r], o[4 * nt + 2 * r + 1]);
      }
    }
    bw::fence_async_shared();   // the head outputs seen by wgmma
    wg_sync();
    // The residual rows (bf16 pairs; rows past Lq read as zeros) and bo,
    // loaded while the output projection runs.
    float2 bb[DM / 8];
    uint32_t xr[2][DM / 8];
    load_bias(bo, bb);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 16 * warp + g + 8 * r;
      if (row < Lq) {
#pragma unroll
        for (int nt = 0; nt < DM / 8; ++nt)
          xr[r][nt] = __ldg(reinterpret_cast<const unsigned int*>(
              xqb + (int64_t)row * DM + 8 * nt + 2 * t));
      }
    }
    float acc[DM / 2];
    project(by_staged(w_o), acc);
    wg_sync();   // every warp's product has read the staging tile
    if (tile + WGS < tile1) stage(xqb, (tile + WGS) * ROWS, Lq);
    // (x_q + acc) + bo in f32, rounded once; rows past Lq not stored.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 16 * warp + g + 8 * r;
      if (row >= Lq) continue;
      bf16* dst = out + ((int64_t)b * Lq + row) * DM + 2 * t;
#pragma unroll
      for (int nt = 0; nt < DM / 8; ++nt) {
        const float2 x = widen2(xr[r][nt]);
        *reinterpret_cast<uint32_t*>(dst + 8 * nt) =
            pack2((x.x + acc[4 * nt + 2 * r]) + bb[nt].x,
                  (x.y + acc[4 * nt + 2 * r + 1]) + bb[nt].y);
      }
    }
  }
}

// Blocks a batch element's query tiles are split over: enough for a block
// on each of the 132 SMs where the batch gives fewer.
inline int query_splits(int B, int Lq) {
  const int tiles = (Lq + ROWS - 1) / ROWS;
  const int want = (132 + B - 1) / B;
  return want < tiles ? want : tiles;
}

template <int D, int NC>
int launch_nc(const bf16* xq, const bf16* xkv, const float* lnqs,
              const float* lnqb, const float* lnks, const float* lnkb,
              const uint8_t* img, const float* bq, const float* bk,
              const float* bv, const float* bo, bf16* out, int B, int Lq,
              int Lk, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(NC);
  auto kernel = mha_wgmma_bf16_kernel<D, NC>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int qs = query_splits(B, Lq);
  const int64_t blocks = (int64_t)B * qs;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      xq, xkv, lnqs, lnqb, lnks, lnkb, img, bq, bk, bv, bo, out, Lq, Lk,
      scale, qs);
  return (int)cudaGetLastError();
}

// img: 4 * W_BYTES (128 KB) of scratch for the rounded weight tiles. Lk <=
// 256 (checked by the caller).
template <int D>
int launch(const bf16* xq, const bf16* xkv, const float* lnqs,
           const float* lnqb, const float* lnks, const float* lnkb,
           const float* wq, const float* bq, const float* wk, const float* bk,
           const float* wv, const float* bv, const float* wo, const float* bo,
           uint8_t* img, bf16* out, int B, int Lq, int Lk, float scale,
           cudaStream_t stream) {
  pack_images_kernel<<<4 * DM * DM / 8 / 256, 256, 0, stream>>>(wq, wk, wv,
                                                                 wo, img);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  switch ((Lk + CHUNK - 1) / CHUNK) {
    case 1: return launch_nc<D, 1>(xq, xkv, lnqs, lnqb, lnks, lnkb, img, bq,
                                   bk, bv, bo, out, B, Lq, Lk, scale, stream);
    case 2: return launch_nc<D, 2>(xq, xkv, lnqs, lnqb, lnks, lnkb, img, bq,
                                   bk, bv, bo, out, B, Lq, Lk, scale, stream);
    case 3: return launch_nc<D, 3>(xq, xkv, lnqs, lnqb, lnks, lnkb, img, bq,
                                   bk, bv, bo, out, B, Lq, Lk, scale, stream);
    default: return launch_nc<D, 4>(xq, xkv, lnqs, lnqb, lnks, lnkb, img, bq,
                                    bk, bv, bo, out, B, Lq, Lk, scale, stream);
  }
}

}  // namespace mha_bf16
