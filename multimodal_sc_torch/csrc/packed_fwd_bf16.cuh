// The packed attention forward on bf16 tensors (train.bf16) on bf16 wgmma:
// fwd_wgmma_bf16_kernel, counterpart of
// multimodal_sc_tpu/kernels/attention_packed.py's _fwd_impl / _fwd_kernel
// with bf16=True handed bf16 arrays. attention_packed.cu launches it for
// every bf16-I/O shape; its f32-I/O bf16 mode stays on fwd_mma_kernel.
//
// What it computes is the port's plain version of the TPU kernel: S = q k^T
// of the bf16 values summed in f32, times the scale; the softmax normalised
// in f32 as P = exp(s scale - lse), lse = max + log(sum) (JAX's _fwd_kernel
// divides the exponentials by their sum instead, which rounds P to bf16
// differently now and then); P rounded to bf16; P v summed in f32; the
// output rounded once at the store; lse in f32 for the backward. Both
// products are of bf16 values, so each is one bf16 tensor-core pass
// (m64nNk16, f32 sums).
//
// Bound on the card: at d = 32 the bytes (q, k, v read once, the output
// written once, two bytes each) and the exponentials weigh about the same;
// the fwd_mma_kernel it replaces formed S twice and took every
// exponential twice (two passes, because the definition rounds the
// NORMALISED probability, so an online softmax, which rounds exp(s - m)
// against a running max, would round elsewhere). Here, while Lk <= 256
// (every main-path shape):
//
//   * A warpgroup a block, a block a (batch element, head) and its 64-row
//     query tiles (small batches split a head's tiles over several
//     blocks). K and V of the head, a strided d-column slice of the packed
//     rows, are copied once by cp.async into swizzled tiles and serve every
//     query tile of the block; the query tiles are double-buffered, the
//     next copied while this one computes. (Blocks resident on the SMs
//     walking over heads, the next head's K and V copied ahead, gained
//     nothing: PERF.md.)
//   * One pass a query tile: S for all keys, 64 at a time (wgmma.m64n64k16,
//     q and K both read K-major from shared memory), stays in registers (at
//     Lk 256, 128 floats a thread). Keys past Lk are set to -1e30 by a
//     select; the row max and the sum of 2^(s c - m c), c = scale log2(e)
//     (one fma and ex2.approx.ftz), are taken with no branch per key (each
//     row's four lanes joined by shuffles), giving lse = m scale + log sum;
//     then P = exp(s scale - lse), the plain version's form, rounded to
//     bf16 straight into the A-operand registers of O = P V (the
//     accumulator layout of two 8-key tiles is the A layout of a 16-key
//     k-step), V read MN-major from its tile, no transposed copy; 64 keys
//     at a time, a chunk's P packed while the chunk before multiplies.
//     Two exponentials an element, as in the kernel this replaces, but S
//     formed once: P taken as JAX's e / sum instead (one exponential) flips
//     the bf16 rounding of P against the plain version twice as often, and
//     a bf16 learn step's route comparison then drifts past its gate.
//     Warps whose 16 query rows all lie past Lq skip the exponentials.
//   * Every wgmma is issued unconditionally (the zero-filled tiles past Lk
//     and D add exact zeros): one under a runtime condition makes ptxas
//     serialize all of a kernel's wgmma (its warning C7514).
//   * Lk > 256 (no main-path shape): an instance of its own keeps two
//     passes over 256-key chunks, the max and sum (rescaled from chunk to
//     chunk), then S again, the exact normalised P and O += P V.
//
// Head dims 8 and 16 use tiles 32 columns wide, zero-filled past D: one
// k-step of S (half of it zeros at d = 8), and O's columns past D are
// computed as zeros and not stored. PERF.md gives the variants measured
// (scripts/torch_conv_packed_bf16_variants.py) and what holds the kernel
// back.

#pragma once

#include <math.h>

#include "bf16_wgmma.cuh"
#include "elem_io.cuh"
#include "flash_bf16.cuh"

namespace packed_bf16 {

using bw::bf16;

constexpr int THREADS = 128;      // a warpgroup
constexpr int ROWS = 64;          // query rows of a tile
constexpr int CHUNK = 64;         // keys of one S product
constexpr int MAX_CHUNKS = 4;     // keys held at once: 256
constexpr float NEG = -1e30f;     // a masked score, and the first max
constexpr float LOG2E = 1.4426950408889634f;

// Compiled tile width at head dim D: the 64-byte swizzle's 32 columns at
// least.
__host__ __device__ constexpr int tile_w(int D) { return D < 32 ? 32 : D; }

// Dynamic shared memory: 1024 bytes to align the tiles (the swizzle is read
// on address bits), K and V tiles of nc * 64 keys, two query tiles.
constexpr size_t fwd_smem(int D, int nc) {
  return 1024 + (size_t)(2 * nc * CHUNK + 2 * ROWS) * tile_w(D) * 2;
}

// 2^x on the exp2 unit alone (ex2.approx.ftz: within 2 ulp, results below
// 2^-126 flushed to zero). exp2f adds a test and two multiplies around it
// for results in the subnormal range.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 values as one bf16 pair, a in the low half.
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return bw::bits(__floats2bfloat162_rn(a, b));
}

// A block a work item: a (batch element, head) and a run of its query
// tiles. LONG: Lk > 256, the two-pass instance (its registers apart from
// the one-pass instances').
template <int D, int NC, bool LONG>
__global__ void __launch_bounds__(THREADS, NC == 1 ? 4 : NC == 2 ? 3 : 2)
fwd_wgmma_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      float* __restrict__ lse, int Lq, int Lk, int dm,
                      int heads, float scale, int qsplit) {
  constexpr int DT = tile_w(D), KD = (D + 15) / 16, SW = bw::sw_bytes(DT);
  constexpr int KC = NC * CHUNK;                 // keys a pass holds
  constexpr int KTILE = KC * DT * 2, QTILE = ROWS * DT * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = flash_bf16::align1024(smem_raw);
  // K and V tiles, then two query tiles.
  const uint32_t kt = bw::smem_addr(sm), vt = kt + KTILE;
  auto qt = [&](int buf) { return vt + KTILE + buf * QTILE; };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long ld = dm;
  const int ntiles = (Lq + ROWS - 1) / ROWS;
  const float c2 = scale * LOG2E;

  // Work item `item`: its (batch element, head), first and end tiles.
  struct Item {
    int bh, tile0, tile1;
  };
  auto item_of = [&](int item) {
    const int part = item % qsplit;
    return Item{item / qsplit, ntiles * part / qsplit,
                ntiles * (part + 1) / qsplit};
  };
  // The (batch element, head) slice of a packed tensor of L rows.
  auto head_of = [&](const bf16* x, int bh, int L) {
    return x + ((int64_t)(bh / heads) * L) * ld + (bh % heads) * D;
  };
  auto copy_q = [&](int bh, int tile, uint32_t dst) {
    flash_bf16::copy_tile<ROWS, DT>(dst, head_of(q, bh, Lq), ld, tile * ROWS,
                                    Lq, D, true);
  };
  // K (and V) rows [c0, c0 + KC) of head bh into their tiles, zeros past
  // Lk.
  auto copy_kv = [&](int bh, int c0, bool with_v) {
    flash_bf16::copy_tile<KC, DT>(kt, head_of(k, bh, Lk) + c0 * ld, ld, 0,
                                  Lk - c0, D, true);
    if (with_v)
      flash_bf16::copy_tile<KC, DT>(vt, head_of(v, bh, Lk) + c0 * ld, ld, 0,
                                    Lk - c0, D, true);
  };
  auto sync_copies = [&]() {
    bw::cp_async_commit();
    bw::cp_async_wait<0>();
    bw::fence_async_shared();
    __syncthreads();
  };

  // S = q K^T for every chunk of the K tile at ka (zeros past Lk); issued,
  // not waited. Every wgmma is issued unconditionally: one under a runtime
  // condition makes ptxas serialize them all (C7514).
  auto scores = [&](float (&s)[NC][CHUNK / 2], uint32_t qa, uint32_t ka) {
#pragma unroll
    for (int c = 0; c < NC; ++c) wgmma_operand_fence(s[c]);
    bw::wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int ks = 0; ks < KD; ++ks)
        bw::wgmma_bf16_ss<CHUNK, 0>(
            s[c], bw::kmajor<ROWS, DT>(qa, ks),
            bw::kmajor<CHUNK, DT>(ka + c * CHUNK * SW, ks), ks > 0);
    bw::wgmma_commit();
  };
  auto scores_done = [&](float (&s)[NC][CHUNK / 2]) {
    bw::wgmma_wait();
#pragma unroll
    for (int c = 0; c < NC; ++c) wgmma_operand_fence(s[c]);
  };
  // Scores of keys past nk set to NEG (probability 0), by a select in the
  // chunks that reach past nk (every lane alike decides which chunks):
  // element 4 nt + 2 r + e of chunk c is row g + 8 r, key 64 c + 8 nt +
  // 2 t + e.
  auto mask = [&](float (&s)[NC][CHUNK / 2], int nk) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (c * CHUNK + CHUNK > nk) {
#pragma unroll
        for (int x = 0; x < CHUNK / 2; ++x) {
          const int key = c * CHUNK + 8 * (x / 4) + 2 * t + (x & 1);
          s[c][x] = key < nk ? s[c][x] : NEG;
        }
      }
  };
  // The masked scores' max of rows g, g + 8, joined across the row's four
  // lanes; no branch.
  auto row_max = [&](const float (&s)[NC][CHUNK / 2], float (&mx)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float a = NEG, b = NEG;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int nt = 0; nt < CHUNK / 8; nt += 2) {
          a = fmaxf(a, fmaxf(s[c][4 * nt + 2 * r], s[c][4 * nt + 2 * r + 1]));
          b = fmaxf(b, fmaxf(s[c][4 * nt + 4 + 2 * r],
                             s[c][4 * nt + 4 + 2 * r + 1]));
        }
      mx[r] = fmaxf(a, b);
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
  };
  // This thread's sums of 2^(s c2 - m c2) over rows g, g + 8 of the masked
  // scores (its own keys; two chains a row, even and odd keys, joined at
  // the end), s left as it is. Full chunks without a branch; in a chunk
  // that reaches past nk, groups of 8 keys wholly past it are skipped,
  // every lane alike. Only log(sum) enters lse: the fast exp2 serves.
  auto row_sum = [&](const float (&s)[NC][CHUNK / 2], int nk,
                     const float (&m)[2], float (&sum)[2]) {
    const float ml[2] = {m[0] * c2, m[1] * c2};
    float part[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
    auto group = [&](const float (&sc)[CHUNK / 2], int nt) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          part[r][e] += ex2(fmaf(sc[4 * nt + 2 * r + e], c2, -ml[r]));
    };
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c * CHUNK + CHUNK <= nk) {
#pragma unroll
        for (int nt = 0; nt < CHUNK / 8; ++nt) group(s[c], nt);
      } else {
#pragma unroll
        for (int nt = 0; nt < CHUNK / 8; ++nt)
          if (c * CHUNK + 8 * nt < nk) group(s[c], nt);
      }
    }
    sum[0] = part[0][0] + part[0][1];
    sum[1] = part[1][0] + part[1][1];
  };
  // Chunk c of s <- P = exp(s scale - lse) of rows g, g + 8, in place: the
  // plain version's form, the product rounded before the difference (no
  // fma), so the kernel's bf16 P matches the plain version's but where
  // their f32 sums differ; 0 past nk (whole groups of 8 keys wholly past it
  // skipped, every lane alike).
  auto probs = [&](float (&sc)[CHUNK / 2], int c, int nk,
                   const float (&ls)[2]) {
    auto group = [&](int nt) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * nt + 2 * r + e];
          x = expf(__fmul_rn(x, scale) - ls[r]);
        }
    };
    if (c * CHUNK + CHUNK <= nk) {
#pragma unroll
      for (int nt = 0; nt < CHUNK / 8; ++nt) group(nt);
    } else {
#pragma unroll
      for (int nt = 0; nt < CHUNK / 8; ++nt) {
        if (c * CHUNK + 8 * nt < nk) {
          group(nt);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[4 * nt + j] = 0.0f;
        }
      }
    }
  };
  auto quad_sum = [&](float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
  };
  // P rounded to bf16 into the A operands of chunk c's four P V k-steps:
  // k-step kk's register i holds elements 8 kk + 2 i and + 1 of the chunk
  // (the m16n8k16 A fragment).
  auto pack_p = [&](const float (&p)[CHUNK / 2], uint32_t (&pa)[4][4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kk][i] = pack2(p[8 * kk + 2 * i], p[8 * kk + 2 * i + 1]);
  };
  // O (+)= P V over every chunk, V read MN-major from the tile at va;
  // waited for. Chunk by chunk: its P taken (live rows; else zeros, as s
  // holds them) and packed into one of two 16-register buffers, its
  // k-steps issued while the next chunk's P is taken; a buffer is reused
  // once the chunk that read it two chunks before is waited for.
  auto pv = [&](float (&o)[DT / 2], float (&p)[NC][CHUNK / 2], int nk,
                const float (&ls)[2], bool live, uint32_t va,
                bool accumulate) {
    uint32_t pa0[4][4], pa1[4][4];
    auto chunk = [&](int c, uint32_t (&pa)[4][4]) {
      if (c >= 2) bw::wgmma_wait_pending<1>();
      if (live) probs(p[c], c, nk, ls);
      pack_p(p[c], pa);
      bw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        bw::wgmma_bf16<DT, 1>(o, pa[kk], bw::mnmajor<KC, DT>(va, 4 * c + kk),
                              accumulate || c > 0 || kk > 0);
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
  };
  // Rows of a finished query tile: the output and lse.
  auto store = [&](int bh, int row0, const float (&o)[DT / 2],
                   const float (&ls)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 16 * warp + g + 8 * r;
      if (row >= Lq) continue;
      bf16* dst = out + ((int64_t)(bh / heads) * Lq + row) * ld +
                (bh % heads) * D;
#pragma unroll
      for (int nd = 0; nd < DT / 8; ++nd) {
        const int col = 8 * nd + 2 * t;
        if (col < D)
          io::st2(dst + col, o[4 * nd + 2 * r], o[4 * nd + 2 * r + 1]);
      }
      if (t == 0 && lse != nullptr)
        lse[(int64_t)bh * Lq + row] = ls[r];
    }
  };

  float m[2], l[2], ls[2];   // row max, sum, lse = m scale + log l
  float o[DT / 2];
  float s[NC][CHUNK / 2];
  const Item it = item_of(blockIdx.x);
  if constexpr (!LONG) {
    // One pass a query tile, K and V resident. Each tile starts past a
    // barrier after every copy issued so far has landed: its q (and at the
    // first, K and V), and every warp has waited for its products of the
    // tile before, whose q tile takes the next tile's copy below.
    copy_kv(it.bh, 0, true);
    copy_q(it.bh, it.tile0, qt(0));
    bw::cp_async_commit();
    for (int tile = it.tile0, qbuf = 0; tile < it.tile1; ++tile, qbuf ^= 1) {
      const int row0 = tile * ROWS;
      const bool live = row0 + 16 * warp < Lq;   // a query row in the warp
      bw::cp_async_wait<0>();
      bw::fence_async_shared();
      __syncthreads();
      scores(s, qt(qbuf), kt);
      if (tile + 1 < it.tile1) copy_q(it.bh, tile + 1, qt(qbuf ^ 1));
      bw::cp_async_commit();
      scores_done(s);
      if (live) {
        float sum[2];
        mask(s, Lk);
        row_max(s, m);
        row_sum(s, Lk, m, sum);
#pragma unroll
        for (int r = 0; r < 2; ++r)
          ls[r] = m[r] * scale + logf(quad_sum(sum[r]));
      } else {   // P = 0: the warp's wgmma still takes part
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int x = 0; x < CHUNK / 2; ++x) s[c][x] = 0.0f;
      }
      pv(o, s, Lk, ls, live, vt, false);
      store(it.bh, row0, o, ls);
    }
  } else {
    // Two passes over KC-key chunks a query tile, the exact max and sum
    // first.
    for (int tile = it.tile0; tile < it.tile1; ++tile) {
      __syncthreads();   // the tile before is done with q, K and V
      copy_q(it.bh, tile, qt(0));
      sync_copies();
      m[0] = m[1] = NEG;
      l[0] = l[1] = 0.0f;
      for (int c0 = 0; c0 < Lk; c0 += KC) {
        const int nk = min(KC, Lk - c0);
        if (c0 > 0) __syncthreads();   // every warp is done with K
        copy_kv(it.bh, c0, false);
        sync_copies();
        scores(s, qt(0), kt);
        scores_done(s);
        float cm[2], sum[2];
        mask(s, nk);
        row_max(s, cm);
        const float mn[2] = {fmaxf(m[0], cm[0]), fmaxf(m[1], cm[1])};
        row_sum(s, nk, mn, sum);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] = l[r] * ex2((m[r] - mn[r]) * c2) + quad_sum(sum[r]);
          m[r] = mn[r];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) ls[r] = m[r] * scale + logf(l[r]);
      for (int c0 = 0; c0 < Lk; c0 += KC) {
        const int nk = min(KC, Lk - c0);
        __syncthreads();   // every warp is done with K and V
        copy_kv(it.bh, c0, true);
        sync_copies();
        scores(s, qt(0), kt);
        scores_done(s);
        mask(s, nk);
        pv(o, s, nk, ls, true, vt, c0 > 0);
      }
      store(it.bh, tile * ROWS, o, ls);
    }
  }
}

// Blocks a (batch element, head) splits its query tiles over: enough for
// three blocks on each of the 132 SMs where the batch gives fewer.
inline int query_splits(int B, int heads, int Lq) {
  const int64_t bh = (int64_t)B * heads;
  const int tiles = (Lq + ROWS - 1) / ROWS;
  const int64_t want = (3 * 132 + bh - 1) / bh;
  return (int)(want < tiles ? want : tiles);
}

template <int D, int NC, bool LONG = false>
int launch_fwd_nc(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                  float* lse, int B, int Lq, int Lk, int dm, int heads,
                  float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem(D, NC);
  auto kernel = fwd_wgmma_bf16_kernel<D, NC, LONG>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int qs = query_splits(B, heads, Lq);
  const int64_t blocks = (int64_t)B * heads * qs;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      q, k, v, out, lse, Lq, Lk, dm, heads, scale, qs);
  return (int)cudaGetLastError();
}

// Keys held at once: Lk rounded up to 64, at most 256 (past that, two
// passes over 256-key chunks).
template <int D>
int launch_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* out,
               float* lse, int B, int Lq, int Lk, int dm, int heads,
               float scale, cudaStream_t stream) {
  if (Lk > MAX_CHUNKS * CHUNK)
    return launch_fwd_nc<D, MAX_CHUNKS, true>(q, k, v, out, lse, B, Lq, Lk,
                                              dm, heads, scale, stream);
  switch ((Lk + CHUNK - 1) / CHUNK) {
    case 1: return launch_fwd_nc<D, 1>(q, k, v, out, lse, B, Lq, Lk, dm,
                                       heads, scale, stream);
    case 2: return launch_fwd_nc<D, 2>(q, k, v, out, lse, B, Lq, Lk, dm,
                                       heads, scale, stream);
    case 3: return launch_fwd_nc<D, 3>(q, k, v, out, lse, B, Lq, Lk, dm,
                                       heads, scale, stream);
    default: return launch_fwd_nc<D, 4>(q, k, v, out, lse, B, Lq, Lk, dm,
                                        heads, scale, stream);
  }
}

}  // namespace packed_bf16
