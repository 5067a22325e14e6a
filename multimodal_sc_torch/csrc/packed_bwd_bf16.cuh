// The packed attention backward on bf16 tensors (train.bf16) on bf16 wgmma:
// bwd_wgmma_bf16_kernel, counterpart of
// multimodal_sc_tpu/kernels/attention_packed.py's _bwd_impl (:201) ->
// pl.pallas_call (:218) of _bwd_kernel (:121) handed bf16 arrays with
// bf16=True. attention_packed.cu launches it for every bf16-I/O backward
// with Lk <= 256 (every main-path shape); past 256 keys, and for the bf16
// mode on f32 tensors, bwd_mma_kernel runs as before. Its f32-I/O instance
// (f32 tensors, bf16 operands) is launched by the checks alone.
//
// What it computes is packed_attention_bwd_reference(..., bf16=True,
// lse=lse), the plain version:
//   P = exp(s scale - lse), s = q k^T (bf16 values, f32 sums), lse the
//     forward's f32 logsumexp; the product rounded before the difference;
//   delta = sum_d dO O per query row, in f32 of the unrounded values;
//   dS = P (dP - delta) scale, dP = dO v^T;
//   dV = bf16(P)^T dO, dK = bf16(dS)^T q, dQ = bf16(dS) k, every sum in f32;
//   dQ rounded once at the store; dK and dV summed per 128-query block (the
//   TPU kernel's BLOCK_Q), each block's partial rounded to bf16 and added to
//   the running bf16 sum, which is rounded again (JAX's _accum, :159-162).
// The f32-I/O instance rounds q, k, v and dO to bf16 on the way into
// shared memory, keeps dK and dV in f32 over every query and stores f32: the
// sums of the bf16-I/O instance before its roundings.
//
// Bound on the card: at arm B's shapes (B 128, dm 128, d 32) the five
// products are 10 B Lq Lk dm FLOPs against 2 (4 Lq + 4 Lk) dm B bytes, under
// 64 FLOP/byte, far under the bf16 tensor-core break-even (~295): the bytes
// set the least time. What bounds a kernel in practice is the latency of
// its chains (copies, products, exponentials) between barriers and the
// instructions of the exponentials and dS, one score at a time.
// bwd_mma_kernel, which this replaces at those shapes, fed bf16 mma.sync
// from ldmatrix 16 keys a warp and 64 queries a tile: at Lq 65 its second
// tile held one row and still paid a whole stage, two barriers and a dQ
// phase; at Lk 64-65 half its warps held no key; its copies ran through
// registers in series with the products. Here (scripts/
// torch_packed_bwd_bf16_stamps.py times the phases and the variants
// measured; PERF.md gives them):
//
//   * A block a (batch element, head) at a time, one warpgroup a 64-key
//     tile of it (Lk <= 256: one to four warpgroups). The keys are the
//     products' M, so S^T = K Q^T and dP^T = V dO^T leave P^T and dS^T in
//     the accumulator layout, which is the A-register layout of dV += P^T
//     dO and dK += dS^T Q: the queries are their contraction, dO and Q read
//     MN-major by descriptor, no transposed copy. K and V of the head (a
//     strided d-column slice of the packed rows) stay in swizzled tiles for
//     the item; Q, dO and O pass through in chunks of 64 queries,
//     double-buffered, the next chunk copied while this one computes.
//   * The grid is persistent (as many blocks as fit at once, each taking
//     items in turn): with two K and V slots the next item's K and V are
//     copied from this item's first chunk on, its first chunk during this
//     one's last.
//   * Head dims 32 and 64 (a head row is a whole swizzle row): the tiles
//     arrive by TMA, one thread issuing a box a tile from tensor maps built
//     at the launch (rows past the tensor's are zeros), counted on an
//     mbarrier a chunk buffer and a K and V slot (the last warp's first
//     thread issues them, under its warpgroup's first products of a chunk:
//     right after the barrier, or by thread 0, ran 1-2% slower); lse by
//     4-byte cp.async.
//     Head dims 8 and 16, and the f32-I/O instance: cp.async, or through
//     registers. A chunk's delta = sum_d dO O is taken by the block as soon
//     as the chunk lands (at the end of the chunk before) and published by
//     the chunk's first barrier.
//   * A chunk's queries are taken 32 at a time (wgmma.m64n32k16), a tail of
//     at most 16 queries 16 at a time: Lq 65 costs 80 query columns, not
//     128 (a 32-wide tail ran 2-3% slower).
//   * P^T and dS^T are rounded to bf16 straight into the A fragments of dV
//     and dK; dS^T also goes into the warpgroup's 64 x 64 shared tile
//     [key][query] by stmatrix. The warpgroups take the chunks' dQ in turn:
//     the one whose turn it is waits for every dS^T tile (a named barrier
//     the others only arrive at) and forms dQ = dS K over every key tile,
//     A = dS^T read MN-major (the transposed-A form of wgmma), B = the K
//     tile read MN-major; dQ is rounded once at the store. No atomics: the
//     same bits from run to run.
//   * Chains: S^T and dP^T one over the head dim; dK and dV one per
//     128-query block in the accumulator (bf16 I/O; the f32-I/O instance one
//     over every query), flushed into the running bf16 sums after every
//     second chunk and after the last; dQ one a 64-key tile, the tiles
//     joined by f32 adds in key order (one chain over every key ran 3%
//     faster and flipped more of dQ's roundings). PERF.md gives the shares
//     of outputs that differ from the plain version beside bwd_mma_kernel's.
//   * dK and dV leave through the warpgroup's own V rows and a free dS^T
//     tile, in 16-byte stores of head rows.
//   * Every wgmma is issued by a whole warpgroup, and no chain's registers
//     are read while another chain is in flight: otherwise ptxas
//     serializes all of a kernel's wgmma (its warning C7514). Keys past Lk
//     and queries past Lq are zero rows (P and dS of keys past Lk are set
//     to 0).
//
// Head dims 8 and 16 use tiles 32 columns wide, zero-filled past D: one
// k-step of S^T and dP^T, and dK, dV, dQ computed over 32 columns of which
// D are stored.

#pragma once

#include <math.h>

#include <cuda.h>
#include <cudaTypedefs.h>

#include <algorithm>

#include "bf16_wgmma.cuh"
#include "elem_io.cuh"
#include "flash_bf16.cuh"

namespace packed_bwd_bf16 {

using bw::bf16;

constexpr int KEYS = 64;      // keys of a warpgroup: the products' M
constexpr int MAX_WG = 4;     // warpgroups of a block: Lk <= 256
constexpr int QC = 64;        // queries staged a chunk
constexpr int BQ = 128;       // the TPU kernel's query block (dK, dV rounding)
constexpr int DS_SW = 128;    // a dS^T tile's row: 64 queries, 128-byte swizzle
static_assert(BQ % QC == 0, "a query block is whole chunks");

// Compiled tile width at head dim D: the 64-byte swizzle's 32 columns at
// least.
__host__ __device__ constexpr int tile_w(int D) { return D < 32 ? 32 : D; }
// Bytes of a 64-row tile of width DT.
__host__ __device__ constexpr int rows_tile(int DT) {
  return QC * bw::sw_bytes(DT);
}
// Dynamic shared memory at nc warpgroups and kv_slots sets of K and V:
// 1024 bytes to align the tiles (the swizzle is read on address bits); the
// K and V tiles (nc 64-key tiles each) of each slot; two buffers of the Q,
// dO and O tiles of a chunk; two buffers of a dS^T tile a warpgroup; lse
// and delta of the two buffers; four mbarriers.
constexpr size_t smem_bytes(int D, int nc, int kv_slots) {
  return 1024 + (size_t)(2 * nc * kv_slots + 6) * rows_tile(tile_w(D)) +
         (size_t)2 * nc * KEYS * DS_SW + 4 * QC * sizeof(float) + 32;
}
constexpr size_t SMEM_MAX = 232448;   // a block's shared memory on sm_90

// K and V slots: two (the next work item's copied while this one computes)
// where two fit beside blocks enough to fill an SM, else one.
constexpr int kv_slots(int D, int nc) {
  return nc > 1 && smem_bytes(D, nc, 2) <= SMEM_MAX ? 2 : 1;
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return bw::bits(__floats2bfloat162_rn(a, b));
}

// sum_i a[i] b[i] as one fma chain in order: delta of eight columns, the
// same bits in both instances.
__device__ __forceinline__ float dot8(const float (&a)[8],
                                     const float (&b)[8]) {
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s = fmaf(a[i], b[i], s);
  return s;
}

// Four 8 x 8 bf16 matrices to shared memory from the m16n8k16 fragment
// layout (register j: matrix j, row lane / 4, columns 2 (lane % 4), + 1);
// lane i gives the address of row i % 8 of matrix i / 8.
__device__ __forceinline__ void stsm_x4(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// The tensor memory accelerator (TMA): a box of a tensor, as a tensor map
// describes it, into shared memory, its bytes counted on an mbarrier.
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(phase)
      : "memory");
}
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// bf16 pair `run` + the pair (a, b) rounded to bf16, rounded again (the
// first block: the rounded pair alone).
__device__ __forceinline__ uint32_t accum(uint32_t run, float a, float b,
                                         bool first) {
  const uint32_t part = pack2(a, b);
  if (first) return part;
  const float2 r = io::widen2(run), p = io::widen2(part);
  return pack2(r.x + p.x, r.y + p.y);
}

// A block takes the work items (batch element, head) blockIdx.x, + gridDim.x,
// ...: blockDim.x / 128 warpgroups, one a 64-key tile of the item. With two
// K and V slots the next item's K and V are copied while this one computes.
// bf16 I/O at head dims 32 and 64 (a head row is a whole swizzle row): the
// tiles arrive by TMA, one thread issuing a box a tile (tm_q, tm_do, tm_o:
// 64 rows, tm_k, tm_v: every key row of the item; rows past the tensor's
// are zeros), counted on an mbarrier a chunk buffer and a K and V slot; the
// other instances copy by cp.async or, f32, through registers. lse arrives
// by cp.async in every instance.
template <typename T, int D>
__global__ void __launch_bounds__(MAX_WG * 128, 1)
bwd_wgmma_bf16_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ o,
                      const T* __restrict__ dout,
                      const float* __restrict__ lse, T* __restrict__ dq,
                      T* __restrict__ dk, T* __restrict__ dv, int Lq, int Lk,
                      int dm, int heads, int items, float scale, int slots,
                      const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_o,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v) {
  constexpr bool IO_BF16 = io::is_bf16<T>;
  constexpr bool TMA = IO_BF16 && D >= 32;
  constexpr int DT = tile_w(D), SW = bw::sw_bytes(DT), KD = (D + 15) / 16;
  constexpr int RT = rows_tile(DT), DSB = KEYS * DS_SW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = flash_bf16::align1024(smem_raw);
  const int nthreads = blockDim.x, nc = nthreads / 128;
  // [slot][K, V] tiles, [buffer][Q, dO, O] tiles, [buffer][warpgroup] dS^T
  // tiles, lse [buffer][64], delta [buffer][64].
  const uint32_t s0 = bw::smem_addr(sm);
  auto kt = [&](int slot) { return s0 + 2 * nc * slot * RT; };
  auto vt = [&](int slot) { return kt(slot) + nc * RT; };
  const uint32_t qt0 = s0 + 2 * nc * slots * RT;
  auto qt = [&](int buf) { return qt0 + 3 * buf * RT; };
  auto dot = [&](int buf) { return qt(buf) + RT; };
  auto ot = [&](int buf) { return qt(buf) + 2 * RT; };
  const uint32_t ds0 = qt0 + 6 * RT;
  auto dst = [&](int buf, int w) { return ds0 + (buf * nc + w) * DSB; };
  float* lse_s = reinterpret_cast<float*>(sm + (ds0 - s0) + 2 * nc * DSB);
  float* delta_b = lse_s + 2 * QC;
  // TMA: the mbarriers of the chunk buffers and the K and V slots, and the
  // phase each waits for next (bit buf; bit 2 + slot).
  const uint32_t bar0 = bw::smem_addr(delta_b + 2 * QC);
  auto cbar = [&](int buf) { return bar0 + 8 * buf; };
  auto kbar = [&](int slot) { return bar0 + 16 + 8 * slot; };
  uint32_t phases = 0;

  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int64_t ld = dm;
  const int nchunks = (Lq + QC - 1) / QC;
  // This thread's keys: rows g and g + 8 of its warp's 16; a warp whose
  // keys all lie past Lk skips the exponentials (its P and dS are 0).
  const int key0 = wg * KEYS + 16 * warp + g;
  const bool key_ok0 = key0 < Lk, key_ok1 = key0 + 8 < Lk;
  const bool warp_live = wg * KEYS + 16 * warp < Lk;
  // This lane's row of the stmatrix that stores dS^T: matrix lane / 8 holds
  // keys + 8 (m & 1), queries + 8 (m >> 1) of a 16 x 16 piece.
  const int sm_row = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int sm_col = 8 * (lane >> 4);

  // The rows of item it's head in the packed q, O, dO, dQ (Lq rows) and k,
  // v, dK, dV (Lk rows).
  auto qrow = [&](int it) {
    return (int64_t)(it / heads) * Lq * ld + (it % heads) * D;
  };
  auto krow = [&](int it) {
    return (int64_t)(it / heads) * Lk * ld + (it % heads) * D;
  };
  auto wg_sync = [&]() {
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  };

  // Rows [r0, r0 + rows) of src (n rows valid) into the tile at dst, zeros
  // past n and past D, by every thread of the block: bf16 by cp.async in
  // 16-byte chunks; f32 rounded to bf16 through registers.
  auto copy_rows = [&](uint32_t to, const T* src, int r0, int rows, int n) {
    if constexpr (IO_BF16) {
      constexpr int C = DT / 8;
#pragma unroll 1
      for (int i = tid; i < rows * C; i += nthreads) {
        const int r = i / C, c = (i % C) * 8;
        const bool ok = r0 + r < n && c < D;
        bw::cp_async16(to + bw::tile_off<QC, DT>(r, c),
                       ok ? src + (r0 + r) * ld + c : src, ok);
      }
    } else {
      constexpr int C = DT / 4;
#pragma unroll 1
      for (int i = tid; i < rows * C; i += nthreads) {
        const int r = i / C, c = (i % C) * 4;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r0 + r < n && c < D) x = io::ld4(src + (r0 + r) * ld + c);
        *reinterpret_cast<uint2*>(sm + (to - s0) +
                                  bw::tile_off<QC, DT>(r, c)) =
            make_uint2(pack2(x.x, x.y), pack2(x.z, x.w));
      }
    }
  };
  auto copy_kv = [&](int it, int slot) {
    if constexpr (TMA) {
      if (tid == nthreads - 32) {
        mbar_expect(kbar(slot), 2 * nc * KEYS * D * 2);
        tma_load(kt(slot), &tm_k, (it % heads) * D, 0, it / heads,
                 kbar(slot));
        tma_load(vt(slot), &tm_v, (it % heads) * D, 0, it / heads,
                 kbar(slot));
      }
    } else {
      copy_rows(kt(slot), k + krow(it), 0, nc * KEYS, Lk);
      copy_rows(vt(slot), v + krow(it), 0, nc * KEYS, Lk);
    }
  };
  // delta of row r from its eight columns' dO and O at this lane into
  // to[r]: a row's chunks of eight on neighbouring lanes, joined by shuffles
  // (the same order in both instances).
  auto put_delta = [&](float* to, int r, int c, const float (&a)[8],
                       const float (&y)[8]) {
    float s = dot8(a, y);
#pragma unroll
    for (int off = DT / 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (c == 0) to[r] = s;
  };
  // Chunk j of item it: Q, dO (and O), lse into buffer buf; the f32-I/O
  // instance also takes delta of the unrounded values here, rounding dO on
  // the way.
  auto copy_chunk = [&](int it, int j, int buf) {
    const int r0 = j * QC;
    const int64_t qr = qrow(it);
    if constexpr (TMA) {
      if (tid == nthreads - 32) {
        const int c0 = (it % heads) * D, c2 = it / heads;
        mbar_expect(cbar(buf), 3 * QC * D * 2);
        tma_load(qt(buf), &tm_q, c0, r0, c2, cbar(buf));
        tma_load(dot(buf), &tm_do, c0, r0, c2, cbar(buf));
        tma_load(ot(buf), &tm_o, c0, r0, c2, cbar(buf));
      }
    } else if constexpr (IO_BF16) {
      copy_rows(qt(buf), q + qr, r0, QC, Lq);
      copy_rows(dot(buf), dout + qr, r0, QC, Lq);
      copy_rows(ot(buf), o + qr, r0, QC, Lq);
    } else {
      copy_rows(qt(buf), q + qr, r0, QC, Lq);
      constexpr int C = DT / 8;
      uint8_t* dp_ = sm + (dot(buf) - s0);
#pragma unroll 1
      for (int i = tid; i < QC * C; i += nthreads) {
        const int r = i / C, c = (i % C) * 8;
        float a[8] = {}, y[8] = {};
        if (r0 + r < Lq && c < D) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int64_t at = qr + (r0 + r) * ld + c + 4 * h;
            const float4 a4 = io::ld4(dout + at), y4 = io::ld4(o + at);
            a[4 * h] = a4.x, a[4 * h + 1] = a4.y, a[4 * h + 2] = a4.z;
            a[4 * h + 3] = a4.w;
            y[4 * h] = y4.x, y[4 * h + 1] = y4.y, y[4 * h + 2] = y4.z;
            y[4 * h + 3] = y4.w;
          }
        }
        *reinterpret_cast<uint4*>(dp_ + bw::tile_off<QC, DT>(r, c)) =
            make_uint4(pack2(a[0], a[1]), pack2(a[2], a[3]),
                       pack2(a[4], a[5]), pack2(a[6], a[7]));
        put_delta(delta_b + buf * QC, r, c, a, y);
      }
    }
    if (tid < QC) {
      const float* lr = lse + (int64_t)it * Lq;
      const bool ok = r0 + tid < Lq;
      bw::cp_async4(bw::smem_addr(lse_s + buf * QC + tid),
                    ok ? lr + r0 + tid : lr, ok);
    }
  };
  // bf16 I/O: delta = sum_d dO O of the 64 rows of buffer buf from the
  // staged tiles (zeros past Lq and D), by the block.
  auto deltas_from_tiles = [&](int buf) {
    constexpr int C = DT / 8;
    const uint8_t* dp_ = sm + (dot(buf) - s0);
    const uint8_t* op_ = sm + (ot(buf) - s0);
#pragma unroll 1
    for (int i = tid; i < QC * C; i += nthreads) {
      const int r = i / C, c = (i % C) * 8;
      const uint32_t off = bw::tile_off<QC, DT>(r, c);
      const uint4 a = *reinterpret_cast<const uint4*>(dp_ + off);
      const uint4 y = *reinterpret_cast<const uint4*>(op_ + off);
      const uint32_t av[4] = {a.x, a.y, a.z, a.w}, yv[4] = {y.x, y.y, y.z, y.w};
      float af[8], yf[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 p = io::widen2(av[e]), w = io::widen2(yv[e]);
        af[2 * e] = p.x;
        af[2 * e + 1] = p.y;
        yf[2 * e] = w.x;
        yf[2 * e + 1] = w.y;
      }
      put_delta(delta_b + buf * QC, r, c, af, yf);
    }
  };

  float dka[DT / 2], dva[DT / 2];
#pragma unroll
  for (int i = 0; i < DT / 2; ++i) dka[i] = dva[i] = 0.0f;
  // bf16 I/O: the running bf16 sums of dK and dV over the query blocks done,
  // as pairs (accumulator elements 4 nt + 2 r, + 1 at 2 nt + r); the
  // accumulators then hold the current block's partial.
  uint32_t dk_run[DT / 4], dv_run[DT / 4];
#pragma unroll
  for (int i = 0; i < DT / 4; ++i) dk_run[i] = dv_run[i] = 0u;
  auto flush = [&](bool first) {
#pragma unroll
    for (int nt = 0; nt < DT / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int x = 4 * nt + 2 * r;
        dk_run[2 * nt + r] = accum(dk_run[2 * nt + r], dka[x], dka[x + 1],
                                   first);
        dv_run[2 * nt + r] = accum(dv_run[2 * nt + r], dva[x], dva[x + 1],
                                   first);
        dka[x] = dka[x + 1] = dva[x] = dva[x + 1] = 0.0f;
      }
  };

  // Queries [s, s + N) of the chunk in buffer buf against this warpgroup's
  // keys (K and V tiles of slot). issue_sdp: S^T and dP^T (64 keys x N
  // queries, one chain over the head dim each), issued, not committed.
  auto issue_sdp = [&](auto n_, auto& st, auto& dpt, int buf, int slot,
                       int s) {
    constexpr int N = decltype(n_)::value;
    const uint32_t kw = kt(slot) + wg * KEYS * SW;
    const uint32_t vw = vt(slot) + wg * KEYS * SW;
#pragma unroll
    for (int ks = 0; ks < KD; ++ks)
      bw::wgmma_bf16_ss<N, 0>(st, bw::kmajor<KEYS, DT>(kw, ks),
                              bw::kmajor<QC, DT>(qt(buf) + s * SW, ks),
                              ks > 0);
#pragma unroll
    for (int ks = 0; ks < KD; ++ks)
      bw::wgmma_bf16_ss<N, 0>(dpt, bw::kmajor<KEYS, DT>(vw, ks),
                              bw::kmajor<QC, DT>(dot(buf) + s * SW, ks),
                              ks > 0);
  };
  // probs: P^T and dS^T in the accumulator layout (element 4 nt + 2 r + e:
  // key g + 8 r of the warp's 16, query 8 nt + 2 t + e), rounded into the A
  // fragments of dV and dK (k-step kk's register i: elements 8 kk + 2 i,
  // + 1), dS^T also into the warpgroup's tile (one stmatrix a k-step).
  // Masked keys' P is exp(-inf) = 0, selected on the argument (no branch);
  // a group of 8 queries wholly past the chunk's nq (the tail's second) and
  // warps with no key skip the exponentials.
  auto probs = [&](auto n_, const auto& st, const auto& dpt, auto& pa,
                   auto& dsa, int buf, int s, int nq, const float* dl) {
    constexpr int N = decltype(n_)::value, KK = N / 16;
    const float* ls = lse_s + buf * QC + s;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[kk][i] = dsa[kk][i] = 0u;
    if (warp_live) {
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt) {
        if (N == 16 && nt == 1 && s + 8 >= nq) break;
        const float2 l2 =
            *reinterpret_cast<const float2*>(ls + 8 * nt + 2 * t);
        const float2 d2 =
            *reinterpret_cast<const float2*>(dl + s + 8 * nt + 2 * t);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int x = 4 * nt + 2 * r;
          const bool ok = r ? key_ok1 : key_ok0;
          const float a0 = __fmul_rn(st[x], scale) - l2.x;
          const float a1 = __fmul_rn(st[x + 1], scale) - l2.y;
          const float p0 = expf(ok ? a0 : -INFINITY);
          const float p1 = expf(ok ? a1 : -INFINITY);
          pa[nt >> 1][2 * (nt & 1) + r] = pack2(p0, p1);
          dsa[nt >> 1][2 * (nt & 1) + r] =
              pack2(p0 * (dpt[x] - d2.x) * scale,
                    p1 * (dpt[x + 1] - d2.y) * scale);
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      stsm_x4(dst(buf, wg) +
                  bw::tile_off<KEYS, QC>(sm_row, s + 16 * kk + sm_col),
              dsa[kk]);
  };
  // issue_dkv: dV += P^T dO, dK += dS^T Q (dO and Q read MN-major), issued,
  // not committed.
  auto issue_dkv = [&](auto n_, const auto& pa, const auto& dsa, int buf,
                       int s) {
    constexpr int KK = decltype(n_)::value / 16;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      bw::wgmma_bf16<DT, 1>(dva, pa[kk],
                            bw::mnmajor<QC, DT>(dot(buf), s / 16 + kk), 1);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      bw::wgmma_bf16<DT, 1>(dka, dsa[kk],
                            bw::mnmajor<QC, DT>(qt(buf), s / 16 + kk), 1);
  };
  // The chunk's queries: 32 at a time, a tail of at most 16 then 16 at a
  // time. (Issuing the next 32's S^T and dP^T with this 32's dV and dK, one
  // wait a step, ran 7% slower.)
  // TMA: a chunk's delta is taken as soon as it lands, at the end of the
  // chunk before (here, before the first), and published by the next
  // barrier A. (Taking it under the chunk's last S^T and dP^T ran 3%
  // slower.)
  auto chunk_landed = [&](int b_) {
    mbar_wait(cbar(b_), (phases >> b_) & 1);
    phases ^= 1u << b_;
    deltas_from_tiles(b_);
  };
  // The next copies (issue_next) go out under the chunk's first S^T and
  // dP^T: a thread issuing TMA can stall a while, and its warpgroup's
  // products are then already running.
  auto chunk = [&](int buf, int slot, int nq, const float* dl,
                   auto issue_next) {
    bool first = true;
    auto step = [&](auto n_, int s) {
      constexpr int N = decltype(n_)::value;
      float st[N / 2], dpt[N / 2];
      uint32_t pa[N / 16][4], dsa[N / 16][4];
      wgmma_operand_fence(st);
      wgmma_operand_fence(dpt);
      bw::wgmma_fence();
      issue_sdp(n_, st, dpt, buf, slot, s);
      bw::wgmma_commit();
      if (first) issue_next();
      first = false;
      bw::wgmma_wait();
      wgmma_operand_fence(st);
      wgmma_operand_fence(dpt);
      probs(n_, st, dpt, pa, dsa, buf, s, nq, dl);
      wgmma_operand_fence(dva);
      wgmma_operand_fence(dka);
      bw::wgmma_fence();
      issue_dkv(n_, pa, dsa, buf, s);
      bw::wgmma_commit_wait();
      wgmma_operand_fence(dva);
      wgmma_operand_fence(dka);
    };
    int s = 0;
#pragma unroll 1
    for (; s + 16 < nq; s += 32) step(std::integral_constant<int, 32>(), s);
#pragma unroll 1
    for (; s < nq; s += 16) step(std::integral_constant<int, 16>(), s);
  };

  // dQ of the chunk in buffer buf (rows q0 + [0, 64) of item it) by the
  // warpgroup that takes it: dS (64 queries x 64 keys, each warpgroup's dS^T
  // tile read MN-major) K (64 keys x DT, read MN-major), a chain a key tile
  // joined by f32 adds in key order; rounded once.
  auto chunk_dq = [&](int buf, int slot, int it, int q0) {
    float dqa[DT / 2], tq[DT / 2];
#pragma unroll 1
    for (int w = 0; w < nc; ++w) {
      wgmma_operand_fence(tq);
      bw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KEYS / 16; ++kk)
        bw::wgmma_bf16_ss<DT, 1, 1>(
            tq, bw::mnmajor<KEYS, QC>(dst(buf, w), kk),
            bw::mnmajor<KEYS, DT>(kt(slot) + w * KEYS * SW, kk), kk > 0);
      bw::wgmma_commit_wait();
      wgmma_operand_fence(tq);
#pragma unroll
      for (int i = 0; i < DT / 2; ++i)
        dqa[i] = w == 0 ? tq[i] : dqa[i] + tq[i];
    }
    const int64_t qr = qrow(it);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + 16 * warp + g + 8 * r;
      if (row >= Lq) continue;
#pragma unroll
      for (int nt = 0; nt < DT / 8; ++nt) {
        const int col = 8 * nt + 2 * t;
        if (col < D)
          io::st2(dq + qr + row * ld + col, dqa[4 * nt + 2 * r],
                  dqa[4 * nt + 2 * r + 1]);
      }
    }
  };

  // dK and dV of item it from this thread's sums: bf16 through this
  // warpgroup's own V rows of slot (their one reader, its dP^T, is done)
  // and its own dS^T tile of buffer buf (not the last chunk's: its dQ is
  // done), then 16-byte stores of head rows; f32 straight from the
  // accumulators. The K rows stay with the dQ of the last chunk.
  auto store_dkv = [&](int it, int slot, int buf) {
    const int64_t kr = krow(it);
    if constexpr (IO_BF16) {
      uint8_t* kst = sm + (dst(buf, wg) - s0);
      uint8_t* vst = sm + (vt(slot) + wg * KEYS * SW - s0);
#pragma unroll
      for (int nt = 0; nt < DT / 8; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t off =
              bw::tile_off<QC, DT>(16 * warp + g + 8 * r, 8 * nt + 2 * t);
          *reinterpret_cast<uint32_t*>(kst + off) = dk_run[2 * nt + r];
          *reinterpret_cast<uint32_t*>(vst + off) = dv_run[2 * nt + r];
        }
      wg_sync();
      constexpr int C = DT / 8;
#pragma unroll 1
      for (int i = wtid; i < KEYS * C; i += 128) {
        const int r = i / C, c = (i % C) * 8, key = wg * KEYS + r;
        if (key >= Lk || c >= D) continue;
        const uint32_t off = bw::tile_off<QC, DT>(r, c);
        const int64_t at = kr + key * ld + c;
        *reinterpret_cast<uint4*>(dk + at) =
            *reinterpret_cast<const uint4*>(kst + off);
        *reinterpret_cast<uint4*>(dv + at) =
            *reinterpret_cast<const uint4*>(vst + off);
      }
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key >= Lk) continue;
#pragma unroll
        for (int nt = 0; nt < DT / 8; ++nt) {
          const int col = 8 * nt + 2 * t;
          if (col >= D) continue;
          const int64_t at = kr + key * ld + col;
          io::st2(dk + at, dka[4 * nt + 2 * r], dka[4 * nt + 2 * r + 1]);
          io::st2(dv + at, dva[4 * nt + 2 * r], dva[4 * nt + 2 * r + 1]);
        }
      }
#pragma unroll
      for (int i = 0; i < DT / 2; ++i) dka[i] = dva[i] = 0.0f;
    }
  };

  int item = blockIdx.x, slot = 0, buf = 0, j = 0, turn = 0;
  bool kv_newest = false;
  if (TMA && tid == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(bar0 + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    tma_prefetch(&tm_q);
    tma_prefetch(&tm_do);
    tma_prefetch(&tm_o);
    tma_prefetch(&tm_k);
    tma_prefetch(&tm_v);
  }
  __syncthreads();
  copy_kv(item, 0);
  copy_chunk(item, 0, 0);
  bw::cp_async_commit();
  if constexpr (TMA) chunk_landed(0);
  for (;;) {
    const int q0 = j * QC, nq = min(QC, Lq - q0);
    const bool last = j + 1 == nchunks;
    const int next = last ? item + (int)gridDim.x : item;
    // Past this barrier chunk j and (TMA, f32 I/O) its delta are in shared
    // memory, and every thread is done with the buffers the next copies
    // take: chunk j - 1's, and with two slots the item before's K and V
    // (its last dQ and its staged dK, dV). Chunk j's cp.async copies are
    // every commit group but, at the second chunk, the newest: the next
    // item's K and V.
    if (kv_newest)
      bw::cp_async_wait<1>();
    else
      bw::cp_async_wait<0>();
    bw::fence_async_shared();
    __syncthreads();
    // The next chunk (or item's first) and, from an item's first chunk, the
    // next item's K and V; issued under the chunk's first products.
    auto issue_next = [&]() {
      if (next < items) copy_chunk(next, last ? 0 : j + 1, buf ^ 1);
      bw::cp_async_commit();
      // With two slots the next item's K and V are copied from the first
      // chunk on (the item before is done with them), a group of their own.
      kv_newest = false;
      if (j == 0 && slots == 2 && item + (int)gridDim.x < items) {
        copy_kv(item + gridDim.x, slot ^ 1);
        bw::cp_async_commit();
        kv_newest = !last;
      }
    };
    if constexpr (TMA) {   // the item's K and V
      if (j == 0) {
        mbar_wait(kbar(slot), (phases >> (2 + slot)) & 1);
        phases ^= 4u << slot;
      }
    } else if constexpr (IO_BF16) {
      deltas_from_tiles(buf);
      __syncthreads();
    }
    const float* dl = delta_b + buf * QC;

    chunk(buf, slot, nq, dl, issue_next);

    // The warpgroups take the chunks' dQ in turn: it waits for every dS^T
    // tile of the chunk, the others go on (barrier 5: sync or arrive).
    bw::fence_async_shared();
    if (wg == turn) {
      asm volatile("bar.sync 5, %0;\n" ::"r"(nthreads) : "memory");
      chunk_dq(buf, slot, item, q0);
    } else {
      asm volatile("bar.arrive 5, %0;\n" ::"r"(nthreads) : "memory");
    }
    turn = turn + 1 == nc ? 0 : turn + 1;
    if constexpr (IO_BF16) {
      if ((q0 + QC) % BQ == 0 || q0 + QC >= Lq) flush(q0 < BQ);
    }
    if constexpr (TMA) {
      if (next < items) chunk_landed(buf ^ 1);
    }
    buf ^= 1;
    if (!last) {
      ++j;
      continue;
    }
    store_dkv(item, slot, buf);
    if (next >= items) break;
    if (slots == 1) {   // the last dQ and every staging are done with slot 0
      __syncthreads();
      copy_kv(next, 0);
      bw::cp_async_commit();
    } else {
      slot ^= 1;
    }
    item = next;
    j = 0;
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime (no link to
// libcuda).
inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &got) == cudaSuccess &&
        got == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// The tensor map of a bf16 (B, L, dm) tensor read a (rows x D) box of a
// head's columns at a time, in the swizzle of a D-wide tile (D 32: 64
// bytes, D 64: 128); rows past L read as zeros.
inline bool rows_map(CUtensorMap* m, const void* base, int B, int L, int dm,
                     int D, int rows) {
  const auto fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[3] = {(cuuint64_t)dm, (cuuint64_t)L, (cuuint64_t)B};
  cuuint64_t strides[2] = {(cuuint64_t)dm * 2, (cuuint64_t)L * dm * 2};
  cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)rows, 1};
  cuuint32_t step[3] = {1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            D * 2 == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Blocks of the grid: as many as fit on the card at once, at most one a
// work item (B heads of them).
template <typename T, int D>
int launch_bwd(const T* q, const T* k, const T* v, const T* o, const T* dout,
               const float* lse, T* dq, T* dk, T* dv, int B, int Lq, int Lk,
               int dm, int heads, float scale, cudaStream_t stream) {
  if (Lk > MAX_WG * KEYS) return (int)cudaErrorInvalidValue;
  const int nc = (Lk + KEYS - 1) / KEYS, slots = kv_slots(D, nc);
  const size_t smem = smem_bytes(D, nc, slots);
  auto kernel = bwd_wgmma_bf16_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, 128 * nc, smem)) != cudaSuccess)
    return (int)e;
  const int64_t items = (int64_t)B * heads;
  if (items > 2147483647LL || per_sm < 1) return (int)cudaErrorInvalidValue;
  const int64_t blocks = std::min<int64_t>(items, (int64_t)per_sm * sms);
  CUtensorMap tm[5] = {};
  if constexpr (io::is_bf16<T> && D >= 32) {
    if (!rows_map(&tm[0], q, B, Lq, dm, D, QC) ||
        !rows_map(&tm[1], dout, B, Lq, dm, D, QC) ||
        !rows_map(&tm[2], o, B, Lq, dm, D, QC) ||
        !rows_map(&tm[3], k, B, Lk, dm, D, nc * KEYS) ||
        !rows_map(&tm[4], v, B, Lk, dm, D, nc * KEYS))
      return (int)cudaErrorInvalidValue;
  }
  kernel<<<(unsigned)blocks, 128 * nc, smem, stream>>>(
      q, k, v, o, dout, lse, dq, dk, dv, Lq, Lk, dm, heads, (int)items, scale,
      slots, tm[0], tm[1], tm[2], tm[3], tm[4]);
  return (int)cudaGetLastError();
}

}  // namespace packed_bwd_bf16
