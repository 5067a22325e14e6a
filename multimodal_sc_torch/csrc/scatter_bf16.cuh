// The pillar scatter-max and its gradient on bf16 features (train.bf16)
// whose D is a multiple of 8: scatter_max_bf16_kernel and
// scatter_max_bwd_bf16_kernel, counterparts of
// multimodal_sc_tpu/kernels/pillar_scatter.py's scatter_max_pallas (:79) ->
// pl.pallas_call (:94) of _scatter_kernel (:45), and of the gradient XLA
// takes of segment_max (:32 scatter_max_reference) on the features the JAX
// pillar net widens to f32. pillar_scatter.cu's bf16 entries launch them;
// f32 features, and bf16 features of other D, keep scatter_max_kernel and
// scatter_max_bwd_kernel.
//
// What they compute, bit for bit (kernels/pillar_scatter.py
// scatter_max_reference and scatter_max_backward_reference):
//   out[b, c, f] = the max over the points p of env b in cell c of
//     feats[b, p, f]; 0 where no point reached c. Points whose cell lies
//     outside [0, cells) (the trash cell `cells` among them) are dropped.
//   gf[b, p, f] = bf16(g[b, c, f] * (1 / n)), the product and the
//     reciprocal in f32, where p's cell c is real and feats[b, p, f] ==
//     out[b, c, f] (an f32 compare); n is the number of c's points equal to
//     it in f. Every other entry is 0.
//
// Bound on the card: bytes (one compare per feature). At c4's act step (B
// 1024, N 64, D 64, 256 cells) the output is 80% of them: 32 KB an env, of
// which 92% are empty cells (21 of 256 reached on average). The kernels
// they replace (the <bf16, 4> instances of pillar_scatter.cu) held an f32
// grid slice of 16 features a block (4 blocks an env), filled it with a
// sentinel, took each point's max with shared-memory atomics after two
// dependent global loads (its cell, then its features), and wrote 8-byte
// pieces of each cell row at the end of a short block; the backward read
// every point's features and `out` at its cell in both of its passes, one
// point after another. Here (scripts/torch_scatter_bf16_stamps.py stamps
// both designs' phases and times the variants; PERF.md gives the times):
//
//   * A block an item: an env and a slice of `width` features (the whole
//     row where shared memory and the block count allow: c4's and c5's
//     shapes; 16 of 64 at c3's 1024 points), read as 16-byte pieces of 8
//     bf16. A thread keeps one piece's lane and takes rows (cells or
//     points) in turn: no division in the loops. 256 threads, or 512
//     where the grid has under two blocks an SM (c3's shape, where the
//     backward ran 20% faster so). Its threads first copy the env's cells,
//     then its feature slice, into shared memory by cp.async, in two
//     commit groups: no load waits on another, and the cells land first.
//     (A persistent grid whose blocks copy the next item under this one's
//     work ran no faster: every main-path grid fits on the card at once.)
//   * Forward: lists, not a grid. Each point in a real cell links itself
//     into its cell's list (next[p] = atomicExch(&head[c], p)) as soon as
//     the cells land, while the features are still landing; head[c] = -1
//     marks an empty cell, whose row goes out as zeros (92% of c4's
//     output); no sentinel grid is filled or read back. A thread takes a
//     cell's piece, walks a reached cell's list in shared memory and
//     takes the max of 8 features on the integer keys of the bf16 bits
//     (sign clear: the bits order like the values; sign set: the low 15
//     bits flipped, so that larger magnitudes order lower; -0 sorts below
//     +0, as pillar_scatter.cu's integer atomics order them), two
//     features a __vmaxs2. The max is exact, so any order of the list
//     gives the same bits. Every row goes out in 16-byte stores, the
//     lanes of a cell on consecutive pieces (whole 128-byte lines at width
//     64), in one pass (the empty cells' zeros stored in a pass of their
//     own, before the features land, ran 25% slower at c4's act shape).
//   * Backward: a thread a piece of a point, every piece in parallel (a
//     walk of each cell's list, as the forward's, waited on crowded cells
//     and ran 2x slower than the old instance at c4's learn shape). Once
//     the cells land, `g` at each point's cell is copied into shared
//     memory by cp.async, for pass 2; pass 1 gathers `out` there (a
//     thread's kBatch pieces at once, the first batch while the features
//     land), compares, keeps the 8 hits in a byte and counts the ties in
//     shared memory, two 16-bit counts a word: one atomicAdd of 1, 1 << 16
//     or both a word (exact up to 65535 points an env; the wrapper refuses
//     more), half the shared memory of int counts. Pass 2, from shared
//     memory alone, forms bf16(g * (1 / n)) for each hit and writes every
//     piece of the slice's gradient (a hit's share, else 0; trash points'
//     zeros) in 16-byte stores. (Forming each reached cell's shares once
//     left the work to the few warps of the crowded cells and ran slower
//     at every shape.) No float atomics: the result does not depend on
//     the order of the atomics. Each point's features are read from
//     device memory once.
//
// Shared memory a block (kernels/pillar_scatter.py bf16_smem_bytes):
// forward N x (width x 2 + 8) + cells x 4 bytes; backward N x (width x 4 +
// 4 + width / 8) + cells x width x 2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace scatter_bf16 {

using bf16 = __nv_bfloat16;

constexpr int kBatch = 4;   // a thread's pieces whose gathers fly together

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Two bf16 (a 32-bit word) to two ordered 16-bit integer keys and back
// (the map is its own inverse: the sign bits stay).
__device__ __forceinline__ uint32_t key2(uint32_t w) {
  return w ^ (((w >> 15) & 0x00010001u) * 0x7fffu);
}
__device__ __forceinline__ uint4 key8(uint4 v) {
  return make_uint4(key2(v.x), key2(v.y), key2(v.z), key2(v.w));
}
__device__ __forceinline__ uint4 max8(uint4 a, uint4 b) {
  return make_uint4(__vmaxs2(a.x, b.x), __vmaxs2(a.y, b.y),
                    __vmaxs2(a.z, b.z), __vmaxs2(a.w, b.w));
}

// The 8 features of a 16-byte piece as floats (bf16 -> f32 is exact).
__device__ __forceinline__ void widen8(uint4 v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// XLA's f32 share of a tied max, g * (1 / n), rounded to bf16 bits. The
// reciprocal is __frcp_rn's, rounded to nearest as the IEEE quotient 1.0f /
// n is: the same bits, without the division's general sequence.
__device__ __forceinline__ uint32_t share_bits(float g, uint32_t n) {
  return (uint32_t)__bfloat16_as_ushort(
      __float2bfloat16_rn(g * __frcp_rn((float)n)));
}

// A block's item (env b, features [f0, f0 + 8 * lanes) of the slice) and
// its threads' place in it: a thread keeps one lane (a 16-byte piece of a
// row) and takes rows r0, r0 + rows, ...; the last T % lanes threads take
// none. No division in the loops.
template <int T>
struct Item {
  int b, f0, lanes, l, r0, rows;
  __device__ __forceinline__ Item(int dim, int width, int n_slices) {
    b = blockIdx.x / n_slices;
    f0 = (blockIdx.x - b * n_slices) * width;
    lanes = min(width, dim - f0) / 8;
    rows = T / lanes;
    l = threadIdx.x % lanes;
    r0 = threadIdx.x / lanes;
    if (r0 >= rows) r0 = 1 << 30;   // past every row
  }
};

// Copies the item's cells (4 bytes each; one commit group) and then its
// feature slice (16-byte pieces; a second group).
template <int T>
__device__ __forceinline__ void copy_item(int* cs, uint4* fs,
                                          const bf16* __restrict__ feats,
                                          const int* __restrict__ cell,
                                          const Item<T>& it, int n, int dim,
                                          int wp) {
  const int* cb = cell + (int64_t)it.b * n;
  for (int i = threadIdx.x; i < n; i += T) cp_async4(cs + i, cb + i);
  cp_async_commit();
  const bf16* fb = feats + (int64_t)it.b * n * dim + it.f0 + 8 * it.l;
  for (int p = it.r0; p < n; p += it.rows)
    cp_async16(fs + p * wp + it.l, fb + (int64_t)p * dim);
  cp_async_commit();
}

// Grid: one block of T threads an item (env, slice of `width` features);
// dynamic shared memory: [N][width / 8] feature pieces, [N] cells, [cells]
// list heads, [N] list links.
template <int T>
__global__ void __launch_bounds__(T)
    scatter_max_bf16_kernel(const bf16* __restrict__ feats,
                            const int* __restrict__ cell,
                            bf16* __restrict__ out, int n, int dim,
                            int num_cells, int width, int n_slices) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Item<T> it(dim, width, n_slices);
  const int wp = width / 8;
  uint4* fs = reinterpret_cast<uint4*>(smem);
  int* cs = reinterpret_cast<int*>(smem + (size_t)n * width * 2);
  int* heads = cs + n;
  int* next = heads + num_cells;
  copy_item<T>(cs, fs, feats, cell, it, n, dim, wp);
  for (int i = threadIdx.x; i < num_cells; i += T) heads[i] = -1;
  cp_async_wait<1>();
  __syncthreads();  // the cells landed; the heads are at -1
  // The lists, while the features land.
  for (int p = threadIdx.x; p < n; p += T) {
    const int c = cs[p];
    if (c >= 0 && c < num_cells) next[p] = atomicExch(heads + c, p);
  }
  cp_async_wait<0>();
  __syncthreads();  // the lists are linked; the features landed
  bf16* ob = out + (int64_t)it.b * num_cells * dim + it.f0 + 8 * it.l;
  const uint4* fl = fs + it.l;
  for (int c = it.r0; c < num_cells; c += it.rows) {
    int p = heads[c];
    uint4 acc = make_uint4(0u, 0u, 0u, 0u);   // an empty cell's zeros
    if (p >= 0) {
      acc = key8(fl[p * wp]);
      for (p = next[p]; p >= 0; p = next[p]) acc = max8(acc, key8(fl[p * wp]));
      acc = key8(acc);
    }
    *reinterpret_cast<uint4*>(ob + (int64_t)c * dim) = acc;
  }
}

// Grid: one block of T threads an item; dynamic shared memory: [N][width /
// 8] feature pieces, [N][width / 8] pieces of `g` at each point's cell,
// [cells][width / 2] tie counts (two 16-bit counts a word), [N] cells,
// [N][width / 8] hit masks (a byte a piece).
template <int T>
__global__ void __launch_bounds__(T)
    scatter_max_bwd_bf16_kernel(const bf16* __restrict__ feats,
                                const int* __restrict__ cell,
                                const bf16* __restrict__ out,
                                const bf16* __restrict__ g,
                                bf16* __restrict__ gf, int n, int dim,
                                int num_cells, int width, int n_slices) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Item<T> it(dim, width, n_slices);
  const int wp = width / 8, half = width / 2;
  uint4* fs = reinterpret_cast<uint4*>(smem);
  uint4* gs = fs + (size_t)n * wp;
  uint32_t* cnt = reinterpret_cast<uint32_t*>(gs + (size_t)n * wp);
  int* cs = reinterpret_cast<int*>(cnt + (size_t)num_cells * half);
  uint8_t* mask = reinterpret_cast<uint8_t*>(cs + n);
  copy_item<T>(cs, fs, feats, cell, it, n, dim, wp);
  uint4* cnt4 = reinterpret_cast<uint4*>(cnt);
  for (int i = threadIdx.x; i < num_cells * wp; i += T)
    cnt4[i] = make_uint4(0u, 0u, 0u, 0u);
  cp_async_wait<1>();
  __syncthreads();  // the cells landed; the counts are 0
  // This thread's lane of every row: of `out` and `g` at a cell, of the
  // counts, of the features, `g` copies and masks at a point.
  const int64_t lane0 = (int64_t)it.b * num_cells * dim + it.f0 + 8 * it.l;
  const bf16* ol = out + lane0;
  const bf16* gl = g + lane0;
  uint32_t* cl = cnt + 4 * it.l;
  // `g` at each real piece's cell, copied while pass 1 runs (a third
  // commit group).
  for (int p = it.r0; p < n; p += it.rows) {
    const int c = cs[p];
    if (c >= 0 && c < num_cells)
      cp_async16(gs + p * wp + it.l, gl + (int64_t)c * dim);
  }
  cp_async_commit();
  // Pass 1: each piece of a point in a real cell against `out` at the
  // cell: its hits (a byte), and the ties counted, one atomicAdd of 1 or
  // 1 << 16 (or both) a word. The first batch's gathers fly while the
  // features land.
  for (int base = 0; base < n; base += kBatch * it.rows) {
    int c[kBatch];
    uint4 m[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int p = base + it.r0 + j * it.rows;
      c[j] = -1;
      m[j] = make_uint4(0u, 0u, 0u, 0u);
      if (p < n) {
        const int cc = cs[p];
        if (cc >= 0 && cc < num_cells) {
          c[j] = cc;
          m[j] = __ldg(reinterpret_cast<const uint4*>(ol + (int64_t)cc * dim));
        }
      }
    }
    if (base == 0) {
      cp_async_wait<1>();
      __syncthreads();  // the features landed
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (c[j] < 0) continue;
      const int p = base + it.r0 + j * it.rows;
      float v[8], mf[8];
      widen8(fs[p * wp + it.l], v);
      widen8(m[j], mf);
      uint32_t bits = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) bits |= (v[k] == mf[k] ? 1u : 0u) << k;
      mask[p * wp + it.l] = (uint8_t)bits;
      uint32_t* cw = cl + c[j] * half;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t inc =
            ((bits >> (2 * i)) & 1u) | (((bits >> (2 * i + 1)) & 1u) << 16);
        if (inc) atomicAdd(cw + i, inc);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every tie is counted; `g` landed
  // Pass 2: every piece of the slice's gradient: a hit's share, else 0.
  bf16* gb = gf + (int64_t)it.b * n * dim + it.f0 + 8 * it.l;
  for (int p = it.r0; p < n; p += it.rows) {
    const int c = cs[p];
    const uint32_t bits =
        c >= 0 && c < num_cells ? mask[p * wp + it.l] : 0u;
    uint32_t r[4] = {0u, 0u, 0u, 0u};
    if (bits) {
      const uint4 n4 = *reinterpret_cast<const uint4*>(cl + c * half);
      const uint32_t nw[4] = {n4.x, n4.y, n4.z, n4.w};
      float gv[8];
      widen8(gs[p * wp + it.l], gv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if ((bits >> (2 * i)) & 1u)
          r[i] = share_bits(gv[2 * i], nw[i] & 0xffffu);
        if ((bits >> (2 * i + 1)) & 1u)
          r[i] |= share_bits(gv[2 * i + 1], nw[i] >> 16) << 16;
      }
    }
    *reinterpret_cast<uint4*>(gb + (int64_t)p * dim) =
        make_uint4(r[0], r[1], r[2], r[3]);
  }
}

inline size_t smem_fwd(int n, int width, int num_cells) {
  return (size_t)n * ((size_t)width * 2 + 8) + (size_t)num_cells * 4;
}
inline size_t smem_bwd(int n, int width, int num_cells) {
  return (size_t)n * ((size_t)width * 4 + 4 + width / 8) +
         (size_t)num_cells * width * 2;
}

// Dynamic shared memory above 48 KB has to be asked for, once per kernel
// and size; `granted` remembers the largest size granted. Internal
// linkage: each loaded library (the checks load variants side by side)
// grants its own kernels.
template <typename K>
cudaError_t allow(K kernel, size_t bytes, size_t* granted) {
  if (bytes <= 48 * 1024 || bytes <= *granted) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *granted = bytes;
  return err;
}

static size_t granted[2][2];   // [backward][512 threads]

template <int T>
int launch_fwd_t(const void* feats, const int* cell, void* out, int batch,
                 int n, int dim, int num_cells, int width,
                 cudaStream_t stream) {
  const int n_slices = (dim + width - 1) / width;
  const size_t smem = smem_fwd(n, width, num_cells);
  cudaError_t err =
      allow(scatter_max_bf16_kernel<T>, smem, &granted[0][T == 512]);
  if (err != cudaSuccess) return (int)err;
  scatter_max_bf16_kernel<T><<<batch * n_slices, T, smem, stream>>>(
      static_cast<const bf16*>(feats), cell, static_cast<bf16*>(out), n, dim,
      num_cells, width, n_slices);
  return (int)cudaGetLastError();
}

template <int T>
int launch_bwd_t(const void* feats, const int* cell, const void* out,
                 const void* g, void* gf, int batch, int n, int dim,
                 int num_cells, int width, cudaStream_t stream) {
  const int n_slices = (dim + width - 1) / width;
  const size_t smem = smem_bwd(n, width, num_cells);
  cudaError_t err =
      allow(scatter_max_bwd_bf16_kernel<T>, smem, &granted[1][T == 512]);
  if (err != cudaSuccess) return (int)err;
  scatter_max_bwd_bf16_kernel<T><<<batch * n_slices, T, smem, stream>>>(
      static_cast<const bf16*>(feats), cell, static_cast<const bf16*>(out),
      static_cast<const bf16*>(g), static_cast<bf16*>(gf), n, dim, num_cells,
      width, n_slices);
  return (int)cudaGetLastError();
}

// `threads` is 256 or 512 (kernels/pillar_scatter.py bf16_threads).
inline int launch_fwd(const void* feats, const int* cell, void* out,
                      int batch, int n, int dim, int num_cells, int width,
                      int threads, cudaStream_t stream) {
  return (threads == 512 ? launch_fwd_t<512> : launch_fwd_t<256>)(
      feats, cell, out, batch, n, dim, num_cells, width, stream);
}

inline int launch_bwd(const void* feats, const int* cell, const void* out,
                      const void* g, void* gf, int batch, int n, int dim,
                      int num_cells, int width, int threads,
                      cudaStream_t stream) {
  return (threads == 512 ? launch_bwd_t<512> : launch_bwd_t<256>)(
      feats, cell, out, g, gf, batch, n, dim, num_cells, width, stream);
}

}  // namespace scatter_bf16
