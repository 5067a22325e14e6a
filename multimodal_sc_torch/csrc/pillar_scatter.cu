// Batched pillar scatter-max (per-point features -> BEV cells) and its
// gradient.
//
// Replaces the TPU kernel multimodal_sc_tpu/kernels/pillar_scatter.py
// (scatter_max_pallas / _scatter_kernel), which max-accumulated one point
// at a time into a VMEM-resident grid, relying on the TPU grid running in
// order, and zeroed untouched cells in an epilogue. The JAX package has no
// backward kernel (XLA differentiates segment_max); the backward here is
// new and keeps segment_max's gradient: a cell's gradient splits evenly
// among the points that tie at its max.
//
// Bound on the card: bytes. Forward: each point's cell and each in-range
// point's features read once, the (B, cells, D) grid written once; one
// compare per feature, far below the memory rate's break-even. So the grid
// never touches device memory before its one write:
//
//   * one block owns one env and one slice of `width` features, and holds
//     that slice of the env's grid in shared memory (cells x width floats;
//     the wrapper picks the width so that it fits and the card has enough
//     blocks);
//   * the block fills its grid with the sentinel, streams the env's points
//     (feature index fastest, float4 loads where D allows), skips trash and
//     out-of-range cells, and takes the max with shared-memory integer
//     atomics;
//   * it writes its slice once, coalesced, with the epilogue folded in: a
//     cell still at the sentinel (no point reached it) becomes 0, a cell
//     whose points were all negative keeps its negative max.
//
// Backward, the same blocks: pass 1 counts, per (cell, feature), the points
// equal to the forward's max into a shared int grid (exact integer
// atomics); pass 2 writes every point's gradient, coalesced:
//   gf[b,n,f] = (cell real and feats == out[b,cell,f]) ? g[b,cell,f] / count : 0
// `out` and `g` are gathered at the cells that hold points only (through
// L2). The division is IEEE (no fast math), as PyTorch's, so the result is
// bit-equal to autograd of the plain version.
//
// Float max through integer atomics: for v >= 0 (sign bit clear) the int
// bits order like the floats, so atomicMax on int; for v < 0 the unsigned
// bits order inversely, so atomicMin on unsigned. Mixed signs resolve
// correctly because every non-negative float is above every negative one
// in both views. The result does not depend on the order of the atomics,
// so it is exact and the same on every run.
//
// bf16 I/O (train.bf16; the TPU kernel reads and writes the activation
// dtype): where D is a multiple of 8 (every bf16 path's D 64), the kernels
// of scatter_bf16.cuh, designed for bf16 rows (scatter_max_bf16_launch,
// scatter_max_bwd_bf16_launch); for other D the same kernels as f32
// instantiated on bf16 rows, read 4 or 1 to a
// load (8 or 2 bytes) and upcast to f32, which is lossless, so the max on
// the f32 bits is the bf16 max and its bf16 store is exact. The gradient
// gives the bits of the JAX package's pillar net, which widens its bf16
// features to f32 before the scatter: XLA's f32 segment_max gradient, the
// cotangent times the reciprocal of the tie count, g * (1 / count) in f32,
// then rounded to bf16 by the widening's transpose. The counts stay exact
// integers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scatter_bf16.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void smem_max(float* addr, float v) {
  if (__float_as_int(v) >= 0) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

// VEC neighbouring elements of a row of E (float or bf16) as floats, in
// one load (16 bytes of float4, 8 of four bf16) or one element; and back.
template <typename E, int VEC>
struct Row;
template <>
struct Row<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) {
    v[0] = __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[1]) {
    *p = v[0];
  }
};
template <>
struct Row<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
__device__ __forceinline__ float bf16_bits_to_f32(uint32_t bits) {
  return __uint_as_float(bits << 16);
}
__device__ __forceinline__ uint32_t f32_to_bf16_bits(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}
template <>
struct Row<bf16, 1> {
  static __device__ __forceinline__ void load(const bf16* p, float (&v)[1]) {
    v[0] = bf16_bits_to_f32(__ldg(reinterpret_cast<const unsigned short*>(p)));
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&v)[1]) {
    *reinterpret_cast<unsigned short*>(p) =
        (unsigned short)f32_to_bf16_bits(v[0]);
  }
};
template <>
struct Row<bf16, 4> {
  static __device__ __forceinline__ void load(const bf16* p, float (&v)[4]) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = bf16_bits_to_f32(t.x & 0xffffu); v[1] = bf16_bits_to_f32(t.x >> 16);
    v[2] = bf16_bits_to_f32(t.y & 0xffffu); v[3] = bf16_bits_to_f32(t.y >> 16);
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&v)[4]) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(f32_to_bf16_bits(v[0]) | (f32_to_bf16_bits(v[1]) << 16),
                   f32_to_bf16_bits(v[2]) | (f32_to_bf16_bits(v[3]) << 16));
  }
};

// A tied max's share of the cell's gradient: g / count in f32 (IEEE, as
// torch's division); for bf16 rows XLA's f32 share, g * (1 / count), which
// the store rounds to bf16 (see the note above).
__device__ __forceinline__ float share(float g, int count, float) {
  return g / (float)count;
}
__device__ __forceinline__ float share(float g, int count, bf16) {
  return g * (1.0f / (float)count);
}

// Where a block and a thread sit. Block (env b, slice s) owns features
// [f0, f0 + w) of env b; `lanes` threads cover one point's (or one cell's)
// slice, VEC features each, so a pass over points takes `rows` points at a
// time. Threads past rows * lanes, and lanes past the slice's last feature
// (a last slice narrower than `width`), do no point work.
struct Slot {
  int b, f0, w, lanes, rows, lane, row;
  bool active;
};

template <int VEC>
__device__ __forceinline__ Slot slot(int dim, int width, int n_slices) {
  Slot s;
  s.b = blockIdx.x / n_slices;
  s.f0 = (blockIdx.x % n_slices) * width;
  s.w = min(width, dim - s.f0);
  s.lanes = width / VEC;
  s.rows = blockDim.x / s.lanes;
  s.lane = threadIdx.x % s.lanes;
  s.row = threadIdx.x / s.lanes;
  s.active = s.row < s.rows && s.lane * VEC < s.w;
  return s;
}

// Grid: B * n_slices blocks of kThreads; dynamic shared memory
// num_cells * width floats.
template <typename E, int VEC>
__global__ void __launch_bounds__(kThreads)
    scatter_max_kernel(const E* __restrict__ feats,
                       const int* __restrict__ cell, E* __restrict__ out,
                       int n_points, int dim, int num_cells, int width,
                       int n_slices) {
  using R = Row<E, VEC>;
  extern __shared__ float grid[];  // [num_cells][width]
  const Slot s = slot<VEC>(dim, width, n_slices);
  const int size = num_cells * width;
  for (int i = threadIdx.x; i < size; i += blockDim.x) grid[i] = kNeg;
  __syncthreads();

  const int f = s.lane * VEC;
  if (s.active) {
    const int* cb = cell + (int64_t)s.b * n_points;
    const E* fb = feats + (int64_t)s.b * n_points * dim + s.f0 + f;
    for (int p = s.row; p < n_points; p += s.rows) {
      const int c = __ldg(cb + p);
      if (c < 0 || c >= num_cells) continue;  // num_cells is the trash cell
      float v[VEC];
      R::load(fb + (int64_t)p * dim, v);
      float* dst = grid + c * width + f;
#pragma unroll
      for (int k = 0; k < VEC; ++k) smem_max(dst + k, v[k]);
    }
  }
  __syncthreads();

  // The slice written once, the epilogue folded in.
  E* ob = out + (int64_t)s.b * num_cells * dim + s.f0;
  const int n_vec = num_cells * s.lanes;
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    const int c = i / s.lanes;
    const int ff = (i % s.lanes) * VEC;
    if (ff >= s.w) continue;
    const float* src = grid + c * width + ff;
    float v[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float x = src[k];
      v[k] = x > 0.5f * kNeg ? x : 0.0f;
    }
    R::store(ob + (int64_t)c * dim + ff, v);
  }
}

// The gradient of scatter_max_kernel's result, the same blocks; dynamic
// shared memory num_cells * width ints.
template <typename E, int VEC>
__global__ void __launch_bounds__(kThreads)
    scatter_max_bwd_kernel(const E* __restrict__ feats,
                           const int* __restrict__ cell,
                           const E* __restrict__ out,
                           const E* __restrict__ g,
                           E* __restrict__ gf, int n_points, int dim,
                           int num_cells, int width, int n_slices) {
  using R = Row<E, VEC>;
  extern __shared__ int count[];  // [num_cells][width]
  const Slot s = slot<VEC>(dim, width, n_slices);
  const int size = num_cells * width;
  for (int i = threadIdx.x; i < size; i += blockDim.x) count[i] = 0;
  __syncthreads();

  const int f = s.lane * VEC;
  const int* cb = cell + (int64_t)s.b * n_points;
  const int64_t env = (int64_t)s.b * n_points * dim + s.f0 + f;
  const int64_t grid0 = (int64_t)s.b * num_cells * dim + s.f0 + f;
  // Pass 1: how many points of each cell reach its max, per feature.
  if (s.active) {
    for (int p = s.row; p < n_points; p += s.rows) {
      const int c = __ldg(cb + p);
      if (c < 0 || c >= num_cells) continue;
      float v[VEC], m[VEC];
      R::load(feats + env + (int64_t)p * dim, v);
      R::load(out + grid0 + (int64_t)c * dim, m);
      int* dst = count + c * width + f;
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        if (v[k] == m[k]) atomicAdd(dst + k, 1);
    }
  }
  __syncthreads();

  // Pass 2: every point's gradient, trash points' included (zeros).
  if (s.active) {
    for (int p = s.row; p < n_points; p += s.rows) {
      const int c = __ldg(cb + p);
      float r[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) r[k] = 0.0f;
      if (c >= 0 && c < num_cells) {
        float v[VEC], m[VEC], gg[VEC];
        R::load(feats + env + (int64_t)p * dim, v);
        R::load(out + grid0 + (int64_t)c * dim, m);
        R::load(g + grid0 + (int64_t)c * dim, gg);
        const int* n = count + c * width + f;
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          if (v[k] == m[k]) r[k] = share(gg[k], n[k], E());
      }
      R::store(gf + env + (int64_t)p * dim, r);
    }
  }
}

// Dynamic shared memory above 48 KB has to be asked for, once per kernel
// and size; remember the largest size granted.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int* granted) {
  if (bytes <= 48 * 1024 || bytes <= *granted) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *granted = bytes;
  return err;
}

// Largest shared memory granted to each kernel: [element type][vec].
int granted_fwd[2][2] = {{0, 0}, {0, 0}};
int granted_bwd[2][2] = {{0, 0}, {0, 0}};

template <typename E, int VEC>
int launch_fwd(const void* feats, const int* cell, void* out, int batch,
               int n_points, int dim, int num_cells, int width,
               cudaStream_t stream) {
  const int n_slices = (dim + width - 1) / width;
  const int smem = num_cells * width * (int)sizeof(float);
  auto kernel = scatter_max_kernel<E, VEC>;
  cudaError_t err = allow_smem(
      kernel, smem, &granted_fwd[sizeof(E) == 2][VEC == 4]);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch * n_slices, kThreads, smem, stream>>>(
      static_cast<const E*>(feats), cell, static_cast<E*>(out), n_points, dim,
      num_cells, width, n_slices);
  return (int)cudaGetLastError();
}

template <typename E, int VEC>
int launch_bwd(const void* feats, const int* cell, const void* out,
               const void* g, void* gf, int batch, int n_points, int dim,
               int num_cells, int width, cudaStream_t stream) {
  const int n_slices = (dim + width - 1) / width;
  const int smem = num_cells * width * (int)sizeof(int);
  auto kernel = scatter_max_bwd_kernel<E, VEC>;
  cudaError_t err = allow_smem(
      kernel, smem, &granted_bwd[sizeof(E) == 2][VEC == 4]);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch * n_slices, kThreads, smem, stream>>>(
      static_cast<const E*>(feats), cell, static_cast<const E*>(out),
      static_cast<const E*>(g), static_cast<E*>(gf), n_points, dim, num_cells,
      width, n_slices);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch: (batch * n_slices) blocks, num_cells * width * 4 bytes of
// shared memory each. feats and out are f32, or bf16 when is_bf16. vec is
// 4 (D and width multiples of 4; rows of 16 or 8 bytes, aligned) or 1.
extern "C" int scatter_max_launch(const void* feats, const int* cell,
                                  void* out, int batch, int n_points,
                                  int dim, int num_cells, int width, int vec,
                                  int is_bf16, cudaStream_t stream) {
#define FWD(E, V)                                                        \
  return launch_fwd<E, V>(feats, cell, out, batch, n_points, dim, num_cells, \
                          width, stream)
  if (is_bf16) {
    if (vec == 4) FWD(bf16, 4);
    FWD(bf16, 1);
  }
  if (vec == 4) FWD(float, 4);
  FWD(float, 1);
#undef FWD
}

// The gradient; feats, out, g and gf all f32, or all bf16 when is_bf16.
extern "C" int scatter_max_bwd_launch(const void* feats, const int* cell,
                                      const void* out, const void* g,
                                      void* gf, int batch, int n_points,
                                      int dim, int num_cells, int width,
                                      int vec, int is_bf16,
                                      cudaStream_t stream) {
#define BWD(E, V)                                                          \
  return launch_bwd<E, V>(feats, cell, out, g, gf, batch, n_points, dim,   \
                          num_cells, width, stream)
  if (is_bf16) {
    if (vec == 4) BWD(bf16, 4);
    BWD(bf16, 1);
  }
  if (vec == 4) BWD(float, 4);
  BWD(float, 1);
#undef BWD
}

// bf16 features with D a multiple of 8 (scatter_bf16.cuh): a block of
// `threads` (256 or 512) an env and slice of `width` features (a multiple
// of 8); shared memory as scatter_bf16::smem_fwd / smem_bwd.
extern "C" int scatter_max_bf16_launch(const void* feats, const int* cell,
                                       void* out, int batch, int n_points,
                                       int dim, int num_cells, int width,
                                       int threads, cudaStream_t stream) {
  return scatter_bf16::launch_fwd(feats, cell, out, batch, n_points, dim,
                                  num_cells, width, threads, stream);
}

extern "C" int scatter_max_bwd_bf16_launch(const void* feats, const int* cell,
                                           const void* out, const void* g,
                                           void* gf, int batch, int n_points,
                                           int dim, int num_cells, int width,
                                           int threads, cudaStream_t stream) {
  return scatter_bf16::launch_bwd(feats, cell, out, g, gf, batch, n_points,
                                  dim, num_cells, width, threads, stream);
}
