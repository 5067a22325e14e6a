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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;

__device__ __forceinline__ void smem_max(float* addr, float v) {
  if (__float_as_int(v) >= 0) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ float get(const T& v, int) { return v; }
  static __device__ __forceinline__ void set(T& v, int, float x) { v = x; }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ float get(const T& v, int k) {
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
  }
  static __device__ __forceinline__ void set(T& v, int k, float x) {
    if (k == 0) v.x = x;
    else if (k == 1) v.y = x;
    else if (k == 2) v.z = x;
    else v.w = x;
  }
};

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
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    scatter_max_kernel(const float* __restrict__ feats,
                       const int* __restrict__ cell, float* __restrict__ out,
                       int n_points, int dim, int num_cells, int width,
                       int n_slices) {
  using V = Vec<VEC>;
  using T = typename V::T;
  extern __shared__ float grid[];  // [num_cells][width]
  const Slot s = slot<VEC>(dim, width, n_slices);
  const int size = num_cells * width;
  for (int i = threadIdx.x; i < size; i += blockDim.x) grid[i] = kNeg;
  __syncthreads();

  const int f = s.lane * VEC;
  if (s.active) {
    const int* cb = cell + (int64_t)s.b * n_points;
    const float* fb = feats + (int64_t)s.b * n_points * dim + s.f0 + f;
    for (int p = s.row; p < n_points; p += s.rows) {
      const int c = __ldg(cb + p);
      if (c < 0 || c >= num_cells) continue;  // num_cells is the trash cell
      const T v = __ldg(reinterpret_cast<const T*>(fb + (int64_t)p * dim));
      float* dst = grid + c * width + f;
#pragma unroll
      for (int k = 0; k < VEC; ++k) smem_max(dst + k, V::get(v, k));
    }
  }
  __syncthreads();

  // The slice written once, the epilogue folded in.
  float* ob = out + (int64_t)s.b * num_cells * dim + s.f0;
  const int n_vec = num_cells * s.lanes;
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    const int c = i / s.lanes;
    const int ff = (i % s.lanes) * VEC;
    if (ff >= s.w) continue;
    const float* src = grid + c * width + ff;
    T v;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float x = src[k];
      V::set(v, k, x > 0.5f * kNeg ? x : 0.0f);
    }
    *reinterpret_cast<T*>(ob + (int64_t)c * dim + ff) = v;
  }
}

// The gradient of scatter_max_kernel's result, the same blocks; dynamic
// shared memory num_cells * width ints.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    scatter_max_bwd_kernel(const float* __restrict__ feats,
                           const int* __restrict__ cell,
                           const float* __restrict__ out,
                           const float* __restrict__ g,
                           float* __restrict__ gf, int n_points, int dim,
                           int num_cells, int width, int n_slices) {
  using V = Vec<VEC>;
  using T = typename V::T;
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
      const T v = __ldg(reinterpret_cast<const T*>(feats + env +
                                                    (int64_t)p * dim));
      const T m = __ldg(reinterpret_cast<const T*>(out + grid0 +
                                                   (int64_t)c * dim));
      int* dst = count + c * width + f;
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        if (V::get(v, k) == V::get(m, k)) atomicAdd(dst + k, 1);
    }
  }
  __syncthreads();

  // Pass 2: every point's gradient, trash points' included (zeros).
  if (s.active) {
    for (int p = s.row; p < n_points; p += s.rows) {
      const int c = __ldg(cb + p);
      T r;
#pragma unroll
      for (int k = 0; k < VEC; ++k) V::set(r, k, 0.0f);
      if (c >= 0 && c < num_cells) {
        const T v = __ldg(reinterpret_cast<const T*>(feats + env +
                                                      (int64_t)p * dim));
        const T m = __ldg(reinterpret_cast<const T*>(out + grid0 +
                                                     (int64_t)c * dim));
        const T gg = __ldg(reinterpret_cast<const T*>(g + grid0 +
                                                      (int64_t)c * dim));
        const int* n = count + c * width + f;
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          if (V::get(v, k) == V::get(m, k))
            V::set(r, k, V::get(gg, k) / (float)n[k]);
      }
      *reinterpret_cast<T*>(gf + env + (int64_t)p * dim) = r;
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

int granted_fwd[2] = {0, 0};
int granted_bwd[2] = {0, 0};

}  // namespace

// One launch: (batch * n_slices) blocks, num_cells * width * 4 bytes of
// shared memory each. vec is 4 (D and width multiples of 4, 16-byte aligned
// rows) or 1.
extern "C" int scatter_max_launch(const float* feats, const int* cell,
                                  float* out, int batch, int n_points,
                                  int dim, int num_cells, int width, int vec,
                                  cudaStream_t stream) {
  const int n_slices = (dim + width - 1) / width;
  const int smem = num_cells * width * (int)sizeof(float);
  const dim3 blocks(batch * n_slices);
  cudaError_t err;
  if (vec == 4) {
    err = allow_smem(scatter_max_kernel<4>, smem, &granted_fwd[1]);
    if (err != cudaSuccess) return (int)err;
    scatter_max_kernel<4><<<blocks, kThreads, smem, stream>>>(
        feats, cell, out, n_points, dim, num_cells, width, n_slices);
  } else {
    err = allow_smem(scatter_max_kernel<1>, smem, &granted_fwd[0]);
    if (err != cudaSuccess) return (int)err;
    scatter_max_kernel<1><<<blocks, kThreads, smem, stream>>>(
        feats, cell, out, n_points, dim, num_cells, width, n_slices);
  }
  return (int)cudaGetLastError();
}

extern "C" int scatter_max_bwd_launch(const float* feats, const int* cell,
                                      const float* out, const float* g,
                                      float* gf, int batch, int n_points,
                                      int dim, int num_cells, int width,
                                      int vec, cudaStream_t stream) {
  const int n_slices = (dim + width - 1) / width;
  const int smem = num_cells * width * (int)sizeof(int);
  const dim3 blocks(batch * n_slices);
  cudaError_t err;
  if (vec == 4) {
    err = allow_smem(scatter_max_bwd_kernel<4>, smem, &granted_bwd[1]);
    if (err != cudaSuccess) return (int)err;
    scatter_max_bwd_kernel<4><<<blocks, kThreads, smem, stream>>>(
        feats, cell, out, g, gf, n_points, dim, num_cells, width, n_slices);
  } else {
    err = allow_smem(scatter_max_bwd_kernel<1>, smem, &granted_bwd[0]);
    if (err != cudaSuccess) return (int)err;
    scatter_max_bwd_kernel<1><<<blocks, kThreads, smem, stream>>>(
        feats, cell, out, g, gf, n_points, dim, num_cells, width, n_slices);
  }
  return (int)cudaGetLastError();
}
