// Batched pillar scatter-max: per-point features -> BEV cells.
//
// Replaces the TPU kernel multimodal_sc_tpu/kernels/pillar_scatter.py
// (scatter_max_pallas / _scatter_kernel), which max-accumulated one point
// at a time into a VMEM-resident grid and relied on the TPU grid running in
// order. Here blocks run in parallel in no order, so the read-modify-write
// becomes a float atomic max, and the vmapped per-env calls become one
// batched launch.
//
// Bound on the card: bytes. Each point feature is read once and each cell
// written a few times (fill, atomics, epilogue); there is one compare per
// feature, far below the memory rate's break-even. The design keeps every
// pass coalesced (feature index fastest) and touches no point twice.
//
// Float max through integer atomics: for v >= 0 (sign bit clear) the int
// bits order like the floats, so atomicMax on int; for v < 0 the unsigned
// bits order inversely, so atomicMin on unsigned. Mixed signs resolve
// correctly because every non-negative float is above every negative one
// in both views. The result does not depend on the order of the atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;

__global__ void fill_kernel(float* __restrict__ out, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = kNeg;
}

__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (__float_as_int(v) >= 0) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

// One thread per (env, point, feature).
__global__ void scatter_kernel(const float* __restrict__ feats,
                               const int* __restrict__ cell,
                               float* __restrict__ out, int n_points,
                               int dim, int num_cells, int64_t total) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int f = (int)(i % dim);
  int64_t bp = i / dim;                 // env * n_points + point
  int c = __ldg(cell + bp);
  if (c < 0 || c >= num_cells) return;  // num_cells is the trash cell
  int64_t b = bp / n_points;
  atomic_max_float(out + (b * num_cells + c) * dim + f, __ldg(feats + i));
}

// Cells no point reached keep the sentinel and become 0; a cell whose
// points were all negative keeps its negative max.
__global__ void epilogue_kernel(float* __restrict__ out, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    float v = out[i];
    out[i] = v > 0.5f * kNeg ? v : 0.0f;
  }
}

int blocks_for(int64_t n, int threads) {
  return (int)((n + threads - 1) / threads);
}

}  // namespace

extern "C" int scatter_max_launch(const float* feats, const int* cell,
                                  float* out, int batch, int n_points,
                                  int dim, int num_cells,
                                  cudaStream_t stream) {
  const int threads = 256;
  int64_t n_out = (int64_t)batch * num_cells * dim;
  int64_t n_in = (int64_t)batch * n_points * dim;
  if (n_out > 0)
    fill_kernel<<<blocks_for(n_out, threads), threads, 0, stream>>>(out,
                                                                    n_out);
  if (n_in > 0)
    scatter_kernel<<<blocks_for(n_in, threads), threads, 0, stream>>>(
        feats, cell, out, n_points, dim, num_cells, n_in);
  if (n_out > 0)
    epilogue_kernel<<<blocks_for(n_out, threads), threads, 0, stream>>>(
        out, n_out);
  return (int)cudaGetLastError();
}
