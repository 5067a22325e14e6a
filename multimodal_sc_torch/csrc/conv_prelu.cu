// Fused SAME K x K convolution + bias + optional per-channel PReLU, NHWC.
//
// Replaces the TPU kernel multimodal_sc_tpu/kernels/conv_block.py
// (_conv_prelu_pallas_s1 / _conv_kernel, with stride 2 through
// _space_to_depth / _weights_to_s2d). The space-to-depth rewrite was a
// Mosaic workaround for strided VMEM reads; here the kernel reads the
// strided window straight from shared memory, so one kernel serves
// stride 1 and 2. It computes XLA's SAME padding itself:
// lo = max((out - 1) * s + K - in, 0) / 2 (asymmetric for stride 2 on an
// even input), the rest of the window past the image reads as zero.
//
// Bound on the card: operations. On the camera encoder's shapes a layer
// does 75 to 3200 multiply-adds per output (K=5, Cin up to 128) against
// one read of its input and one write of its output, so float32 FMA
// throughput is the limit, not memory. The design: one block per image;
// the zero-padded input window sits in shared memory (at most ~74 KB on
// these shapes); each thread holds a register tile of CT output channels
// x PT neighbouring pixels, so each weight load feeds PT FMAs and each
// input load CT (the host picks the largest tile that still gives all 256
// threads a work item); HWIO weights for the CT channels are contiguous
// and go through the read-only cache as float4 loads (a layer's whole
// filter bank is at most 1.6 MB and stays in L2). Bias and PReLU are fused
// into the epilogue. Exact float32 arithmetic (no TF32), like the JAX
// kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int CT>
__device__ __forceinline__ void load_w(const float* __restrict__ p,
                                       float (&w)[CT]) {
  if constexpr (CT % 4 == 0) {
#pragma unroll
    for (int j = 0; j < CT; j += 4) {
      float4 v = __ldg(reinterpret_cast<const float4*>(p + j));
      w[j] = v.x; w[j + 1] = v.y; w[j + 2] = v.z; w[j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < CT; ++j) w[j] = __ldg(p + j);
  }
}

template <int CT, int PT>
__global__ void conv_prelu_kernel(const float* __restrict__ x,
                                  const float* __restrict__ w,
                                  const float* __restrict__ bias,
                                  const float* __restrict__ alpha,
                                  float* __restrict__ out, int H, int W,
                                  int Cin, int OH, int OW, int Cout, int K,
                                  int stride, int pad_h, int pad_w, int Hp,
                                  int Wp) {
  extern __shared__ float xs[];  // (Hp, Wp, Cin) zero-padded window
  const int n = blockIdx.x;
  const float* xn = x + (int64_t)n * H * W * Cin;
  const int n_smem = Hp * Wp * Cin;
  for (int i = threadIdx.x; i < n_smem; i += blockDim.x) {
    int c = i % Cin;
    int t = i / Cin;
    int iy = t / Wp - pad_h;
    int ix = t % Wp - pad_w;
    xs[i] = (iy >= 0 && iy < H && ix >= 0 && ix < W)
                ? xn[((int64_t)iy * W + ix) * Cin + c]
                : 0.0f;
  }
  __syncthreads();

  // Work item: CT channels x PT neighbouring pixels of one output row.
  const int groups = Cout / CT;
  const int xgroups = (OW + PT - 1) / PT;
  const int total = OH * xgroups * groups;
  float* on = out + (int64_t)n * OH * OW * Cout;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int g = t % groups;  // neighbouring threads: neighbouring channels
    const int xg = (t / groups) % xgroups;
    const int oy = t / (groups * xgroups);
    int xoff[PT];
#pragma unroll
    for (int p = 0; p < PT; ++p) {
      // Pixels past the row's end compute on the last one, never stored.
      const int ox = min(xg * PT + p, OW - 1);
      xoff[p] = ox * stride * Cin;
    }
    float acc[PT][CT];
#pragma unroll
    for (int p = 0; p < PT; ++p)
#pragma unroll
      for (int j = 0; j < CT; ++j) acc[p][j] = 0.0f;
    for (int ky = 0; ky < K; ++ky) {
      for (int kx = 0; kx < K; ++kx) {
        const float* xr = xs + ((oy * stride + ky) * Wp + kx) * Cin;
        const float* wr = w + (int64_t)(ky * K + kx) * Cin * Cout + g * CT;
        for (int ci = 0; ci < Cin; ++ci) {
          float wv[CT];
          load_w<CT>(wr + (int64_t)ci * Cout, wv);
#pragma unroll
          for (int p = 0; p < PT; ++p) {
            const float xv = xr[xoff[p] + ci];
#pragma unroll
            for (int j = 0; j < CT; ++j)
              acc[p][j] = fmaf(xv, wv[j], acc[p][j]);
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < PT; ++p) {
      const int ox = xg * PT + p;
      if (ox >= OW) break;
      float* o = on + ((int64_t)oy * OW + ox) * Cout + g * CT;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int co = g * CT + j;
        float y = acc[p][j] + __ldg(bias + co);
        if (alpha != nullptr && y < 0.0f) y *= __ldg(alpha + co);
        o[j] = y;
      }
    }
  }
}

constexpr int kThreads = 256;

template <int CT, int PT>
int launch(const float* x, const float* w, const float* b, const float* a,
           float* out, int N, int H, int W, int Cin, int OH, int OW,
           int Cout, int K, int stride, int pad_h, int pad_w, int Hp, int Wp,
           size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      conv_prelu_kernel<CT, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  conv_prelu_kernel<CT, PT><<<N, kThreads, smem, stream>>>(
      x, w, b, a, out, H, W, Cin, OH, OW, Cout, K, stride, pad_h, pad_w, Hp,
      Wp);
  return (int)cudaGetLastError();
}

}  // namespace

// alpha may be null (no PReLU). Output (N, ceil(H/s), ceil(W/s), Cout).
extern "C" int conv_prelu_launch(const float* x, const float* w,
                                 const float* b, const float* alpha,
                                 float* out, int N, int H, int W, int Cin,
                                 int Cout, int K, int stride,
                                 cudaStream_t stream) {
  if (N <= 0) return 0;
  const int OH = (H + stride - 1) / stride;
  const int OW = (W + stride - 1) / stride;
  const int tot_h = (OH - 1) * stride + K - H;
  const int tot_w = (OW - 1) * stride + K - W;
  const int pad_h = (tot_h > 0 ? tot_h : 0) / 2;
  const int pad_w = (tot_w > 0 ? tot_w : 0) / 2;
  const int Hp = (OH - 1) * stride + K;
  const int Wp = (OW - 1) * stride + K;
  const size_t smem = (size_t)Hp * Wp * Cin * sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  // Register tile (CT channels x PT pixels): the largest that still gives
  // every thread of the block a work item; else the one with most items.
  const int tiles[6][2] = {{8, 4}, {8, 2}, {4, 2}, {8, 1}, {4, 1}, {1, 1}};
  int pick = -1, best = -1;
  for (int i = 0; i < 6; ++i) {
    const int ct = tiles[i][0], pt = tiles[i][1];
    if (Cout % ct) continue;
    const int items = OH * ((OW + pt - 1) / pt) * (Cout / ct);
    if (items >= kThreads) { pick = i; break; }
    if (best < 0 || items > OH * ((OW + tiles[best][1] - 1) / tiles[best][1]) *
                                (Cout / tiles[best][0]))
      best = i;
  }
  if (pick < 0) pick = best;
#define CONV_LAUNCH(CT, PT)                                                  \
  return launch<CT, PT>(x, w, b, alpha, out, N, H, W, Cin, OH, OW, Cout, K, \
                        stride, pad_h, pad_w, Hp, Wp, smem, stream)
  switch (pick) {
    case 0: CONV_LAUNCH(8, 4);
    case 1: CONV_LAUNCH(8, 2);
    case 2: CONV_LAUNCH(4, 2);
    case 3: CONV_LAUNCH(8, 1);
    case 4: CONV_LAUNCH(4, 1);
    default: CONV_LAUNCH(1, 1);
  }
#undef CONV_LAUNCH
}
