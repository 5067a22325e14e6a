// What the f32-grade (3xTF32) tensor-core kernels share: the split of an
// f32 value into two TF32 halves, asynchronous 16-byte copies, and Hopper's
// warpgroup mma (wgmma) on TF32 operands with its shared-memory matrix
// descriptor. Included by conv_prelu.cu, flash_kernels.cuh and
// mha_block.cu (for cp_async16).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// x = hi + lo for the tensor cores: hi is x rounded to TF32 (10 mantissa
// bits) to nearest, ties away from zero, which is what cvt.rna.tf32.f32
// computes, done here as an add and a mask on the bits because the
// conversion unit is slow; lo is the rest, at most half a TF32 step of x,
// handed over as it is: the tensor cores read the upper 19 bits of a
// register, so what lo loses is below 2^-21 of x.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

// Shared-memory matrix descriptor of a K-major operand without swizzle: 8
// rows x 16 bytes make a core matrix of 128 contiguous bytes; `lbo` bytes
// lead from one core matrix to the next along K, `sbo` to the next 8 rows.
__device__ __forceinline__ uint64_t wgmma_desc(const float* p, uint32_t lbo,
                                               uint32_t sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3ffffu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d (64 x BN of a warpgroup, f32) = a (64 x 8, TF32, registers) * b (8 x BN,
// TF32, shared memory) + (accumulate ? d : 0), asynchronously. A thread
// holds BN / 2 of the sums.
#define WG_R8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define WG_R16 WG_R8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define WG_R32 WG_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_R64 \
  WG_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
         "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define WG_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_D8(i) WG_D4(i), WG_D4(i + 4)
#define WG_D16(i) WG_D8(i), WG_D8(i + 8)
#define WG_D32(i) WG_D16(i), WG_D16(i + 16)
#define WG_D64(i) WG_D32(i), WG_D32(i + 32)
// n: the instruction's width; a0..a3, desc, pred: the operand numbers after
// the n / 2 sums.
#define WGMMA_TF32(n, sums, outs, a0, a1, a2, a3, desc, pred)               \
  asm volatile(                                                             \
      "{\n"                                                                 \
      ".reg .pred p;\n"                                                     \
      "setp.ne.b32 p, %" pred ", 0;\n"                                      \
      "wgmma.mma_async.sync.aligned.m64n" #n "k8.f32.tf32.tf32 {" sums "}, " \
      "{%" a0 ", %" a1 ", %" a2 ", %" a3 "}, %" desc ", p, 1, 1;\n"          \
      "}\n"                                                                 \
      : outs                                                                \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc),            \
        "r"(accumulate))

template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t b_desc, int accumulate) {
  static_assert(BN == 16 || BN == 32 || BN == 64 || BN == 128, "tile width");
  if constexpr (BN == 16) {
    WGMMA_TF32(16, WG_R8, WG_D8(0), "8", "9", "10", "11", "12", "13");
  } else if constexpr (BN == 32) {
    WGMMA_TF32(32, WG_R16, WG_D16(0), "16", "17", "18", "19", "20", "21");
  } else if constexpr (BN == 64) {
    WGMMA_TF32(64, WG_R32, WG_D32(0), "32", "33", "34", "35", "36", "37");
  } else {
    WGMMA_TF32(128, WG_R64, WG_D64(0), "64", "65", "66", "67", "68", "69");
  }
}

// As wgmma_tf32, with a (64 x 8) read from shared memory too, by `a_desc`.
#define WGMMA_TF32_SS(n, sums, outs, adesc, bdesc, pred)                    \
  asm volatile(                                                             \
      "{\n"                                                                 \
      ".reg .pred p;\n"                                                     \
      "setp.ne.b32 p, %" pred ", 0;\n"                                      \
      "wgmma.mma_async.sync.aligned.m64n" #n "k8.f32.tf32.tf32 {" sums "}, " \
      "%" adesc ", %" bdesc ", p, 1, 1;\n"                                   \
      "}\n"                                                                 \
      : outs                                                                \
      : "l"(a_desc), "l"(b_desc), "r"(accumulate))

template <int BN>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[BN / 2],
                                              uint64_t a_desc,
                                              uint64_t b_desc,
                                              int accumulate) {
  static_assert(BN == 16 || BN == 32, "tile width");
  if constexpr (BN == 16) {
    WGMMA_TF32_SS(16, WG_R8, WG_D8(0), "8", "9", "10");
  } else {
    WGMMA_TF32_SS(32, WG_R16, WG_D16(0), "16", "17", "18");
  }
}

// Keeps the compiler from moving uses of d across the asynchronous mma.
template <int N>
__device__ __forceinline__ void wgmma_operand_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
