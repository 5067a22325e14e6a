// What the bf16 wgmma kernels share: swizzled shared-memory tiles that
// Hopper's warpgroup mma (wgmma m64nNk16, bf16 operands, f32 sums) reads
// through descriptors in either major order, asynchronous 8- and 16-byte
// copies into them, and the split of an f32 value into three bf16 pieces.
// Included by flash_bf16.cuh, attention_packed.cu (with packed_fwd_bf16.cuh
// and packed_bwd_bf16.cuh) and conv_prelu.cu.
//
// A tile of R rows x DT bf16 columns is stored as DT / AW atom columns of R
// rows of SW bytes (SW = 2 AW: 128 bytes for DT >= 64, 64 for DT = 32), each
// row's 16-byte chunks permuted by the swizzle wgmma's descriptors know
// (address bits 4.. XORed with bits 7..). Read K-major (the rows are the
// product's M or N, its k runs along the row) it is an A or B operand of a
// product over the columns; read MN-major (the rows are the product's k) it
// is the B operand of a product over the rows, the transpose wgmma does in
// the descriptor, so no transposed copy exists.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace bw {

using bf16 = __nv_bfloat16;

// Bytes of a swizzled row at compiled width DT (a whole 128-byte swizzle
// atom row where the width allows it), and the columns it holds.
__host__ __device__ constexpr int sw_bytes(int DT) {
  return DT >= 64 ? 128 : 64;
}
__host__ __device__ constexpr int atom_w(int DT) { return sw_bytes(DT) / 2; }

// The swizzle of an SW-byte row layout on a byte offset from a tile base
// aligned to 1024 bytes: 16-byte chunk index XOR row index (mod SW / 16).
template <int SW>
__host__ __device__ constexpr uint32_t swz(uint32_t off) {
  return off ^ ((off >> 3) & ((SW / 16 - 1) << 4));
}

// Byte offset of element (r, c) of an R x DT tile; c a multiple of 4.
template <int R, int DT>
__device__ __forceinline__ uint32_t tile_off(int r, int c) {
  constexpr int SW = sw_bytes(DT), AW = atom_w(DT);
  return swz<SW>((c / AW) * (R * SW) + r * SW + (c % AW) * 2);
}

// Shared-memory matrix descriptor of a swizzled operand: start address,
// leading and stride byte offsets, swizzle mode (1: 128 B, 2: 64 B).
template <int SW>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  constexpr uint64_t mode = SW == 128 ? 1 : 2;
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (mode << 62);
}

// The R x DT tile at shared address t read K-major, k-step ks (columns
// 16 ks .. + 15): 8-row groups SW * 8 bytes apart (the leading offset is
// unused: a k-step never leaves its 32 bytes of a row).
template <int R, int DT>
__device__ __forceinline__ uint64_t kmajor(uint32_t t, int ks) {
  constexpr int SW = sw_bytes(DT), AW = atom_w(DT);
  return desc<SW>(t + (ks * 16 / AW) * (R * SW) + (ks * 16 % AW) * 2, 16,
                  8 * SW);
}

// The same tile read MN-major, k-step kk (rows 16 kk .. + 15): its columns
// are the product's N, AW of them to an atom column R * SW bytes on (the
// leading offset), 8-row groups SW * 8 bytes apart (the stride offset).
template <int R, int DT>
__device__ __forceinline__ uint64_t mnmajor(uint32_t t, int kk) {
  constexpr int SW = sw_bytes(DT);
  return desc<SW>(t + kk * 16 * SW, R * SW, 8 * SW);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 or 8 bytes global -> shared, asynchronously; zeros when !valid (src
// must still be a readable address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x0, x1 (x0 in the low half) as three bf16 pairs with x = hi + mid + lo
// exactly: hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), each
// difference exact in f32. A finite f32 has 24 significant bits, each
// piece keeps 8, so nothing is lost while the last piece stays above
// bf16's smallest subnormal (|x| >= 2^-110).
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

// d (64 x BN of a warpgroup, f32) += or = a (64 x 16 bf16, registers: the
// m16n8k16 A fragment of the warp's 16 rows) * b (16 x BN bf16, shared, by
// descriptor; TB: read MN-major), asynchronously.
#define WGMMA_BF16_RS(n, sums, outs, a0, a1, a2, a3, bdesc, pred, tb)        \
  asm volatile(                                                             \
      "{\n"                                                                 \
      ".reg .pred p;\n"                                                     \
      "setp.ne.b32 p, %" pred ", 0;\n"                                      \
      "wgmma.mma_async.sync.aligned.m64n" #n "k16.f32.bf16.bf16 {" sums "}, " \
      "{%" a0 ", %" a1 ", %" a2 ", %" a3 "}, %" bdesc ", p, 1, 1, %" tb      \
      ";\n"                                                                 \
      "}\n"                                                                 \
      : outs                                                                \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc),            \
        "r"(accumulate), "n"(TB))

template <int BN, int TB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[BN / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t b_desc, int accumulate) {
  static_assert(BN == 32 || BN == 64 || BN == 128, "tile width");
  if constexpr (BN == 32) {
    WGMMA_BF16_RS(32, WG_R16, WG_D16(0), "16", "17", "18", "19", "20", "21",
                  "22");
  } else if constexpr (BN == 64) {
    WGMMA_BF16_RS(64, WG_R32, WG_D32(0), "32", "33", "34", "35", "36", "37",
                  "38");
  } else {
    WGMMA_BF16_RS(128, WG_R64, WG_D64(0), "64", "65", "66", "67", "68", "69",
                  "70");
  }
}

// As wgmma_bf16, with a (64 x 16) read from shared memory too: K-major, or
// with TA MN-major (a stored [k][row], the transpose wgmma does in the
// descriptor).
#define WGMMA_BF16_SS(n, sums, outs, adesc, bdesc, pred, tb, ta)             \
  asm volatile(                                                             \
      "{\n"                                                                 \
      ".reg .pred p;\n"                                                     \
      "setp.ne.b32 p, %" pred ", 0;\n"                                      \
      "wgmma.mma_async.sync.aligned.m64n" #n "k16.f32.bf16.bf16 {" sums "}, " \
      "%" adesc ", %" bdesc ", p, 1, 1, %" ta ", %" tb ";\n"                \
      "}\n"                                                                 \
      : outs                                                                \
      : "l"(a_desc), "l"(b_desc), "r"(accumulate), "n"(TB), "n"(TA))

template <int BN, int TB, int TA = 0>
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[BN / 2],
                                              uint64_t a_desc,
                                              uint64_t b_desc,
                                              int accumulate) {
  static_assert(BN == 16 || BN == 32 || BN == 64 || BN == 128, "tile width");
  if constexpr (BN == 16) {
    WGMMA_BF16_SS(16, WG_R8, WG_D8(0), "8", "9", "10", "11", "12");
  } else if constexpr (BN == 32) {
    WGMMA_BF16_SS(32, WG_R16, WG_D16(0), "16", "17", "18", "19", "20");
  } else if constexpr (BN == 64) {
    WGMMA_BF16_SS(64, WG_R32, WG_D32(0), "32", "33", "34", "35", "36");
  } else {
    WGMMA_BF16_SS(128, WG_R64, WG_D64(0), "64", "65", "66", "67", "68");
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Every committed group but the N most recent complete.
template <int N>
__device__ __forceinline__ void wgmma_wait_pending() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  wgmma_commit();
  wgmma_wait();
}
// Shared-memory writes of this thread (st.shared, cp.async) seen by
// wgmma, which reads through the asynchronous proxy; a barrier then makes
// them every thread's.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// Every group but the N most recent complete.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace bw
