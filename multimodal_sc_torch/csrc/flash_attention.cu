// Softmax attention on the (B, H, L, D) layout, forward and backward:
//   out[b, h, i] = softmax_j(q[b, h, i] . k[b, h, j] * scale) v[b, h, j]
// for any Lq, Lk and any head dim D <= 128 that is a multiple of 4.
//
// Replaces the three TPU kernels of multimodal_sc_tpu/kernels/attention.py:
// _flash_kernel (forward, out + logsumexp), _bwd_dq_kernel (dQ) and
// _bwd_dkv_kernel (fused dK/dV). There q, k, v were first copied into
// (B*H, L, 128) buffers padded to 128 lanes and 128-row blocks, and one
// program held the whole padded K and V of its (batch, head) in VMEM. None
// of that carries over: no padded copy of any operand exists here, tensors
// are read where they lie through (batch, head, row) strides (so the
// transposed views an attention module hands in need no .contiguous()), K
// and V stream through shared memory 32 rows at a time, the ragged ends of
// Lq and Lk are predicates, and the logsumexp is a plain (B, H, Lq) array.
//
// The kernels on f32 tensors are in flash_kernels.cuh (attention_packed.cu
// launches all three as its f32 mode), those on bf16 tensors in
// flash_bf16.cuh; this file holds their launchers. All arithmetic is
// f32-grade (the TPU kernels cast every operand to f32 too). Keys past Lk
// score -1e30 (probability exactly 0); rows past Lq or Lk compute on zeros
// and store nothing. The f32 kernels:
//
//   flash_fwd_kernel   one block, a warpgroup of four warps, per
//                      (batch*head, 64 queries). Bound on the card: its
//                      4 B H Lq Lk D operations are f32-grade, which on
//                      Hopper means three TF32 tensor-core products each
//                      (3 x 4 B H Lq Lk D / 495 TFLOP/s), against 4 B H
//                      (2 Lq + 2 Lk) D bytes: operations bound it at the
//                      main path's Lk = 256. So both products, S = (q scale)
//                      K^T and O = P V, run on Hopper's warpgroup mma
//                      (wgmma m64nNk8 TF32) as lo*hi + hi*lo + hi*hi of
//                      each operand's split (on the bits; cvt.rna is a slow
//                      unit). q is split once into registers (at width 128,
//                      where registers run out, into shared planes that
//                      wgmma reads). K and V tiles of 32 keys (16 at width
//                      128) arrive by double-buffered cp.async (zero-filled
//                      past Lk and D); each thread splits the chunks it
//                      copied, once per block, into hi and lo planes laid
//                      out as wgmma's shared-memory operands, in two sets:
//                      the next tile is split while the tensor cores work
//                      on this one, one barrier per tile. The softmax is
//                      online per key tile (running max m and denominator
//                      l; out = acc / max(l, 1e-30), lse = m + log
//                      max(l, 1e-30)); P stays in registers, the S
//                      accumulator read as the A operand of P V with its
//                      key order carried into V's planes. Each tile's P V
//                      starts from zero and joins the rescaled running
//                      output through the FADD units (acc = acc alpha +
//                      PV), because the tensor cores truncate when they
//                      accumulate; S is one chain over the head dim.
//   flash_bwd_dq_tc_kernel, flash_bwd_dkv_tc_kernel  the backward as on the
//                      TPU, in two kernels, each one warpgroup per
//                      (batch*head, 64 of its own rows) streaming the other
//                      side in tiles of 32 rows (double-buffered cp.async,
//                      split once per block into hi and lo planes, one
//                      plane set, two barriers a tile). Their 6 and 8 B H Lq
//                      Lk D operations are f32-grade, so every product is
//                      3xTF32 on wgmma, as in the forward. The dQ kernel
//                      (queries' q scale and dO in shared planes, the A
//                      operands by descriptor) forms S = (q scale) K^T and
//                      dP = dO V^T per key tile, each one chain over the
//                      head dim, P = exp(S - lse) and dS = P (dP - delta)
//                      in registers (delta = rowsum(dO O), also written to
//                      a (B, H, Lq) array), then dQ += dS K with dS as the
//                      register A operand and K transposed in its planes;
//                      dQ = acc scale. The dK/dV kernel (keys' k scale and
//                      v in planes) forms S^T and dP^T per query tile,
//                      P^T and dS^T against that tile's lse and delta, then
//                      dV += P^T dO and dK += dS^T Q; each over ALL queries
//                      in its own block, written once, no atomics: the
//                      same bits every run. Each tile's product over its
//                      rows starts from zero and joins the running sum
//                      through the FADD units (the tensor cores truncate
//                      when they accumulate). Compiled widths 32 and 64
//                      (every packed f32 shape; c3 arm F's 64). At width
//                      128 (head dims 68-128) the accumulators and planes
//                      do not fit, and flash_bwd_dq_kernel /
//                      flash_bwd_dkv_kernel run on the f32 FMA units: a row
//                      owned by 4 neighbouring lanes, 32 columns each in
//                      registers, the other side streamed 32 rows at a time
//                      through shared memory.
//
// On bf16 tensors (train.bf16) three other kernels run, designed for bf16
// (flash_bf16.cuh): what they compute is the f32 kernels' function on the
// widened values, as the TPU kernels compute when handed bf16 arrays (the
// forward scales q in f32, the backward scales q K^T; the output, dQ, dK
// and dV rounded to bf16 once at the store; lse and delta f32). Their bound
// on the card is their bytes at two a value against products on the bf16
// tensor cores (989 TFLOP/s): a product of two bf16 values is exact in f32,
// so it is one bf16 wgmma pass, and one with an f32 operand (P, dS, q scale
// where the scale is no power of two) is three, that operand split exactly
// into bf16 hi, mid and lo. So:
//   - K and V tiles (forward, dQ) and Q and dO tiles (dK/dV) are copied as
//     bf16 by cp.async, 16 bytes a chunk (8 where the head dim is no
//     multiple of 8 or a row is not 16-byte aligned), three stages deep:
//     tiles j + 1 and j + 2 land while the tensor cores work on tile j, one
//     barrier a tile. They are stored in the 128-byte (64 at head dim 32)
//     swizzle wgmma's descriptors read, so a tile is a K-major operand
//     (K of S = q K^T, V of dP = dO V^T) and an MN-major one (V of P V, K
//     of dS K, Q and dO of dK, dV) as it landed: no transposed copy, no
//     hi and lo planes.
//   - The block's own rows (q scale in one or three pieces; q and dO; k
//     and v) are split once into shared tiles, the A operands of S, dP and
//     their transposes; P and dS stay in registers in the accumulator
//     layout, which is the A fragment of the products over the tile's rows.
//   - One warpgroup a block, 64 of its own rows (queries; keys for dK/dV),
//     64-key tiles forward, 64-row tiles backward (32 at head dims above
//     64, where dK and dV take 128 accumulator registers). The running
//     output, dQ, dK and dV accumulate on the tensor cores in f32 (the f32
//     kernels join each tile's product through the FADD units instead: the
//     registers of a second accumulator would cost a block an SM here).
// Launchers take `mode` to pick them.

#include "flash_bf16.cuh"
#include "flash_kernels.cuh"

namespace {

using namespace flash;

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

bool shape_ok(int B, int H, int Lq, int Lk, int D) {
  const int64_t bh = (int64_t)B * H;
  // One grid dimension holds batch*head x row blocks (at least Lq / 128).
  const int64_t longest = Lq > Lk ? Lq : Lk;
  return H > 0 && D > 0 && D % 4 == 0 && D <= 128 &&
         bh * (longest / 32 + 1) < 2147483647LL;
}

#define DISPATCH_HEAD_TILE(D_, CALL)                      \
  if ((D_) <= 32) { constexpr int DT = 32; return CALL; } \
  if ((D_) <= 64) { constexpr int DT = 64; return CALL; } \
  { constexpr int DT = 128; return CALL; }

// The launchers of flash_kernels.cuh (f32) and flash_bf16.cuh (bf16), one
// name each: the element type of the pointers picks.
using flash::launch_bwd_dkv;
using flash::launch_bwd_dq;
using flash::launch_fwd;
using flash_bf16::launch_bwd_dkv;
using flash_bf16::launch_bwd_dq;
using flash_bf16::launch_fwd;

// T: the inputs' element type; OT: the outputs' (float for T = float).
template <typename T, typename OT>
int fwd(const void* q, const void* k, const void* v, void* out, float* lse,
        const long long* s, int B, int H, int Lq, int Lk, int D, float scale,
        cudaStream_t stream) {
  DISPATCH_HEAD_TILE(D, (launch_fwd<DT>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<OT*>(out), lse, strides_at(s, 0),
      strides_at(s, 1), strides_at(s, 2), strides_at(s, 3), B, H, Lq, Lk, D,
      scale, stream)))
}

template <typename T, typename OT>
int bwd_dq(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, void* dq, float* delta,
           const long long* s, int B, int H, int Lq, int Lk, int D,
           float scale, cudaStream_t stream) {
  DISPATCH_HEAD_TILE(D, (launch_bwd_dq<DT>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, static_cast<OT*>(dq), delta,
      strides_at(s, 0), strides_at(s, 1), strides_at(s, 2), strides_at(s, 3),
      strides_at(s, 4), strides_at(s, 5), B, H, Lq, Lk, D, scale, stream)))
}

template <typename T, typename OT>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* delta, void* dk, void* dv,
            const long long* s, int B, int H, int Lq, int Lk, int D,
            float scale, cudaStream_t stream) {
  DISPATCH_HEAD_TILE(D, (launch_bwd_dkv<DT>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<OT*>(dk), static_cast<OT*>(dv), strides_at(s, 0),
      strides_at(s, 1), strides_at(s, 2), strides_at(s, 3), strides_at(s, 4),
      strides_at(s, 5), B, H, Lq, Lk, D, scale, stream)))
}

}  // namespace

// q, k, v, out (and o, dout, dq, dk, dv) read and written through their
// (batch, head, row) strides in elements (`strides`: three per tensor, in
// argument order); rows 16-byte aligned in f32, 8-byte in bf16. `mode`: 0,
// all f32 (flash_kernels.cuh); 1, all bf16 (flash_bf16.cuh); 2, bf16 inputs
// and f32 outputs (flash_bf16.cuh's sums before their rounding). lse and
// delta: f32 (B, H, Lq), contiguous.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* out, float* lse,
    const long long* strides, int B, int H, int Lq, int Lk, int D, float scale,
    int mode, cudaStream_t stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0) return 0;
  if (!shape_ok(B, H, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  if (mode == 0)
    return fwd<float, float>(q, k, v, out, lse, strides, B, H, Lq, Lk, D,
                             scale, stream);
  if (mode == 1)
    return fwd<bw::bf16, bw::bf16>(q, k, v, out, lse, strides, B, H, Lq, Lk,
                                   D, scale, stream);
  return fwd<bw::bf16, float>(q, k, v, out, lse, strides, B, H, Lq, Lk, D,
                              scale, stream);
}

extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* dq, float* delta,
    const long long* strides, int B, int H, int Lq, int Lk, int D, float scale,
    int mode, cudaStream_t stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0) return 0;
  if (!shape_ok(B, H, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  if (mode == 0)
    return bwd_dq<float, float>(q, k, v, o, dout, lse, dq, delta, strides, B,
                                H, Lq, Lk, D, scale, stream);
  if (mode == 1)
    return bwd_dq<bw::bf16, bw::bf16>(q, k, v, o, dout, lse, dq, delta,
                                      strides, B, H, Lq, Lk, D, scale, stream);
  return bwd_dq<bw::bf16, float>(q, k, v, o, dout, lse, dq, delta, strides, B,
                                 H, Lq, Lk, D, scale, stream);
}

extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    const long long* strides, int B, int H, int Lq, int Lk, int D, float scale,
    int mode, cudaStream_t stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0) return 0;
  if (!shape_ok(B, H, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  if (mode == 0)
    return bwd_dkv<float, float>(q, k, v, dout, lse, delta, dk, dv, strides,
                                 B, H, Lq, Lk, D, scale, stream);
  if (mode == 1)
    return bwd_dkv<bw::bf16, bw::bf16>(q, k, v, dout, lse, delta, dk, dv,
                                       strides, B, H, Lq, Lk, D, scale,
                                       stream);
  return bwd_dkv<bw::bf16, float>(q, k, v, dout, lse, delta, dk, dv, strides,
                                  B, H, Lq, Lk, D, scale, stream);
}
