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
// The kernels themselves are in flash_kernels.cuh (attention_packed.cu
// launches the two backward ones as its f32 mode); this file holds their
// launchers. Work split, the same in all three kernels: a block is 128
// threads; a row
// (a query in the forward and dQ kernels, a key in the dK/dV kernel) is
// owned by LPR = DT / 32 neighbouring lanes, DT in {32, 64, 128} the
// compiled width D is rounded up to (columns past D read as zeros and are
// never stored). Each lane keeps 32 columns of its row in registers, the
// 16-byte chunks c = i * LPR + lane_in_row, so the lanes of one row read
// neighbouring chunks of a shared-memory row (no bank conflict) and finish
// a dot product with LPR - 1 shuffle steps. Register use therefore does not
// grow with D: 32 floats per operand row whatever the head dim.
//
//   flash_fwd_kernel   one block per (batch*head, 128/LPR queries): online
//                      softmax over K tiles with a running max m and
//                      denominator l, rescaling the accumulator once per
//                      tile; writes out = acc / max(l, 1e-30) and
//                      lse = m + log(max(l, 1e-30)).
//   flash_bwd_dq_kernel  same blocks: delta = sum_d dO*O for its row (also
//                      written to a (B, H, Lq) scratch for the next kernel),
//                      P = exp(S*scale - lse) recomputed per tile,
//                      dS = P (dO V^T - delta), dQ = dS K * scale.
//   flash_bwd_dkv_kernel one block per (batch*head, 128/LPR keys) that loops
//                      over ALL query rows itself, 32 at a time through
//                      shared memory: dV = P^T dO, dK = dS^T Q * scale are
//                      written once, no atomics, the same bits every run.
//
// All arithmetic is f32 (the TPU kernels cast every operand to f32 too).
// Keys past Lk are scored -1e30 (probability exactly 0), rows past Lq or Lk
// compute on zeros and store nothing.
//
// Bound on the card: 4 B H Lq Lk D operations forward, 6 and 8 times
// B H Lq Lk D in the two backward kernels, against 4 B H (2 Lq + 2 Lk) D
// bytes and up: at Lk = 256 that is 64 operations per byte and more, above
// the f32 break-even of the card (67 TFLOP/s over 3.35 TB/s = 20), so the
// f32 FMA rate bounds it. This version runs on the FMA units from
// registers and broadcast shared-memory reads (one 16-byte load feeds four
// FMAs per lane); tensor cores are later work.

#include "flash_kernels.cuh"

namespace {

using namespace flash;

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

// Blocks of 128 / (DT / 32) rows covering L rows.
int row_blocks_for(int L, int DT) {
  const int rows = THREADS / (DT / W);
  return (L + rows - 1) / rows;
}

bool shape_ok(int B, int H, int Lq, int Lk, int D) {
  const int64_t bh = (int64_t)B * H;
  // One grid dimension holds batch*head x row blocks (at least Lq / 128).
  const int64_t longest = Lq > Lk ? Lq : Lk;
  return H > 0 && D > 0 && D % 4 == 0 && D <= 128 &&
         bh * (longest / 32 + 1) < 2147483647LL;
}

template <int DT>
int launch_fwd(const float* q, const float* k, const float* v, float* out,
               float* lse, const long long* st, int B, int H, int Lq, int Lk,
               int D, float scale, cudaStream_t stream) {
  const int rb = row_blocks_for(Lq, DT);
  flash_fwd_kernel<DT><<<B * H * rb, THREADS, 0, stream>>>(
      q, k, v, out, lse, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), H, Lq, Lk, D, rb, scale);
  return (int)cudaGetLastError();
}

template <int DT>
int launch_bwd_dq(const float* q, const float* k, const float* v,
                  const float* o, const float* dout, const float* lse,
                  float* dq, float* delta, const long long* st, int B, int H,
                  int Lq, int Lk, int D, float scale, cudaStream_t stream) {
  const int rb = row_blocks_for(Lq, DT);
  flash_bwd_dq_kernel<DT><<<B * H * rb, THREADS, 0, stream>>>(
      q, k, v, o, dout, lse, dq, delta, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), strides_at(st, 4),
      strides_at(st, 5), H, Lq, Lk, D, rb, scale);
  return (int)cudaGetLastError();
}

template <int DT>
int launch_bwd_dkv(const float* q, const float* k, const float* v,
                   const float* dout, const float* lse, const float* delta,
                   float* dk, float* dv, const long long* st, int B, int H,
                   int Lq, int Lk, int D, float scale, cudaStream_t stream) {
  const int rb = row_blocks_for(Lk, DT);
  flash_bwd_dkv_kernel<DT><<<B * H * rb, THREADS, 0, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), strides_at(st, 4),
      strides_at(st, 5), H, Lq, Lk, D, rb, scale);
  return (int)cudaGetLastError();
}

}  // namespace

#define DISPATCH_HEAD_TILE(D_, CALL)                      \
  if ((D_) <= 32) { constexpr int DT = 32; return CALL; } \
  if ((D_) <= 64) { constexpr int DT = 64; return CALL; } \
  { constexpr int DT = 128; return CALL; }

// q, out (B, H, Lq, D), k, v (B, H, Lk, D): f32, last dim contiguous, every
// other stride a multiple of 4 floats and every base 16-byte aligned.
// `strides`: (batch, head, row) strides in floats of q, k, v, out, on the
// host. lse (B, H, Lq) f32 contiguous. D a multiple of 4, at most 128.
extern "C" int flash_attention_fwd_launch(
    const float* q, const float* k, const float* v, float* out, float* lse,
    const long long* strides, int B, int H, int Lq, int Lk, int D, float scale,
    cudaStream_t stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0) return 0;
  if (!shape_ok(B, H, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  DISPATCH_HEAD_TILE(D, (launch_fwd<DT>(q, k, v, out, lse, strides, B, H, Lq,
                                        Lk, D, scale, stream)))
}

// dQ: as above, plus o = the forward's output, dout (B, H, Lq, D) and the
// forward's lse; writes dq (B, H, Lq, D) and delta (B, H, Lq) = rowsum(dO*O)
// for the dK/dV kernel. `strides`: of q, k, v, o, dout, dq.
extern "C" int flash_attention_bwd_dq_launch(
    const float* q, const float* k, const float* v, const float* o,
    const float* dout, const float* lse, float* dq, float* delta,
    const long long* strides, int B, int H, int Lq, int Lk, int D, float scale,
    cudaStream_t stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0) return 0;
  if (!shape_ok(B, H, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  DISPATCH_HEAD_TILE(D, (launch_bwd_dq<DT>(q, k, v, o, dout, lse, dq, delta,
                                           strides, B, H, Lq, Lk, D, scale,
                                           stream)))
}

// dK and dV (B, H, Lk, D) from the forward's lse and the dQ kernel's delta.
// `strides`: of q, k, v, dout, dk, dv.
extern "C" int flash_attention_bwd_dkv_launch(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* delta, float* dk, float* dv,
    const long long* strides, int B, int H, int Lq, int Lk, int D, float scale,
    cudaStream_t stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0) return 0;
  if (!shape_ok(B, H, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  DISPATCH_HEAD_TILE(D, (launch_bwd_dkv<DT>(q, k, v, dout, lse, delta, dk, dv,
                                            strides, B, H, Lq, Lk, D, scale,
                                            stream)))
}
