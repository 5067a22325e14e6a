"""Generic multi-head attention on the (B, H, L, D) layout.

Counterpart of ``multimodal_sc_tpu/kernels/attention.py``: the plain
version, the flash kernels (forward, dQ, fused dK/dV; they serve the shapes
``attention_packed.packed_eligible`` refuses) and the ``attention``
dispatch. On a CUDA tensor ``flash_attention`` launches the forward kernel
of ``csrc/flash_attention.cu`` and its autograd backward launches the two
backward kernels (dQ with delta, then dK/dV) on the saved q, k, v, output
and logsumexp; on float32 tensors all three form f32-grade products on the
TF32 tensor cores by the 3xTF32 split (the backward at head dims above 64
on the f32 FMA units). On a CPU tensor the plain version runs: for float32
the twin ``attention_reference`` under autograd; for bf16 the kernels'
plain versions, whose backward rounds dQ, dK and dV once, where the
kernels store them (``flash_attention_plain``).

bf16 tensors (``train.bf16``) take three kernels of their own
(``csrc/flash_bf16.cuh``), counted apart (``launches_*_bf16``), at every
shape the wrapper takes: the same function on the widened values (the
forward's q scale in f32, the backward's scale after q K^T, f32 softmax and
sums, the output, dQ, dK and dV rounded once at the store; lse and delta
f32), as the JAX kernels compute when handed bf16 arrays, with every product
on the bf16 tensor cores (``wgmma``): one pass where both operands are bf16
values, three where one is f32 (P, dS, q scale), split exactly into bf16
hi, mid and lo. Their K, V (Q, dO) tiles are copied as bf16 by ``cp.async``,
16 bytes a chunk, or 8 where the head dim is no multiple of 8 or a row is
not 16-byte aligned (``_readable`` guarantees 8).

The kernels read q, k, v and dO where they lie, through their (batch, head,
row) strides, so the transposed views of a (B, L, H, D) projection need no
copy; the output is allocated (B, L, H, D) and returned as its (B, H, L, D)
view, so the caller's transpose back to (B, L, H*D) is free as well.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from multimodal_sc_torch.kernels import _build

_MAX_HEAD_DIM = 128

# Launches of the CUDA forward, dQ and dK/dV kernels (one backward pass
# launches the dQ kernel, which also writes delta, then the dK/dV kernel);
# the kernels on bf16 inputs (csrc/flash_bf16.cuh) apart.
launches_fwd = 0
launches_bwd_dq = 0
launches_bwd_dkv = 0
launches_fwd_bf16 = 0
launches_bwd_dq_bf16 = 0
launches_bwd_dkv_bf16 = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG = {
    "flash_attention_fwd_launch": (_P,) * 6 + (_I,) * 5 + (_F, _I, _P),
    "flash_attention_bwd_dq_launch": (_P,) * 9 + (_I,) * 5 + (_F, _I, _P),
    "flash_attention_bwd_dkv_launch": (_P,) * 9 + (_I,) * 5 + (_F, _I, _P),
}
_DTYPES = (torch.float32, torch.bfloat16)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain softmax attention, the JAX package's XLA twin: f32 scores and
    softmax, the probabilities rounded to V's dtype before P V (a no-op in
    f32), f32 sums. q (B,H,Lq,D), k and v (B,H,Lk,D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    probs = torch.softmax(q.float() @ k.float().transpose(-1, -2) * scale,
                          dim=-1)
    return (probs.to(v.dtype).float() @ v.float()).to(q.dtype)


def flash_attention_fwd_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: ``(out, lse)``, lse (B, H, Lq)
    the f32 logsumexp of the scaled scores of each row. Every operand is
    widened to f32 and the probabilities are not rounded (the JAX kernel's
    online softmax keeps them f32); the output is rounded once to q's
    dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = q.float() @ k.float().transpose(-1, -2) * scale
    lse = torch.logsumexp(s, dim=-1)
    out = torch.exp(s - lse.unsqueeze(-1)) @ v.float()
    return out.to(q.dtype), lse


def flash_attention_dq_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
        lse: torch.Tensor, g: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dQ kernel: ``(dq, delta)``, the probabilities
    recomputed from the saved logsumexp.

        P = exp(q k^T scale - lse)     delta = rowsum(dO * O)   (B, H, Lq)
        dS = P * (dO V^T - delta)      dQ = dS K scale
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    p = torch.exp(qf @ kf.transpose(-1, -2) * scale - lse.unsqueeze(-1))
    delta = (gf * out.float()).sum(-1)
    ds = p * (gf @ vf.transpose(-1, -2) - delta.unsqueeze(-1))
    return (ds @ kf * scale).to(q.dtype), delta


def flash_attention_dkv_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lse: torch.Tensor,
        delta: torch.Tensor, g: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fused dK/dV kernel: ``(dk, dv)``.

        dV = P^T dO                    dK = dS^T Q scale
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    p = torch.exp(qf @ kf.transpose(-1, -2) * scale - lse.unsqueeze(-1))
    ds = p * (gf @ vf.transpose(-1, -2) - delta.unsqueeze(-1))
    dk = ds.transpose(-1, -2) @ qf * scale
    return dk.to(k.dtype), (p.transpose(-1, -2) @ gf).to(v.dtype)


def flash_attention_bwd_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
        lse: torch.Tensor, g: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward pass: (dq, dk, dv) from the saved
    q, k, v, output and logsumexp, as the two backward kernels compute it:
    f32 sums over every block, each result rounded once to its input's
    dtype; delta of the widened dO and O."""
    dq, delta = flash_attention_dq_reference(q, k, v, out, lse, g, scale)
    dk, dv = flash_attention_dkv_reference(q, k, v, lse, delta, g, scale)
    return dq, dk, dv


class _FlashAttentionPlain(torch.autograd.Function):
    """The kernels' plain versions under one backward: the gradients are
    rounded once, where the kernels store them (autograd through the plain
    forward would round each op's result in the activation dtype)."""

    @staticmethod
    def forward(ctx, scale, q, k, v):
        out, lse = flash_attention_fwd_reference(q, k, v, scale)
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        return (None,) + flash_attention_bwd_reference(q, k, v, out, lse, g,
                                                       ctx.scale)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """What the kernels compute, by their plain versions, on any device:
    the forward, and a backward that rounds where the kernels store."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttentionPlain.apply(float(scale), q, k, v)


def _readable(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels can read it in place: last dim contiguous, every
    other stride a multiple of 4 elements, its base aligned to 4 elements
    (rows are read 4 values at a time). A copy only when it is not."""
    ok = (t.stride(-1) == 1 and all(s % 4 == 0 for s in t.stride()[:-1])
          and t.data_ptr() % (4 * t.element_size()) == 0)
    return t if ok else _build.aligned(t)


def _strides(*tensors: torch.Tensor):
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _check_cuda(*tensors: torch.Tensor) -> Tuple[int, int, int, int, int]:
    """Validate what the kernels take; returns (B, H, Lq, Lk, D). The first
    three tensors are q, k, v; any others have q's shape."""
    q, k, v = tensors[:3]
    if q.dim() != 4:
        raise ValueError(f"q (B, H, Lq, D) expected, got {tuple(q.shape)}")
    b, h, lq, d = q.shape
    lk = k.shape[2] if k.dim() == 4 else -1
    if k.shape != (b, h, lk, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} disagree")
    for t in tensors[3:]:
        if t.shape != q.shape:
            raise ValueError(f"expected shape {tuple(q.shape)}, got "
                             f"{tuple(t.shape)}")
    if d % 4 or d > _MAX_HEAD_DIM:
        raise ValueError("the flash attention kernels take a head dim that "
                         f"is a multiple of 4 up to {_MAX_HEAD_DIM}, got {d}")
    for t in tensors:
        if (t.dtype not in _DTYPES or t.dtype != q.dtype
                or t.device != q.device):
            raise TypeError("the flash attention kernels take float32 or "
                            "bfloat16 tensors of one dtype on one device, "
                            f"got {t.dtype} on {t.device} beside {q.dtype}")
    return b, h, lq, lk, d


def _heads_inner(b: int, h: int, l: int, d: int, like: torch.Tensor,
                 dtype: Optional[torch.dtype] = None):
    """An uninitialised (B, H, L, D) tensor (``like``'s dtype unless
    ``dtype`` is given) in the (B, L, H, D) memory order of a projection's
    output, so a caller's transpose to (B, L, H*D), or the one autograd
    applies on the way back, is a view."""
    return torch.empty((b, l, h, d), dtype=dtype or like.dtype,
                       device=like.device).transpose(1, 2)


def _mode(q: torch.Tensor, out_dtype: Optional[torch.dtype]):
    """(the C entry's mode, the outputs' dtype): 0 f32 in and out; 1 bf16 in
    and out; 2 bf16 in, f32 out (the bf16 kernels' sums before their one
    rounding, which ``chip_smoke.py`` holds their bf16 outputs to)."""
    out_dtype = q.dtype if out_dtype is None else out_dtype
    if q.dtype == torch.float32 and out_dtype == torch.float32:
        return 0, out_dtype
    if q.dtype == torch.bfloat16 and out_dtype in _DTYPES:
        return (1 if out_dtype == torch.bfloat16 else 2), out_dtype
    raise TypeError(f"no flash attention kernel takes {q.dtype} to "
                    f"{out_dtype}")


def _fwd_cuda(q, k, v, scale: float, out_dtype=None):
    global launches_fwd, launches_fwd_bf16
    b, h, lq, lk, d = _check_cuda(q, k, v)
    mode, out_dtype = _mode(q, out_dtype)
    q, k, v = (_readable(t) for t in (q, k, v))
    out = _heads_inner(b, h, lq, d, q, out_dtype)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention", _SIG)
    err = lib.flash_attention_fwd_launch(
        *(_build.ptr(t) for t in (q, k, v, out, lse)), _strides(q, k, v, out),
        b, h, lq, lk, d, scale, mode, _build.stream_ptr(q.device))
    _build.check(err, "flash_attention forward")
    if mode:
        launches_fwd_bf16 += 1
    else:
        launches_fwd += 1
    return out, lse


def _bwd_dq_cuda(q, k, v, out, lse, dout, scale: float, out_dtype=None):
    """dq, and delta = rowsum(dO * O) (B, H, Lq) for the dK/dV kernel."""
    global launches_bwd_dq, launches_bwd_dq_bf16
    b, h, lq, lk, d = _check_cuda(q, k, v, out, dout)
    mode, out_dtype = _mode(q, out_dtype)
    if lse.shape != (b, h, lq) or lse.dtype != torch.float32:
        raise ValueError(f"lse (B, H, Lq) float32 expected, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    q, k, v, out, dout = (_readable(t) for t in (q, k, v, out, dout))
    lse = lse.contiguous()
    dq = _heads_inner(b, h, lq, d, q, out_dtype)
    delta = torch.empty_like(lse)
    lib = _build.load("flash_attention", _SIG)
    err = lib.flash_attention_bwd_dq_launch(
        *(_build.ptr(t) for t in (q, k, v, out, dout, lse, dq, delta)),
        _strides(q, k, v, out, dout, dq),
        b, h, lq, lk, d, scale, mode, _build.stream_ptr(q.device))
    _build.check(err, "flash_attention dQ")
    if mode:
        launches_bwd_dq_bf16 += 1
    else:
        launches_bwd_dq += 1
    return dq, delta


def _bwd_dkv_cuda(q, k, v, lse, delta, dout, scale: float, out_dtype=None):
    global launches_bwd_dkv, launches_bwd_dkv_bf16
    b, h, lq, lk, d = _check_cuda(q, k, v, dout)
    mode, out_dtype = _mode(q, out_dtype)
    q, k, v, dout = (_readable(t) for t in (q, k, v, dout))
    lse, delta = lse.contiguous(), delta.contiguous()
    dk, dv = (_heads_inner(b, h, lk, d, q, out_dtype) for _ in range(2))
    lib = _build.load("flash_attention", _SIG)
    err = lib.flash_attention_bwd_dkv_launch(
        *(_build.ptr(t) for t in (q, k, v, dout, lse, delta, dk, dv)),
        _strides(q, k, v, dout, dk, dv),
        b, h, lq, lk, d, scale, mode, _build.stream_ptr(q.device))
    _build.check(err, "flash_attention dK/dV")
    if mode:
        launches_bwd_dkv_bf16 += 1
    else:
        launches_bwd_dkv += 1
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward kernel; backward kernels on the saved q, k, v, output and
    logsumexp."""

    @staticmethod
    def forward(ctx, scale, q, k, v):
        out, lse = _fwd_cuda(q, k, v, scale)
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, delta = _bwd_dq_cuda(q, k, v, out, lse, g, ctx.scale)
        dk, dv = _bwd_dkv_cuda(q, k, v, lse, delta, g, ctx.scale)
        return None, dq, dk, dv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention, drop-in for ``attention_reference``.

    On a CUDA tensor the kernels run, or the call raises for what they do
    not take (a head dim above 128 or no multiple of 4, a type other than
    float32 or bfloat16). On a CPU tensor the plain version runs: float32
    through the twin, as autograd differentiates it; bf16 through the
    kernels' plain versions (``flash_attention_plain``), as JAX's kernels
    in interpret mode compute it.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        if q.dtype == torch.float32:
            return attention_reference(q, k, v, scale)
        return flash_attention_plain(q, k, v, scale)
    return _FlashAttention.apply(float(scale), q, k, v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: Optional[float] = None,
              use_pallas: bool = False) -> torch.Tensor:
    """Dispatch: the flash kernels when asked for, else the plain version.

    ``use_pallas`` keeps the JAX package's name for "run the hand-written
    kernel": on a CUDA tensor it launches the kernels (or raises), on a CPU
    tensor the plain version runs, as for every kernel of the port.
    """
    if use_pallas:
        return flash_attention(q, k, v, scale)
    return attention_reference(q, k, v, scale)
