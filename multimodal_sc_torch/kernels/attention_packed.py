"""Packed-head attention for small head dims: forward and backward kernels.

Counterpart of ``multimodal_sc_tpu/kernels/attention_packed.py``. Inputs
stay in the packed ``(B, L, H*d)`` layout a q/k/v projection produces, so
the caller needs no ``(B,L,H,d) <-> (B,H,L,d)`` transposes. On a CUDA
tensor ``packed_attention`` launches the forward kernel of
``csrc/attention_packed.cu``, which also hands back the softmax's logsumexp
when a gradient is wanted, and its autograd backward launches the backward
kernel on the saved q, k, v, output and logsumexp. In bf16 mode both are
one kernel each on the tensor cores (bf16 operands, f32 sums: ``mma.sync``
on f32 tensors and for the backward; the forward on bf16 tensors on bf16
``wgmma``, one pass while Lk <= 256); in f32 mode
the packed layout is handed, as (batch, head, row) strides, to the flash
kernels of ``csrc/flash_kernels.cuh``: the forward, dQ and dK/dV kernels on
3xTF32 tensor cores. Which backward runs in bf16 mode: on bf16 tensors with
Lk <= 256 (every main-path shape) ``bwd_wgmma_bf16_kernel``
(``csrc/packed_bwd_bf16.cuh``, bf16 ``wgmma``); on f32 tensors, and past 256
keys, ``bwd_mma_kernel`` (bf16 ``mma.sync``). On a CPU tensor the plain
version runs: for float32
the twin ``packed_attention_reference`` under autograd; for bf16 the
kernels' plain versions (``packed_attention_plain``), whose backward rounds
where the kernels store.

bf16 tensors (``train.bf16``) take the bf16 mode's bf16-I/O instances,
counted apart (``launches_*_bf16``): q, k, v, O and dO read in bf16, the
output and dQ summed in f32 and rounded once, lse f32, and dK, dV summed
per 128-query block and rounded into a running bf16 sum, as the JAX kernel
accumulates them across its query blocks in the output dtype. bf16 tensors
in the f32 mode (``mxu_bf16=False``, no main path: the kernels' own entry
points) take the flash kernels' bf16-I/O instances (``csrc/flash_kernels.cuh``
with T = bf16), counted apart again (``launches_*_f32io_bf16``): every value
widened exactly, the f32 mode's arithmetic, the output and dQ rounded once,
lse f32, and dK, dV summed per 128-query block into running bf16 sums as
above.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from multimodal_sc_torch.kernels import _build

_LANES = 128
_MAX_LK_PAD = 4096
_KERNEL_HEAD_DIMS = (8, 16, 32, 64)

# Calls that launched a CUDA forward kernel (whichever serves the mode) /
# the backward kernels (one backward call is one count: in bf16 mode one kernel, plus the sum of the
# key splits' partial dQ when Lk takes more than one block; in f32 mode the
# dQ kernel, then the dK/dV kernel); with bf16 tensors, the ``_bf16`` ones,
# and with bf16 tensors in the f32 mode the ``_f32io_bf16`` ones.
launches_fwd = 0
launches_bwd = 0
launches_fwd_bf16 = 0
launches_bwd_bf16 = 0
launches_fwd_f32io_bf16 = 0
launches_bwd_f32io_bf16 = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG = {
    "packed_attention_fwd_launch": (_P,) * 5 + (_I,) * 5 + (_F, _I, _P),
    "packed_attention_bwd_launch": (_P,) * 10 + (_I,) * 5 + (_F, _I, _I,
                                                            _P),
    "packed_attention_bwd_splits": (_I,) * 3,
}
# The JAX kernel's query block: its backward sums dK and dV across blocks
# in the output dtype.
BLOCK_Q = 128
# Keys the bf16 wgmma backward holds: four warpgroups of 64.
_WGMMA_MAX_LK = 256
# The backward launcher's kernel argument (``BwdKernel`` in
# csrc/attention_packed.cu).
_BWD_KERNELS = {"wgmma": 1, "mma": 2}


def packed_eligible(heads: int, head_dim: int, lk: int) -> bool:
    """The JAX package's rule, kept identical so both packages pick the same
    path for the same config: the model dim is whole 128-wide groups, heads
    pack evenly into a group, padded Lk at most 4096."""
    dm = heads * head_dim
    lk_pad = -(-lk // _LANES) * _LANES
    return (dm % _LANES == 0 and _LANES % head_dim == 0
            and lk_pad <= _MAX_LK_PAD)


def _split(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, l, dm = x.shape
    return x.reshape(b, l, heads, dm // heads).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.bfloat16().float()


def packed_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, heads: int,
                               scale: Optional[float] = None) -> torch.Tensor:
    """The JAX package's XLA twin: unpack heads, f32 scores and softmax,
    the probabilities rounded to V's dtype before P V (a no-op in f32), f32
    sums, repack."""
    if scale is None:
        scale = (q.shape[-1] // heads) ** -0.5
    qh, kh, vh = (_split(t.float(), heads) for t in (q, k, v))
    probs = torch.softmax(qh @ kh.transpose(-1, -2) * scale, dim=-1)
    return _merge(probs.to(v.dtype).float() @ vh).to(q.dtype)


def packed_attention_reference_bf16(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, heads: int,
                                    scale: Optional[float] = None
                                    ) -> torch.Tensor:
    """Plain version of the kernel's bf16 mode, rounding where it does:
    q, k, v and the NORMALISED probabilities are rounded to bf16, every sum
    is kept in f32. These are the JAX kernel's roundings too."""
    if scale is None:
        scale = (q.shape[-1] // heads) ** -0.5
    qh, kh, vh = (_split(_bf16(t.float()), heads) for t in (q, k, v))
    probs = torch.softmax(qh @ kh.transpose(-1, -2) * scale, dim=-1)
    return _merge(_bf16(probs) @ vh).to(q.dtype)


def packed_attention_fwd_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
        scale: Optional[float] = None, bf16: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel with both its results: the output
    and ``lse``, the logsumexp of the scaled scores, (B, heads, Lq). With
    ``bf16`` the operands are rounded where the kernel's bf16 mode rounds
    them; the scores (hence ``lse``) are of the rounded q and k."""
    if scale is None:
        scale = (q.shape[-1] // heads) ** -0.5
    r = _bf16 if bf16 else (lambda t: t)
    qh, kh, vh = (_split(r(t.float()), heads) for t in (q, k, v))
    s = qh @ kh.transpose(-1, -2) * scale
    lse = torch.logsumexp(s, dim=-1)
    probs = torch.exp(s - lse.unsqueeze(-1))
    return _merge(r(probs) @ vh).to(q.dtype), lse


def packed_attention_bwd_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
        dout: torch.Tensor, heads: int, scale: Optional[float] = None,
        bf16: bool = False, lse: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels: (dq, dk, dv) by the formulas
    they evaluate.

        P = exp(q k^T scale - lse)   delta = rowsum(dO * O) per head
        dV = P^T dO    dS = P * (dO V^T - delta) * scale
        dQ = dS K      dK = dS^T Q

    ``lse`` is the forward's logsumexp, (B, heads, Lq), as the kernels are
    handed it; without it the softmax is recomputed from q and k. With
    ``bf16`` the matmul operands (q, k, v, dO, P, dS) are rounded to bf16
    where the kernels round them; delta uses the unrounded dO and O.

    float32 inputs give float32 results summed over every query. Inputs of
    another dtype (bf16 I/O) give results in it, as the kernels store them:
    dQ rounded once; dK and dV summed over each ``BLOCK_Q``-query block
    (the JAX kernel's ``min(128, round_up(Lq, 8))`` rows, so one block up
    to Lq = 128), each block's sum rounded and added to the running sum,
    which is rounded again.
    """
    if scale is None:
        scale = (q.shape[-1] // heads) ** -0.5
    r = _bf16 if bf16 else (lambda t: t)
    qh, kh, vh = (_split(r(t.float()), heads) for t in (q, k, v))
    oh, doh = _split(out.float(), heads), _split(dout.float(), heads)
    delta = (doh * oh).sum(-1, keepdim=True)
    doh = r(doh)
    s = qh @ kh.transpose(-1, -2) * scale
    p = (torch.softmax(s, dim=-1) if lse is None
         else torch.exp(s - lse.unsqueeze(-1)))
    ds = r(p * (doh @ vh.transpose(-1, -2) - delta) * scale)
    dq = _merge(ds @ kh)
    if q.dtype == torch.float32:
        dv = r(p).transpose(-1, -2) @ doh
        return dq, _merge(ds.transpose(-1, -2) @ qh), _merge(dv)
    io = q.dtype
    dk = dv = None
    for q0 in range(0, q.shape[1], BLOCK_Q):
        rows = slice(q0, q0 + BLOCK_Q)
        part_k = (ds[..., rows, :].transpose(-1, -2) @ qh[..., rows, :]).to(io)
        part_v = (r(p[..., rows, :]).transpose(-1, -2)
                  @ doh[..., rows, :]).to(io)
        dk = part_k if dk is None else dk + part_k
        dv = part_v if dv is None else dv + part_v
    return dq.to(io), _merge(dk), _merge(dv)


class _PackedAttentionPlain(torch.autograd.Function):
    """The kernels' plain versions under one backward, which rounds where
    the kernels store (autograd through the plain forward would round dK
    and dV once, not once per query block)."""

    @staticmethod
    def forward(ctx, heads, scale, bf16, q, k, v):
        out, lse = packed_attention_fwd_reference(q, k, v, heads, scale, bf16)
        ctx.heads, ctx.scale, ctx.bf16 = heads, scale, bf16
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        return (None, None, None) + packed_attention_bwd_reference(
            q, k, v, out, g, ctx.heads, ctx.scale, bf16=ctx.bf16, lse=lse)


def packed_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           heads: int, scale: Optional[float] = None,
                           mxu_bf16: bool = False) -> torch.Tensor:
    """What the kernels compute (bf16 operands under ``mxu_bf16``), by
    their plain versions, on any device: the forward, and a backward that
    rounds where the kernels store."""
    if scale is None:
        scale = (q.shape[-1] // heads) ** -0.5
    return _PackedAttentionPlain.apply(heads, float(scale), bool(mxu_bf16),
                                       q, k, v)


def _check_cuda(heads: int, *tensors: torch.Tensor) -> Tuple[int, int, int, int]:
    """Validate what the kernels take; returns (B, Lq, Lk, dm)."""
    q, k, v = tensors[:3]
    b, lq, dm = q.shape
    lk = k.shape[1]
    if k.shape != (b, lk, dm) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} disagree")
    for t in tensors[3:]:
        if t.shape != q.shape:
            raise ValueError(f"expected shape {tuple(q.shape)}, got "
                             f"{tuple(t.shape)}")
    if dm % heads or not packed_eligible(heads, dm // heads, lk):
        raise ValueError(f"packed kernel ineligible for dm={dm} heads={heads} "
                         f"lk={lk}")
    if dm // heads not in _KERNEL_HEAD_DIMS:
        raise ValueError("the packed attention kernels take head dims "
                         f"{_KERNEL_HEAD_DIMS}, got {dm // heads}")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernels' grid limit 65535")
    for t in tensors:
        if (t.dtype not in (torch.float32, torch.bfloat16)
                or t.dtype != q.dtype or t.device != q.device):
            raise TypeError("the packed attention kernels take float32 or "
                            "bfloat16 tensors of one dtype on one device, "
                            f"got {t.dtype} on {t.device} beside {q.dtype}")
    return b, lq, lk, dm


# The launchers' modes (``Mode`` in csrc/attention_packed.cu): operands in
# f32 or bf16, I/O in ``q``'s dtype.
_MODE_F32, _MODE_BF16, _MODE_BF16_IO, _MODE_F32_BF16_IO = 0, 1, 2, 3


def _mode(q: torch.Tensor, bf16: bool) -> int:
    """The launchers' mode for ``q``'s dtype and the operand flag."""
    if q.dtype != torch.bfloat16:
        return _MODE_BF16 if bf16 else _MODE_F32
    return _MODE_BF16_IO if bf16 else _MODE_F32_BF16_IO


def _count(mode: int, which: str) -> None:
    """One more launch of the ``which`` ("fwd" or "bwd") kernels of
    ``mode``, on its counter."""
    suffix = {_MODE_BF16_IO: "_bf16",
              _MODE_F32_BF16_IO: "_f32io_bf16"}.get(mode, "")
    globals()[f"launches_{which}{suffix}"] += 1


def _fwd_cuda(q, k, v, heads: int, scale: float, bf16: bool,
              want_lse: bool = False):
    """The forward kernel: ``(out, lse)``, ``lse`` None unless wanted."""
    b, lq, lk, dm = _check_cuda(heads, q, k, v)
    mode = _mode(q, bf16)
    q, k, v = (_build.aligned(t) for t in (q, k, v))
    out = torch.empty_like(q)
    lse = (torch.empty((b, heads, lq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    lib = _build.load("attention_packed", _SIG)
    err = lib.packed_attention_fwd_launch(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        _build.ptr(lse) if want_lse else None,
        b, lq, lk, dm, heads, scale, mode, _build.stream_ptr(q.device))
    _build.check(err, "packed_attention forward")
    _count(mode, "fwd")
    return out, lse


def bwd_wgmma_route(io_bf16: bool, bf16: bool, lk: int) -> bool:
    """Whether a backward on the card runs ``bwd_wgmma_bf16_kernel``: bf16
    tensors in the bf16 mode with at most 256 keys."""
    return io_bf16 and bf16 and lk <= _WGMMA_MAX_LK


def _bwd_cuda(q, k, v, out, lse, dout, heads: int, scale: float, bf16: bool,
              kernel: Optional[str] = None):
    """The backward's launch. ``kernel`` names which bf16-mode kernel runs
    ("wgmma" or "mma"); by default ``bwd_wgmma_route`` picks. Naming one
    serves the checks: "mma" runs ``bwd_mma_kernel`` on bf16 tensors at Lk
    <= 256 too, "wgmma" the new kernel's f32-I/O instance on f32 tensors;
    a shape the named kernel does not take raises before a launch."""
    b, lq, lk, dm = _check_cuda(heads, q, k, v, out, dout)
    mode = _mode(q, bf16)
    if kernel is not None:
        if kernel not in _BWD_KERNELS:
            raise ValueError(f"no packed attention backward kernel "
                             f"{kernel!r}")
        if not bf16:
            raise ValueError("the named backward kernels are the bf16 "
                             "mode's (mxu_bf16=True)")
        if kernel == "wgmma" and lk > _WGMMA_MAX_LK:
            raise ValueError(f"bwd_wgmma_bf16_kernel takes at most "
                             f"{_WGMMA_MAX_LK} keys, got {lk}")
    wgmma = (kernel == "wgmma" if kernel is not None
             else bwd_wgmma_route(mode == _MODE_BF16_IO, bf16, lk))
    if (lse.shape != (b, heads, lq) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError(f"lse must be float32 {(b, heads, lq)} on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)}")
    q, k, v, out, dout = (_build.aligned(t) for t in (q, k, v, out, dout))
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _build.load("attention_packed", _SIG)
    # Scratch (f32): the f32 modes keep delta = rowsum(dO * O) between their
    # two kernels; bwd_mma_kernel the partial dQ of each key split, when Lk
    # takes more than one block, summed in f32 before dQ is stored.
    if wgmma:
        scratch = None
    elif bf16:
        splits = lib.packed_attention_bwd_splits(lk, dm, heads)
        scratch = (torch.empty((splits,) + tuple(q.shape),
                               dtype=torch.float32, device=q.device)
                   if splits > 1 else None)
    else:
        scratch = torch.empty_like(lse)
    err = lib.packed_attention_bwd_launch(
        *(_build.ptr(t) for t in (q, k, v, out, dout, lse, dq, dk, dv)),
        _build.ptr(scratch) if scratch is not None else None,
        b, lq, lk, dm, heads, scale, mode,
        _BWD_KERNELS[kernel] if kernel is not None else 0,
        _build.stream_ptr(q.device))
    _build.check(err, "packed_attention backward")
    _count(mode, "bwd")
    return dq, dk, dv


class _PackedAttention(torch.autograd.Function):
    """Forward kernel; backward kernels on the saved q, k, v, output and
    logsumexp (written by the forward only when a gradient is wanted)."""

    @staticmethod
    def forward(ctx, heads, scale, bf16, q, k, v):
        out, lse = _fwd_cuda(q, k, v, heads, scale, bf16,
                             want_lse=any(ctx.needs_input_grad))
        ctx.heads, ctx.scale, ctx.bf16 = heads, scale, bf16
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        return (None, None, None) + _bwd_cuda(q, k, v, out, lse, g, ctx.heads,
                                              ctx.scale, ctx.bf16)


def packed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     heads: int, scale: Optional[float] = None,
                     mxu_bf16: Optional[bool] = None) -> torch.Tensor:
    """Multi-head attention on the packed (B, L, H*d) layout.

    Callers check ``packed_eligible`` first. ``mxu_bf16`` mirrors the JAX
    function's flag: bf16 matmul operands with f32 sums (the default on the
    card, as compiled on the TPU), or exact f32 when False. On a CPU tensor
    the plain version runs: float32 through the twin (the flag does not
    apply); bf16 through the kernels' plain versions with the flag, False
    by default, as JAX's kernel runs in interpret mode. On a CUDA tensor the
    kernels run, or the call raises for a shape they do not take (head dims
    other than 8-64).
    """
    dm = q.shape[-1]
    if dm % heads:
        raise ValueError(f"model dim {dm} not divisible by heads {heads}")
    d = dm // heads
    if not packed_eligible(heads, d, k.shape[1]):
        raise ValueError(f"packed kernel ineligible for heads={heads} d={d} "
                         f"lk={k.shape[1]}; use kernels.attention.attention")
    if scale is None:
        scale = d ** -0.5
    if not q.is_cuda:
        if q.dtype == torch.float32:
            return packed_attention_reference(q, k, v, heads, scale)
        return packed_attention_plain(q, k, v, heads, scale, bool(mxu_bf16))
    if mxu_bf16 is None:
        mxu_bf16 = True
    return _PackedAttention.apply(heads, float(scale), bool(mxu_bf16), q, k, v)
