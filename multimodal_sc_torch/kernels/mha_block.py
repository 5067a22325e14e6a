"""Whole-MHA-span fused block: LN -> QKV -> attention -> out-proj + residual.

Counterpart of ``multimodal_sc_tpu/kernels/mha_block.py``:

    out = x_q + attention(LN_q(x_q) Wq, LN_kv(x_kv) Wk, LN_kv(x_kv) Wv) Wo + bo

with the heads packed in the 128-wide model dim, params in the same packed
layout (wq/wk/wv (dim, heads*d) head-major in the output columns, wo
(heads*d, dim), all ``(in, out)``). ``mha_block`` launches the CUDA kernel
(``csrc/mha_block.cu``) on a CUDA tensor and runs ``mha_block_reference``
on a CPU tensor; its backward recomputes through the plain version, as the
JAX package's custom VJP does.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from multimodal_sc_torch.kernels import _build

_LANES = 128
_MAX_LK_PAD = 2048
_EPS = 1e-6
_KERNEL_HEAD_DIMS = (8, 16, 32, 64)
_KV_TILE = 32       # keys per online-softmax step of the CUDA kernel

PARAM_KEYS = ("ln_q_scale", "ln_q_bias", "ln_kv_scale", "ln_kv_bias",
              "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")

# Launches of the CUDA kernel (one per mha_block call on the card; each
# runs the K/V projection and the attention as two grid launches).
launches = 0

_SIG = {"mha_block_launch": (ctypes.c_void_p,) * 17 + (
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_int, ctypes.c_void_p)}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def block_eligible(heads: int, dim: int, lk: int) -> bool:
    """The JAX package's rule: model dim one 128-lane group, heads pack
    evenly, padded Lk at most 2048. Kept identical so both packages pick
    the same path for the same config."""
    if dim != _LANES or dim % heads:
        return False
    d = dim // heads
    return _LANES % d == 0 and _round_up(lk, _LANES) <= _MAX_LK_PAD


def kernel_eligible(heads: int, dim: int, lk: int) -> bool:
    """``block_eligible`` narrowed to the head dims the CUDA kernel is built
    for; ``FusedMHABlock`` runs the plain version for the others."""
    return block_eligible(heads, dim, lk) and dim // heads in _KERNEL_HEAD_DIMS


def _layer_norm(x: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + _EPS) * scale + bias


def mha_block_reference(x_q: torch.Tensor, x_kv: torch.Tensor,
                        p: Dict[str, torch.Tensor], heads: int,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain version in float32 (and the backward's recompute path)."""
    dm = x_q.shape[-1]
    d = dm // heads
    if scale is None:
        scale = d ** -0.5
    xq = _layer_norm(x_q.float(), p["ln_q_scale"], p["ln_q_bias"])
    xkv = _layer_norm(x_kv.float(), p["ln_kv_scale"], p["ln_kv_bias"])
    q = xq @ p["wq"] + p["bq"]
    k = xkv @ p["wk"] + p["bk"]
    v = xkv @ p["wv"] + p["bv"]
    b, lq, _ = q.shape
    lk = k.shape[1]

    def split(x, n):
        return x.reshape(b, n, heads, d).transpose(1, 2)

    logits = split(q, lq) @ split(k, lk).transpose(-1, -2) * scale
    probs = torch.softmax(logits, dim=-1)
    o = (probs @ split(v, lk)).transpose(1, 2).reshape(b, lq, dm)
    return (x_q.float() + o @ p["wo"] + p["bo"]).to(x_q.dtype)


def mha_block_reference_bf16(x_q: torch.Tensor, x_kv: torch.Tensor,
                             p: Dict[str, torch.Tensor], heads: int,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of the CUDA kernel's bf16 mode, rounding where it does.

    Every matmul operand (LN outputs, weights, q, k, v, probabilities, the
    attention output) is rounded to bf16, every sum kept in f32, and the
    softmax runs online over tiles of ``_KV_TILE`` keys with the
    unnormalised probabilities rounded, as in ``csrc/mha_block.cu``. The
    check of the kernel's bf16 mode on the card holds it against this.
    """
    def r(t):
        return t.bfloat16().float()

    dm = x_q.shape[-1]
    d = dm // heads
    if scale is None:
        scale = d ** -0.5
    xq = r(_layer_norm(x_q.float(), p["ln_q_scale"], p["ln_q_bias"]))
    xkv = r(_layer_norm(x_kv.float(), p["ln_kv_scale"], p["ln_kv_bias"]))
    q = r(xq @ r(p["wq"]) + p["bq"])
    k = r(xkv @ r(p["wk"]) + p["bk"])
    v = r(xkv @ r(p["wv"]) + p["bv"])
    b, lq, _ = q.shape
    lk = k.shape[1]

    def split(x, n):
        return x.reshape(b, n, heads, d).transpose(1, 2)

    qh, kh, vh = split(q, lq), split(k, lk), split(v, lk)
    m = torch.full((b, heads, lq, 1), float("-inf"), device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros_like(qh)
    for k0 in range(0, lk, _KV_TILE):
        s = qh @ kh[:, :, k0:k0 + _KV_TILE].transpose(-1, -2) * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        pr = torch.exp(s - m_new)
        l = l * corr + pr.sum(-1, keepdim=True)
        o = o * corr + r(pr) @ vh[:, :, k0:k0 + _KV_TILE]
        m = m_new
    att = r(o * (1.0 / l)).transpose(1, 2).reshape(b, lq, dm)
    return ((x_q.float() + att @ r(p["wo"])) + p["bo"]).to(x_q.dtype)


def _mha_block_cuda(x_q, x_kv, flat, heads: int, scale: float,
                    bf16: bool) -> torch.Tensor:
    global launches
    b, lq, dm = x_q.shape
    lk = x_kv.shape[1]
    if x_kv.shape[0] != b or x_kv.shape[2] != dm:
        raise ValueError(f"x_q {tuple(x_q.shape)} and x_kv "
                         f"{tuple(x_kv.shape)} disagree")
    if dm // heads not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"mha_block kernel takes head dims 8-64, got "
                         f"{dm // heads}")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit 65535")
    for t in (x_q, x_kv, *flat):
        if t.dtype != torch.float32 or t.device != x_q.device:
            raise TypeError("mha_block kernel takes float32 tensors on one "
                            f"device, got {t.dtype} on {t.device}")
    for name, t in zip(PARAM_KEYS, flat):
        want = (dm, dm) if name.startswith("w") else (dm,)
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {want}")
    x_q, x_kv = _build.aligned(x_q), _build.aligned(x_kv)
    flat = [_build.aligned(t) for t in flat]
    kbuf = torch.empty((b, lk, dm), dtype=torch.float32, device=x_q.device)
    vbuf = torch.empty_like(kbuf)
    out = torch.empty((b, lq, dm), dtype=torch.float32, device=x_q.device)
    lib = _build.load("mha_block", _SIG)
    err = lib.mha_block_launch(
        _build.ptr(x_q), _build.ptr(x_kv), *(_build.ptr(t) for t in flat),
        _build.ptr(kbuf), _build.ptr(vbuf), _build.ptr(out),
        b, lq, lk, heads, scale, int(bf16), _build.stream_ptr(x_q.device))
    _build.check(err, "mha_block")
    launches += 1
    return out


class _MHABlock(torch.autograd.Function):
    """Kernel forward; backward by recomputing the plain version."""

    @staticmethod
    def forward(ctx, heads, scale, bf16, x_q, x_kv, *flat):
        ctx.heads, ctx.scale = heads, scale
        ctx.save_for_backward(x_q, x_kv, *flat)
        return _mha_block_cuda(x_q, x_kv, flat, heads, scale, bf16)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            x_q, x_kv, *flat = ins
            y = mha_block_reference(x_q, x_kv, dict(zip(PARAM_KEYS, flat)),
                                    ctx.heads, ctx.scale)
            grads = torch.autograd.grad(y, ins, g)
        return (None, None, None) + tuple(grads)


def mha_block(x_q: torch.Tensor, x_kv: torch.Tensor,
              params: Dict[str, torch.Tensor], heads: int,
              scale: Optional[float] = None,
              mxu_bf16: Optional[bool] = None) -> torch.Tensor:
    """Fused LN+QKV+attention+out-proj+residual block.

    Callers check ``block_eligible`` first. ``mxu_bf16`` mirrors the JAX
    function's flag: bf16 matmul operands with f32 accumulation (the
    default on the card, as on the TPU), or exact f32 when False. On a CPU
    tensor the plain f32 version runs and the flag does not apply.
    """
    dm = x_q.shape[-1]
    if not block_eligible(heads, dm, x_kv.shape[1]):
        raise ValueError(f"mha_block ineligible for dim={dm} heads={heads} "
                         f"lk={x_kv.shape[1]}")
    if scale is None:
        scale = (dm // heads) ** -0.5
    if not x_q.is_cuda:
        return mha_block_reference(x_q, x_kv, params, heads, scale)
    if mxu_bf16 is None:
        mxu_bf16 = True
    flat = tuple(params[k] for k in PARAM_KEYS)
    return _MHABlock.apply(heads, float(scale), bool(mxu_bf16), x_q, x_kv,
                           *flat)
