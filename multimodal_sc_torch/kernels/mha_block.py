"""Whole-MHA-span fused block: LN -> QKV -> attention -> out-proj + residual.

Counterpart of ``multimodal_sc_tpu/kernels/mha_block.py``:

    out = x_q + attention(LN_q(x_q) Wq, LN_kv(x_kv) Wk, LN_kv(x_kv) Wv) Wo + bo

with the heads packed in the 128-wide model dim, params in the same packed
layout (wq/wk/wv (dim, heads*d) head-major in the output columns, wo
(heads*d, dim), all ``(in, out)``). ``mha_block`` launches the CUDA kernel
(``csrc/mha_block.cu``) on a CUDA tensor and runs ``mha_block_reference``
on a CPU tensor; its backward recomputes through the plain version, as the
JAX package's custom VJP does.

Which kernel runs which shapes on the card: bf16 activations with Lk <=
256 (every c4, c4_vq, c4_digital and c5 shape) run ``mha_wgmma_bf16_kernel``
(``csrc/mha_bf16.cuh``, bf16 ``wgmma``); f32 activations, and bf16 ones
past 256 keys (fog + V2X's 512), run ``mha_mma_kernel`` (bf16 ``mma.sync``)
or, with ``mxu_bf16=False``, the f32 mode on the FMA units.

Under ``train.bf16`` the activations ``x_q`` and ``x_kv`` are bf16 and the
parameters stay f32, as the JAX package passes them; the output takes
``x_q``'s dtype. Both modes read and write bf16 activations themselves
(counted apart, ``launches_bf16``). In the f32 mode (``mxu_bf16=False``, no
main path) they run the f32 kernels' bf16-I/O instance, counted again in
``launches_f32io_bf16``: x_q and x_kv widened exactly, everything f32, the
output rounded once, as JAX's kernel computes bf16 arrays with
``bf16=False``.
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
_WEIGHT_SCRATCH = 4 * 128 * 128 // 2   # floats: four bf16 128 x 128 weights
_WGMMA_MAX_LK = 256   # keys mha_wgmma_bf16_kernel holds in shared memory

PARAM_KEYS = ("ln_q_scale", "ln_q_bias", "ln_kv_scale", "ln_kv_bias",
              "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")

# Launches of the CUDA kernel (one per mha_block call on the card: one grid
# in bf16 mode; the f32 mode runs the K/V projection and the attention as
# two grid launches); with bf16 activations, ``launches_bf16``, and of
# those the f32 mode's also ``launches_f32io_bf16``.
launches = 0
launches_bf16 = 0
launches_f32io_bf16 = 0

_SIG = {
    "mha_block_launch": (ctypes.c_void_p,) * 17 + (
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p),
    "mha_wgmma_bf16_launch": (ctypes.c_void_p,) * 16 + (
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p),
}


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


def _layer_norm_f64(x: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm taken in f64 and rounded to f32 once: the correctly rounded
    f32 result, which the kernel's bf16 mode computes too, so both round
    the same values to bf16 (an f32 LayerNorm moves by an ulp with the
    order of its sums, and a flipped bf16 rounding of one x_kv entry moves
    every output of its batch element)."""
    x = x.double()
    mu = x.mean(-1, keepdim=True)
    d = x - mu
    rs = 1.0 / torch.sqrt(d.square().mean(-1, keepdim=True) + _EPS)
    return (d * rs * scale.double() + bias.double()).float()


def mha_block_reference(x_q: torch.Tensor, x_kv: torch.Tensor,
                        p: Dict[str, torch.Tensor], heads: int,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain version in float32 (and the backward's recompute path); bf16
    activations are widened and the output rounded to their dtype once."""
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
    """Plain version of the bf16 mode, rounding where the JAX kernel does
    (bf16 or f32 activations in, the output in their dtype).

    Every matmul operand (LN outputs, weights, q, k, v, the probabilities,
    the concatenated head outputs) is rounded to bf16 and every sum kept in
    f32; the softmax is f32 and NORMALISED before its probabilities are
    rounded, as ``_block_kernel`` of the JAX package computes it with
    ``bf16=True``. The LayerNorm is the correctly rounded one
    (``_layer_norm_f64``), as in the kernel. The check of the kernel's bf16
    mode on the card holds it against this.
    """
    def r(t):
        return t.bfloat16().float()

    dm = x_q.shape[-1]
    d = dm // heads
    if scale is None:
        scale = d ** -0.5
    xq = r(_layer_norm_f64(x_q, p["ln_q_scale"], p["ln_q_bias"]))
    xkv = r(_layer_norm_f64(x_kv, p["ln_kv_scale"], p["ln_kv_bias"]))
    q = r(xq @ r(p["wq"]) + p["bq"])
    k = r(xkv @ r(p["wk"]) + p["bk"])
    v = r(xkv @ r(p["wv"]) + p["bv"])
    b, lq, _ = q.shape
    lk = k.shape[1]

    def split(x, n):
        return x.reshape(b, n, heads, d).transpose(1, 2)

    probs = torch.softmax(split(q, lq) @ split(k, lk).transpose(-1, -2)
                          * scale, dim=-1)
    att = r((r(probs) @ split(v, lk)).transpose(1, 2).reshape(b, lq, dm))
    return ((x_q.float() + att @ r(p["wo"])) + p["bo"]).to(x_q.dtype)


def wgmma_route(io_bf16: bool, bf16: bool, lk: int) -> bool:
    """Whether a call on the card runs ``mha_wgmma_bf16_kernel``: bf16
    activations in the bf16 mode with at most 256 keys."""
    return io_bf16 and bf16 and lk <= _WGMMA_MAX_LK


def _mha_block_cuda(x_q, x_kv, flat, heads: int, scale: float,
                    bf16: bool, kernel: Optional[str] = None) -> torch.Tensor:
    """The kernel's launch. ``kernel`` names which one runs ("wgmma" or
    "mma"); by default ``wgmma_route`` picks. Naming one serves the checks
    that time the two bf16-I/O kernels side by side at the same shapes."""
    global launches, launches_bf16, launches_f32io_bf16
    b, lq, dm = x_q.shape
    lk = x_kv.shape[1]
    if x_kv.shape[0] != b or x_kv.shape[2] != dm:
        raise ValueError(f"x_q {tuple(x_q.shape)} and x_kv "
                         f"{tuple(x_kv.shape)} disagree")
    if dm // heads not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"mha_block kernel takes head dims 8-64, got "
                         f"{dm // heads}")
    if not bf16 and b > 65535:
        raise ValueError(f"batch {b} exceeds the f32 kernel's grid limit "
                         "65535")
    io_bf16 = x_q.dtype == torch.bfloat16
    if x_q.dtype not in (torch.float32, torch.bfloat16) \
            or x_kv.dtype != x_q.dtype:
        raise TypeError("mha_block kernel takes x_q and x_kv both float32 "
                        f"or both bfloat16, got {x_q.dtype} / {x_kv.dtype}")
    for t in (x_q, x_kv, *flat):
        if t.device != x_q.device:
            raise TypeError("mha_block kernel takes tensors on one device, "
                            f"got {t.device} and {x_q.device}")
    for t in flat:
        if t.dtype != torch.float32:
            raise TypeError("mha_block kernel takes float32 parameters, got "
                            f"{t.dtype}")
    for name, t in zip(PARAM_KEYS, flat):
        want = (dm, dm) if name.startswith("w") else (dm,)
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {want}")
    if kernel is None:
        kernel = "wgmma" if wgmma_route(io_bf16, bf16, lk) else "mma"
    if kernel not in ("wgmma", "mma"):
        raise ValueError(f"no mha_block kernel {kernel!r}")
    if kernel == "wgmma" and not wgmma_route(io_bf16, bf16, lk):
        raise ValueError("mha_wgmma_bf16_kernel takes bf16 activations in "
                         f"the bf16 mode and at most {_WGMMA_MAX_LK} keys, "
                         f"got {x_q.dtype}, mxu_bf16={bf16}, Lk {lk}")
    x_q, x_kv = _build.aligned(x_q), _build.aligned(x_kv)
    flat = [_build.aligned(t) for t in flat]
    out = torch.empty((b, lq, dm), dtype=x_q.dtype, device=x_q.device)
    # The bf16 mode (either kernel) keeps K and V on chip and takes 128 KB
    # of scratch for the four weights rounded to bf16; the f32 mode
    # projects K and V into scratch first.
    if bf16:
        kbuf, vbuf = torch.empty(_WEIGHT_SCRATCH, dtype=torch.float32,
                                 device=x_q.device), None
    else:
        kbuf = torch.empty((b, lk, dm), dtype=torch.float32, device=x_q.device)
        vbuf = torch.empty_like(kbuf)
    lib = _build.load("mha_block", _SIG)
    if kernel == "wgmma":
        err = lib.mha_wgmma_bf16_launch(
            _build.ptr(x_q), _build.ptr(x_kv), *(_build.ptr(t) for t in flat),
            _build.ptr(kbuf), _build.ptr(out), b, lq, lk, heads, scale,
            _build.stream_ptr(x_q.device))
    else:
        err = lib.mha_block_launch(
            _build.ptr(x_q), _build.ptr(x_kv), *(_build.ptr(t) for t in flat),
            *(None if t is None else _build.ptr(t) for t in (kbuf, vbuf)),
            _build.ptr(out),
            b, lq, lk, heads, scale, int(bf16), int(io_bf16),
            _build.stream_ptr(x_q.device))
    _build.check(err, f"mha_block ({kernel})")
    if io_bf16:
        launches_bf16 += 1
        if not bf16:
            launches_f32io_bf16 += 1
    else:
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
    tensor the plain f32 version runs, on bf16 activations widened and its
    output rounded once, and the flag does not apply.
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
