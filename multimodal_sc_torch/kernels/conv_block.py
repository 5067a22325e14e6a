"""Fused SAME conv + bias + PReLU for the CNN-JSCC blocks.

Counterpart of ``multimodal_sc_tpu/kernels/conv_block.py``. Layouts stay
the JAX package's: NHWC activations, HWIO weights. ``conv_prelu`` launches
the CUDA kernel (``csrc/conv_prelu.cu``) on a CUDA tensor and runs
``conv_prelu_reference`` on a CPU tensor. On the TPU ``use_pallas`` picked
between the Pallas kernel and XLA; the port has no XLA to fall back on, so
on the card the kernel always runs.

When Cin and Cout are multiples of 4 the kernel is an implicit GEMM on the
tensor cores (``wgmma`` for more than 64 output channels, ``mma.sync`` for
fewer): output pixels x (tap, channel) gathered from the input, times the
HWIO weights read as a (K*K*Cin, Cout) matrix, every product formed by the
3xTF32 split. Other channel counts (the first layer's Cin = 3, the decoder's
Cout = 3) take a banded kernel on the FMA units: a block per image and band
of output rows, the band's padded window in shared memory, the band chosen
by ``band_plan``.

Under ``train.bf16`` ``FusedConvPReLU`` casts ``x`` and its f32 kernel, bias
and slopes to bf16, as the JAX module does, and the kernel reads and writes
bf16 itself (counted apart, ``launches_bf16``): the implicit GEMM on bf16
``wgmma`` when Cout is a multiple of 8 (any Cin: the first layer's Cin = 3
too), else the banded path; the products summed in f32 a step at a time
(64 consecutive values of the flattened (ky, kx, c) K), the steps' sums
joined in order, bias and PReLU applied, one rounding. Where the output
tiles give a small grid (a batch of 32-64 on 8 x 8 maps), a cluster of up
to 8 blocks splits the steps of a tile and adds its blocks' sums in rank
order (``bf16_splits``).
The plain version computes the same: widened operands, an f32 conv, one
rounding. The JAX package's XLA route (``use_pallas=False``) rounds a bf16
conv after the conv, again after the bias and again after the PReLU; its
Pallas kernel, which the port's forward follows, rounds once, and its
custom VJP differentiates the XLA route. So does the port's backward on
bf16 (``conv_prelu_reference(..., round_once=False)``), on the card and
on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_sc_torch.kernels import _build
from multimodal_sc_torch.nn_init import lecun_normal_

# Launches of the CUDA kernel (one per conv_prelu call on the card); with
# bf16 operands, ``launches_bf16``.
launches = 0
launches_bf16 = 0

_SMEM_LIMIT = 232448    # bytes of shared memory one block may use (sm_90)
_SMEM_AIM = 56 * 1024   # a banded window this size lets 4 blocks share an SM
_SMS = 132              # streaming multiprocessors of an H100 SXM

_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 9 + (ctypes.c_void_p,)
_SIG = {"conv_prelu_launch": _ARGS, "conv_prelu_bf16_launch": _ARGS,
        "conv_prelu_bf16_splits": (ctypes.c_int,) * 7}


def same_pads(size: int, k: int, stride: int):
    """XLA SAME padding (lo, hi) for one spatial dim: back-heavy when odd."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_prelu_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         alpha: Optional[torch.Tensor], stride: int = 1,
                         round_once: bool = True) -> torch.Tensor:
    """Plain version: SAME conv (NHWC, HWIO), the bias added, optional
    PReLU, each op in the operands' dtype. On bf16 operands ``round_once``
    gives the kernel's arithmetic: the operands widened, the result rounded
    to bf16 once. Without it each op rounds to bf16, three roundings, as the
    JAX package's XLA route does; the bf16 backward recomputes through that,
    as the JAX package's ``_conv_fused_bwd`` does."""
    if round_once and x.dtype == torch.bfloat16:
        return conv_prelu_reference(
            x.float(), w.float(), b.float(),
            None if alpha is None else alpha.float(), stride).bfloat16()
    k = w.shape[0]
    ph, pw = same_pads(x.shape[1], k, stride), same_pads(x.shape[2], k, stride)
    xc = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride).permute(
        0, 2, 3, 1) + b
    if alpha is not None:
        y = torch.where(y >= 0, y, y * alpha)
    return y


def tensor_core_path(cin: int, cout: int,
                     dtype: torch.dtype = torch.float32) -> bool:
    """Whether the kernel runs its implicit GEMM or its banded path. f32:
    16-byte copies need both channel counts to be multiples of 4. bf16:
    Cout a multiple of 8 (its 16-byte stores), any Cin (a Cin no multiple
    of 8 is gathered value by value). The C entry is told the path and only
    refuses one the shape cannot take."""
    if dtype == torch.bfloat16:
        return cout % 8 == 0
    return cin % 4 == 0 and cout % 4 == 0


def bf16_splits(n: int, h: int, w: int, cin: int, cout: int, k: int,
                stride: int) -> int:
    """Blocks of a cluster that split one output tile's steps on the bf16
    implicit GEMM (1: no split), as the kernel's launcher plans them. Asks
    the built library: the rule lives in ``csrc/conv_prelu.cu``."""
    lib = _build.load("conv_prelu", _SIG)
    return lib.conv_prelu_bf16_splits(n, h, w, cin, cout, k, stride)


def band_window_bytes(band: int, ow: int, cin: int, k: int,
                      stride: int) -> int:
    """Shared memory of a banded block: the zero-padded input rows that
    ``band`` output rows read, ``(band - 1) * stride + k`` of them, each
    ``(ow - 1) * stride + k`` pixels of ``cin | 1`` floats (an odd pixel
    stride keeps a warp's reads off each other's banks)."""
    return ((band - 1) * stride + k) * ((ow - 1) * stride + k) * (cin | 1) * 4


def band_plan(n: int, oh: int, ow: int, cin: int, k: int,
              stride: int) -> int:
    """Output rows per block of the banded kernel for ``n`` images of
    ``oh x ow`` outputs: the most rows whose window stays within
    ``_SMEM_AIM`` bytes, and few enough that the batch gives at least
    ``_SMS`` blocks wherever ``n * oh`` allows. One row whose window still
    exceeds the aim takes up to the block's limit; past that the image is too
    wide and the plan refuses it."""
    if band_window_bytes(1, ow, cin, k, stride) > _SMEM_LIMIT:
        # The widest output row one block holds: (ow - 1) * stride + k
        # padded pixels of k rows.
        wp_max = _SMEM_LIMIT // (k * (cin | 1) * 4)
        w_max = ((wp_max - k) // stride + 1) * stride
        raise ValueError(
            f"conv_prelu: one output row's padded window of "
            f"{band_window_bytes(1, ow, cin, k, stride)} bytes exceeds the "
            f"{_SMEM_LIMIT} bytes of shared memory a block may use; at Cin "
            f"{cin}, K {k}, stride {stride} the banded path takes images at "
            f"most {w_max} pixels wide")
    fit = 1
    while fit < oh and band_window_bytes(fit + 1, ow, cin, k,
                                         stride) <= _SMEM_AIM:
        fit += 1
    bands_wanted = -(-_SMS // max(n, 1))
    return max(1, min(fit, oh // bands_wanted))


def _conv_prelu_cuda(x, w, b, alpha, stride: int,
                     band: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel. ``band`` (checks only) overrides ``band_plan``
    on the banded path."""
    global launches, launches_bf16
    tensors = (x, w, b) if alpha is None else (x, w, b, alpha)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv_prelu kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    for t in tensors:
        if t.device != x.device or t.dtype != x.dtype:
            raise TypeError("conv_prelu kernel takes x, w, b and alpha in one "
                            f"dtype on one device, got {t.dtype} on "
                            f"{t.device} beside {x.dtype} on {x.device}")
    n, h, wd, cin = x.shape
    k, k2, wcin, cout = w.shape
    if k != k2 or wcin != cin or b.shape != (cout,) or (
            alpha is not None and alpha.shape != (cout,)):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}")
    if stride not in (1, 2):
        raise ValueError(f"stride {stride} unsupported")
    oh, ow = -(-h // stride), -(-wd // stride)
    bf16 = x.dtype == torch.bfloat16
    tensor_cores = tensor_core_path(cin, cout, x.dtype)
    if tensor_cores:
        band = 0
    elif band is None:
        band = band_plan(n, oh, ow, cin, k, stride)
    # 16-byte copies and loads need aligned bases (the bf16 kernel reads
    # bias and slopes 8 at a time).
    x, w = _build.aligned(x), _build.aligned(w)
    b = _build.aligned(b)
    alpha = _build.aligned(alpha) if alpha is not None else None
    out = torch.empty((n, oh, ow, cout), dtype=x.dtype, device=x.device)
    lib = _build.load("conv_prelu", _SIG)
    entry = lib.conv_prelu_bf16_launch if bf16 else lib.conv_prelu_launch
    err = entry(
        _build.ptr(x), _build.ptr(w), _build.ptr(b),
        _build.ptr(alpha) if alpha is not None else None, _build.ptr(out),
        n, h, wd, cin, cout, k, stride, int(tensor_cores), band,
        _build.stream_ptr(x.device))
    _build.check(err, "conv_prelu")
    if bf16:
        launches_bf16 += 1
    else:
        launches += 1
    return out


class _ConvPReLU(torch.autograd.Function):
    """Kernel forward (or, with ``plain``, the plain version's); the
    backward recomputes through the plain version op by op (on bf16 its
    three roundings), as the JAX package's ``_conv_fused_bwd`` does."""

    @staticmethod
    def forward(ctx, stride, x, w, b, alpha, plain=False):
        ctx.stride = stride
        ctx.save_for_backward(x, w, b, alpha)
        fwd = conv_prelu_reference if plain else _conv_prelu_cuda
        return fwd(x, w, b, alpha, stride)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            x, w, b, alpha = (t.detach().requires_grad_(True)
                              if t is not None else None for t in saved)
            y = conv_prelu_reference(x, w, b, alpha, ctx.stride,
                                     round_once=False)
            ins = [t for t in (x, w, b, alpha) if t is not None]
            grads = iter(torch.autograd.grad(y, ins, g))
        return (None,) + tuple(next(grads) if t is not None else None
                               for t in saved) + (None,)


def conv_prelu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               alpha: Optional[torch.Tensor] = None,
               stride: int = 1) -> torch.Tensor:
    """Fused SAME conv + bias + optional PReLU (NHWC in, NHWC out)."""
    if x.is_cuda:
        return _ConvPReLU.apply(stride, x, w, b, alpha)
    return conv_prelu_plain(x, w, b, alpha, stride)


def conv_prelu_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     alpha: Optional[torch.Tensor] = None,
                     stride: int = 1) -> torch.Tensor:
    """What ``conv_prelu`` runs on a CPU tensor: the plain version, whose
    gradient on bf16 operands is the kernel's (through the three
    roundings)."""
    if x.dtype == torch.bfloat16 and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b, alpha)):
        return _ConvPReLU.apply(stride, x, w, b, alpha, True)
    return conv_prelu_reference(x, w, b, alpha, stride)


class FusedConvPReLU(nn.Module):
    """Owns conv (HWIO ``kernel``) + bias + PReLU ``alpha`` params.

    Parameter names, layout and fresh draws match the flax module, so the
    bridge copies them unchanged. With ``dtype=torch.bfloat16`` the input
    and the f32 parameters are cast to bf16 for the call, as the flax
    module's ``dtype`` casts them."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 5,
                 stride: int = 1, with_prelu: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        k = kernel_size
        self.stride, self.dtype = stride, dtype
        self.kernel = nn.Parameter(lecun_normal_(
            torch.empty(k, k, in_features, features), k * k * in_features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.alpha = (nn.Parameter(torch.full((features,), 0.25))
                      if with_prelu else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return conv_prelu(x, self.kernel, self.bias, self.alpha,
                              self.stride)
        d = self.dtype
        return conv_prelu(x.to(d), self.kernel.to(d), self.bias.to(d),
                          None if self.alpha is None else self.alpha.to(d),
                          self.stride)
