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
3xTF32 split. Other channel counts (the first layer's Cin = 3) take a per-image kernel on
the FMA units.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_sc_torch.kernels import _build

# Launches of the CUDA kernel (one per conv_prelu call on the card).
launches = 0

_SMEM_LIMIT = 232448    # bytes of shared memory one block may use (sm_90)

_SIG = {"conv_prelu_launch": (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p)}


def same_pads(size: int, k: int, stride: int):
    """XLA SAME padding (lo, hi) for one spatial dim: back-heavy when odd."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_prelu_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         alpha: Optional[torch.Tensor],
                         stride: int = 1) -> torch.Tensor:
    """Plain version: SAME conv (NHWC, HWIO) + bias + optional PReLU."""
    k = w.shape[0]
    ph, pw = same_pads(x.shape[1], k, stride), same_pads(x.shape[2], k, stride)
    xc = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), b, stride=stride)
    y = y.permute(0, 2, 3, 1)
    if alpha is not None:
        y = torch.where(y >= 0, y, y * alpha)
    return y


def tensor_core_path(cin: int, cout: int) -> bool:
    """Whether the kernel runs its implicit GEMM (16-byte copies need both
    channel counts to be multiples of 4) or its per-image path. The C entry
    is told the path and only refuses one the shape cannot take."""
    return cin % 4 == 0 and cout % 4 == 0


def _conv_prelu_cuda(x, w, b, alpha, stride: int) -> torch.Tensor:
    global launches
    tensors = (x, w, b) if alpha is None else (x, w, b, alpha)
    for t in tensors:
        if t.device != x.device or t.dtype != torch.float32:
            raise TypeError("conv_prelu kernel takes float32 tensors on one "
                            f"device, got {t.dtype} on {t.device}")
    n, h, wd, cin = x.shape
    k, k2, wcin, cout = w.shape
    if k != k2 or wcin != cin or b.shape != (cout,) or (
            alpha is not None and alpha.shape != (cout,)):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}")
    if stride not in (1, 2):
        raise ValueError(f"stride {stride} unsupported")
    oh, ow = -(-h // stride), -(-wd // stride)
    tensor_cores = tensor_core_path(cin, cout)
    smem = ((oh - 1) * stride + k) * ((ow - 1) * stride + k) * cin * 4
    if not tensor_cores and smem > _SMEM_LIMIT:
        raise ValueError(f"padded input window of {smem} bytes exceeds the "
                         f"{_SMEM_LIMIT} bytes of shared memory per block")
    # 16-byte copies and float4 weight loads need aligned bases.
    x, w = _build.aligned(x), _build.aligned(w)
    b = b.contiguous()
    alpha = alpha.contiguous() if alpha is not None else None
    out = torch.empty((n, oh, ow, cout), dtype=x.dtype, device=x.device)
    lib = _build.load("conv_prelu", _SIG)
    err = lib.conv_prelu_launch(
        _build.ptr(x), _build.ptr(w), _build.ptr(b),
        _build.ptr(alpha) if alpha is not None else None, _build.ptr(out),
        n, h, wd, cin, cout, k, stride, int(tensor_cores),
        _build.stream_ptr(x.device))
    _build.check(err, "conv_prelu")
    launches += 1
    return out


class _ConvPReLU(torch.autograd.Function):
    """Kernel forward; the backward recomputes through the plain version,
    as the JAX package's ``_conv_fused_bwd`` does."""

    @staticmethod
    def forward(ctx, stride, x, w, b, alpha):
        ctx.stride = stride
        ctx.save_for_backward(x, w, b, alpha)
        return _conv_prelu_cuda(x, w, b, alpha, stride)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            x, w, b, alpha = (t.detach().requires_grad_(True)
                              if t is not None else None for t in saved)
            y = conv_prelu_reference(x, w, b, alpha, ctx.stride)
            ins = [t for t in (x, w, b, alpha) if t is not None]
            grads = iter(torch.autograd.grad(y, ins, g))
        return (None,) + tuple(next(grads) if t is not None else None
                               for t in saved)


def conv_prelu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               alpha: Optional[torch.Tensor] = None,
               stride: int = 1) -> torch.Tensor:
    """Fused SAME conv + bias + optional PReLU (NHWC in, NHWC out)."""
    if x.is_cuda:
        return _ConvPReLU.apply(stride, x, w, b, alpha)
    return conv_prelu_reference(x, w, b, alpha, stride)


class FusedConvPReLU(nn.Module):
    """Owns conv (HWIO ``kernel``) + bias + PReLU ``alpha`` params.

    Parameter names and layout match the flax module, so the bridge copies
    them unchanged."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 5,
                 stride: int = 1, with_prelu: bool = True):
        super().__init__()
        k = kernel_size
        self.stride = stride
        fan_in = k * k * in_features
        self.kernel = nn.Parameter(
            torch.randn(k, k, in_features, features) / math.sqrt(fan_in))
        self.bias = nn.Parameter(torch.zeros(features))
        self.alpha = (nn.Parameter(torch.full((features,), 0.25))
                      if with_prelu else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_prelu(x, self.kernel, self.bias, self.alpha, self.stride)
