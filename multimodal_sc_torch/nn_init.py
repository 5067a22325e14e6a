"""Fresh weights drawn as flax draws them.

Flax's ``Dense``, ``DenseGeneral``, ``Conv`` and ``ConvTranspose`` start from
``lecun_normal()`` kernels and zero biases; PyTorch's ``nn.Linear`` and
``nn.Conv*`` from kaiming-uniform weights (a standard deviation of
1/sqrt(3 fan_in)) and non-zero uniform biases. The port's networks call
:func:`init_like_flax_` once they are built, and its hand-built parameters
(the conv kernel's filter bank, the fused attention blocks' weights) draw
from :func:`lecun_normal_` themselves, so one rule holds everywhere.
LayerNorm ones and zeros, PReLU slopes and the ``normal(0.02)`` tables
already match flax and are left alone. A VQ codebook draws from
:func:`variance_scaling_uniform_`, flax's ``variance_scaling(1.0, "fan_in",
"uniform")``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# The standard deviation of a unit normal truncated to [-2, 2]; flax divides
# by it so that the truncated draw keeps the variance asked for.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int) -> torch.Tensor:
    """Fill ``w`` in place as flax's ``variance_scaling(1, "fan_in",
    "truncated_normal")``: a unit normal truncated at +-2, scaled by
    1 / (sqrt(fan_in) * 0.8796...), so that the variance is 1 / fan_in."""
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0)
        return w.mul_(1.0 / (math.sqrt(fan_in) * _TRUNC_STD))


def variance_scaling_uniform_(w: torch.Tensor) -> torch.Tensor:
    """Fill ``w`` in place as flax's ``variance_scaling(1.0, "fan_in",
    "uniform")``: U(-sqrt(3 / fan_in), sqrt(3 / fan_in)), where flax takes
    the fan-in of a 2-d ``(K, D)`` parameter from its first axis, K (a VQ
    codebook of K codes draws at +-sqrt(3 / K))."""
    limit = math.sqrt(3.0 / w.shape[-2])
    with torch.no_grad():
        return w.uniform_(-limit, limit)


def flax_fan_in(m: nn.Module) -> int:
    """The fan-in flax gives the layer's kernel: the input features, times
    the window for a convolution. For a transposed convolution that is the
    INPUT channels (flax's kernel is (kh, kw, in, out)), where torch's
    ``_calculate_fan_in_and_fan_out`` would take its weight's second axis,
    the output channels."""
    w = m.weight
    window = math.prod(w.shape[2:])
    if isinstance(m, nn.ConvTranspose2d):
        return w.shape[0] * window
    return w.shape[1] * window      # Linear (out, in); Conv2d (out, in, kh, kw)


def init_like_flax_(module: nn.Module) -> nn.Module:
    """Redraw every ``nn.Linear``, ``nn.Conv2d`` and ``nn.ConvTranspose2d``
    under ``module`` as flax draws a fresh layer: :func:`lecun_normal_`
    weights at flax's fan-in, zero biases. Draws come from the global RNG
    (callers build their networks under ``torch.random.fork_rng``)."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            lecun_normal_(m.weight, flax_fan_in(m))
            if m.bias is not None:
                with torch.no_grad():
                    m.bias.zero_()
    return module
