"""The activation dtype of ``train.bf16`` and flax's dtype rules for it.

With ``train.bf16`` the JAX package builds every codec and the fusion trunk
with ``dtype=bfloat16`` while the parameters stay float32 (its
``config/configs.py`` ``TrainConfig.bf16``). A flax layer built so:

* ``Dense``, ``Conv`` and ``ConvTranspose`` cast the input, the kernel and
  the bias to bf16 and return bf16: the product is rounded, then the bias
  added and rounded again;
* ``LayerNorm`` takes its statistics in f32 from the upcast input, applies
  its f32 scale and bias, and rounds once;
* ``gelu`` and the elementwise ops run in bf16.

``Dense``, ``Conv`` and ``LayerNorm`` below are PyTorch's ``nn.Linear``,
``nn.Conv2d`` and ``nn.LayerNorm`` (same parameters, same names) with an
activation dtype, and ``PointwiseConv`` is flax's 1x1 ``Conv`` on NHWC
features (an ``nn.Conv2d`` weight of shape (out, in, 1, 1), applied as a
matmul over the channels): at float32 they run PyTorch's own forward, so
the f32 paths compute as before; at bfloat16 they follow flax. These are
not PyTorch's autocast rules, which keep a LayerNorm in f32 and round a
matmul's bias into its sum.

The port runs ``train.bf16`` on every codec the JAX package builds with a
dtype: the CNN, ViT and VQ camera codecs, the analog and VQ LiDAR codecs,
the fused attention blocks and the unfused fusion MHA, with the packed and
flash attention under ``pallas_attention`` (each kernel reads and writes
bf16 itself). The VQ codecs widen their code features to f32 before the
nearest-code search, as JAX does, so codebooks, indices and VQ losses stay
f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def activation_dtype(cfg) -> torch.dtype:
    """``torch.bfloat16`` under ``train.bf16``, else ``torch.float32``, for
    every configuration: the camera (CNN, ViT or VQ), the LiDAR (analog or
    VQ) and the fusion transformer in either form, with or without
    ``pallas_attention``, as the JAX package takes its dtype from the
    config."""
    return torch.bfloat16 if cfg.train.bf16 else torch.float32


class Dense(nn.Linear):
    """``nn.Linear`` with flax ``Dense``'s ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.act_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.act_dtype
        if d == torch.float32:
            return super().forward(x)
        return F.linear(x.to(d), self.weight.to(d)) + self.bias.to(d)


class Conv(nn.Conv2d):
    """``nn.Conv2d`` (NCHW) with flax ``Conv``'s ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 padding: int = 0, dtype: torch.dtype = torch.float32,
                 stride: int = 1):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=padding)
        self.act_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.act_dtype
        if d == torch.float32:
            return super().forward(x)
        y = self._conv_forward(x.to(d), self.weight.to(d), None)
        return y + self.bias.to(d)[:, None, None]


class PointwiseConv(nn.Conv2d):
    """flax's 1x1 ``Conv`` with its ``dtype`` on NHWC features (B, H, W, C):
    a matmul over the channels with the ``nn.Conv2d`` weight (out, in, 1,
    1) and bias. In bf16 the product is rounded, then the bias added and
    rounded again, as ``Dense``."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, 1)
        self.act_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, d = self.weight[:, :, 0, 0], self.act_dtype
        if d == torch.float32:
            return F.linear(x, w, self.bias)
        return F.linear(x.to(d), w.to(d)) + self.bias.to(d)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with flax ``LayerNorm``'s ``dtype``: in bf16 the
    normalisation, the f32 scale and the f32 bias are applied to the upcast
    input and the result rounded once (``F.layer_norm`` on bf16 operands
    would round the scale and bias first)."""

    def __init__(self, features: int, eps: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=eps)
        self.act_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.act_dtype == torch.float32:
            return super().forward(x)
        return super().forward(x.float()).to(self.act_dtype)
