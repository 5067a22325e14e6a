"""Multi-head attention module of the ViT codec and the unfused fusion layer.

Counterpart of ``multimodal_sc_tpu/codec/camera_vit.py``: ``MHA`` only. The
ViT encoder/decoder classes of that file wait for the c3 slice (ROADMAP
item 13); asking for one raises.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from multimodal_sc_torch.kernels.attention import attention
from multimodal_sc_torch.kernels.attention_packed import (packed_attention,
                                                          packed_eligible)

_NOT_PORTED = ("TransformerBlock", "SNRToken", "ViTEncoderJSCC",
               "ViTDecoderJSCC", "ViTTokensDecoder", "ViTJSCC")


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"camera_vit.{name} is not ported yet (ROADMAP item 13)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class MHA(nn.Module):
    """q/k/v/o projections around softmax attention.

    The projections are ``nn.Linear(dim, dim)`` with the heads head-major in
    the output columns (flax ``DenseGeneral((heads, hd))`` flattened), so
    q, k and v come out in the packed (B, L, H*d) layout. With
    ``use_pallas`` and a ``packed_eligible`` shape the packed kernel runs
    on them as they are; otherwise heads are split out for ``attention``.
    """

    def __init__(self, dim: int, heads: int, use_pallas: bool = False):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} not divisible by heads {heads}")
        self.dim, self.heads, self.use_pallas = dim, heads, use_pallas
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.o = nn.Linear(dim, dim)

    def forward(self, x_q: torch.Tensor,
                x_kv: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x_kv is None:
            x_kv = x_q
        hd = self.dim // self.heads
        q, k, v = self.q(x_q), self.k(x_kv), self.v(x_kv)
        if self.use_pallas and packed_eligible(self.heads, hd, k.shape[1]):
            o = packed_attention(q, k, v, self.heads)
        else:
            b, lq, lk = q.shape[0], q.shape[1], k.shape[1]
            # (B, L, H*D) -> (B, H, L, D)
            qh = q.reshape(b, lq, self.heads, hd).transpose(1, 2)
            kh = k.reshape(b, lk, self.heads, hd).transpose(1, 2)
            vh = v.reshape(b, lk, self.heads, hd).transpose(1, 2)
            o = attention(qh, kh, vh, use_pallas=self.use_pallas)
            o = o.transpose(1, 2).reshape(b, lq, self.dim)
        return self.o(o)
