"""Cross-modal fusion transformer: (camera tokens, LiDAR tokens) -> state.

Counterpart of ``multimodal_sc_tpu/fusion/transformer.py``: the fused-block
form (``FusedMHABlock`` layers, the c4/c5 default) and the unfused form
(LayerNorms around ``camera_vit.MHA``, whose attention is the packed
kernel under ``use_pallas``) in ``cross_attention`` mode, and
``late_concat``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_sc_torch.codec.camera_vit import MHA
from multimodal_sc_torch.kernels.mha_block import (kernel_eligible, mha_block,
                                                   mha_block_reference)

_LN_EPS = 1e-6      # flax LayerNorm's epsilon (torch's default is 1e-5)


class FusedMHABlock(nn.Module):
    """The whole ``x_q + OutProj(Attn(LN(x_q), LN(x_kv)))`` span as one op.

    Params in the kernel's packed layout (wq/wk/wv/wo (dim, dim) ``(in,
    out)``), named as in the flax module. ``self_attn=True`` shares one
    LayerNorm between the q and kv streams. With ``use_kernel`` and an
    eligible shape it calls ``mha_block`` (the CUDA kernel on the card);
    otherwise the plain version, as the JAX module does. Eligible is the
    JAX rule narrowed to the head dims the kernel is built for (8-64).
    """

    def __init__(self, dim: int, heads: int, self_attn: bool = False,
                 use_kernel: bool = True):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.self_attn, self.use_kernel = self_attn, use_kernel
        self.ln_q_scale = nn.Parameter(torch.ones(dim))
        self.ln_q_bias = nn.Parameter(torch.zeros(dim))
        if not self_attn:
            self.ln_kv_scale = nn.Parameter(torch.ones(dim))
            self.ln_kv_bias = nn.Parameter(torch.zeros(dim))
        for name in ("q", "k", "v", "o"):
            setattr(self, f"w{name}", nn.Parameter(
                torch.randn(dim, dim) / math.sqrt(dim)))
            setattr(self, f"b{name}", nn.Parameter(torch.zeros(dim)))

    def packed_params(self):
        p = {k: getattr(self, k) for k in (
            "ln_q_scale", "ln_q_bias", "wq", "bq", "wk", "bk", "wv", "bv",
            "wo", "bo")}
        if self.self_attn:
            p["ln_kv_scale"], p["ln_kv_bias"] = p["ln_q_scale"], p["ln_q_bias"]
        else:
            p["ln_kv_scale"], p["ln_kv_bias"] = self.ln_kv_scale, self.ln_kv_bias
        return p

    def forward(self, x_q: torch.Tensor,
                x_kv: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x_kv is None:
            x_kv = x_q
        p = self.packed_params()
        if self.use_kernel and kernel_eligible(self.heads, self.dim,
                                               x_kv.shape[1]):
            return mha_block(x_q, x_kv, p, self.heads)
        return mha_block_reference(x_q, x_kv, p, self.heads)


class FusionLayer(nn.Module):
    """Bidirectional cross-attention + per-modality self-attention + MLP.

    ``fused_block`` picks the parameter tree: ``FusedMHABlock``s (each LN +
    q/k/v + attention + out-proj + residual span one op), or LayerNorms
    around ``MHA`` modules with the residual outside. ``use_pallas`` reaches
    only the unfused ``MHA``s; ``block_kernel`` only the fused blocks.
    """

    def __init__(self, dim: int, heads: int, use_pallas: bool = False,
                 fused_block: bool = True, block_kernel: bool = True):
        super().__init__()
        self.fused_block = fused_block
        if fused_block:
            self.cam2lid_f = FusedMHABlock(dim, heads, use_kernel=block_kernel)
            self.lid2cam_f = FusedMHABlock(dim, heads, use_kernel=block_kernel)
        else:
            self.cam2lid = MHA(dim, heads, use_pallas)
            self.lid2cam = MHA(dim, heads, use_pallas)
            for name in ("c1", "l1", "l2", "c2"):
                setattr(self, f"ln_{name}", nn.LayerNorm(dim, eps=_LN_EPS))
        for name in ("cam", "lid"):
            if fused_block:
                setattr(self, f"{name}_self_f", FusedMHABlock(
                    dim, heads, self_attn=True, use_kernel=block_kernel))
            else:
                setattr(self, f"ln_{name}_sa", nn.LayerNorm(dim, eps=_LN_EPS))
                setattr(self, f"{name}_self", MHA(dim, heads, use_pallas))
            setattr(self, f"ln_{name}_mlp", nn.LayerNorm(dim, eps=_LN_EPS))
            setattr(self, f"{name}_mlp1", nn.Linear(dim, 4 * dim))
            setattr(self, f"{name}_mlp2", nn.Linear(4 * dim, dim))

    def _self_mlp(self, name: str, x: torch.Tensor) -> torch.Tensor:
        if self.fused_block:
            x = getattr(self, f"{name}_self_f")(x)
        else:
            x = x + getattr(self, f"{name}_self")(
                getattr(self, f"ln_{name}_sa")(x))
        h = getattr(self, f"ln_{name}_mlp")(x)
        # flax nn.gelu is the tanh approximation.
        h = F.gelu(getattr(self, f"{name}_mlp1")(h), approximate="tanh")
        return x + getattr(self, f"{name}_mlp2")(h)

    def forward(self, cam: torch.Tensor, lid: torch.Tensor):
        # The second cross direction reads the UPDATED camera stream.
        if self.fused_block:
            cam = self.cam2lid_f(cam, lid)
            lid = self.lid2cam_f(lid, cam)
        else:
            cam = cam + self.cam2lid(self.ln_c1(cam), self.ln_l1(lid))
            lid = lid + self.lid2cam(self.ln_l2(lid), self.ln_c2(cam))
        return self._self_mlp("cam", cam), self._self_mlp("lid", lid)


class FusionTransformer(nn.Module):
    """Fuse camera + LiDAR token streams into one state embedding.

    mode="cross_attention": fusion layers + CLS pooling.
    mode="late_concat": mean-pool each modality, concat, MLP.
    """

    def __init__(self, cam_in: int, lid_in: int, dim: int = 128,
                 depth: int = 2, heads: int = 4, state_dim: int = 128,
                 mode: str = "cross_attention", use_pallas: bool = False,
                 fused_block: bool = True, block_kernel: bool = True):
        super().__init__()
        if mode not in ("cross_attention", "late_concat"):
            raise ValueError(f"unknown fusion mode {mode!r}")
        self.mode, self.depth, self.dim = mode, depth, dim
        self.cam_proj = nn.Linear(cam_in, dim)
        self.lid_proj = nn.Linear(lid_in, dim)
        if mode == "late_concat":
            self.fc1 = nn.Linear(2 * dim, 2 * state_dim)
            self.fc2 = nn.Linear(2 * state_dim, state_dim)
            return
        self.mod_cam = nn.Parameter(0.02 * torch.randn(1, 1, dim))
        self.mod_lid = nn.Parameter(0.02 * torch.randn(1, 1, dim))
        self.cls = nn.Parameter(0.02 * torch.randn(1, 1, dim))
        for i in range(depth):
            setattr(self, f"layer{i}", FusionLayer(
                dim, heads, use_pallas=use_pallas, fused_block=fused_block,
                block_kernel=block_kernel))
        self.ln_out = nn.LayerNorm(dim, eps=_LN_EPS)
        self.state_head = nn.Linear(dim, state_dim)

    def forward(self, cam_tokens: torch.Tensor,
                lid_tokens: torch.Tensor) -> torch.Tensor:
        cam = self.cam_proj(cam_tokens.float())
        lid = self.lid_proj(lid_tokens.float())
        if self.mode == "late_concat":
            pooled = torch.cat([cam.mean(1), lid.mean(1)], dim=-1)
            return self.fc2(F.gelu(self.fc1(pooled), approximate="tanh"))
        b = cam.shape[0]
        cam = torch.cat([self.cls.expand(b, 1, self.dim), cam + self.mod_cam],
                        dim=1)
        lid = lid + self.mod_lid
        for i in range(self.depth):
            cam, lid = getattr(self, f"layer{i}")(cam, lid)
        return self.state_head(self.ln_out(cam[:, 0]))
