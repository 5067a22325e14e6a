"""LiDAR BEV pillar encoder: voxelize -> point MLP -> scatter-max -> convs.

Counterpart of the RL trunk's half of ``multimodal_sc_tpu/codec/lidar_bev.py``:
``voxelize``, ``PillarFeatureNet`` and ``BEVBackbone``. Static shapes: every
point gets a cell, masked or out-of-range points the trash cell ``H*W``.
The scatter is ``kernels/pillar_scatter.py`` (the CUDA kernel on the card);
the 3x3 SAME convs are plain ``F.conv2d``, as they are plain XLA convs in
the JAX package. The reconstruction codec (``LidarBEVCodec``, the targets)
waits for the c3 slice (ROADMAP item 13).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_sc_torch.kernels.pillar_scatter import scatter_max

_LN_EPS = 1e-6      # flax LayerNorm's epsilon (torch's default is 1e-5)


def voxelize(points: torch.Tensor, mask: torch.Tensor,
             bev_hw: Tuple[int, int], x_range: Tuple[float, float],
             y_range: Tuple[float, float]):
    """points (B,N,F>=3), mask (B,N) -> (aug_feats (B,N,F+3), cell_idx (B,N) int32).

    Augments each point with its offset from the pillar center and routes
    masked/out-of-range points to the trash cell ``H*W``.
    """
    h, w = bev_hw
    dx = (x_range[1] - x_range[0]) / h
    dy = (y_range[1] - y_range[0]) / w
    gx = torch.floor((points[..., 0] - x_range[0]) / dx).to(torch.int32)
    gy = torch.floor((points[..., 1] - y_range[0]) / dy).to(torch.int32)
    in_range = (gx >= 0) & (gx < h) & (gy >= 0) & (gy < w) & mask.bool()
    cell = torch.where(in_range, gx * w + gy,
                       torch.full_like(gx, h * w))
    cx = x_range[0] + (gx.to(points.dtype) + 0.5) * dx
    cy = y_range[0] + (gy.to(points.dtype) + 0.5) * dy
    offs = torch.stack([points[..., 0] - cx, points[..., 1] - cy], dim=-1)
    keep = in_range.unsqueeze(-1).to(points.dtype)
    aug = torch.cat([points, offs, keep], dim=-1) * keep
    return aug, cell


class PillarFeatureNet(nn.Module):
    """Shared per-point MLP, then max-scatter to the BEV grid (B, H, W, D)."""

    def __init__(self, point_features: int = 4, pillar_dim: int = 64,
                 bev_hw: Tuple[int, int] = (16, 16),
                 x_range: Tuple[float, float] = (0.0, 48.0),
                 y_range: Tuple[float, float] = (-12.0, 12.0)):
        super().__init__()
        self.pillar_dim, self.bev_hw = pillar_dim, tuple(bev_hw)
        self.x_range, self.y_range = tuple(x_range), tuple(y_range)
        self.fc1 = nn.Linear(point_features + 3, pillar_dim)
        self.ln = nn.LayerNorm(pillar_dim, eps=_LN_EPS)
        self.fc2 = nn.Linear(pillar_dim, pillar_dim)

    def forward(self, points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        aug, cell = voxelize(points, mask, self.bev_hw, self.x_range,
                             self.y_range)
        x = self.fc2(F.relu(self.ln(self.fc1(aug.float()))))
        h, w = self.bev_hw
        bev = scatter_max(x, cell, h * w)               # (B, H*W, D)
        return bev.reshape(-1, h, w, self.pillar_dim)


class BEVBackbone(nn.Module):
    """3x3 SAME conv + LayerNorm + ReLU blocks over the NHWC pillar grid."""

    def __init__(self, in_features: int, features: Tuple[int, ...] = (64, 128)):
        super().__init__()
        self.n = len(features)
        cin = in_features
        for i, f in enumerate(features):
            setattr(self, f"conv{i}", nn.Conv2d(cin, f, 3, padding=1))
            setattr(self, f"ln{i}", nn.LayerNorm(f, eps=_LN_EPS))
            cin = f

    def forward(self, bev: torch.Tensor) -> torch.Tensor:
        x = bev.float()
        for i in range(self.n):
            x = getattr(self, f"conv{i}")(x.permute(0, 3, 1, 2))
            x = F.relu(getattr(self, f"ln{i}")(x.permute(0, 2, 3, 1)))
        return x
