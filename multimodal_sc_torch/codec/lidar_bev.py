"""LiDAR BEV pillar encoder and semantic-occupancy JSCC codec.

Counterpart of ``multimodal_sc_tpu/codec/lidar_bev.py``: ``voxelize``,
``PillarFeatureNet`` and ``BEVBackbone`` (voxelize -> point MLP ->
scatter-max -> convs), the ground-truth BEV targets, and ``LidarBEVCodec``
(point cloud -> channel symbols -> semantic BEV logits). Static shapes:
every point gets a cell, masked or out-of-range points the trash cell
``H*W``. The scatter is ``kernels/pillar_scatter.py`` (the CUDA kernel on
the card); the 3x3 SAME convs are plain ``F.conv2d``, as they are plain XLA
convs in the JAX package. The digital codec (``LidarBEVVQCodec``) is not
ported and raises (ROADMAP item 14b).
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def _cell_counts(cell: torch.Tensor, weight: torch.Tensor,
                 slots: int) -> torch.Tensor:
    """Per batch row, the sum of ``weight`` (B, N, ...) over the points of
    each cell: (B, slots, ...), the trash cell last."""
    out = torch.zeros((cell.shape[0], slots) + weight.shape[2:],
                      dtype=weight.dtype, device=cell.device)
    idx = cell.long().reshape(cell.shape + (1,) * (weight.dim() - 2))
    return out.scatter_add_(1, idx.expand_as(weight), weight)


def occupancy_target(points: torch.Tensor, mask: torch.Tensor,
                     bev_hw: Tuple[int, int], x_range: Tuple[float, float],
                     y_range: Tuple[float, float],
                     min_points: int = 1) -> torch.Tensor:
    """Ground-truth binary occupancy grid (B, H, W) float32 from a point cloud."""
    _, cell = voxelize(points, mask, bev_hw, x_range, y_range)
    h, w = bev_hw
    cnt = _cell_counts(cell, torch.ones_like(cell), h * w + 1)[:, :h * w]
    return (cnt >= min_points).float().reshape(-1, h, w)


def semantic_bev_target(points: torch.Tensor, mask: torch.Tensor,
                        classes: torch.Tensor, bev_hw: Tuple[int, int],
                        x_range: Tuple[float, float],
                        y_range: Tuple[float, float],
                        num_classes: int = 4) -> torch.Tensor:
    """Ground-truth semantic BEV grid (B, H, W) int32 from labeled points.

    Cell class = majority point class, ties going to the higher class id;
    0 = empty cell.
    """
    _, cell = voxelize(points, mask, bev_hw, x_range, y_range)
    h, w = bev_hw
    ids = torch.arange(1, num_classes, device=cell.device)
    onehot = (classes.unsqueeze(-1) == ids).to(torch.int32)     # (B, N, C-1)
    cnt = _cell_counts(cell, onehot, h * w + 1)[:, :h * w]      # (B, HW, C-1)
    # The highest class id among those that reach the top count: no
    # reliance on how argmax breaks a tie.
    top = cnt == cnt.max(dim=-1, keepdim=True).values
    best = (top * ids).max(dim=-1).values
    return torch.where(cnt.sum(-1) > 0, best, 0).to(torch.int32).reshape(
        -1, h, w)


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


class LidarBEVCodec(nn.Module):
    """Point cloud -> channel symbols; symbols -> semantic BEV logits.

    encode: (points (B,N,F), mask (B,N)) -> z (B, H*W*c_sym, 2)
    decode: z_hat -> BEV logits (B, H, W, C) where C = max(seg_classes, 1);
      seg_classes == 1 is the binary-occupancy mode (single logit + BCE),
      seg_classes > 1 the semantic mode (softmax classes incl. 0 = empty).
    tokens: intermediate BEV tokens (B, H*W, D) for the fusion transformer.
    """

    def __init__(self, pillar_dim: int = 64,
                 bev_hw: Tuple[int, int] = (16, 16), c_sym: int = 4,
                 seg_classes: int = 1,
                 x_range: Tuple[float, float] = (0.0, 48.0),
                 y_range: Tuple[float, float] = (-12.0, 12.0),
                 point_features: int = 4):
        super().__init__()
        self.pillar_dim, self.bev_hw, self.c_sym = pillar_dim, tuple(bev_hw), c_sym
        self.seg_classes = seg_classes
        self.pfn = PillarFeatureNet(point_features, pillar_dim, bev_hw,
                                    x_range, y_range)
        feats = (pillar_dim, pillar_dim)
        self.backbone = BEVBackbone(pillar_dim, feats)
        self.sym_head = nn.Linear(pillar_dim, 2 * c_sym)
        self.sym_embed = nn.Linear(2 * c_sym, pillar_dim)
        self.dec_backbone = BEVBackbone(pillar_dim, feats)
        self.occ_head = nn.Linear(pillar_dim, max(seg_classes, 1))

    def bev_features(self, points: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
        return self.backbone(self.pfn(points, mask))

    def encode(self, obs, snr_db: Optional[torch.Tensor] = None) -> torch.Tensor:
        points, mask = obs
        x = self.sym_head(self.bev_features(points, mask))   # (B, H, W, 2c)
        b, h, w, _ = x.shape
        return x.reshape(b, h * w * self.c_sym, 2)

    def _decoded(self, z_hat: torch.Tensor) -> torch.Tensor:
        h, w = self.bev_hw
        x = z_hat.float().reshape(z_hat.shape[0], h, w, 2 * self.c_sym)
        return self.dec_backbone(self.sym_embed(x))

    def decode(self, z_hat: torch.Tensor,
               snr_db: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.occ_head(self._decoded(z_hat))           # (B, H, W, C)

    def tokens(self, z_hat: torch.Tensor) -> torch.Tensor:
        """Decoded symbols -> BEV tokens for cross-modal fusion."""
        h, w = self.bev_hw
        return self._decoded(z_hat).reshape(-1, h * w, self.pillar_dim)

    def forward(self, obs, snr_db: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.decode(self.encode(obs, snr_db), snr_db)

    @property
    def k(self) -> int:
        return self.bev_hw[0] * self.bev_hw[1] * self.c_sym


class LidarBEVVQCodec(nn.Module):
    """The digital LiDAR codec (``lidar.arch="vq"``): not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "the digital LiDAR codec (lidar.arch='vq') is not ported yet "
            "(ROADMAP item 14b)")
