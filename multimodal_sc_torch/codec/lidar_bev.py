"""LiDAR BEV pillar encoder and semantic-occupancy JSCC codec.

Counterpart of ``multimodal_sc_tpu/codec/lidar_bev.py``: ``voxelize``,
``PillarFeatureNet`` and ``BEVBackbone`` (voxelize -> point MLP ->
scatter-max -> convs), the ground-truth BEV targets, and ``LidarBEVCodec``
(point cloud -> channel symbols -> semantic BEV logits). Static shapes:
every point gets a cell, masked or out-of-range points the trash cell
``H*W``. The scatter is ``kernels/pillar_scatter.py`` (the CUDA kernel on
the card); the 3x3 SAME convs are plain ``F.conv2d``, as they are plain XLA
convs in the JAX package. ``LidarBEVVQCodec`` is the digital codec
(``lidar.arch="vq"``): BEV features -> codebook indices -> the QPSK link of
``codec/semantic_vq.py`` -> semantic BEV logits, with that module's
quantiser, re-seeding stats, token pruning and selection rules.

Under ``train.bf16`` both codecs' modules take ``dtype=torch.bfloat16`` and
follow flax's dtype rules (``act_dtype``): the point MLP, the LayerNorms,
the convs and the heads in bf16 on f32 parameters, the scatter on bf16
features (its kernel reads and writes bf16; the JAX module widens them
first, which gives the same grid, and a tied max's gradient within one
bf16 step, see ``kernels/pillar_scatter.py``), the symbols, logits and
tokens out in f32. The digital codec's ``to_code`` rounds the code
features to bf16 and widens them to f32 for the nearest-code search; its
codebook, indices and VQ loss stay f32.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_sc_torch.act_dtype import (Conv, Dense, LayerNorm,
                                           PointwiseConv)
from multimodal_sc_torch.channel.digital import index_bits
from multimodal_sc_torch.codec import semantic_vq
from multimodal_sc_torch.kernels.pillar_scatter import scatter_max
from multimodal_sc_torch.nn_init import variance_scaling_uniform_

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
                 y_range: Tuple[float, float] = (-12.0, 12.0),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pillar_dim, self.bev_hw = pillar_dim, tuple(bev_hw)
        self.x_range, self.y_range = tuple(x_range), tuple(y_range)
        self.dtype = dtype
        self.fc1 = Dense(point_features + 3, pillar_dim, dtype)
        self.ln = LayerNorm(pillar_dim, _LN_EPS, dtype)
        self.fc2 = Dense(pillar_dim, pillar_dim, dtype)

    def forward(self, points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        aug, cell = voxelize(points, mask, self.bev_hw, self.x_range,
                             self.y_range)
        x = self.fc2(F.relu(self.ln(self.fc1(aug.to(self.dtype)))))
        h, w = self.bev_hw
        bev = scatter_max(x, cell, h * w)               # (B, H*W, D)
        return bev.reshape(-1, h, w, self.pillar_dim)


class BEVBackbone(nn.Module):
    """3x3 SAME conv + LayerNorm + ReLU blocks over the NHWC pillar grid."""

    def __init__(self, in_features: int, features: Tuple[int, ...] = (64, 128),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n, self.dtype = len(features), dtype
        cin = in_features
        for i, f in enumerate(features):
            setattr(self, f"conv{i}", Conv(cin, f, 3, padding=1, dtype=dtype))
            setattr(self, f"ln{i}", LayerNorm(f, _LN_EPS, dtype))
            cin = f

    def forward(self, bev: torch.Tensor) -> torch.Tensor:
        x = bev.to(self.dtype)
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
                 point_features: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pillar_dim, self.bev_hw, self.c_sym = pillar_dim, tuple(bev_hw), c_sym
        self.seg_classes, self.dtype = seg_classes, dtype
        self.pfn = PillarFeatureNet(point_features, pillar_dim, bev_hw,
                                    x_range, y_range, dtype)
        feats = (pillar_dim, pillar_dim)
        self.backbone = BEVBackbone(pillar_dim, feats, dtype)
        self.sym_head = Dense(pillar_dim, 2 * c_sym, dtype)
        self.sym_embed = Dense(2 * c_sym, pillar_dim, dtype)
        self.dec_backbone = BEVBackbone(pillar_dim, feats, dtype)
        self.occ_head = Dense(pillar_dim, max(seg_classes, 1), dtype)

    def bev_features(self, points: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
        return self.backbone(self.pfn(points, mask))

    def encode(self, obs, snr_db: Optional[torch.Tensor] = None) -> torch.Tensor:
        points, mask = obs
        x = self.sym_head(self.bev_features(points, mask))   # (B, H, W, 2c)
        b, h, w, _ = x.shape
        return x.reshape(b, h * w * self.c_sym, 2).float()

    def _decoded(self, z_hat: torch.Tensor) -> torch.Tensor:
        h, w = self.bev_hw
        x = z_hat.to(self.dtype).reshape(z_hat.shape[0], h, w,
                                             2 * self.c_sym)
        return self.dec_backbone(self.sym_embed(x))

    def decode(self, z_hat: torch.Tensor,
               snr_db: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.occ_head(self._decoded(z_hat)).float()   # (B, H, W, C)

    def tokens(self, z_hat: torch.Tensor) -> torch.Tensor:
        """Decoded symbols -> BEV tokens for cross-modal fusion."""
        h, w = self.bev_hw
        return self._decoded(z_hat).reshape(-1, h * w,
                                            self.pillar_dim).float()

    def forward(self, obs, snr_db: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.decode(self.encode(obs, snr_db), snr_db)

    @property
    def k(self) -> int:
        return self.bev_hw[0] * self.bev_hw[1] * self.c_sym


class LidarBEVVQCodec(nn.Module):
    """Digital LiDAR semantic codec (``lidar.arch="vq"``): BEV features ->
    codebook indices -> QPSK digital link -> semantic BEV logits.

    The camera VQ recipe on the BEV grid: the straight-through quantiser
    with codebook and commitment losses (``semantic_vq.vector_quantize``,
    its codebook rows through ``code_rows``), noise-aware decoding (the
    decoder sees the received codes, the gradient the clean path), the
    shared ``transmit_indices`` link (Hamming(7,4) hard or soft under
    ``channel_cfg.fec``), the dead-code re-seeding stats under
    ``vq_reseed``, and token pruning under ``vq_prune`` (a learned
    ``mask_embed`` for untransmitted tokens, drawn from normal(0.02)).
    Parameters: ``pfn``, ``backbone``, ``to_code`` (1x1), ``codebook``,
    ``from_code``, ``mask_embed``, ``dec_backbone``, ``occ_head``; a fresh
    layer is redrawn as flax's by its owner (``LateFusionJSCC``).
    ``channel_cfg``: the ``ChannelConfig`` of the link inside the
    forward. ``dtype``: the activation dtype (``act_dtype``); the logits
    come out f32."""

    def __init__(self, pillar_dim: int = 64,
                 bev_hw: Tuple[int, int] = (16, 16), vq_codes: int = 256,
                 vq_dim: int = 32, vq_beta: float = 0.25,
                 vq_usage_coef: float = 0.0, vq_usage_temp: float = 0.5,
                 vq_reseed: float = 0.0, vq_prune: bool = False,
                 seg_classes: int = 1,
                 x_range: Tuple[float, float] = (0.0, 48.0),
                 y_range: Tuple[float, float] = (-12.0, 12.0),
                 channel_cfg=None, point_features: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        n_bits = index_bits(vq_codes)                 # a power of 4
        if channel_cfg is not None and channel_cfg.fec != "none":
            total = bev_hw[0] * bev_hw[1] * n_bits
            if total % 8 != 0:
                raise ValueError(
                    "channel.fec needs n_tokens * bits_per_index divisible "
                    f"by 8, got {total}")
        self.pillar_dim, self.bev_hw = pillar_dim, tuple(bev_hw)
        self.vq_codes, self.vq_dim, self.vq_beta = vq_codes, vq_dim, vq_beta
        self.vq_usage_coef, self.vq_usage_temp = vq_usage_coef, vq_usage_temp
        self.vq_reseed, self.vq_prune = vq_reseed, vq_prune
        self.seg_classes, self.channel_cfg = seg_classes, channel_cfg
        self.dtype = dtype
        feats = (pillar_dim, pillar_dim)
        self.pfn = PillarFeatureNet(point_features, pillar_dim, bev_hw,
                                    x_range, y_range, dtype)
        self.backbone = BEVBackbone(pillar_dim, feats, dtype)
        self.to_code = PointwiseConv(pillar_dim, vq_dim, dtype)
        self.codebook = nn.Parameter(
            variance_scaling_uniform_(torch.empty(vq_codes, vq_dim)))
        self.from_code = Dense(vq_dim, pillar_dim, dtype)
        if vq_prune:
            self.mask_embed = nn.Parameter(
                torch.empty(vq_dim).normal_(0.0, 0.02))
        self.dec_backbone = BEVBackbone(pillar_dim, feats, dtype)
        self.occ_head = Dense(pillar_dim, max(seg_classes, 1), dtype)

    @property
    def n_tokens(self) -> int:
        return self.bev_hw[0] * self.bev_hw[1]

    def encode_features(self, points: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
        """Point cloud -> pre-quantisation code features (B, H, W, D), what
        ``seed_codebook`` samples; f32."""
        return self.to_code(self.backbone(self.pfn(points, mask))).float()

    def _quantize(self, points, mask):
        out = semantic_vq.vector_quantize(
            self.encode_features(points, mask), self.codebook, self.vq_beta,
            self.vq_usage_coef, self.vq_usage_temp,
            with_stats=self.vq_reseed > 0)
        z_ste, idx, vq_loss = out[:3]
        b = idx.shape[0]
        return (idx.reshape(b, -1), vq_loss, z_ste.reshape(b, -1, self.vq_dim),
                out[3] if len(out) > 3 else None)

    def encode_tokens(self, points: torch.Tensor, mask: torch.Tensor):
        """-> ``(indices (B, N) int32, vq_loss, z_ste (B, N, D))``."""
        return self._quantize(points, mask)[:3]

    def codes_to_logits(self, z: torch.Tensor) -> torch.Tensor:
        """(B, N, D) code vectors -> BEV logits (B, H, W, C), f32."""
        h, w = self.bev_hw
        x = z.reshape(z.shape[0], h, w, self.vq_dim).to(self.dtype)
        return self.occ_head(self.dec_backbone(self.from_code(x))).float()

    def decode_tokens(self, idx: torch.Tensor) -> torch.Tensor:
        """(B, N) received indices -> logits (the receiver alone)."""
        return self.codes_to_logits(self.codebook[idx.long()])

    def token_drop_damage(self, idx_tx: torch.Tensor,
                          probes: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None,
                          ch=None) -> torch.Tensor:
        """(B, N) expected squared BEV-logit damage of not sending a token:
        ``semantic_vq.drop_damage`` through the BEV decoder, with
        ``ch.uep_probes`` probes of shape (B, H, W, C) (2 without a channel
        config), given or drawn from ``generator``. Needs ``vq_prune``."""
        ch = self.channel_cfg if ch is None else ch
        if probes is None:
            h, w = self.bev_hw
            probes = torch.randn(
                (ch.uep_probes if ch is not None else 2, idx_tx.shape[0], h,
                 w, max(self.seg_classes, 1)), generator=generator,
                device=self.codebook.device)
        return semantic_vq.drop_damage(self.codes_to_logits, self.codebook,
                                       self.mask_embed, idx_tx, probes)

    def forward(self, points: torch.Tensor, mask: torch.Tensor, snr_db,
                generator: Optional[torch.Generator] = None, noise=None,
                ch=None, keep: Optional[torch.Tensor] = None,
                select: Optional[str] = None,
                select_draws: Optional[torch.Tensor] = None,
                side_generator: Optional[torch.Generator] = None):
        """``(logits, aux)`` through the whole digital link at ``snr_db``
        over ``ch`` (by default ``channel_cfg``). aux: ``vq_loss``,
        ``index_error_rate`` (sent tokens only), ``code_perplexity``, with
        ``vq_reseed > 0`` ``vq_counts`` and ``vq_candidates``, under
        pruning ``token_keep_frac``.

        ``keep``: (B,) kept-token fractions (``vq_prune`` models; ``None``
        falls back to ``ch.token_keep`` when below 1), ranked by ``select``
        (default ``ch.token_select``): ``scatter``, ``random``,
        ``drop_damage`` or ``drop_damage_scatter``. Draws (else from
        ``generator``, in this order): ``select_draws`` (the ``random``
        scores or the damage probes; from ``side_generator`` when given),
        ``noise`` (the channel's)."""
        ch = self.channel_cfg if ch is None else ch
        idx_tx, vq_loss, z_ste, stats = self._quantize(points, mask)
        b = idx_tx.shape[0]
        if keep is None and self.vq_prune and ch is not None \
                and ch.token_keep < 1.0:
            keep = torch.full((b,), ch.token_keep, dtype=torch.float32,
                              device=idx_tx.device)
        if keep is not None and not self.vq_prune:
            raise ValueError("keep requires lidar.vq_prune=true")
        kept = None
        if keep is not None:
            side = generator if side_generator is None else side_generator
            if select is None:
                select = ch.token_select if ch is not None else "scatter"
            if select not in ("drop_damage", "scatter", "drop_damage_scatter",
                              "random"):
                raise ValueError(f"unsupported BEV token_select {select!r}")
            kept = semantic_vq.kept_tokens(
                select, idx_tx, keep, self.bev_hw,
                {"drop_damage": functools.partial(
                    self.token_drop_damage, generator=side, ch=ch)},
                select_draws, side)
        idx_rx = semantic_vq.transmit_indices(
            ch, idx_tx, self.vq_codes, snr_db, generator,
            token_weights=None if kept is None else kept.to(torch.float32),
            noise=noise)
        err = (idx_rx != idx_tx).float()
        z_rx = z_ste + (self.codebook[idx_rx.long()] - z_ste).detach()
        if kept is not None:
            z_rx = torch.where(kept[..., None], z_rx,
                               self.mask_embed.expand_as(z_rx))
            kf = kept.to(torch.float32)
            idx_err = (err * kf).sum() / kf.sum().clamp(min=1.0)
        else:
            idx_err = err.mean()
        logits = self.codes_to_logits(z_rx)
        p = torch.bincount(idx_tx.reshape(-1).long(),
                           minlength=self.vq_codes).float() / idx_tx.numel()
        aux = {"vq_loss": vq_loss, "index_error_rate": idx_err,
               "code_perplexity": torch.exp(-(p * torch.log(p + 1e-10)).sum())}
        if kept is not None:
            aux["token_keep_frac"] = kept.to(torch.float32).mean()
        if stats is not None:
            aux["vq_counts"] = stats["counts"]
            aux["vq_candidates"] = stats["candidates"]
        return logits, aux
