"""Semantic-communication perception trunk and the DQN head.

Counterpart of ``multimodal_sc_tpu/rl/perception.py`` for the analog/CNN
arch: per modality encode -> channel -> decode-to-tokens, then the fusion
transformer. The channel runs inside the forward, so gradients flow
through it into both codecs. Channel noise is drawn from an explicit
``torch.Generator`` or handed in (``channel_noise``), which is how the
tests feed the JAX package's draws. The digital (``vq``) and ViT arches
raise until ROADMAP items 13-14 port them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_sc_torch.channel import channel as channel_op
from multimodal_sc_torch.channel import channel_kwargs
from multimodal_sc_torch.codec.camera_cnn import CameraEncoderCNN, CameraTokensCNN
from multimodal_sc_torch.codec.lidar_bev import BEVBackbone, PillarFeatureNet
from multimodal_sc_torch.config.configs import ExperimentConfig
from multimodal_sc_torch.fusion.transformer import FusionTransformer


class SemanticPerception(nn.Module):
    """(image, points, mask) -> fused state vector, through noisy channels."""

    def __init__(self, cfg: ExperimentConfig):
        super().__init__()
        cam, lid, fus = cfg.camera, cfg.lidar, cfg.fusion
        if cam.arch != "cnn" or lid.arch != "analog":
            raise NotImplementedError(
                f"camera.arch={cam.arch!r} / lidar.arch={lid.arch!r}: only "
                "the analog CNN trunk is ported (ViT: ROADMAP item 13, "
                "digital VQ: item 14)")
        if cfg.train.bf16:
            raise NotImplementedError("train.bf16 activations are not ported")
        self.cfg = cfg
        cond = cam.snr_conditioning
        self.cam_enc = CameraEncoderCNN(cam.features, cam.c_sym,
                                        snr_conditioning=cond)
        self.cam_tok = CameraTokensCNN(fus.dim, cam.c_sym, cam.image_hw,
                                       snr_conditioning=cond)
        self.pfn = PillarFeatureNet(lid.point_features, lid.pillar_dim,
                                    lid.bev_hw, lid.x_range, lid.y_range)
        feats = (lid.pillar_dim, lid.pillar_dim)
        self.lid_backbone = BEVBackbone(lid.pillar_dim, feats)
        self.lid_sym_head = nn.Linear(lid.pillar_dim, 2 * lid.c_sym)
        self.lid_sym_embed = nn.Linear(2 * lid.c_sym, lid.pillar_dim)
        self.lid_dec = BEVBackbone(lid.pillar_dim, feats)
        if cfg.env.v2x_rays > 0:
            self.v2x_embed = nn.Parameter(
                0.02 * torch.randn(1, 1, lid.pillar_dim))
        self.fusion = FusionTransformer(
            cam_in=fus.dim, lid_in=lid.pillar_dim, dim=fus.dim,
            depth=fus.depth, heads=fus.heads, state_dim=fus.state_dim,
            mode=fus.mode,
            use_pallas=cfg.use_pallas or cfg.pallas_attention,
            fused_block=cfg.pallas_mha_block,
            block_kernel=cfg.mha_block_kernel)

    def _lidar_branch(self, pts, msk, snr_db, generator, noise):
        lid, ch = self.cfg.lidar, self.cfg.channel
        sym = self.lid_sym_head(self.lid_backbone(self.pfn(pts, msk)))
        b, h, w, _ = sym.shape
        z = sym.reshape(b, h * w * lid.c_sym, 2)
        z_hat = channel_op(z, snr_db, ch.kind, generator, noise=noise,
                           **channel_kwargs(ch))
        x = self.lid_sym_embed(z_hat.reshape(b, h, w, 2 * lid.c_sym))
        return self.lid_dec(x).reshape(b, h * w, lid.pillar_dim)

    def forward(self, image: torch.Tensor, points: torch.Tensor,
                mask: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                snr_db: Optional[torch.Tensor] = None,
                v2x_offset_db: Optional[float] = None,
                channel_noise: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        """``channel_noise`` (optional): the standard-normal draws of the
        links, ``(camera, ego LiDAR[, V2X])``, in place of draws from
        ``generator``."""
        ch = self.cfg.channel
        if snr_db is None:
            snr_db = torch.full((image.shape[0],), ch.snr_db,
                                dtype=torch.float32, device=image.device)
        if v2x_offset_db is None:
            v2x_offset_db = ch.v2x_snr_offset_db
        noise = (list(channel_noise) if channel_noise is not None
                 else [None, None, None])
        noise += [None] * (3 - len(noise))
        if self.cfg.rl.ablate_lidar:
            points = torch.zeros_like(points)
            mask = torch.zeros_like(mask)
        v2x = self.cfg.env.v2x_rays > 0
        if v2x:
            # Ego rays first, RSU rays after (envs/driving.py observe).
            r_ego = self.cfg.env.lidar_rays
            points, pts_v2x = points[:, :r_ego], points[:, r_ego:]
            mask, mask_v2x = mask[:, :r_ego], mask[:, r_ego:]
        snr_in = snr_db if self.cfg.camera.snr_conditioning else None

        z_cam = self.cam_enc(image, snr_in)
        z_cam_hat = channel_op(z_cam, snr_db, ch.kind, generator,
                               noise=noise[0], **channel_kwargs(ch))
        cam_tokens = self.cam_tok(z_cam_hat, snr_in)

        lid_tokens = self._lidar_branch(points, mask, snr_db, generator,
                                        noise[1])
        if v2x:
            v2x_tokens = self._lidar_branch(pts_v2x, mask_v2x,
                                            snr_db + v2x_offset_db,
                                            generator, noise[2])
            lid_tokens = torch.cat([lid_tokens, v2x_tokens + self.v2x_embed],
                                   dim=1)
        return self.fusion(cam_tokens, lid_tokens)


class QNetwork(nn.Module):
    """DQN head over the fused state."""

    def __init__(self, cfg: ExperimentConfig):
        super().__init__()
        self.perception = SemanticPerception(cfg)
        self.h1 = nn.Linear(cfg.fusion.state_dim, 256)
        self.h2 = nn.Linear(256, 256)
        self.q = nn.Linear(256, cfg.rl.num_actions)

    def forward(self, image, points, mask, generator=None, snr_db=None,
                v2x_offset_db=None, channel_noise=None) -> torch.Tensor:
        s = self.perception(image, points, mask, generator, snr_db,
                            v2x_offset_db, channel_noise)
        return self.q(F.relu(self.h2(F.relu(self.h1(s)))))
