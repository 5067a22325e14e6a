"""Semantic-communication perception trunk, the DQN head and the PPO heads.

Counterpart of ``multimodal_sc_tpu/rl/perception.py``: per modality encode
-> channel -> decode-to-tokens, then the fusion transformer. The camera
branch is the CNN codec (``camera.arch="cnn"``), the ViT encoder with a ViT
token decoder of half its depth (``camera.arch="vit"``, unconditioned on
the SNR, its attention on the packed or flash kernels under ``use_pallas``
or ``pallas_attention``), or the digital VQ link (``camera.arch="vq"``: the
VQ encoder's indices over QPSK, Hamming-coded under ``channel.fec`` or under
Type-I HARQ with ``channel.harq``, the received codes through a 5x5 conv to
tokens, the gradient through the clean straight-through path). The analog
channels run inside the forward, so gradients flow through them into both
codecs. Channel noise is drawn from an explicit ``torch.Generator`` or
handed in (``channel_noise``), which is how the tests feed the JAX
package's draws.

What the JAX trunk sows (the VQ loss, the index error rate, the HARQ
accounting, the dead-code re-seeding inputs) the port's forward writes
into the dict passed as ``aux``; the learners add the VQ loss to theirs and
re-seed dead codes after their step (:func:`collect_reseed_stats`,
:func:`apply_codebook_reseed`). Not ported, raising: the digital LiDAR
link (``lidar.arch="vq"``, ROADMAP item 14c) and ``train.bf16``
activations (item 13b).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_sc_torch.channel import channel as channel_op
from multimodal_sc_torch.channel import channel_kwargs
from multimodal_sc_torch.codec.camera_cnn import CameraEncoderCNN, CameraTokensCNN
from multimodal_sc_torch.codec.camera_vit import ViTEncoderJSCC, ViTTokensDecoder
from multimodal_sc_torch.codec.lidar_bev import BEVBackbone, PillarFeatureNet
from multimodal_sc_torch.codec.semantic_vq import (VQEncoderTokens,
                                                   VQTokensCamera,
                                                   check_digital_camera,
                                                   reseed_dead_codes,
                                                   transmit_indices,
                                                   transmit_indices_harq)
from multimodal_sc_torch.config.configs import ExperimentConfig
from multimodal_sc_torch.fusion.transformer import FusionTransformer
from multimodal_sc_torch.nn_init import init_like_flax_


class SemanticPerception(nn.Module):
    """(image, points, mask) -> fused state vector, through noisy channels."""

    def __init__(self, cfg: ExperimentConfig):
        super().__init__()
        cam, lid, fus = cfg.camera, cfg.lidar, cfg.fusion
        if lid.arch != "analog":
            raise NotImplementedError(
                f"lidar.arch={lid.arch!r}: the digital LiDAR link is not "
                "ported yet (ROADMAP item 14c)")
        if cam.arch not in ("cnn", "vit", "vq"):
            raise ValueError(f"unknown camera arch {cam.arch!r}")
        if cfg.train.bf16:
            raise NotImplementedError(
                "train.bf16 activations are not ported (ROADMAP item 13b)")
        self.cfg = cfg
        attn_pallas = cfg.use_pallas or cfg.pallas_attention
        if cam.arch == "vit":
            self.cam_enc = ViTEncoderJSCC(
                cam.image_hw, cam.patch, cam.dim, cam.depth, cam.heads,
                cam.c_sym, snr_conditioning=False, use_pallas=attn_pallas)
            self.cam_tok = ViTTokensDecoder(
                cam.image_hw, cam.patch, cam.dim, max(1, cam.depth // 2),
                cam.heads, cam.c_sym, use_pallas=attn_pallas)
            cam_in = cam.dim
        elif cam.arch == "vq":
            check_digital_camera(cfg)
            self.cam_vq = VQEncoderTokens(
                cam.features, cam.vq_dim, cam.vq_codes, cam.vq_beta,
                cam.vq_usage_coef, cam.vq_usage_temp, cam.vq_reseed)
            self.cam_tok = VQTokensCamera(fus.dim, cam.vq_dim, cam.image_hw)
            cam_in = fus.dim
        else:
            cond = cam.snr_conditioning
            self.cam_enc = CameraEncoderCNN(cam.features, cam.c_sym,
                                            snr_conditioning=cond)
            self.cam_tok = CameraTokensCNN(fus.dim, cam.c_sym, cam.image_hw,
                                           snr_conditioning=cond)
            cam_in = fus.dim
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
            cam_in=cam_in, lid_in=lid.pillar_dim, dim=fus.dim,
            depth=fus.depth, heads=fus.heads, state_dim=fus.state_dim,
            mode=fus.mode, use_pallas=attn_pallas,
            fused_block=cfg.pallas_mha_block,
            block_kernel=cfg.mha_block_kernel)

    def _vq_camera(self, image, snr_db, generator, noise, aux):
        """The digital camera link: indices over QPSK (FEC or HARQ as
        configured); the token decoder sees the received codes, the
        gradient the clean straight-through path."""
        ch, codes = self.cfg.channel, self.cfg.camera.vq_codes
        idx_tx, vq_loss, z_ste, stats = self.cam_vq(image)
        hinfo = None
        if ch.harq:
            idx_rx, hinfo = transmit_indices_harq(ch, idx_tx, codes, snr_db,
                                                  generator, draws=noise)
        else:
            idx_rx = transmit_indices(ch, idx_tx, codes, snr_db, generator,
                                      noise=noise)
        z_rx = z_ste + (self.cam_vq.codebook[idx_rx.long()] - z_ste).detach()
        if aux is not None:
            aux["vq_loss"] = vq_loss
            aux["index_error_rate"] = (idx_rx != idx_tx).float().mean()
            if hinfo is not None:
                aux["harq_syms"] = hinfo["symbols_per_item"]
                aux["harq_rounds"] = hinfo["mean_rounds"]
                aux["harq_resid"] = hinfo["residual_fail_rate"]
            if stats is not None:
                aux["vq_counts"] = stats["counts"]
                aux["vq_candidates"] = stats["candidates"]
        return self.cam_tok(z_rx)

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
                channel_noise: Optional[Sequence[torch.Tensor]] = None,
                aux: Optional[dict] = None) -> torch.Tensor:
        """``channel_noise`` (optional): the standard-normal draws of the
        links, ``(camera, ego LiDAR[, V2X])``, in place of draws from
        ``generator``; under ``channel.harq`` the camera's entry is one draw
        per round. ``aux`` (optional dict): receives what the JAX trunk
        sows, the VQ camera's ``vq_loss`` and ``index_error_rate``, its
        HARQ accounting (``harq_syms``, ``harq_rounds``, ``harq_resid``)
        and, under ``camera.vq_reseed``, ``vq_counts`` and
        ``vq_candidates``."""
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
        # The ViT camera branch is built unconditioned, as in the JAX
        # package; the CNN one FiLMs on the SNR under snr_conditioning.
        cam = self.cfg.camera
        snr_in = (snr_db if cam.snr_conditioning and cam.arch == "cnn"
                  else None)

        if cam.arch == "vq":
            cam_tokens = self._vq_camera(image, snr_db, generator, noise[0],
                                         aux)
        else:
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


def collect_reseed_stats(cfg: ExperimentConfig, aux: dict) -> dict:
    """The dead-code re-seeding inputs of a trunk forward's ``aux``:
    ``{"cam": (counts, candidates)}`` when the VQ camera re-seeds
    (``camera.vq_reseed > 0``), else ``{}``."""
    if cfg.camera.arch == "vq" and cfg.camera.vq_reseed > 0:
        return {"cam": (aux["vq_counts"], aux["vq_candidates"])}
    return {}


@torch.no_grad()
def apply_codebook_reseed(cfg: ExperimentConfig, net: nn.Module, rs: dict,
                          generator: Optional[torch.Generator] = None,
                          coin: Optional[torch.Tensor] = None) -> None:
    """Re-seed the batch-dead codes of ``net``'s camera codebook in place
    (``rs`` from :func:`collect_reseed_stats`), each with probability
    ``camera.vq_reseed``; the learners call it after their optimizer step
    and leave the target and EMA networks alone, as the JAX package does.
    ``coin``: the (K,) uniform draws, in place of draws from
    ``generator``."""
    if "cam" not in rs:
        return
    counts, cands = rs["cam"]
    cb = net.perception.cam_vq.codebook
    cb.copy_(reseed_dead_codes(cb, counts, cands, generator,
                               cfg.camera.vq_reseed, coin=coin)[0])


class QNetwork(nn.Module):
    """DQN head over the fused state. Fresh weights are drawn as flax's."""

    def __init__(self, cfg: ExperimentConfig):
        super().__init__()
        self.perception = SemanticPerception(cfg)
        self.h1 = nn.Linear(cfg.fusion.state_dim, 256)
        self.h2 = nn.Linear(256, 256)
        self.q = nn.Linear(256, cfg.rl.num_actions)
        init_like_flax_(self)

    def forward(self, image, points, mask, generator=None, snr_db=None,
                v2x_offset_db=None, channel_noise=None,
                aux=None) -> torch.Tensor:
        s = self.perception(image, points, mask, generator, snr_db,
                            v2x_offset_db, channel_noise, aux)
        return self.q(F.relu(self.h2(F.relu(self.h1(s)))))


class ActorCritic(nn.Module):
    """PPO policy and value heads over the fused state: ``(logits (B, A),
    value (B,))``. Fresh weights are drawn as flax's."""

    def __init__(self, cfg: ExperimentConfig):
        super().__init__()
        self.perception = SemanticPerception(cfg)
        self.pi_h = nn.Linear(cfg.fusion.state_dim, 256)
        self.pi = nn.Linear(256, cfg.rl.num_actions)
        self.v_h = nn.Linear(cfg.fusion.state_dim, 256)
        self.v = nn.Linear(256, 1)
        init_like_flax_(self)

    def forward(self, image, points, mask, generator=None, snr_db=None,
                v2x_offset_db=None, channel_noise=None, aux=None):
        s = self.perception(image, points, mask, generator, snr_db,
                            v2x_offset_db, channel_noise, aux)
        logits = self.pi(torch.tanh(self.pi_h(s)))
        return logits, self.v(torch.tanh(self.v_h(s)))[..., 0]
