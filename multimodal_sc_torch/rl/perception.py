"""Semantic-communication perception trunk, the DQN head and the PPO heads.

Counterpart of ``multimodal_sc_tpu/rl/perception.py``: per modality encode
-> channel -> decode-to-tokens, then the fusion transformer. The camera
branch is the CNN codec (``camera.arch="cnn"``), the ViT encoder with a ViT
token decoder of half its depth (``camera.arch="vit"``, unconditioned on
the SNR, its attention on the packed or flash kernels under ``use_pallas``
or ``pallas_attention``), or the digital VQ link (``camera.arch="vq"``: the
VQ encoder's indices over QPSK, Hamming-coded under ``channel.fec`` or under
Type-I HARQ with ``channel.harq``, the received codes through a 5x5 conv to
tokens, the gradient through the clean straight-through path). The LiDAR
branch is the analog BEV codec (``lidar.arch="analog"``) or its digital
link (``lidar.arch="vq"``: the BEV features through a 1x1 ``lid_to_code``,
quantised against ``lid_codebook``, the indices over the same QPSK link,
the received codes through ``lid_from_code`` into the BEV decoder; under
``lidar.vq_prune`` only a kept set of tokens is sent and the rest decode as
``lid_mask_embed``). With V2X the roadside unit's rays ride the same LiDAR
codec over a link of their own at the SNR offset. The analog channels run
inside the forward, so gradients flow through them into both codecs.
Channel noise is drawn from an explicit ``torch.Generator`` or handed in
(``channel_noise``, a :class:`LinkDraws`), which is how the tests feed the
JAX package's draws.

What the JAX trunk sows, one entry per digital link call (camera, ego
LiDAR, V2X), the port's forward reduces as the JAX consumers do and writes
into the dict passed as ``aux``; the learners add the VQ loss to theirs and
re-seed dead codes after their step (:func:`collect_reseed_stats`,
:func:`apply_codebook_reseed`). A data-parallel learner hands the forward
its mesh (``data_mesh``): the digital links' usage losses, usage counts and
re-seeding candidates are then the global batch's
(``codec/semantic_vq.py``).

Under ``train.bf16`` the codecs and the fusion trunk compute in bf16 on f32
parameters (``act_dtype``), as the JAX trunk takes its dtype from the
config; the channel symbols, the tokens and the state stay f32, and so do
the DQN and PPO heads. On a digital link the code features are rounded to
bf16 by the 1x1 ``to_code`` and widened to f32 for the nearest-code
search; the codebooks, the indices, the VQ losses and ``lid_mask_embed``
stay f32, and the received codes are cast to the BEV dtype for
``lid_from_code``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_sc_torch.act_dtype import (Dense, PointwiseConv,
                                           activation_dtype)
from multimodal_sc_torch.channel import channel as channel_op
from multimodal_sc_torch.channel import channel_kwargs
from multimodal_sc_torch.channel.layer import draw
from multimodal_sc_torch.codec.camera_cnn import CameraEncoderCNN, CameraTokensCNN
from multimodal_sc_torch.codec.camera_vit import ViTEncoderJSCC, ViTTokensDecoder
from multimodal_sc_torch.codec.lidar_bev import BEVBackbone, PillarFeatureNet
from multimodal_sc_torch.channel.digital import index_bits
from multimodal_sc_torch.codec import semantic_vq
from multimodal_sc_torch.codec.semantic_vq import (VQEncoderTokens,
                                                   VQTokensCamera,
                                                   _farthest_point_rank_on,
                                                   check_digital_camera,
                                                   reseed_dead_codes,
                                                   topk_mask,
                                                   transmit_indices,
                                                   transmit_indices_harq)
from multimodal_sc_torch.config.configs import ExperimentConfig
from multimodal_sc_torch.fusion.transformer import FusionTransformer
from multimodal_sc_torch.nn_init import (init_like_flax_,
                                         variance_scaling_uniform_)


class LinkDraws(NamedTuple):
    """The draws of one trunk forward, each in place of a draw from its
    generator (a ``None`` field is drawn there, in this order). A link's
    entry is its channel's standard normals, under ``channel.harq`` a list
    of one draw per round. A plain tuple ``(camera, lidar[, v2x])`` reads
    as the first fields."""
    camera: Any = None              # the camera link
    lidar: Any = None               # the ego LiDAR link
    v2x: Any = None                 # the roadside unit's link (env.v2x_rays)
    # lidar.vq_prune with random selection: the (B, N) uniform scores of
    # the ego and the V2X LiDAR calls.
    lidar_scores: Optional[torch.Tensor] = None
    v2x_scores: Optional[torch.Tensor] = None


def _reduce_sown(sown: Dict[str, List[torch.Tensor]], aux: dict) -> None:
    """What the JAX consumers make of the sown entries, one per digital link
    call (camera, ego LiDAR, V2X): the VQ losses and the HARQ symbols
    summed, the HARQ rounds and residual failures averaged over the links,
    the LiDAR codebook's usage counts summed over ego and V2X with the ego
    call's candidates; the camera's own entries as they are."""
    for name in ("vq_loss", "harq_syms"):
        if name in sown:
            aux[name] = sum(sown.pop(name))
    for name in ("harq_rounds", "harq_resid"):
        if name in sown:
            vals = sown.pop(name)
            aux[name] = sum(vals) / len(vals)
    if "lid_vq_counts" in sown:
        aux["lid_vq_counts"] = sum(sown.pop("lid_vq_counts"))
        aux["lid_vq_candidates"] = sown.pop("lid_vq_candidates")[0]
    aux.update({k: v[0] for k, v in sown.items()})


class SemanticPerception(nn.Module):
    """(image, points, mask) -> fused state vector, through noisy channels."""

    def __init__(self, cfg: ExperimentConfig):
        super().__init__()
        cam, lid, fus = cfg.camera, cfg.lidar, cfg.fusion
        if lid.arch not in ("analog", "vq"):
            raise ValueError(f"unknown lidar arch {lid.arch!r}")
        if cam.arch not in ("cnn", "vit", "vq"):
            raise ValueError(f"unknown camera arch {cam.arch!r}")
        dtype = activation_dtype(cfg)
        self.cfg = cfg
        attn_pallas = cfg.use_pallas or cfg.pallas_attention
        if cam.arch == "vit":
            self.cam_enc = ViTEncoderJSCC(
                cam.image_hw, cam.patch, cam.dim, cam.depth, cam.heads,
                cam.c_sym, snr_conditioning=False, use_pallas=attn_pallas,
                dtype=dtype)
            self.cam_tok = ViTTokensDecoder(
                cam.image_hw, cam.patch, cam.dim, max(1, cam.depth // 2),
                cam.heads, cam.c_sym, use_pallas=attn_pallas, dtype=dtype)
            cam_in = cam.dim
        elif cam.arch == "vq":
            check_digital_camera(cfg)
            self.cam_vq = VQEncoderTokens(
                cam.features, cam.vq_dim, cam.vq_codes, cam.vq_beta,
                cam.vq_usage_coef, cam.vq_usage_temp, cam.vq_reseed,
                dtype=dtype)
            self.cam_tok = VQTokensCamera(fus.dim, cam.vq_dim, cam.image_hw,
                                          dtype)
            cam_in = fus.dim
        else:
            cond = cam.snr_conditioning
            self.cam_enc = CameraEncoderCNN(cam.features, cam.c_sym,
                                            snr_conditioning=cond,
                                            dtype=dtype)
            self.cam_tok = CameraTokensCNN(fus.dim, cam.c_sym, cam.image_hw,
                                           snr_conditioning=cond,
                                           dtype=dtype)
            cam_in = fus.dim
        self.pfn = PillarFeatureNet(lid.point_features, lid.pillar_dim,
                                    lid.bev_hw, lid.x_range, lid.y_range,
                                    dtype)
        feats = (lid.pillar_dim, lid.pillar_dim)
        self.lid_backbone = BEVBackbone(lid.pillar_dim, feats, dtype)
        if lid.arch == "vq":
            # Names mirror LidarBEVVQCodec's (to_code, codebook, from_code,
            # mask_embed), so a c3_vq checkpoint warm-starts them by name.
            index_bits(lid.vq_codes)             # codes must be a power of 4
            self.lid_to_code = PointwiseConv(lid.pillar_dim, lid.vq_dim,
                                             dtype)
            self.lid_codebook = nn.Parameter(variance_scaling_uniform_(
                torch.empty(lid.vq_codes, lid.vq_dim)))
            self.lid_from_code = Dense(lid.vq_dim, lid.pillar_dim, dtype)
            if lid.vq_prune:
                self.lid_mask_embed = nn.Parameter(
                    torch.empty(lid.vq_dim).normal_(0.0, 0.02))
        else:
            self.lid_sym_head = Dense(lid.pillar_dim, 2 * lid.c_sym, dtype)
            self.lid_sym_embed = Dense(2 * lid.c_sym, lid.pillar_dim, dtype)
        self.lid_dec = BEVBackbone(lid.pillar_dim, feats, dtype)
        if cfg.env.v2x_rays > 0:
            self.v2x_embed = nn.Parameter(
                0.02 * torch.randn(1, 1, lid.pillar_dim))
        self.fusion = FusionTransformer(
            cam_in=cam_in, lid_in=lid.pillar_dim, dim=fus.dim,
            depth=fus.depth, heads=fus.heads, state_dim=fus.state_dim,
            mode=fus.mode, use_pallas=attn_pallas,
            fused_block=cfg.pallas_mha_block,
            block_kernel=cfg.mha_block_kernel, dtype=dtype)

    def _vq_camera(self, image, snr_db, generator, noise, sown,
                   data_mesh=None):
        """The digital camera link: indices over QPSK (FEC or HARQ as
        configured); the token decoder sees the received codes, the
        gradient the clean straight-through path. ``sown`` (None on the act
        path): receives the link's entries; the re-seeding statistics are
        computed only then."""
        ch, codes = self.cfg.channel, self.cfg.camera.vq_codes
        idx_tx, vq_loss, z_ste, stats = self.cam_vq(
            image, with_stats=sown is not None, mesh=data_mesh)
        hinfo = None
        if ch.harq:
            idx_rx, hinfo = transmit_indices_harq(ch, idx_tx, codes, snr_db,
                                                  generator, draws=noise)
        else:
            idx_rx = transmit_indices(ch, idx_tx, codes, snr_db, generator,
                                      noise=noise)
        z_rx = z_ste + (self.cam_vq.codebook[idx_rx.long()] - z_ste).detach()
        if sown is not None:
            if hinfo is not None:
                _sow_harq(sown, hinfo)
            sown["vq_loss"].append(vq_loss)
            sown["index_error_rate"].append((idx_rx != idx_tx).float().mean())
            if stats is not None:
                sown["vq_counts"].append(stats["counts"])
                sown["vq_candidates"].append(stats["candidates"])
        return self.cam_tok(z_rx)

    def _vq_lidar(self, bev, snr_db, generator, noise, scores, lidar_keep,
                  sown, data_mesh=None):
        """The digital LiDAR link on the BEV features (B, H, W, C): the
        nearest codes of ``lid_to_code``'s outputs, their indices over
        QPSK (FEC or HARQ as configured), the received codes through
        ``lid_from_code``, the gradient through the clean straight-through
        path. Under ``lidar.vq_prune`` only each row's kept tokens send
        symbols (a ``lidar_keep`` fraction at random, else
        ``channel.token_keep`` by ``channel.token_select``: the
        farthest-point order under ``scatter``, uniform ``scores``
        otherwise) and the rest decode as ``lid_mask_embed``."""
        lid, ch = self.cfg.lidar, self.cfg.channel
        z_e = self.lid_to_code(bev).float()
        b, h, w, _ = z_e.shape
        out = semantic_vq.vector_quantize(
            z_e, self.lid_codebook, lid.vq_beta, lid.vq_usage_coef,
            lid.vq_usage_temp,
            with_stats=sown is not None and lid.vq_reseed > 0,
            mesh=data_mesh)
        z_ste, idx_tx, vq_loss = out[:3]
        idx_tx = idx_tx.reshape(b, h * w)
        z_ste = z_ste.reshape(b, h * w, lid.vq_dim)
        kept = None
        if lid.vq_prune:
            keep = lidar_keep
            if keep is None and ch.token_keep < 1.0:
                keep = torch.full((b,), ch.token_keep, dtype=torch.float32,
                                  device=idx_tx.device)
            if keep is not None:
                m = torch.ceil(keep * h * w).to(torch.int32)
                if lidar_keep is None and ch.token_select == "scatter":
                    scores = -_farthest_point_rank_on(
                        h, w, str(idx_tx.device)).to(torch.float32).expand(
                            idx_tx.shape)
                elif scores is None:
                    scores = draw(torch.rand, idx_tx.shape, generator,
                                  device=idx_tx.device)
                kept = topk_mask(scores, m)
        if ch.harq:
            idx_rx, hinfo = transmit_indices_harq(
                ch, idx_tx, lid.vq_codes, snr_db, generator, draws=noise)
            if sown is not None:
                _sow_harq(sown, hinfo)
        else:
            idx_rx = transmit_indices(
                ch, idx_tx, lid.vq_codes, snr_db, generator,
                token_weights=None if kept is None else kept.float(),
                noise=noise)
        z_rx = z_ste + (self.lid_codebook[idx_rx.long()] - z_ste).detach()
        if kept is not None:
            z_rx = torch.where(kept[..., None], z_rx,
                               self.lid_mask_embed.expand_as(z_rx))
        if sown is not None:
            sown["vq_loss"].append(vq_loss)
            if len(out) > 3:
                sown["lid_vq_counts"].append(out[3]["counts"])
                sown["lid_vq_candidates"].append(out[3]["candidates"])
        return self.lid_from_code(z_rx.reshape(b, h, w, lid.vq_dim).to(
            bev.dtype))

    def _lidar_branch(self, pts, msk, snr_db, generator, noise,
                      scores=None, lidar_keep=None, sown=None,
                      data_mesh=None):
        lid, ch = self.cfg.lidar, self.cfg.channel
        bev = self.lid_backbone(self.pfn(pts, msk))
        if lid.arch == "vq":
            x = self._vq_lidar(bev, snr_db, generator, noise, scores,
                               lidar_keep, sown, data_mesh)
        else:
            sym = self.lid_sym_head(bev)
            b, h, w, _ = sym.shape
            z = sym.reshape(b, h * w * lid.c_sym, 2).float()
            z_hat = channel_op(z, snr_db, ch.kind, generator, noise=noise,
                               **channel_kwargs(ch))
            x = self.lid_sym_embed(z_hat.reshape(b, h, w, 2 * lid.c_sym))
        b, h, w, _ = x.shape
        return self.lid_dec(x).reshape(b, h * w, lid.pillar_dim).float()

    def forward(self, image: torch.Tensor, points: torch.Tensor,
                mask: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                snr_db: Optional[torch.Tensor] = None,
                v2x_offset_db: Optional[float] = None,
                channel_noise=None, aux: Optional[dict] = None,
                lidar_keep: Optional[torch.Tensor] = None,
                data_mesh=None) -> torch.Tensor:
        """``channel_noise`` (optional): a :class:`LinkDraws` (or a tuple
        ``(camera, ego LiDAR[, V2X])``) of the links' draws, in place of
        draws from ``generator``. ``aux`` (optional dict): receives what
        the JAX trunk sows, reduced as its consumers reduce it: the summed
        ``vq_loss`` of the digital links, the camera's
        ``index_error_rate``, the HARQ accounting (``harq_syms`` summed,
        ``harq_rounds`` and ``harq_resid`` averaged over the links) and,
        under ``camera.vq_reseed`` / ``lidar.vq_reseed``, the re-seeding
        inputs (``vq_counts`` and ``vq_candidates`` of the camera;
        ``lid_vq_counts`` summed over ego and V2X, ``lid_vq_candidates``
        the ego call's). ``lidar_keep`` (optional (B,)): the kept-token
        fractions of the pruned digital LiDAR (``lidar.vq_prune``), kept
        at random, as the learners train it. ``data_mesh`` (optional): the
        batch is this rank's rows of a global batch, whose statistics the
        digital links pool over the mesh's data group."""
        ch = self.cfg.channel
        if snr_db is None:
            snr_db = torch.full((image.shape[0],), ch.snr_db,
                                dtype=torch.float32, device=image.device)
        if v2x_offset_db is None:
            v2x_offset_db = ch.v2x_snr_offset_db
        draws = LinkDraws() if channel_noise is None else LinkDraws(
            *channel_noise)
        # What each link call sows (as the JAX trunk's ``self.sow``),
        # reduced into ``aux`` at the end.
        sown = None if aux is None else defaultdict(list)
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
            cam_tokens = self._vq_camera(image, snr_db, generator,
                                         draws.camera, sown, data_mesh)
        else:
            z_cam = self.cam_enc(image, snr_in)
            z_cam_hat = channel_op(z_cam, snr_db, ch.kind, generator,
                                   noise=draws.camera, **channel_kwargs(ch))
            cam_tokens = self.cam_tok(z_cam_hat, snr_in)

        lid_tokens = self._lidar_branch(points, mask, snr_db, generator,
                                        draws.lidar, draws.lidar_scores,
                                        lidar_keep, sown, data_mesh)
        if v2x:
            v2x_tokens = self._lidar_branch(
                pts_v2x, mask_v2x, snr_db + v2x_offset_db, generator,
                draws.v2x, draws.v2x_scores, lidar_keep, sown, data_mesh)
            lid_tokens = torch.cat([lid_tokens, v2x_tokens + self.v2x_embed],
                                   dim=1)
        if aux is not None:
            _reduce_sown(sown, aux)
        return self.fusion(cam_tokens, lid_tokens)


def _sow_harq(sown: dict, hinfo: dict) -> None:
    for name, key in (("harq_syms", "symbols_per_item"),
                      ("harq_rounds", "mean_rounds"),
                      ("harq_resid", "residual_fail_rate")):
        sown[name].append(hinfo[key])


def collect_reseed_stats(cfg: ExperimentConfig, aux: dict) -> dict:
    """The dead-code re-seeding inputs of a trunk forward's ``aux``:
    ``{"cam": (counts, candidates), "lid": (counts, candidates)}`` with
    only the codebooks whose config re-seeds (``camera.vq_reseed > 0``,
    ``lidar.vq_reseed > 0``); the LiDAR counts sum the ego and V2X calls
    (one shared codebook), its candidates are the ego call's."""
    rs = {}
    if cfg.camera.arch == "vq" and cfg.camera.vq_reseed > 0:
        rs["cam"] = (aux["vq_counts"], aux["vq_candidates"])
    if cfg.lidar.arch == "vq" and cfg.lidar.vq_reseed > 0:
        rs["lid"] = (aux["lid_vq_counts"], aux["lid_vq_candidates"])
    return rs


@torch.no_grad()
def apply_codebook_reseed(cfg: ExperimentConfig, net: nn.Module, rs: dict,
                          generator: Optional[torch.Generator] = None,
                          coin: Optional[torch.Tensor] = None,
                          lid_coin: Optional[torch.Tensor] = None) -> None:
    """Re-seed the batch-dead codes of ``net``'s camera and LiDAR codebooks
    in place (``rs`` from :func:`collect_reseed_stats`), each with
    probability ``camera.vq_reseed`` / ``lidar.vq_reseed``; the learners
    call it after their optimizer step and leave the target and EMA
    networks alone, as the JAX package does. ``coin`` / ``lid_coin``: the
    (K,) uniform draws of each codebook, in place of draws from
    ``generator`` (the camera's first)."""
    per = net.perception
    if "cam" in rs:
        counts, cands = rs["cam"]
        cb = per.cam_vq.codebook
        cb.copy_(reseed_dead_codes(cb, counts, cands, generator,
                                   cfg.camera.vq_reseed, coin=coin)[0])
    if "lid" in rs:
        counts, cands = rs["lid"]
        cb = per.lid_codebook
        cb.copy_(reseed_dead_codes(cb, counts, cands, generator,
                                   cfg.lidar.vq_reseed, coin=lid_coin)[0])


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
                v2x_offset_db=None, channel_noise=None, aux=None,
                lidar_keep=None) -> torch.Tensor:
        s = self.perception(image, points, mask, generator, snr_db,
                            v2x_offset_db, channel_noise, aux, lidar_keep)
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
                v2x_offset_db=None, channel_noise=None, aux=None,
                lidar_keep=None, data_mesh=None):
        s = self.perception(image, points, mask, generator, snr_db,
                            v2x_offset_db, channel_noise, aux, lidar_keep,
                            data_mesh)
        logits = self.pi(torch.tanh(self.pi_h(s)))
        return logits, self.v(torch.tanh(self.v_h(s)))[..., 0]
