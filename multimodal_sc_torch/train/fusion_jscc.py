"""Config-3 training loop: camera + LiDAR late-fusion semantic transmission.

Counterpart of ``multimodal_sc_tpu/train/fusion_jscc.py``. Both codecs (the
camera codec, ViT or CNN after ``camera.arch``, and the LiDAR BEV codec)
transmit through the same noisy channel; the joint loss is camera MSE + 0.5
x LiDAR BEV cross entropy (or occupancy BCE). Metrics: PSNR (camera) + mIoU
(LiDAR BEV). The optimizer is optax's chain of the JAX package: global-norm
clip, then AdamW with weight decay 1e-4 on every parameter. With
``train.checkpoint_dir`` the run saves every ``train.checkpoint_every``
steps and resumes from the newest checkpoint (model, moments, generator,
step; the image and point-cloud streams are seeded per step).

Unlike the JAX package's pure update, a train step writes the model and the
optimizer moments IN PLACE: the returned state holds the same objects.

The digital LiDAR codec (``lidar.arch="vq"``, ``LidarBEVVQCodec``) adds its
VQ loss to the joint loss, runs its QPSK link inside the forward, re-seeds
its batch-dead codes after the optimizer step (``lidar.vq_reseed``), trains
under ``lidar.vq_prune`` on per-example kept fractions ~ U[vq_keep_min, 1)
of randomly selected tokens, and on a fresh run (never a resumed one) seeds
its codebook from its own encoder's outputs on a point cloud of a stream of
its own. Under ``train.bf16`` the ViT or CNN camera and the analog or
digital LiDAR codecs compute in bf16 on f32 parameters (their outputs,
the loss and the optimizer's moments f32; the digital codec's features
widened to f32 for the nearest-code search, its codebook f32).
``camera.arch="vq"`` is refused on this path, as the JAX package refuses
it.
``train.iters_per_dispatch`` has no counterpart: PyTorch runs eagerly, so
there is no per-dispatch round trip to amortize, and the value is ignored.

As a script it trains a preset:

    python -m multimodal_sc_torch.train.fusion_jscc --config c3 \\
        [--set train.steps=200 ...] [--device cuda]

prints the card, then one JSON object: the result of ``run`` and the wall
time.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_sc_torch.act_dtype import activation_dtype
from multimodal_sc_torch.channel import channel as channel_op
from multimodal_sc_torch.channel import channel_kwargs
from multimodal_sc_torch.codec.camera_cnn import CameraJSCC
from multimodal_sc_torch.codec.camera_vit import ViTJSCC
from multimodal_sc_torch.codec.lidar_bev import (LidarBEVCodec,
                                                 LidarBEVVQCodec,
                                                 occupancy_target,
                                                 semantic_bev_target)
from multimodal_sc_torch.codec.semantic_vq import (reseed_dead_codes,
                                                   seed_codebook)
from multimodal_sc_torch.config.configs import ExperimentConfig
from multimodal_sc_torch.device import card_name, resolve_device, synchronize
from multimodal_sc_torch.envs.datasets import (ImageDataset, draw_pointcloud,
                                               synthetic_pointcloud_batch)
from multimodal_sc_torch.evaluation.metrics import miou, psnr
from multimodal_sc_torch.io.checkpoint import CheckpointManager
from multimodal_sc_torch.nn_init import init_like_flax_
from multimodal_sc_torch.obs.metrics_writer import (MetricsWriter, Timer,
                                                    to_host)
from multimodal_sc_torch.obs.profiling import NaNWatchdog, maybe_trace
from multimodal_sc_torch.rl.dqn import clip_by_global_norm_

ADAMW_WEIGHT_DECAY = 1e-4      # optax.adamw's default


def _check_ported(cfg: ExperimentConfig) -> torch.dtype:
    """The codecs' activation dtype; raises on a camera arch the fusion
    path does not take."""
    if cfg.camera.arch not in ("vit", "cnn"):
        raise NotImplementedError(
            f"camera.arch={cfg.camera.arch!r} on the fusion path is not "
            "supported: the JAX package refuses it too (lidar.arch=vq is "
            "the digital half of c3)")
    return activation_dtype(cfg)


def build_camera_codec(cfg: ExperimentConfig):
    """The fusion pipeline's camera codec, ``ViTJSCC`` or ``CameraJSCC``
    (no seg head, fixed rate: segmentation lives on the LiDAR BEV side)."""
    dtype = _check_ported(cfg)
    cam = cfg.camera
    if cam.arch == "cnn":
        return CameraJSCC(features=cam.features, c_sym=cam.c_sym,
                          image_hw=cam.image_hw,
                          snr_conditioning=cam.snr_conditioning, dtype=dtype)
    return ViTJSCC(image_hw=cam.image_hw, patch=cam.patch, dim=cam.dim,
                   depth=cam.depth, heads=cam.heads, c_sym=cam.c_sym,
                   snr_conditioning=cam.snr_conditioning,
                   use_pallas=cfg.use_pallas or cfg.pallas_attention,
                   dtype=dtype)


def build_lidar_codec(cfg: ExperimentConfig):
    """The fusion pipeline's LiDAR BEV codec: ``LidarBEVVQCodec`` under
    ``lidar.arch="vq"`` (its link over ``cfg.channel``), else the analog
    ``LidarBEVCodec``."""
    dtype = _check_ported(cfg)
    lid = cfg.lidar
    if lid.arch == "vq":
        return LidarBEVVQCodec(
            pillar_dim=lid.pillar_dim, bev_hw=lid.bev_hw,
            vq_codes=lid.vq_codes, vq_dim=lid.vq_dim, vq_beta=lid.vq_beta,
            vq_usage_coef=lid.vq_usage_coef,
            vq_usage_temp=lid.vq_usage_temp, vq_reseed=lid.vq_reseed,
            vq_prune=lid.vq_prune, seg_classes=lid.seg_classes,
            x_range=lid.x_range, y_range=lid.y_range,
            channel_cfg=cfg.channel, point_features=lid.point_features,
            dtype=dtype)
    return LidarBEVCodec(pillar_dim=lid.pillar_dim, bev_hw=lid.bev_hw,
                         c_sym=lid.c_sym, seg_classes=lid.seg_classes,
                         x_range=lid.x_range, y_range=lid.y_range,
                         point_features=lid.point_features, dtype=dtype)


class LateFusionJSCC(nn.Module):
    """Camera codec + LiDAR codec under one parameter tree (late fusion).
    Fresh weights are drawn as flax's."""

    def __init__(self, cfg: ExperimentConfig):
        super().__init__()
        self.cfg = cfg
        self.camera = build_camera_codec(cfg)
        self.lidar = build_lidar_codec(cfg)
        init_like_flax_(self)

    def forward(self, img, points, mask, snr_db,
                generator: Optional[torch.Generator] = None,
                channel_noise: Optional[Sequence[torch.Tensor]] = None,
                lidar_keep: Optional[torch.Tensor] = None,
                lidar_select: Optional[str] = None,
                select_draws: Optional[torch.Tensor] = None):
        """Full late-fusion TX: both branches through the channel. Returns
        ``(recon, occ_logits, lidar_aux)``; aux is empty for the analog
        LiDAR codec, the digital codec's (``vq_loss``,
        ``index_error_rate``, ...) for ``lidar.arch="vq"``, whose link runs
        inside its own forward with ``lidar_keep``, ``lidar_select`` and
        ``select_draws``. ``channel_noise`` (optional): the standard-normal
        draws of the ``(camera, LiDAR)`` links, in place of draws from
        ``generator``."""
        ch = self.cfg.channel
        n_cam, n_lid = channel_noise if channel_noise is not None else (None,
                                                                        None)
        z_cam = self.camera.encode(img, snr_db)
        z_cam_hat = channel_op(z_cam, snr_db, ch.kind, generator, noise=n_cam,
                               **channel_kwargs(ch))
        recon = self.camera.decode(z_cam_hat, snr_db)
        if self.cfg.lidar.arch == "vq":
            logits, aux = self.lidar(points, mask, snr_db, generator,
                                     noise=n_lid, keep=lidar_keep,
                                     select=lidar_select,
                                     select_draws=select_draws)
            return recon, logits, aux
        z_lid = self.lidar.encode((points, mask))
        z_lid_hat = channel_op(z_lid, snr_db, ch.kind, generator, noise=n_lid,
                               **channel_kwargs(ch))
        return recon, self.lidar.decode(z_lid_hat), {}


class TrainState(NamedTuple):
    params: LateFusionJSCC
    opt_state: torch.optim.AdamW   # over ``params``; holds the Adam moments
    generator: torch.Generator     # SNR and channel-noise draws
    step: int                      # train steps taken


class StepDraws(NamedTuple):
    """The random draws of one train step; a ``None`` field is drawn from
    the state's generator (in this order: SNR, keep, then inside the
    forward the camera noise, the selection scores and the LiDAR link
    noise, and after the update the coin)."""
    snr_db: Optional[torch.Tensor] = None          # (B,), channel.random_snr
    # (camera, LiDAR link): the LiDAR's is its QPSK link's under lidar.arch=vq
    channel_noise: Optional[Sequence[torch.Tensor]] = None
    keep: Optional[torch.Tensor] = None     # (B,) kept fractions, vq_prune
    select: Optional[torch.Tensor] = None   # (B, N) random selection scores
    coin: Optional[torch.Tensor] = None     # (K,) lidar.vq_reseed's coin


def draw_step(cfg: ExperimentConfig, batch: int, generator: torch.Generator,
              device, draws: Optional[StepDraws] = None) -> StepDraws:
    """The step's SNR and kept fractions, those ``draws`` leaves out drawn
    from ``generator``: SNR ~ U[snr_min_db, snr_max_db) with
    ``channel.random_snr``, keep ~ U[vq_keep_min, 1) with
    ``lidar.vq_prune``."""
    ch, lid = cfg.channel, cfg.lidar
    draws = draws if draws is not None else StepDraws()
    snr, keep = draws.snr_db, draws.keep
    if snr is None and ch.random_snr:
        snr = ch.snr_min_db + torch.rand(
            (batch,), generator=generator, device=device) * (
                ch.snr_max_db - ch.snr_min_db)
    if keep is None and lid.arch == "vq" and lid.vq_prune:
        keep = lid.vq_keep_min + torch.rand(
            (batch,), generator=generator, device=device) * (
                1.0 - lid.vq_keep_min)
    return draws._replace(snr_db=snr, keep=keep)


def make_optimizer(cfg: ExperimentConfig,
                   model: nn.Module) -> torch.optim.AdamW:
    """AdamW as ``optax.adamw(lr)``: b1 0.9, b2 0.999, eps 1e-8 and a
    decoupled weight decay of 1e-4 on EVERY parameter, biases and LayerNorm
    included (torch's default would be 1e-2). Both subtract ``lr * wd * p``
    computed on the parameter before the step, so one step is the same. The
    global-norm clip of the chain is ``clip_by_global_norm_``, applied to
    the gradients first."""
    return torch.optim.AdamW(model.parameters(), lr=cfg.train.lr,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=ADAMW_WEIGHT_DECAY)


def create_train_state(cfg: ExperimentConfig, seed: int = 0,
                       device="cuda") -> TrainState:
    """A fresh model, its weights drawn from ``seed`` (the global RNG is
    left as it was), its optimizer and a generator on ``device``."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = LateFusionJSCC(cfg)
    model = model.to(dev)
    return TrainState(params=model, opt_state=make_optimizer(cfg, model),
                      generator=torch.Generator(device=dev).manual_seed(seed),
                      step=0)


def bev_target(cfg: ExperimentConfig, pts, mask, cls) -> torch.Tensor:
    """The LiDAR branch's ground truth: the semantic grid (int32) when
    ``lidar.seg_classes > 1``, else the binary occupancy (float32)."""
    lid = cfg.lidar
    if lid.seg_classes > 1:
        return semantic_bev_target(pts, mask, cls, lid.bev_hw, lid.x_range,
                                   lid.y_range, num_classes=lid.seg_classes)
    return occupancy_target(pts, mask, lid.bev_hw, lid.x_range, lid.y_range)


def loss_fn(cfg: ExperimentConfig, model: LateFusionJSCC, img, pts, mask,
            target, snr_db, generator=None, channel_noise=None,
            draws: Optional[StepDraws] = None):
    """``(loss, (recon, logits, cam_loss, lidar_loss, lidar_aux))`` of one
    batch: camera MSE + 0.5 x the LiDAR loss, plus the digital LiDAR
    codec's VQ loss (the codebook trains through it alone). Under
    ``lidar.vq_prune`` the LiDAR link sends ``draws.keep`` of its tokens,
    selected at random (``draws.select``)."""
    kw = {}
    if cfg.lidar.arch == "vq" and cfg.lidar.vq_prune and draws is not None:
        kw = {"lidar_keep": draws.keep, "lidar_select": "random",
              "select_draws": draws.select}
    recon, logits, lid_aux = model(img, pts, mask, snr_db, generator,
                                   channel_noise, **kw)
    cam_loss = (recon - img).square().mean()
    if cfg.lidar.seg_classes > 1:
        # Classes last in the logits; F.cross_entropy wants them second.
        lid_loss = F.cross_entropy(logits.permute(0, 3, 1, 2), target.long())
    else:
        l = logits[..., 0]
        lid_loss = (torch.clamp(l, min=0) - l * target
                    + torch.log1p(torch.exp(-l.abs()))).mean()
    loss = cam_loss + 0.5 * lid_loss
    if "vq_loss" in lid_aux:
        loss = loss + lid_aux["vq_loss"]
    return loss, (recon, logits, cam_loss, lid_loss, lid_aux)


def make_train_step(cfg: ExperimentConfig):
    """``train_step(state, img, pts, mask, cls, draws=None) -> (state,
    metrics)``: one clip + AdamW step on one batch; a digital LiDAR codec's
    batch-dead codes are then re-seeded (``lidar.vq_reseed > 0``)."""
    _check_ported(cfg)
    lid = cfg.lidar
    semantic = lid.seg_classes > 1

    def train_step(state: TrainState, img, pts, mask, cls,
                   draws: Optional[StepDraws] = None):
        model, opt = state.params, state.opt_state
        draws = draw_step(cfg, img.shape[0], state.generator, img.device,
                          draws)
        snr_db = draws.snr_db
        if snr_db is None:
            snr_db = torch.full((img.shape[0],), cfg.channel.snr_db,
                                dtype=torch.float32, device=img.device)
        with torch.no_grad():
            target = bev_target(cfg, pts, mask, cls)
        loss, (recon, logits, cam_loss, lid_loss, lid_aux) = loss_fn(
            cfg, model, img, pts, mask, target, snr_db, state.generator,
            draws.channel_noise, draws)
        params = list(model.parameters())
        # Parameters the loss does not reach get zero gradients, as jax.grad
        # gives them: their moments and the weight decay then act as optax's.
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        with torch.no_grad():
            clip_by_global_norm_(grads, cfg.train.grad_clip)
            for p, g in zip(params, grads):
                p.grad = g
            opt.step()
            opt.zero_grad(set_to_none=True)
            if semantic:
                m = miou(logits.argmax(dim=-1), target, lid.seg_classes)
            else:
                m = miou((logits[..., 0] > 0).int(), target.int(), 2)
            metrics = {"loss": loss.detach(), "cam_loss": cam_loss.detach(),
                       "lidar_loss": lid_loss.detach(),
                       "psnr": psnr(recon, img), "miou": m}
            if "vq_loss" in lid_aux:
                metrics.update({
                    "lidar_vq_loss": lid_aux["vq_loss"].detach(),
                    "lidar_index_err": lid_aux["index_error_rate"],
                    "lidar_code_perplexity": lid_aux["code_perplexity"]})
            if "vq_counts" in lid_aux:
                # Dead codes jump to the batch's worst-quantised encoder
                # outputs, after the optimizer step.
                cb = model.lidar.codebook
                new_cb, n_rs = reseed_dead_codes(
                    cb, lid_aux["vq_counts"], lid_aux["vq_candidates"],
                    state.generator, lid.vq_reseed, coin=draws.coin)
                cb.copy_(new_cb)
                metrics["lidar_vq_reseeded"] = n_rs.float()
            if "token_keep_frac" in lid_aux:
                metrics["lidar_token_keep_frac"] = lid_aux["token_keep_frac"]
        return state._replace(step=state.step + 1), metrics

    return train_step


def make_batches(cfg: ExperimentConfig, device, start_step: int = 0):
    """The training stream from step ``start_step`` on: an endless iterator
    of ``(img, pts, mask, cls)`` batches on ``device``. Batch ``i``'s images
    and point cloud each come from a generator seeded by ``(train.seed,
    i)``, apart from the channel's (the train state's generator), so a
    resumed run replays the stream."""
    lid, tr = cfg.lidar, cfg.train
    data = ImageDataset(tr.dataset, tr.batch_size, seed=tr.seed,
                        device=device, data_root=tr.data_root)
    data._step = start_step
    cloud_gen = torch.Generator(device=device)
    step = start_step
    while True:
        cloud_gen.manual_seed(((tr.seed + 1) * 0x9E3779B1 + 0xC10D0000 + step)
                              & 0xFFFFFFFF)
        step += 1
        pts, mask, cls = synthetic_pointcloud_batch(
            draw_pointcloud(tr.batch_size, lid.max_points, cloud_gen, device,
                            lid.x_range, lid.y_range),
            lid.x_range, lid.y_range, with_classes=True)
        yield next(data).to(device), pts, mask, cls


def seed_lidar_codebook(cfg: ExperimentConfig, model: LateFusionJSCC,
                        device) -> torch.Tensor:
    """A fresh digital LiDAR codec's codebook becomes a sample of its own
    encoder's outputs on a point cloud of a stream of its own (``seed_codebook``),
    the fix for the degenerate optimum of a small-uniform init. ``run``
    calls it on a fresh run only, never on resume."""
    lid, tr = cfg.lidar, cfg.train
    g = torch.Generator(device=device)
    g.manual_seed((tr.seed * 0x9E3779B1 + 0xC0DE) & 0xFFFFFFFF)
    pts, mask, _ = synthetic_pointcloud_batch(
        draw_pointcloud(tr.batch_size, lid.max_points, g, device, lid.x_range,
                        lid.y_range), lid.x_range, lid.y_range,
        with_classes=True)
    with torch.no_grad():
        z = model.lidar.encode_features(pts, mask)
    g.manual_seed((tr.seed * 0x9E3779B1 + 0xC0DF) & 0xFFFFFFFF)
    return seed_codebook(model.lidar.codebook, z, g)


def run(cfg: ExperimentConfig, metrics_path: Optional[str] = None,
        device="cuda"):
    """Train config-3 late fusion for ``cfg.train.steps`` steps on the
    synthetic generators (resuming from ``train.checkpoint_dir`` when it
    holds a checkpoint); returns ``(state, result)``."""
    dev = resolve_device(device)
    tr = cfg.train
    state = create_train_state(cfg, tr.seed, dev)
    train_step = make_train_step(cfg)
    ckpt = None
    if tr.checkpoint_dir:
        ckpt = CheckpointManager(tr.checkpoint_dir)
        ckpt.save_config(cfg.to_json())
        restored = ckpt.restore_latest(state)
        if restored is not None:
            state = restored
    start = state.step
    if cfg.lidar.arch == "vq" and start == 0:
        seed_lidar_codebook(cfg, state.params, dev)
    batches = make_batches(cfg, dev, start)
    writer = MetricsWriter(metrics_path, config_json=cfg.to_json())
    watchdog = NaNWatchdog()

    # First-step wall (allocator warm-up, kernel build and load) recorded
    # apart from the steady rate; checkpoint writes apart from both.
    first_s = None
    ckpt_s = 0.0
    last = {}
    with maybe_trace(tr.profile_dir), Timer() as t:
        for step in range(start + 1, tr.steps + 1):
            t0 = time.perf_counter() if first_s is None else None
            state, last = train_step(state, *next(batches))
            if t0 is not None:
                synchronize(dev)
                first_s = time.perf_counter() - t0
            if step % tr.log_every == 0:
                writer.write(step, last)
                watchdog.check(step, last)
            if ckpt and step % tr.checkpoint_every == 0:
                t_ck = time.perf_counter()
                ckpt.save(step, state)
                ckpt_s += time.perf_counter() - t_ck
        synchronize(dev)
    out = to_host(last)
    n_steps = tr.steps - start
    if ckpt:
        t_ck = time.perf_counter()
        ckpt.close()
        out["ckpt_save_s"] = round(ckpt_s, 2)
        out["ckpt_close_s"] = round(time.perf_counter() - t_ck, 2)
    if first_s is not None and n_steps > 1 and t.elapsed > first_s + ckpt_s:
        out["first_dispatch_s"] = round(first_s, 2)
        out["steady_steps_per_sec"] = round(
            (n_steps - 1) / (t.elapsed - first_s - ckpt_s), 2)
    writer.write(tr.steps, out)
    writer.close()
    return state, out


def main(argv=None) -> int:
    from multimodal_sc_torch.config import get_preset

    ap = argparse.ArgumentParser(
        description="Train a late-fusion JSCC preset.")
    ap.add_argument("--config", default="c3")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="config override, e.g. train.steps=200 (repeatable)")
    ap.add_argument("--metrics-path", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # The JAX package's refusals of flag combinations it would ignore.
    cfg = get_preset(args.config).override_str(args.set).validate()
    dev = resolve_device(args.device)
    card = card_name(dev)
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    state, result = run(cfg, args.metrics_path, device=dev)
    result["train_wall_s"] = round(time.perf_counter() - t0, 2)
    result["train_steps"] = state.step
    result["card"] = card
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
