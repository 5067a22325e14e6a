"""JSCC reconstruction training loop (config 1).

Counterpart of ``multimodal_sc_tpu/train/jscc.py`` for the CNN camera codec
(``CameraJSCC``) at a fixed SNR: encode -> power-normalise -> channel ->
decode -> MSE. The optimizer is the JAX package's chain: global-norm clip,
then AdamW (decay 1e-4 on every parameter) whose learning rate follows
optax's ``warmup_cosine_decay_schedule(0, lr, warmup_steps, max(steps,
warmup_steps + 1))``, read at the number of updates taken so far (0 for the
first). A held-out batch is scored (PSNR) every ``train.eval_every`` steps.

Unlike the JAX package's pure update, a train step writes the model, the
optimizer moments and the schedule IN PLACE: the returned state holds the
same objects. Not ported yet, each raising: random SNR draws
(``channel.random_snr``), the segmentation head's loss
(``camera.seg_classes > 0``) and the adaptive rate (ROADMAP item 12), the
ViT arch (item 13), the VQ arch (item 14), non-AWGN channels (item 12),
``train.bf16``, checkpoints and resume (item 10). ``train.iters_per_dispatch``
(the chunked step) has no counterpart: PyTorch runs eagerly, so there is no
per-dispatch round trip to amortize, and the value is ignored.

As a script it trains a preset:

    python -m multimodal_sc_torch.train.jscc --config c1 \\
        [--set train.steps=2000 ...] [--device cuda]

prints the card, then one JSON object: the result of ``run`` and the wall
time.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import NamedTuple, Optional

import torch

from multimodal_sc_torch.channel import channel as channel_op
from multimodal_sc_torch.channel import channel_kwargs
from multimodal_sc_torch.codec.camera_cnn import CameraJSCC
from multimodal_sc_torch.config.configs import ExperimentConfig
from multimodal_sc_torch.device import card_name, resolve_device, synchronize
from multimodal_sc_torch.envs.datasets import ImageDataset
from multimodal_sc_torch.evaluation.metrics import psnr
from multimodal_sc_torch.obs.metrics_writer import (MetricsWriter, Timer,
                                                    to_host)
from multimodal_sc_torch.obs.profiling import NaNWatchdog, maybe_trace
from multimodal_sc_torch.rl.dqn import clip_by_global_norm_
from multimodal_sc_torch.train.fusion_jscc import make_optimizer


def _check_ported(cfg: ExperimentConfig) -> None:
    cam, ch = cfg.camera, cfg.channel
    if cam.arch != "cnn":
        item = {"vit": 13, "vq": 14}.get(cam.arch)
        raise NotImplementedError(
            f"camera.arch={cam.arch!r} on the JSCC path is not ported yet"
            + (f" (ROADMAP item {item})" if item else ""))
    if cam.adaptive_rate:
        raise NotImplementedError(
            "camera.adaptive_rate is not ported yet (ROADMAP item 12)")
    if cam.seg_classes > 0:
        raise NotImplementedError(
            "camera.seg_classes > 0 (the segmentation loss and mIoU) is not "
            "ported yet (ROADMAP item 12)")
    if ch.random_snr:
        raise NotImplementedError(
            "channel.random_snr is not ported yet (ROADMAP item 12)")
    if ch.kind != "awgn":
        raise NotImplementedError(
            f"channel.kind={ch.kind!r} on the JSCC path is not ported yet "
            "(ROADMAP item 12)")
    if cfg.train.bf16:
        raise NotImplementedError("train.bf16 activations are not ported")


def build_model(cfg: ExperimentConfig) -> CameraJSCC:
    _check_ported(cfg)
    cam = cfg.camera
    return CameraJSCC(features=cam.features, c_sym=cam.c_sym,
                      image_hw=cam.image_hw, seg_classes=cam.seg_classes,
                      snr_conditioning=cam.snr_conditioning,
                      adaptive_rate=cam.adaptive_rate)


def lr_schedule(cfg: ExperimentConfig, count: int) -> float:
    """``optax.warmup_cosine_decay_schedule(0, lr, warmup_steps,
    max(steps, warmup_steps + 1))`` at ``count`` updates taken: linear from
    0 to lr over the warm-up, then a cosine to 0."""
    tr = cfg.train
    warm = tr.warmup_steps
    if count < warm:
        return tr.lr * count / warm
    decay = max(tr.steps, warm + 1) - warm
    t = min(count - warm, decay)
    return tr.lr * 0.5 * (1.0 + math.cos(math.pi * t / decay))


class TrainState(NamedTuple):
    params: CameraJSCC
    opt_state: torch.optim.AdamW   # over ``params``; holds the Adam moments
    schedule: torch.optim.lr_scheduler.LambdaLR   # stepped after each update
    generator: torch.Generator     # channel-noise draws
    step: int                      # train steps taken


def create_train_state(cfg: ExperimentConfig, seed: int = 0,
                       device="cuda") -> TrainState:
    """A fresh model, its weights drawn from ``seed`` (the global RNG is
    left as it was), its optimizer and schedule, and a generator on
    ``device``."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build_model(cfg)
    model = model.to(dev)
    opt = make_optimizer(cfg, model)
    # LambdaLR scales the optimizer's lr (cfg.train.lr) by its factor at the
    # updates taken so far: 0 now, one more after each step.
    schedule = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: lr_schedule(cfg, count) / cfg.train.lr)
    return TrainState(params=model, opt_state=opt, schedule=schedule,
                      generator=torch.Generator(device=dev).manual_seed(seed),
                      step=0)


def reconstruct(cfg: ExperimentConfig, model: CameraJSCC, img, snr_db,
                generator: Optional[torch.Generator] = None, noise=None):
    """encode -> channel (power-normalised, ``cfg.channel``) -> decode:
    ``(recon, symbols)``. ``noise`` (optional): the channel's
    standard-normal draws, in place of draws from ``generator``."""
    ch = cfg.channel
    z = model.encode(img, snr_db)
    z_hat = channel_op(z, snr_db, ch.kind, generator, noise=noise,
                       **channel_kwargs(ch))
    return model.decode(z_hat, snr_db), z


def _snr(cfg: ExperimentConfig, img) -> torch.Tensor:
    return torch.full((img.shape[0],), cfg.channel.snr_db,
                      dtype=torch.float32, device=img.device)


def make_train_step(cfg: ExperimentConfig):
    """``train_step(state, img, noise=None) -> (state, metrics)``: one MSE
    step (clip, AdamW at the scheduled lr) on one batch; ``noise`` as in
    :func:`reconstruct`."""
    _check_ported(cfg)

    def train_step(state: TrainState, img, noise=None):
        model, opt = state.params, state.opt_state
        recon, _ = reconstruct(cfg, model, img, _snr(cfg, img),
                               state.generator, noise)
        loss = (recon - img).square().mean()
        params = list(model.parameters())
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            clip_by_global_norm_(list(grads), cfg.train.grad_clip)
            for p, g in zip(params, grads):
                p.grad = g
            opt.step()
            opt.zero_grad(set_to_none=True)
            state.schedule.step()
            metrics = {"loss": loss.detach(), "psnr": psnr(recon, img)}
        return state._replace(step=state.step + 1), metrics

    return train_step


def make_eval_step(cfg: ExperimentConfig):
    """``eval_step(model, img, generator=None, noise=None) -> psnr`` through
    the deployed channel at ``channel.snr_db``."""
    _check_ported(cfg)

    @torch.no_grad()
    def eval_step(model: CameraJSCC, img, generator=None, noise=None):
        recon, _ = reconstruct(cfg, model, img, _snr(cfg, img), generator,
                               noise)
        return psnr(recon, img)

    return eval_step


def run(cfg: ExperimentConfig, metrics_path: Optional[str] = None,
        device="cuda"):
    """Train config 1 for ``cfg.train.steps`` steps on the synthetic images;
    returns ``(state, result)``."""
    if cfg.train.checkpoint_dir:
        raise NotImplementedError(
            "checkpoints and resume are not ported yet (ROADMAP item 10)")
    dev = resolve_device(device)
    tr = cfg.train
    state = create_train_state(cfg, tr.seed, dev)
    train_step, eval_step = make_train_step(cfg), make_eval_step(cfg)
    data = ImageDataset(tr.dataset, tr.batch_size, seed=tr.seed, device=dev)
    # The held-out batch comes from a stream of its own; each evaluation's
    # channel noise from a generator seeded by its step, apart from the
    # training stream's.
    eval_img = next(ImageDataset(tr.dataset, tr.batch_size, seed=tr.seed + 999,
                                 device=dev))
    eval_gen = torch.Generator(device=dev)
    writer = MetricsWriter(metrics_path, config_json=cfg.to_json())
    watchdog = NaNWatchdog()

    # First-step wall (allocator warm-up, kernel build and load) recorded
    # apart from the steady rate.
    first_s = None
    last = {}
    with maybe_trace(tr.profile_dir), Timer() as t:
        for step in range(1, tr.steps + 1):
            t0 = time.perf_counter() if first_s is None else None
            state, last = train_step(state, next(data))
            if t0 is not None:
                synchronize(dev)
                first_s = time.perf_counter() - t0
            if step % tr.log_every == 0:
                writer.write(step, last)
                watchdog.check(step, last)
            if step % tr.eval_every == 0:
                eval_gen.manual_seed((tr.seed * 0x9E3779B1 + 0xE7A1 + step)
                                     & 0xFFFFFFFF)
                ep = eval_step(state.params, eval_img, eval_gen)
                last = {**last, "eval_psnr": ep}
                writer.write(step, {"eval_psnr": ep})
        synchronize(dev)
    out = to_host(last)
    if first_s is not None and tr.steps > 1 and t.elapsed > first_s:
        out["first_dispatch_s"] = round(first_s, 2)
        out["steady_steps_per_sec"] = round(
            (tr.steps - 1) / (t.elapsed - first_s), 2)
    writer.write(tr.steps, out)
    writer.close()
    return state, out


def main(argv=None) -> int:
    from multimodal_sc_torch.config import get_preset

    ap = argparse.ArgumentParser(description="Train a CNN JSCC preset.")
    ap.add_argument("--config", default="c1")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="config override, e.g. train.steps=200 (repeatable)")
    ap.add_argument("--metrics-path", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_preset(args.config).override_str(args.set)
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
