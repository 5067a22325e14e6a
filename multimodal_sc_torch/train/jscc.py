"""JSCC reconstruction training loop (configs 1-2).

Counterpart of ``multimodal_sc_tpu/train/jscc.py`` for the CNN camera codec
(``CameraJSCC``): encode -> power-normalise -> channel -> decode -> MSE,
with what config 2 adds: a per-example SNR drawn from U[snr_min_db,
snr_max_db) (``channel.random_snr``), the segmentation head's loss (MSE +
0.1 x cross entropy, ``camera.seg_classes > 0``) and its mIoU, the
bandwidth-agile codec (``camera.adaptive_rate``: m ~ U{rate_min_sym, ..,
c_sym} symbol channels an example, FiLM on the rate m/c_sym, the others
masked out of the channel), every channel kind, pilots and M-QAM. The
optimizer is the JAX package's chain: global-norm clip, then AdamW (decay
1e-4 on every parameter) whose learning rate follows optax's
``warmup_cosine_decay_schedule(0, lr, warmup_steps, max(steps,
warmup_steps + 1))``, read at the number of updates taken so far (0 for the
first). A held-out batch is scored (PSNR) every ``train.eval_every`` steps
over the deployed channel at ``channel.snr_db``. With
``train.checkpoint_dir`` the run saves every ``train.checkpoint_every``
steps and resumes from the newest checkpoint: model, optimizer moments,
schedule, generator and step, the dataset set to the step, so a resumed
run replays the stream of an uninterrupted one.

The codec is ``CameraJSCC`` (``camera.arch="cnn"``), ``ViTJSCC``
(``camera.arch="vit"``, an SNR token under ``camera.snr_conditioning``, its
attention on the packed or flash kernels under ``use_pallas`` or
``pallas_attention``) or the digital ``VQCameraJSCC`` (``camera.arch="vq"``:
the loss is the MSE plus the VQ loss, the digital link runs inside the
forward, dead codes are re-seeded after the step under
``camera.vq_reseed``, and a fresh run seeds its codebook from the encoder's
outputs on a real batch, never a resumed one). Under ``camera.vq_prune``
each example sends a kept fraction ~ U[vq_keep_min, 1) of its tokens,
selected at random; under ``channel.uep_alpha > 0`` the link's unequal
power allocation runs inside the forward. Unlike the JAX package's
pure update, a train step writes the model, the optimizer moments and the
schedule IN PLACE: the returned state holds the same objects. Under
``train.bf16`` the CNN, ViT and VQ codecs compute in bf16 on f32
parameters, as JAX's ``build_model`` builds them (their image and seg
logits come out f32, so the loss, the gradients reaching the parameters
and the AdamW moments stay f32; the VQ codec's features are widened to f32
for the nearest-code search, so its codebook and VQ loss stay f32).
On a mesh whose data axis has S > 1 ranks (``torchrun --nproc-per-node
N``; ``runtime/mesh.py``) a step keeps the JAX package's one global batch:
every rank reads the dataset's global batch of the step and trains on its
rows (``shard_batch``), its draws from a generator of its own (given
draws are the global batch's: each rank reads its rows), and the
gradients are meaned over the data group; the loss is meaned, the PSNR
taken from the meaned MSE and the mIoU from the summed confusion matrix.
The VQ codec's batch statistics are the global batch's too
(``codec/semantic_vq.py``): the usage loss, the usage counts and the
re-seeding candidates, the code perplexity (from the summed histogram) and
the index error rate; the VQ loss and the kept-token fraction are meaned,
and the re-seeding coins are the first rank's, the same on every rank.
Rank 0 writes the metrics and the checkpoint (each other rank its
generator beside it).
``train.iters_per_dispatch`` (the chunked step) has no counterpart:
PyTorch runs eagerly, so there is no per-dispatch round trip to amortize,
and the value is ignored.

As a script it trains a preset:

    python -m multimodal_sc_torch.train.jscc --config c2 \\
        [--set train.steps=3000 --set train.checkpoint_dir=DIR ...] \\
        [--device cuda]

prints the card, then one JSON object: the result of ``run`` and the wall
time.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from multimodal_sc_torch.act_dtype import activation_dtype
from multimodal_sc_torch.channel import ChannelDraws, rate_mask
from multimodal_sc_torch.channel import channel as channel_op
from multimodal_sc_torch.channel import channel_kwargs
from multimodal_sc_torch.codec.camera_cnn import CameraJSCC
from multimodal_sc_torch.codec.camera_vit import ViTJSCC
from multimodal_sc_torch.codec.semantic_vq import (VQCameraJSCC,
                                                   check_digital_camera,
                                                   init_codebook_from_batch,
                                                   reseed_coin,
                                                   reseed_dead_codes)
from multimodal_sc_torch.config.configs import ExperimentConfig
from multimodal_sc_torch.device import card_name, resolve_device, synchronize
from multimodal_sc_torch.envs.datasets import ImageDataset
from multimodal_sc_torch.evaluation.metrics import (confusion_matrix, miou,
                                                    miou_from_confusion, mse,
                                                    psnr)
from multimodal_sc_torch.io.checkpoint import (CheckpointManager,
                                               guard_world, restore_sharded,
                                               save_sharded)
from multimodal_sc_torch.nn_init import init_like_flax_
from multimodal_sc_torch.obs.metrics_writer import (MetricsWriter, Timer,
                                                    to_host)
from multimodal_sc_torch.obs.profiling import NaNWatchdog, maybe_trace
from multimodal_sc_torch.rl.dqn import clip_by_global_norm_
from multimodal_sc_torch.runtime.mesh import (Mesh, all_reduce_mean_,
                                              data_parallel,
                                              init_distributed,
                                              local_batch_size,
                                              mesh_from_config, replicate,
                                              shard_batch, shard_seed)
from multimodal_sc_torch.runtime.prefetch import prefetch_to_device
from multimodal_sc_torch.train.fusion_jscc import make_optimizer


def _check_ported(cfg: ExperimentConfig) -> torch.dtype:
    """The codec's activation dtype; raises on an unknown camera arch and
    on what a digital camera link refuses."""
    cam = cfg.camera
    if cam.arch not in ("cnn", "vit", "vq"):
        raise ValueError(f"unknown camera arch {cam.arch!r}")
    if cam.arch == "vq":
        check_digital_camera(cfg)
    return activation_dtype(cfg)


def build_model(cfg: ExperimentConfig
                ) -> Union[CameraJSCC, ViTJSCC, VQCameraJSCC]:
    dtype = _check_ported(cfg)
    cam = cfg.camera
    if cam.arch == "vq":
        return VQCameraJSCC(cfg, dtype)
    if cam.arch == "vit":
        model = ViTJSCC(image_hw=cam.image_hw, patch=cam.patch, dim=cam.dim,
                        depth=cam.depth, heads=cam.heads, c_sym=cam.c_sym,
                        snr_conditioning=cam.snr_conditioning,
                        use_pallas=cfg.use_pallas or cfg.pallas_attention,
                        dtype=dtype)
        init_like_flax_(model)
        return model
    return CameraJSCC(features=cam.features, c_sym=cam.c_sym,
                      image_hw=cam.image_hw, seg_classes=cam.seg_classes,
                      snr_conditioning=cam.snr_conditioning,
                      adaptive_rate=cam.adaptive_rate, dtype=dtype)


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
    generator: torch.Generator     # SNR, rate and channel draws
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


class StepDraws(NamedTuple):
    """The random draws of one train step; a ``None`` field is drawn from
    the state's generator (in this order: SNR, rate, keep, then inside the
    VQ forward the selection scores, the UEP probes and the channel, and
    after the update the coin)."""
    snr_db: Optional[torch.Tensor] = None   # (B,), channel.random_snr
    m: Optional[torch.Tensor] = None        # (B,) int, camera.adaptive_rate
    channel: Union[None, torch.Tensor, ChannelDraws] = None
    coin: Optional[torch.Tensor] = None     # (K,) camera.vq_reseed's coin
    keep: Optional[torch.Tensor] = None     # (B,) kept fractions, vq_prune
    select: Optional[torch.Tensor] = None   # (B, N) random selection scores
    uep: Optional[torch.Tensor] = None      # (P, B, H, W, 3) UEP probes


def shard_draws(mesh: Mesh, draws: StepDraws) -> StepDraws:
    """This rank's rows of a global batch's draws: every per-example draw
    by its batch axis (the UEP probes' second), the coin whole."""
    uep = draws.uep
    if uep is not None:
        b = local_batch_size(mesh, uep.shape[1])
        uep = uep[:, mesh.data_index * b:(mesh.data_index + 1) * b]
    return shard_batch(mesh, draws._replace(coin=None, uep=None))._replace(
        coin=draws.coin, uep=uep)


def _rate(model, m: Optional[torch.Tensor]):
    """``(codec keywords, mask factory)`` of m transmitted symbol channels
    an example: ``{"rate": m / c_sym}`` and the channel mask for an
    adaptive-rate codec, ``({}, None)`` for a fixed-rate one."""
    if not getattr(model, "adaptive_rate", False):
        return {}, None
    return {"rate": m.float() / model.c_sym}, lambda z: rate_mask(
        z.shape[0], z.shape[1], model.c_sym, m)


def transmit(model: CameraJSCC, img, snr_db, kind: str,
             generator: Optional[torch.Generator] = None, noise=None,
             rate_sym: int = 0, with_seg: bool = False, **channel_kw):
    """encode -> channel -> decode, as the JAX package's
    ``api.reconstruct``: ``(recon, symbols)``, or ``((recon, seg_logits),
    symbols)`` with ``with_seg``. ``snr_db`` a scalar or (B,); ``rate_sym``
    (adaptive-rate codecs only): transmit the first rate_sym of c_sym symbol
    channels, 0 for all. ``noise``: the channel's draws, in place of draws
    from ``generator``."""
    b = img.shape[0]
    snr = torch.as_tensor(snr_db, dtype=torch.float32, device=img.device)
    if snr.dim() == 0:
        snr = snr.expand(b)
    m = torch.full((b,), rate_sym or model.c_sym, dtype=torch.int32,
                   device=img.device)
    rate, mask = _rate(model, m)
    z = model.encode(img, snr, **rate)
    z_hat = channel_op(z, snr, kind, generator, noise=noise,
                       mask=mask(z) if mask else None, **channel_kw)
    decode = model.decode_seg if with_seg else model.decode
    return decode(z_hat, snr, **rate), z


def reconstruct(cfg: ExperimentConfig, model: CameraJSCC, img, snr_db,
                generator: Optional[torch.Generator] = None, noise=None,
                rate_sym: int = 0):
    """``transmit`` over ``cfg.channel``: ``(recon, symbols)``."""
    return transmit(model, img, snr_db, cfg.channel.kind, generator, noise,
                    rate_sym, **channel_kwargs(cfg.channel))


def _with_seg(cfg: ExperimentConfig) -> bool:
    return cfg.camera.seg_classes > 0 and cfg.camera.arch == "cnn"


def draw_step(cfg: ExperimentConfig, batch: int, generator: torch.Generator,
              device, draws: Optional[StepDraws] = None) -> StepDraws:
    """The step's SNR, rate and kept fractions, those ``draws`` leaves out
    drawn from ``generator``: SNR ~ U[snr_min_db, snr_max_db) with
    ``channel.random_snr`` (else ``channel.snr_db``), m ~ U{rate_min_sym,
    .., c_sym} with ``camera.adaptive_rate``, keep ~ U[vq_keep_min, 1) with
    ``camera.vq_prune``."""
    ch, cam = cfg.channel, cfg.camera
    draws = draws if draws is not None else StepDraws()
    snr, m, keep = draws.snr_db, draws.m, draws.keep
    if snr is None:
        if ch.random_snr:
            snr = ch.snr_min_db + torch.rand(
                (batch,), generator=generator, device=device) * (
                    ch.snr_max_db - ch.snr_min_db)
        else:
            snr = torch.full((batch,), ch.snr_db, dtype=torch.float32,
                             device=device)
    if m is None and cam.adaptive_rate:
        m = torch.randint(cam.rate_min_sym, cam.c_sym + 1, (batch,),
                          generator=generator, device=device)
    if keep is None and cam.arch == "vq" and cam.vq_prune:
        keep = cam.vq_keep_min + torch.rand(
            (batch,), generator=generator, device=device) * (
                1.0 - cam.vq_keep_min)
    return draws._replace(snr_db=snr, m=m, keep=keep)


def loss_fn(cfg: ExperimentConfig, model: CameraJSCC, img, seg,
            draws: StepDraws, generator=None):
    """``(loss, (recon, seg_logits))`` of one batch at the step's draws: MSE,
    plus 0.1 x the segmentation cross entropy (mean over B x H x W) with a
    seg head."""
    ch = cfg.channel
    rate, mask = _rate(model, draws.m)
    z = model.encode(img, draws.snr_db, **rate)
    z_hat = channel_op(z, draws.snr_db, ch.kind, generator,
                       noise=draws.channel, mask=mask(z) if mask else None,
                       **channel_kwargs(ch))
    if _with_seg(cfg):
        recon, logits = model.decode_seg(z_hat, draws.snr_db, **rate)
        mse = (recon - img).square().mean()
        # Classes last in the logits; F.cross_entropy wants them second.
        ce = F.cross_entropy(logits.permute(0, 3, 1, 2), seg.long())
        return mse + 0.1 * ce, (recon, logits)
    recon = model.decode(z_hat, draws.snr_db, **rate)
    return (recon - img).square().mean(), (recon, None)


def vq_loss_fn(model: VQCameraJSCC, img, draws: StepDraws, generator=None,
               mesh: Optional[Mesh] = None):
    """``(loss, (recon, aux))`` of the VQ codec at the step's draws: MSE
    plus the VQ loss, the digital link inside the forward; a pruned codec
    sends ``draws.keep`` of its tokens, selected at random (every drop
    pattern a deployed ranking can make). ``mesh``: ``img`` is this rank's
    rows of a global batch, whose statistics the codec pools."""
    kw = ({"keep": draws.keep, "select": "random",
           "select_draws": draws.select} if model.vq_prune else {})
    recon, aux = model(img, draws.snr_db, generator, noise=draws.channel,
                       uep_draws=draws.uep, data_mesh=mesh, **kw)
    return (recon - img).square().mean() + aux["vq_loss"], (recon, aux)


def make_train_step(cfg: ExperimentConfig, mesh: Optional[Mesh] = None):
    """``train_step(state, batch, draws=None) -> (state, metrics)``: one
    clip + AdamW step at the scheduled lr on one batch, ``img`` or ``(img,
    seg)`` as the dataset yields it. ``draws``: a ``StepDraws``, or a tensor
    of the channel's standard-normal noise. A VQ codec's step then re-seeds
    its batch-dead codes (``camera.vq_reseed > 0``). On a data axis of more
    than one rank (``mesh``) ``batch`` is this rank's rows of the global
    batch and given ``draws`` the global batch's."""
    _check_ported(cfg)
    with_seg = _with_seg(cfg)
    vq = cfg.camera.arch == "vq"
    dp = data_parallel(mesh)

    def train_step(state: TrainState, batch, draws=None):
        model, opt = state.params, state.opt_state
        img, seg = batch if with_seg else (batch, None)
        if isinstance(draws, torch.Tensor):
            draws = StepDraws(channel=draws)
        if dp and draws is not None:
            draws = shard_draws(mesh, draws)
        draws = draw_step(cfg, img.shape[0], state.generator, img.device,
                          draws)
        if vq:
            loss, (recon, aux) = vq_loss_fn(model, img, draws,
                                            state.generator,
                                            mesh if dp else None)
        else:
            loss, (recon, logits) = loss_fn(cfg, model, img, seg, draws,
                                            state.generator)
        params = list(model.parameters())
        grads = list(torch.autograd.grad(loss, params))
        # The VQ entries that are plain means of this rank's rows; the
        # others are the global batch's already.
        meaned = [k for k in ("vq_loss", "token_keep_frac")
                  if vq and k in aux]
        with torch.no_grad():
            loss = loss.detach()
            if dp:
                loss, err, *vals = all_reduce_mean_(
                    grads, mesh, [loss, mse(recon, img),
                                  *(aux[k].detach() for k in meaned)])
                if vq:
                    aux = {**aux, **dict(zip(meaned, vals))}
            clip_by_global_norm_(grads, cfg.train.grad_clip)
            for p, g in zip(params, grads):
                p.grad = g
            opt.step()
            opt.zero_grad(set_to_none=True)
            state.schedule.step()
            metrics = {"loss": loss, "psnr": (
                10.0 * torch.log10(1.0 / torch.clamp(err, min=1e-12)) if dp
                else psnr(recon, img))}
            if with_seg:
                pred = logits.argmax(dim=-1)
                if dp:
                    cm = confusion_matrix(pred, seg, cfg.camera.seg_classes)
                    torch.distributed.all_reduce(cm, group=mesh.data_group)
                    metrics["miou"] = miou_from_confusion(cm)
                else:
                    metrics["miou"] = miou(pred, seg, cfg.camera.seg_classes)
            if vq:
                metrics.update({k: aux[k].detach() for k in (
                    "vq_loss", "index_error_rate", "code_perplexity")})
            if vq and "vq_counts" in aux:
                # Dead codes jump to the batch's worst-quantised encoder
                # outputs, after the optimizer step; the coin the same on
                # every rank.
                coin = reseed_coin(aux["vq_counts"], state.generator,
                                   draws.coin, mesh if dp else None)
                new_cb, n_rs = reseed_dead_codes(
                    model.codebook, aux["vq_counts"], aux["vq_candidates"],
                    state.generator, cfg.camera.vq_reseed, coin=coin)
                model.codebook.copy_(new_cb)
                metrics["vq_reseeded"] = n_rs.float()
            if vq and "token_keep_frac" in aux:
                metrics["token_keep_frac"] = aux["token_keep_frac"]
        return state._replace(step=state.step + 1), metrics

    return train_step


def make_eval_step(cfg: ExperimentConfig):
    """``eval_step(model, img, generator=None, noise=None) -> psnr`` through
    the deployed channel (``channel.kind`` and its settings) at
    ``channel.snr_db``, full rate; a VQ codec over its digital link."""
    _check_ported(cfg)

    @torch.no_grad()
    def eval_step(model: CameraJSCC, img, generator=None, noise=None):
        if cfg.camera.arch == "vq":
            snr = torch.full((img.shape[0],), cfg.channel.snr_db,
                             device=img.device)
            recon, _ = model(img, snr, generator, noise=noise)
        else:
            recon, _ = reconstruct(cfg, model, img, cfg.channel.snr_db,
                                   generator, noise)
        return psnr(recon, img)

    return eval_step


def run(cfg: ExperimentConfig, metrics_path: Optional[str] = None,
        device="cuda"):
    """Train a config-1/2 preset for ``cfg.train.steps`` steps (resuming
    from ``train.checkpoint_dir`` when it holds a checkpoint); returns
    ``(state, result)``."""
    dev = resolve_device(device)
    tr = cfg.train
    init_distributed(dev)
    mesh = mesh_from_config(cfg.mesh)
    dp = mesh.data > 1
    lead = mesh.rank == 0
    state = create_train_state(cfg, tr.seed, dev)
    if dp:
        # The same network everywhere, each shard's draws of its own.
        replicate(mesh, state.params)
        state.generator.manual_seed(shard_seed(tr.seed, mesh.data_index))
    train_step = make_train_step(cfg, mesh)
    eval_step = make_eval_step(cfg)
    data = ImageDataset(tr.dataset, tr.batch_size, seed=tr.seed,
                        with_seg=_with_seg(cfg), device=dev,
                        data_root=tr.data_root)
    ckpt = None
    if tr.checkpoint_dir:
        ckpt = CheckpointManager(tr.checkpoint_dir)
        guard_world(ckpt, mesh.data)
        if lead:
            ckpt.save_config(cfg.to_json())
        restored = (restore_sharded(ckpt, state, mesh) if dp
                    else ckpt.restore_latest(state))
        if restored is not None:
            state = restored
    start = state.step
    if cfg.camera.arch == "vq" and start == 0:
        # A fresh VQ run seeds its codebook from the encoder's outputs on a
        # batch of a stream of its own; a resumed run keeps its codebook.
        init_img = next(ImageDataset(tr.dataset, tr.batch_size,
                                     seed=tr.seed + 777, device=dev,
                                     real_bank=data._real)).to(dev)
        init_codebook_from_batch(state.params, init_img, torch.Generator(
            device=dev).manual_seed((tr.seed * 0x9E3779B1 + 0xCB)
                                    & 0xFFFFFFFF))
        if dp:
            replicate(mesh, state.params.codebook)
    # The batches of an uninterrupted run from here on.
    data._step = start
    batches = prefetch_to_device(data, size=2, device=dev,
                                 mesh=mesh if dp else None)
    # The held-out batch comes from a stream of its own; each evaluation's
    # channel noise from a generator seeded by its step, apart from the
    # training stream's.
    eval_img = next(ImageDataset(tr.dataset, tr.batch_size, seed=tr.seed + 999,
                                 device=dev, real_bank=data._real))
    eval_img = eval_img.to(dev)
    eval_gen = torch.Generator(device=dev)
    writer = MetricsWriter(metrics_path if lead else None, stdout=lead,
                           config_json=cfg.to_json())
    watchdog = NaNWatchdog()

    # First-step wall (allocator warm-up, kernel build and load) recorded
    # apart from the steady rate; checkpoint writes apart from both.
    first_s = None
    ckpt_s = 0.0
    last = {}
    with maybe_trace(tr.profile_dir), Timer() as t:
        for step in range(start + 1, tr.steps + 1):
            t0 = time.perf_counter() if first_s is None else None
            state, last = train_step(state, next(batches))
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
            if ckpt and step % tr.checkpoint_every == 0:
                t_ck = time.perf_counter()
                if dp:
                    save_sharded(ckpt, step, state, mesh, ("generator",))
                else:
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

    ap = argparse.ArgumentParser(description="Train a camera JSCC preset.")
    ap.add_argument("--config", default="c1")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="config override, e.g. train.steps=200 (repeatable)")
    ap.add_argument("--metrics-path", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # The JAX package's refusals of flag combinations it would ignore.
    cfg = get_preset(args.config).override_str(args.set).validate()
    dev = resolve_device(args.device)
    init_distributed(dev)
    lead = not torch.distributed.is_initialized() or \
        torch.distributed.get_rank() == 0
    card = card_name(dev)
    if lead:
        print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    state, result = run(cfg, args.metrics_path, device=dev)
    if not lead:
        return 0
    result["train_wall_s"] = round(time.perf_counter() - t0, 2)
    result["train_steps"] = state.step
    result["card"] = card
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
