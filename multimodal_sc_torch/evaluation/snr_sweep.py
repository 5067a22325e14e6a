"""SNR-sweep JSCC evaluator: PSNR / SSIM / mIoU curves over the channel
kinds, the bandwidth curve of an adaptive-rate codec, and the LiDAR BEV
mIoU curve.

Counterpart of ``multimodal_sc_tpu/evaluation/snr_sweep.py`` (its camera,
rate and LiDAR sweeps, ``save_curves`` and ``format_table``) and of the
``eval`` verb's camera and fusion branches of ``multimodal_sc_tpu/cli.py``.
Each point averages ``batches_per_point`` channel draws; the draws of point
(kind ki, SNR si, batch b) come from a generator seeded by ``(seed, ki,
si, b)``, so a sweep is reproducible point by point. The digital camera
codec (``camera.arch=vq``) has its own two sweeps: over its link as
configured (one-shot, or Hamming-coded under ``channel.fec``) and under
Type-I HARQ (``--harq-sweep``), which also records the symbols each image
really cost. The kept-token and entropy-coded sweeps are ROADMAP item 14b.

As a script it sweeps the newest checkpoint of a trained preset:

    python -m multimodal_sc_torch.evaluation.snr_sweep --config c2 \\
        [--kinds awgn,rayleigh,rician] [--rate-sweep] [--allow-untrained] \\
        --set train.checkpoint_dir=DIR [--out curves.json] [--device cuda]

    python -m multimodal_sc_torch.evaluation.snr_sweep --config c1 \\
        --set camera.arch=vq [--set channel.fec=hamming74_soft] \\
        [--harq-sweep] --set train.checkpoint_dir=DIR ...

It restores the parameters only, evaluates one held-out batch (the images
of seed ``train.seed + 999``, as the JAX package's ``eval`` does), prints
the card and the tables, and refuses to sweep untrained weights unless
``--allow-untrained`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from multimodal_sc_torch.channel import channel as channel_op
from multimodal_sc_torch.evaluation.metrics import miou, psnr, ssim

DEFAULT_SNRS = tuple(range(-5, 26, 5))  # -5 .. 25 dB


def _generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (seed * 0x9E3779B1 + stream) & 0xFFFFFFFF)


@torch.no_grad()
def sweep_camera(model, images: torch.Tensor, seed: int = 0,
                 snrs_db: Sequence[float] = DEFAULT_SNRS,
                 kinds: Sequence[str] = ("awgn", "rayleigh"),
                 batches_per_point: int = 4,
                 seg: Optional[torch.Tensor] = None,
                 normalize: bool = True, modulation: int = 0,
                 pilots: int = 0, subcarriers: int = 64,
                 taps: int = 8) -> Dict[str, List[dict]]:
    """``{kind: [{snr_db, psnr, ssim[, miou]}]}`` of an image codec
    (``CameraJSCC`` or ``ViTJSCC``) at full rate; mIoU when the codec has a
    seg head and ``seg`` labels are given. The channel settings must mirror
    the training ``ChannelConfig`` so a model is evaluated over the channel
    it was deployed for."""
    from multimodal_sc_torch.train.jscc import transmit

    with_seg = seg is not None and getattr(model, "seg_classes", 0) > 0
    ch_kw = dict(normalize=normalize, modulation=modulation, pilots=pilots,
                 subcarriers=subcarriers, taps=taps)
    results: Dict[str, List[dict]] = {}
    for ki, kind in enumerate(kinds):
        curve = []
        for si, snr_db in enumerate(snrs_db):
            pv, sv, mv = [], [], []
            for b in range(batches_per_point):
                g = _generator(seed, ki * 100000 + si * 100 + b,
                               images.device)
                out, _ = transmit(model, images, float(snr_db), kind, g,
                                  with_seg=with_seg, **ch_kw)
                rec, logits = out if with_seg else (out, None)
                pv.append(float(psnr(rec, images)))
                sv.append(float(ssim(rec, images)))
                if with_seg:
                    mv.append(float(miou(logits.argmax(dim=-1), seg,
                                         model.seg_classes)))
            point = {"snr_db": float(snr_db), "psnr": float(np.mean(pv)),
                     "ssim": float(np.mean(sv))}
            if with_seg:
                point["miou"] = float(np.mean(mv))
            curve.append(point)
        results[kind] = curve
    return results


@torch.no_grad()
def sweep_camera_rate(model, images: torch.Tensor, seed: int = 0,
                      snr_db: float = 10.0, rates_sym: Sequence[int] = (),
                      kind: str = "awgn", batches_per_point: int = 4,
                      normalize: bool = True, modulation: int = 0,
                      pilots: int = 0, subcarriers: int = 64,
                      taps: int = 8) -> List[dict]:
    """PSNR / SSIM against the deployed bandwidth of an adaptive-rate codec:
    ``[{rate_sym, rate, psnr, ssim}]`` at every m/c_sym, m in ``rates_sym``
    (default 1..c_sym)."""
    from multimodal_sc_torch.train.jscc import transmit

    if not getattr(model, "adaptive_rate", False):
        raise ValueError("sweep_camera_rate requires an adaptive_rate codec")
    rates = tuple(rates_sym) or tuple(range(1, model.c_sym + 1))
    curve = []
    for ri, m in enumerate(rates):
        pv, sv = [], []
        for b in range(batches_per_point):
            g = _generator(seed, ri * 100 + b, images.device)
            rec, _ = transmit(model, images, float(snr_db), kind, g,
                              rate_sym=int(m), normalize=normalize,
                              modulation=modulation, pilots=pilots,
                              subcarriers=subcarriers, taps=taps)
            pv.append(float(psnr(rec, images)))
            sv.append(float(ssim(rec, images)))
        curve.append({"rate_sym": int(m), "rate": m / model.c_sym,
                      "psnr": float(np.mean(pv)), "ssim": float(np.mean(sv))})
    return curve


@torch.no_grad()
def sweep_lidar(model, points: torch.Tensor, mask: torch.Tensor,
                target: torch.Tensor, seed: int = 0,
                snrs_db: Sequence[float] = DEFAULT_SNRS,
                kinds: Sequence[str] = ("awgn", "rayleigh"),
                normalize: bool = True, modulation: int = 0, pilots: int = 0,
                subcarriers: int = 64, taps: int = 8
                ) -> Dict[str, List[dict]]:
    """``{kind: [{snr_db, miou}]}`` of the LiDAR BEV codec: binary
    occupancy (one logit, ``target`` a 0/1 grid) or semantic BEV
    (``model.seg_classes > 1``, ``target`` a class grid)."""
    n_classes = getattr(model, "seg_classes", 1)
    results: Dict[str, List[dict]] = {}
    for ki, kind in enumerate(kinds):
        curve = []
        for si, snr_db in enumerate(snrs_db):
            g = _generator(seed, ki * 100000 + si * 100, points.device)
            z = model.encode((points, mask))
            snr = torch.full((points.shape[0],), float(snr_db),
                             device=points.device)
            z_hat = channel_op(z, snr, kind, g, normalize=normalize,
                               modulation=modulation, pilots=pilots,
                               subcarriers=subcarriers, taps=taps)
            logits = model.decode(z_hat)
            if n_classes > 1:
                v = miou(logits.argmax(dim=-1), target.int(), n_classes)
            else:
                v = miou((logits[..., 0] > 0).int(), target.int(), 2)
            curve.append({"snr_db": float(snr_db), "miou": float(v)})
        results[kind] = curve
    return results


@torch.no_grad()
def sweep_camera_vq(cfg, model, images: torch.Tensor, seed: int = 0,
                    snrs_db: Sequence[float] = DEFAULT_SNRS,
                    kinds: Sequence[str] = ("awgn", "rayleigh"),
                    batches_per_point: int = 4) -> Dict[str, List[dict]]:
    """``{kind: [{snr_db, psnr, ssim, index_err}]}`` of a ``VQCameraJSCC``
    over its digital link as ``cfg.channel`` configures it (FEC included),
    the kind overridden per curve."""
    results: Dict[str, List[dict]] = {}
    for ki, kind in enumerate(kinds):
        ch = cfg.override_str([f"channel.kind={kind}"]).channel
        curve = []
        for si, snr_db in enumerate(snrs_db):
            snr = torch.full((images.shape[0],), float(snr_db),
                             device=images.device)
            pv, sv, ev = [], [], []
            for b in range(batches_per_point):
                g = _generator(seed, ki * 100000 + si * 100 + b,
                               images.device)
                rec, aux = model(images, snr, g, ch=ch)
                pv.append(float(psnr(rec, images)))
                sv.append(float(ssim(rec, images)))
                ev.append(float(aux["index_error_rate"]))
            curve.append({"snr_db": float(snr_db),
                          "psnr": float(np.mean(pv)),
                          "ssim": float(np.mean(sv)),
                          "index_err": float(np.mean(ev))})
        results[kind] = curve
    return results


@torch.no_grad()
def sweep_camera_vq_harq(cfg, model, images: torch.Tensor, seed: int = 0,
                         snrs_db: Sequence[float] = DEFAULT_SNRS,
                         kinds: Sequence[str] = ("awgn", "rayleigh"),
                         batches_per_point: int = 4, max_rounds: int = 4,
                         block_bits: int = 64, crc_bits: int = 8
                         ) -> Dict[str, List[dict]]:
    """Type-I HARQ curves of a ``VQCameraJSCC``: ``{kind: [{snr_db, psnr,
    ssim, index_err, symbols_per_item, mean_rounds, residual_fail_rate,
    oneshot_symbols}]}``, the uncoded index bits in CRC-8 blocks over the
    channel's defaults (no pilots), as the JAX package's sweep sends
    them."""
    from multimodal_sc_torch.channel.digital import (bits_from_indices,
                                                     indices_from_bits)
    from multimodal_sc_torch.channel.harq import harq_transmit

    codes = cfg.camera.vq_codes
    idx_tx = model.encode_tokens(images)[0]
    bits = bits_from_indices(idx_tx, codes)
    results: Dict[str, List[dict]] = {}
    for ki, kind in enumerate(kinds):
        curve = []
        for si, snr_db in enumerate(snrs_db):
            snr = torch.full((images.shape[0],), float(snr_db),
                             device=images.device)
            acc: Dict[str, list] = {}
            for b in range(batches_per_point):
                g = _generator(seed, ki * 100000 + si * 100 + b,
                               images.device)
                bits_rx, info = harq_transmit(
                    bits, snr, kind, g, block_bits=block_bits,
                    crc_bits=crc_bits, max_rounds=max_rounds)
                idx_rx = indices_from_bits(bits_rx, codes)
                rec = model.decode_tokens(idx_rx)
                for name, v in (("psnr", psnr(rec, images)),
                                ("ssim", ssim(rec, images)),
                                ("index_err",
                                 (idx_rx != idx_tx).float().mean()),
                                *info.items()):
                    acc.setdefault(name, []).append(float(v))
            curve.append({"snr_db": float(snr_db),
                          **{k: float(np.mean(v)) for k, v in acc.items()}})
        results[kind] = curve
    return results


def format_harq_table(curves: Dict[str, List[dict]]) -> str:
    """The ``--harq-sweep`` table, as the JAX package's ``eval`` prints
    it."""
    lines = []
    for kind, curve in curves.items():
        lines.append(f"{kind}: {'snr':>6} {'psnr':>8} {'idx_err':>9} "
                     f"{'sym/img':>9} {'rounds':>7} {'fail':>7}")
        for p in curve:
            lines.append(f"      {p['snr_db']:>6.1f} {p['psnr']:>8.2f} "
                         f"{p['index_err']:>9.4f} "
                         f"{p['symbols_per_item']:>9.1f} "
                         f"{p['mean_rounds']:>7.2f} "
                         f"{p['residual_fail_rate']:>7.4f}")
    return "\n".join(lines)


def save_curves(curves: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(curves, f, indent=2)


def format_table(curves: Dict[str, List[dict]], metric: str = "psnr") -> str:
    lines = [f"{'snr_db':>8} " + " ".join(f"{k:>10}" for k in curves)]
    snrs = [p["snr_db"] for p in next(iter(curves.values()))]
    for i, s in enumerate(snrs):
        row = f"{s:>8.1f} " + " ".join(
            f"{curves[k][i][metric]:>10.3f}" for k in curves)
        lines.append(row)
    return "\n".join(lines)


def _restore(cfg, module, allow_untrained: bool):
    """The newest checkpoint's parameters into ``module``; without one, a
    hard error unless ``allow_untrained`` (then the fresh weights, with a
    warning)."""
    from multimodal_sc_torch.io.checkpoint import CheckpointManager

    if cfg.train.checkpoint_dir:
        mgr = CheckpointManager(cfg.train.checkpoint_dir)
        if mgr.restore_params_latest(module) is not None:
            print(f"restored step {mgr.latest_step()} from "
                  f"{cfg.train.checkpoint_dir}", file=sys.stderr)
            return module
    if allow_untrained:
        print("warning: no checkpoint found (train.checkpoint_dir="
              f"{cfg.train.checkpoint_dir!r}): using UNTRAINED init params "
              "(--allow-untrained)", file=sys.stderr)
        return module
    raise SystemExit(
        "error: no checkpoint found at train.checkpoint_dir="
        f"{cfg.train.checkpoint_dir!r}; evaluating untrained params is "
        "almost never intended: train first, fix the path, or pass "
        "--allow-untrained to evaluate a fresh init")


def _sweep_fusion(cfg, args, kinds, dev) -> dict:
    from multimodal_sc_torch.channel import channel_kwargs
    from multimodal_sc_torch.envs.datasets import (ImageDataset,
                                                   draw_pointcloud,
                                                   synthetic_pointcloud_batch)
    from multimodal_sc_torch.train import fusion_jscc

    tr, lid = cfg.train, cfg.lidar
    model = fusion_jscc.create_train_state(cfg, tr.seed, dev).params
    _restore(cfg, model, args.allow_untrained)
    model.eval()
    images = next(ImageDataset(tr.dataset, tr.batch_size, seed=tr.seed + 999,
                               device=dev, data_root=tr.data_root)).to(dev)
    pts, mask, cls = synthetic_pointcloud_batch(
        draw_pointcloud(tr.batch_size, lid.max_points,
                        _generator(tr.seed, 0xE7A1, dev), dev, lid.x_range,
                        lid.y_range),
        lid.x_range, lid.y_range, with_classes=True)
    target = fusion_jscc.bev_target(cfg, pts, mask, cls)
    ch_kw = channel_kwargs(cfg.channel)
    cam = sweep_camera(model.camera, images, tr.seed, kinds=kinds, **ch_kw)
    lidar = sweep_lidar(model.lidar, pts, mask, target, tr.seed + 0x11DA,
                        kinds=kinds, **ch_kw)
    print("camera PSNR:")
    print(format_table(cam))
    print("camera SSIM:")
    print(format_table(cam, metric="ssim"))
    print("lidar BEV mIoU:")
    print(format_table(lidar, metric="miou"))
    return {"camera": cam, "lidar": lidar}


def main(argv=None) -> int:
    from multimodal_sc_torch.channel import channel_kwargs
    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.device import card_name, resolve_device
    from multimodal_sc_torch.envs.datasets import ImageDataset
    from multimodal_sc_torch.train import jscc

    ap = argparse.ArgumentParser(
        description="SNR-sweep evaluation of a trained JSCC preset.")
    ap.add_argument("--config", required=True)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="config override, e.g. train.checkpoint_dir=DIR")
    ap.add_argument("--out", default=None, help="curve JSON output path")
    ap.add_argument("--rate-sweep", action="store_true",
                    help="PSNR against bandwidth instead of SNR (adaptive-"
                         "rate camera configs; at channel.snr_db over the "
                         "first of --kinds)")
    ap.add_argument("--harq-sweep", action="store_true",
                    help="VQ camera configs: PSNR and the symbols spent "
                         "under Type-I HARQ (CRC-8 blocks, chase "
                         "combining) against SNR")
    ap.add_argument("--keep-sweep", action="store_true",
                    help="VQ camera configs: PSNR against the kept-token "
                         "fraction (not ported yet)")
    ap.add_argument("--allow-untrained", action="store_true",
                    help="sweep fresh weights when no checkpoint exists")
    ap.add_argument("--kinds", default="awgn,rayleigh",
                    help="comma list of channel kinds to sweep")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_preset(args.config).override_str(args.set)
    dev = resolve_device(args.device)
    print(f"card: {card_name(dev)}", flush=True)
    kinds = tuple(k.strip() for k in args.kinds.split(","))
    tr = cfg.train

    if tr.task == "jscc_fusion":
        curves = _sweep_fusion(cfg, args, kinds, dev)
    else:
        model = jscc.create_train_state(cfg, tr.seed, dev).params
        _restore(cfg, model, args.allow_untrained)
        model.eval()
        with_seg = jscc._with_seg(cfg)
        batch = next(ImageDataset(tr.dataset, tr.batch_size,
                                  seed=tr.seed + 999, with_seg=with_seg,
                                  device=dev, data_root=tr.data_root))
        images, seg = batch if with_seg else (batch, None)
        images = images.to(dev)
        ch_kw = channel_kwargs(cfg.channel)
        if cfg.camera.arch == "vq" and args.keep_sweep:
            raise NotImplementedError(
                "--keep-sweep (token pruning) is not ported yet (ROADMAP "
                "item 14b)")
        if cfg.camera.arch == "vq" and args.harq_sweep:
            curves = sweep_camera_vq_harq(cfg, model, images, tr.seed,
                                          kinds=kinds)
            print(format_harq_table(curves))
        elif cfg.camera.arch == "vq":
            curves = sweep_camera_vq(cfg, model, images, tr.seed,
                                     kinds=kinds)
            print(format_table(curves))
            print(format_table(curves, metric="index_err"))
        elif args.rate_sweep:
            if not cfg.camera.adaptive_rate:
                print("--rate-sweep requires camera.adaptive_rate=true",
                      file=sys.stderr)
                return 2
            kind = kinds[0]
            curve = sweep_camera_rate(model, images, tr.seed,
                                      snr_db=cfg.channel.snr_db, kind=kind,
                                      **ch_kw)
            print(f"{'rate':>8} {'psnr':>10} {'ssim':>10}   ({kind} @ "
                  f"{cfg.channel.snr_db} dB)")
            for p in curve:
                print(f"{p['rate']:>8.3f} {p['psnr']:>10.3f} "
                      f"{p['ssim']:>10.3f}")
            curves = {kind: curve}
        else:
            curves = sweep_camera(model, images, tr.seed, kinds=kinds,
                                  seg=seg, **ch_kw)
            print(format_table(curves))
            print(format_table(curves, metric="ssim"))
            if with_seg:
                print(format_table(curves, metric="miou"))
    if args.out:
        save_curves(curves, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
