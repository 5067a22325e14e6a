"""SNR-sweep JSCC evaluator: PSNR / SSIM / mIoU curves over the channel
kinds, the bandwidth curve of an adaptive-rate codec, and the LiDAR BEV
mIoU curve.

Counterpart of ``multimodal_sc_tpu/evaluation/snr_sweep.py`` (its camera,
rate and LiDAR sweeps, ``save_curves`` and ``format_table``) and of the
``eval`` verb's camera and fusion branches of ``multimodal_sc_tpu/cli.py``.
Each point averages ``batches_per_point`` channel draws; the draws of point
(kind ki, SNR si, batch b) come from a generator seeded by ``(seed, ki,
si, b)``, so a sweep is reproducible point by point; a VQ point's token
selection and UEP draws come from a second generator of the point, so
its deployments meet the same channel noise. The digital camera
codec (``camera.arch=vq``) has sweeps of its own: over its link as
configured (one-shot, or Hamming-coded under ``channel.fec``) and under
Type-I HARQ (``--harq-sweep``), which also records the symbols each image
really cost, and, for a ``camera.vq_prune`` model, over the kept-token
fraction under each selection rule (``--keep-sweep``). The digital LiDAR
codec (``lidar.arch=vq``) has its SNR sweep with index errors, the kept-token
sweep of a ``lidar.vq_prune`` model (``--keep-sweep``) and the
entropy-coded transport sweep (``--entropy-sweep``: fixed-length, Huffman
and re-alphabet deployments of one checkpoint).

As a script it sweeps the newest checkpoint of a trained preset:

    python -m multimodal_sc_torch.evaluation.snr_sweep --config c2 \\
        [--kinds awgn,rayleigh,rician] [--rate-sweep] [--allow-untrained] \\
        --set train.checkpoint_dir=DIR [--out curves.json] [--device cuda]

    python -m multimodal_sc_torch.evaluation.snr_sweep --config c1 \\
        --set camera.arch=vq [--set channel.fec=hamming74_soft] \\
        [--set channel.uep_alpha=0.25] [--harq-sweep] \\
        [--keep-sweep --set camera.vq_prune=true] \\
        --set train.checkpoint_dir=DIR ...

    python -m multimodal_sc_torch.evaluation.snr_sweep --config c3 \\
        --set lidar.arch=vq [--set channel.fec=hamming74_soft] \\
        [--entropy-sweep | --keep-sweep --set lidar.vq_prune=true] \\
        --set train.checkpoint_dir=DIR ...

``python -m multimodal_sc_torch.cli eval`` runs the same flags and body
(:func:`add_arguments`, :func:`run_command`). It restores the parameters
only, evaluates one held-out batch (the images
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
DEFAULT_KEEPS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 1.0)


def _generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (seed * 0x9E3779B1 + stream) & 0xFFFFFFFF)


def _side_generator(seed: int, stream: int, device) -> torch.Generator:
    """The token selection's and UEP's draws of a point, apart from its
    channel noise: every deployment of the point (each selection rule,
    with or without UEP) meets the same noise, as the JAX package's
    ``fold_in`` keys pair them."""
    return _generator(seed, stream + (88 << 24), device)


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
            v = bev_miou(model.decode(z_hat), target, n_classes)
            curve.append({"snr_db": float(snr_db), "miou": float(v)})
        results[kind] = curve
    return results


def bev_miou(logits: torch.Tensor, target: torch.Tensor,
             n_classes: int) -> torch.Tensor:
    """mIoU of BEV logits (B, H, W, C): the argmax class against a class
    grid (``n_classes > 1``), else the one logit's sign against a 0/1
    grid."""
    if n_classes > 1:
        return miou(logits.argmax(dim=-1), target.int(), n_classes)
    return miou((logits[..., 0] > 0).int(), target.int(), 2)


@torch.no_grad()
def sweep_lidar_vq(cfg, model, points: torch.Tensor, mask: torch.Tensor,
                   target: torch.Tensor, seed: int = 0,
                   snrs_db: Sequence[float] = DEFAULT_SNRS,
                   kinds: Sequence[str] = ("awgn", "rayleigh"),
                   batches_per_point: int = 4) -> Dict[str, List[dict]]:
    """``{kind: [{snr_db, miou, index_err}]}`` of a ``LidarBEVVQCodec``
    over its digital link as ``cfg.channel`` configures it (FEC
    included), the kind overridden per curve."""
    results: Dict[str, List[dict]] = {}
    for ki, kind in enumerate(kinds):
        ch = cfg.override_str([f"channel.kind={kind}"]).channel
        curve = []
        for si, snr_db in enumerate(snrs_db):
            snr = torch.full((points.shape[0],), float(snr_db),
                             device=points.device)
            mv, ev = [], []
            for b in range(batches_per_point):
                g = _generator(seed, ki * 100000 + si * 100 + b,
                               points.device)
                logits, aux = model(points, mask, snr, g, ch=ch)
                mv.append(float(bev_miou(logits, target,
                                         cfg.lidar.seg_classes)))
                ev.append(float(aux["index_error_rate"]))
            curve.append({"snr_db": float(snr_db),
                          "miou": float(np.mean(mv)),
                          "index_err": float(np.mean(ev))})
        results[kind] = curve
    return results


@torch.no_grad()
def sweep_lidar_vq_keep(cfg, model, points: torch.Tensor, mask: torch.Tensor,
                        target: torch.Tensor, seed: int = 0,
                        keeps: Sequence[float] = DEFAULT_KEEPS,
                        selects: Sequence[str] = (
                            "scatter", "random", "drop_damage",
                            "drop_damage_scatter"),
                        batches_per_point: int = 4) -> Dict[str, List[dict]]:
    """``{select: [{keep, miou, keep_frac_actual}]}`` of a pruned digital
    BEV codec (``lidar.vq_prune``) at ``cfg.channel``'s kind and SNR, one
    curve a selection rule. As the JAX package reports it,
    ``keep_frac_actual`` is the kept fraction of the point's LAST batch,
    not a mean over its batches (every batch keeps the same count, so they
    agree)."""
    snr = torch.full((points.shape[0],), cfg.channel.snr_db,
                     device=points.device)
    results: Dict[str, List[dict]] = {}
    for sel_i, select in enumerate(selects):
        curve = []
        for ki, keep in enumerate(keeps):
            kv = torch.full((points.shape[0],), float(keep),
                            device=points.device)
            mv = []
            for b in range(batches_per_point):
                stream = sel_i * 100000 + ki * 100 + b
                logits, aux = model(
                    points, mask, snr,
                    _generator(seed, stream, points.device), keep=kv,
                    select=select, side_generator=_side_generator(
                        seed, stream, points.device))
                mv.append(float(bev_miou(logits, target,
                                         cfg.lidar.seg_classes)))
            curve.append({"keep": float(keep), "miou": float(np.mean(mv)),
                          "keep_frac_actual": float(aux["token_keep_frac"])})
        results[select] = curve
    return results


@torch.no_grad()
def sweep_lidar_vq_entropy(cfg, model, points: torch.Tensor,
                           mask: torch.Tensor, target: torch.Tensor,
                           seed: int = 0,
                           snrs_db: Sequence[float] = DEFAULT_SNRS,
                           kinds: Sequence[str] = ("awgn", "rayleigh"),
                           batches_per_point: int = 4,
                           keep_codes: int = 16) -> Dict:
    """Entropy-aware index transport of one digital BEV checkpoint, three
    deployments a point: ``full`` (the fixed 8-bit link), ``vlc``
    (canonical Huffman on the code histogram, zero-power padding, decoded
    on the host by ``decode_vlc_np``) and ``fixed`` (the top-``keep_codes``
    re-alphabet over the fixed link). The histogram is calibrated on the
    evaluation batch itself. Returns ``{"calibration": {...}, kind: [{snr_db,
    miou_*, index_err_*, syms_*, bits_per_token_vlc}]}``; a point's draws
    come from one generator, in the order full, VLC, fixed."""
    from multimodal_sc_torch.channel import channel_kwargs
    from multimodal_sc_torch.channel.digital import qpsk_to_bits
    from multimodal_sc_torch.channel.entropy_coding import (build_huffman,
                                                           decode_vlc_np,
                                                           encode_vlc,
                                                           entropy_bits,
                                                           topk_remap,
                                                           vlc_symbols)
    from multimodal_sc_torch.codec.semantic_vq import transmit_indices

    dev = points.device
    codes, n_classes = cfg.lidar.vq_codes, cfg.lidar.seg_classes
    idx_tx = model.encode_tokens(points, mask)[0]
    n_tok = idx_tx.shape[1]
    probs = (np.bincount(idx_tx.cpu().numpy().ravel(), minlength=codes)
             / idx_tx.numel())
    codec = build_huffman(probs, dev)
    kept, full_to_small, _ = topk_remap(probs, model.codebook, keep_codes,
                                        dev)
    nz = probs[probs > 0]
    calibration = {
        "entropy_bits_per_token": entropy_bits(probs),
        "huffman_mean_bits_per_token": float(np.sum(
            probs * codec.code_len.cpu().numpy())),
        "code_perplexity": float(np.exp(-np.sum(nz * np.log(nz)))),
        "keep_codes": int(keep_codes),
        "topk_mass": float(np.sort(probs)[::-1][:keep_codes].sum()),
        "fixed_bits_per_token": float(np.log2(codes))}
    bits_tx, total = encode_vlc(codec, idx_tx)
    sym_vlc = vlc_symbols(bits_tx, total)
    small_tx = full_to_small[idx_tx.long()]
    fixed_tx = kept[small_tx.long()]

    def scored(idx_rx, idx_ref):
        logits = model.decode_tokens(idx_rx)
        return (float(bev_miou(logits, target, n_classes)),
                float((idx_rx != idx_ref).float().mean()))

    results: Dict = {"calibration": calibration}
    for ki, kind in enumerate(kinds):
        ch = cfg.override_str([f"channel.kind={kind}"]).channel
        ch_kw = channel_kwargs(ch)
        ch_kw.update(normalize=False, modulation=0)
        curve = []
        for si, snr_db in enumerate(snrs_db):
            snr = torch.full((points.shape[0],), float(snr_db), device=dev)
            acc: Dict[str, list] = {}
            for b in range(batches_per_point):
                g = _generator(seed, ki * 100000 + si * 100 + b, dev)
                rx_full = transmit_indices(ch, idx_tx, codes, snr, g)
                y = channel_op(sym_vlc, snr, kind, g, **ch_kw)
                small_rx = transmit_indices(ch, small_tx, keep_codes, snr, g)
                rx_vlc = torch.as_tensor(decode_vlc_np(
                    codec, qpsk_to_bits(y), total, n_tok), device=dev)
                row = {}
                row["miou_full"], row["index_err_full"] = scored(rx_full,
                                                                 idx_tx)
                row["syms_vlc"] = float(torch.ceil(total / 2.0).mean())
                row["bits_per_token_vlc"] = float(total.float().mean()
                                                  / n_tok)
                row["miou_fixed"], row["index_err_fixed"] = scored(
                    kept[small_rx.long()], fixed_tx)
                row["miou_vlc"], row["index_err_vlc"] = scored(rx_vlc,
                                                               idx_tx)
                for name, v in row.items():
                    acc.setdefault(name, []).append(v)
            point = {"snr_db": float(snr_db)}
            point.update({name: float(np.mean(v)) for name, v in acc.items()})
            point["syms_full"] = n_tok * float(np.log2(codes)) / 2
            point["syms_fixed"] = n_tok * float(np.log2(keep_codes)) / 2
            curve.append(point)
        results[kind] = curve
    return results


@torch.no_grad()
def sweep_camera_vq(cfg, model, images: torch.Tensor, seed: int = 0,
                    snrs_db: Sequence[float] = DEFAULT_SNRS,
                    kinds: Sequence[str] = ("awgn", "rayleigh"),
                    batches_per_point: int = 4) -> Dict[str, List[dict]]:
    """``{kind: [{snr_db, psnr, ssim, index_err}]}`` of a ``VQCameraJSCC``
    over its digital link as ``cfg.channel`` configures it (FEC and UEP
    included), the kind overridden per curve."""
    results: Dict[str, List[dict]] = {}
    for ki, kind in enumerate(kinds):
        ch = cfg.override_str([f"channel.kind={kind}"]).channel
        curve = []
        for si, snr_db in enumerate(snrs_db):
            snr = torch.full((images.shape[0],), float(snr_db),
                             device=images.device)
            pv, sv, ev = [], [], []
            for b in range(batches_per_point):
                stream = ki * 100000 + si * 100 + b
                rec, aux = model(images, snr,
                                 _generator(seed, stream, images.device),
                                 ch=ch, side_generator=_side_generator(
                                     seed, stream, images.device))
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
def sweep_camera_vq_keep(cfg, model, images: torch.Tensor, seed: int = 0,
                         keeps: Sequence[float] = DEFAULT_KEEPS,
                         selects: Sequence[str] = (
                             "drop_damage", "random", "scatter",
                             "drop_damage_scatter"),
                         batches_per_point: int = 4
                         ) -> Dict[str, List[dict]]:
    """``{select: [{keep, psnr, ssim, index_err}]}`` of a token-pruned
    ``VQCameraJSCC`` (``camera.vq_prune``) deployed at every kept fraction
    at ``cfg.channel``'s kind and SNR, one curve a selection rule."""
    if not cfg.camera.vq_prune:
        raise ValueError("sweep_camera_vq_keep requires camera.vq_prune")
    snr = torch.full((images.shape[0],), cfg.channel.snr_db,
                     device=images.device)
    results: Dict[str, List[dict]] = {}
    for si, select in enumerate(selects):
        curve = []
        for ki, keep in enumerate(keeps):
            kv = torch.full((images.shape[0],), float(keep),
                            device=images.device)
            pv, sv, ev = [], [], []
            for b in range(batches_per_point):
                stream = si * 100000 + ki * 100 + b
                rec, aux = model(
                    images, snr, _generator(seed, stream, images.device),
                    ch=cfg.channel, keep=kv, select=select,
                    side_generator=_side_generator(seed, stream,
                                                   images.device))
                pv.append(float(psnr(rec, images)))
                sv.append(float(ssim(rec, images)))
                ev.append(float(aux["index_error_rate"]))
            curve.append({"keep": float(keep), "psnr": float(np.mean(pv)),
                          "ssim": float(np.mean(sv)),
                          "index_err": float(np.mean(ev))})
        results[select] = curve
    return results


def format_keep_table(curves: Dict[str, List[dict]]) -> str:
    """The camera ``--keep-sweep`` table, as the JAX package's ``eval``
    prints it."""
    lines = [f"{'keep':>8} " + " ".join(
        f"{s + '/psnr':>14} {s + '/idx_err':>14}" for s in curves)]
    for i, p in enumerate(next(iter(curves.values()))):
        lines.append(f"{p['keep']:>8.3f} " + " ".join(
            f"{curves[s][i]['psnr']:>14.3f} "
            f"{curves[s][i]['index_err']:>14.4f}" for s in curves))
    return "\n".join(lines)


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
    if args.keep_sweep:
        if not lid.vq_prune:
            print("--keep-sweep on the fusion task requires "
                  "lidar.vq_prune=true", file=sys.stderr)
            return None
        curves = sweep_lidar_vq_keep(cfg, model.lidar, pts, mask, target,
                                     tr.seed + 0x6EEB)
        for sel, rows in curves.items():
            print(f"select={sel}:")
            for row in rows:
                print(json.dumps(row))
        return curves
    if args.entropy_sweep:
        if lid.arch != "vq":
            print("--entropy-sweep requires lidar.arch=vq", file=sys.stderr)
            return None
        curves = sweep_lidar_vq_entropy(cfg, model.lidar, pts, mask, target,
                                        tr.seed + 0xE27, kinds=kinds)
        print(json.dumps(curves["calibration"]))
        for kind in kinds:
            print(f"{kind}: mIoU full/vlc/fixed + syms:")
            for row in curves[kind]:
                print(json.dumps(row))
        return curves
    ch_kw = channel_kwargs(cfg.channel)
    cam = sweep_camera(model.camera, images, tr.seed, kinds=kinds, **ch_kw)
    if lid.arch == "vq":
        # The digital link rides inside the codec: its own sweep.
        lidar = sweep_lidar_vq(cfg, model.lidar, pts, mask, target,
                               tr.seed + 0x11DA, kinds=kinds)
    else:
        lidar = sweep_lidar(model.lidar, pts, mask, target, tr.seed + 0x11DA,
                            kinds=kinds, **ch_kw)
    print("camera PSNR:")
    print(format_table(cam))
    print("camera SSIM:")
    print(format_table(cam, metric="ssim"))
    print("lidar BEV mIoU:")
    print(format_table(lidar, metric="miou"))
    if lid.arch == "vq":
        print("lidar index error rate:")
        print(format_table(lidar, metric="index_err"))
    return {"camera": cam, "lidar": lidar}


def add_arguments(ap) -> None:
    """The ``eval`` verb's flags, shared by this module's script and
    ``multimodal_sc_torch.cli`` (the JAX package's ``eval`` flags)."""
    ap.add_argument("--out", default=None, help="curve JSON output path")
    ap.add_argument("--rate-sweep", action="store_true", dest="rate_sweep",
                    help="PSNR against bandwidth instead of SNR (adaptive-"
                         "rate camera configs; at channel.snr_db over the "
                         "first of --kinds)")
    ap.add_argument("--allow-untrained", action="store_true",
                    dest="allow_untrained",
                    help="sweep fresh weights when no checkpoint exists")
    ap.add_argument("--harq-sweep", action="store_true", dest="harq_sweep",
                    help="VQ camera configs: PSNR and the symbols spent "
                         "under Type-I HARQ (CRC-8 blocks, chase "
                         "combining) against SNR")
    ap.add_argument("--entropy-sweep", action="store_true",
                    dest="entropy_sweep",
                    help="digital LiDAR configs (lidar.arch=vq): mIoU and "
                         "symbols of the fixed-length, Huffman and "
                         "re-alphabet deployments against SNR")
    ap.add_argument("--keep-sweep", action="store_true", dest="keep_sweep",
                    help="pruned VQ configs (camera.vq_prune, or "
                         "lidar.vq_prune on c3): PSNR or mIoU against the "
                         "kept-token fraction under each selection rule")
    ap.add_argument("--kinds", default="awgn,rayleigh",
                    help="comma list of channel kinds to sweep "
                         "(awgn,rayleigh,rician,ideal)")


def run_command(cfg, args, dev) -> int:
    """The ``eval`` verb on a validated ``cfg`` and the parsed flags of
    :func:`add_arguments`, on ``dev``: prints the tables, writes
    ``--out``; returns the exit code."""
    from multimodal_sc_torch.channel import channel_kwargs
    from multimodal_sc_torch.envs.datasets import ImageDataset
    from multimodal_sc_torch.train import jscc

    kinds = tuple(k.strip() for k in args.kinds.split(","))
    tr = cfg.train

    if tr.task == "jscc_fusion":
        curves = _sweep_fusion(cfg, args, kinds, dev)
        if curves is None:
            return 2
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
        if cfg.camera.arch == "vq" and args.harq_sweep:
            curves = sweep_camera_vq_harq(cfg, model, images, tr.seed,
                                          kinds=kinds)
            print(format_harq_table(curves))
        elif cfg.camera.arch == "vq" and args.keep_sweep:
            if not cfg.camera.vq_prune:
                print("--keep-sweep requires camera.vq_prune=true",
                      file=sys.stderr)
                return 2
            curves = sweep_camera_vq_keep(cfg, model, images, tr.seed)
            print(format_keep_table(curves))
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


def main(argv=None) -> int:
    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.device import card_name, resolve_device

    ap = argparse.ArgumentParser(
        description="SNR-sweep evaluation of a trained JSCC preset.")
    ap.add_argument("--config", required=True)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="config override, e.g. train.checkpoint_dir=DIR")
    add_arguments(ap)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # The JAX package's refusals of flag combinations it would ignore.
    cfg = get_preset(args.config).override_str(args.set).validate()
    dev = resolve_device(args.device)
    print(f"card: {card_name(dev)}", flush=True)
    return run_command(cfg, args, dev)


if __name__ == "__main__":
    sys.exit(main())
