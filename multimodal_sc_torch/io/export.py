"""Deployment export: trained codecs and policies as standalone artifacts.

Counterpart of ``multimodal_sc_tpu/io/export.py``. Semantic communication
deploys asymmetrically: the TRANSMITTER carries only the encoder (sensor
frame -> channel symbols), the RECEIVER only the decoder (noisy symbols ->
reconstruction / segmentation), and the driving agent deploys the greedy
policy. Each part is serialized with ``torch.export`` as a self-contained
program (``<part>.pt2``): the trained weights baked in, batch-size
polymorphic (one ``torch.export.Dim("b")`` shared by every input;
``batch=N`` fixes the size instead), so a deployment target runs it with
nothing but torch installed: no framework code, no module tree, no
checkpoint plumbing (:func:`load_artifact`).

The physical channel is deliberately NOT part of a codec artifact: it is
the medium between the two ends (the receiver consumes whatever symbols
arrive). A policy carries its trunk's simulated links, as the JAX
package's does; their noise is drawn from the device's default generator,
which the loaded policy seeds from its ``seed`` argument.

By design an artifact runs the PLAIN PyTorch versions of the hand-written
CUDA kernels, as the JAX package's artifacts run the XLA twins of its
Pallas kernels: :func:`_portable` turns the execution flags off
(``mha_block_kernel``, ``use_pallas``, ``pallas_attention``; the packed
parameter tree of ``pallas_mha_block`` stays as trained) and each part is
traced from a CPU copy of the module, where every kernel wrapper takes its
plain version. One artifact thus serves the CPU and the card
(:func:`load_artifact` moves it), and runs slower on the card than the
live module with its kernels.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional

import torch
from torch import nn

from multimodal_sc_torch.config.configs import ExperimentConfig

PLATFORMS = ("cpu", "cuda")
MANIFEST = "manifest.json"
FORMAT = "torch.export/pt2"
# The rows of the example inputs a part is traced on: a symbolic batch
# needs two or more (a size of 1 would be specialised).
TRACE_BATCH = 2


def _portable(cfg: ExperimentConfig) -> ExperimentConfig:
    """Execution-flag overrides for export: the plain versions everywhere.

    ``pallas_mha_block`` stays as trained (it shapes the parameter tree);
    ``mha_block_kernel=False`` routes execution through the plain version.
    ``use_pallas`` and ``pallas_attention`` are pure execution flags."""
    return cfg.override(mha_block_kernel=False, use_pallas=False,
                        pallas_attention=False)


def _cpu_copy(build: Callable[[], nn.Module], trained: nn.Module
              ) -> nn.Module:
    """``build()`` on the CPU with ``trained``'s weights, in eval mode. The
    fresh weights ``build`` draws leave the global generator as it was."""
    with torch.random.fork_rng(devices=[]):
        module = build()
    module.load_state_dict({k: v.detach().cpu()
                            for k, v in trained.state_dict().items()})
    return module.eval()


class _Part(nn.Module):
    """One exported function of a module: ``fn(module, *inputs)``."""

    def __init__(self, module: nn.Module, fn: Callable):
        super().__init__()
        self.module = module
        self.fn = fn

    def forward(self, *inputs):
        return self.fn(self.module, *inputs)


def _export(module: nn.Module, fn: Callable, inputs, batch: Optional[int]
            ) -> torch.export.ExportedProgram:
    """``fn(module, *inputs)`` as an exported program, the leading dim of
    every input one shared symbol unless ``batch`` fixes it.

    One eager call comes first, its draws on a forked generator: it fills
    the module-level caches (CRC tables, the farthest-point order) with
    real tensors before the trace reads them."""
    part = _Part(module, fn)
    with torch.no_grad(), torch.random.fork_rng(devices=[]):
        part(*inputs)
    dims = None
    if batch is None:
        b = torch.export.Dim("b", min=1)
        # One entry, for ``_Part.forward``'s ``*inputs``.
        dims = (tuple({0: b} for _ in inputs),)
    return torch.export.export(part, tuple(inputs), dynamic_shapes=dims)


def _rows(batch: Optional[int]) -> int:
    return TRACE_BATCH if batch is None else batch


def export_camera_codec(cfg: ExperimentConfig, model: nn.Module,
                        batch: Optional[int] = None,
                        model_builder: Optional[Callable] = None,
                        ) -> Dict[str, torch.export.ExportedProgram]:
    """Export the camera JSCC codec ``model`` (configs 1-3's camera).

    Returns ``{"encoder": ..., "decoder": ...}`` plus ``"decoder_seg"``
    when the codec has a segmentation head. Each takes ``(x, snr_db)``
    with ``snr_db`` shaped ``(b,)``: per-example SNR, the training-time
    channel conditioning. The VQ codec (``camera.arch="vq"``) exports
    ``img -> int32 (b, n_tokens)`` indices and ``indices -> image``, with
    no SNR input: the digital radio between the halves handles modulation
    and FEC. ``model_builder`` (called with the portable config) builds
    the module the weights load into, in place of ``train.jscc``'s
    ``build_model`` (the fusion pipeline's camera codec)."""
    cfg = _portable(cfg)
    if model_builder is None:
        from multimodal_sc_torch.train.jscc import build_model

        model_builder = build_model
    model = _cpu_copy(lambda: model_builder(cfg), model)
    h, w = cfg.camera.image_hw
    n = _rows(batch)
    img = torch.rand((n, h, w, 3), generator=torch.Generator().manual_seed(0))
    snr = torch.full((n,), cfg.channel.snr_db)

    if cfg.camera.arch == "vq":
        # The over-the-air payload is integer indices: the transmitter
        # exports img -> (b, n_tokens) int32, the receiver indices -> image.
        # The indices alone: the re-seeding statistics are training's.
        def enc_vq(m, img):
            return m.quantize(m.encode_features(img), with_stats=False)[0]

        def dec_vq(m, idx):
            return m.decode_tokens(idx)

        with torch.no_grad():
            idx = enc_vq(model, img)
        return {"encoder": _export(model, enc_vq, (img,), batch),
                "decoder": _export(model, dec_vq, (idx,), batch)}

    def enc(m, img, snr_db):
        return m.encode(img, snr_db)

    def dec(m, z_hat, snr_db):
        return m.decode(z_hat, snr_db)

    # The symbol shape comes from the encoder's output (trailing real/imag
    # pair); the decoder is traced on it.
    with torch.no_grad():
        z = enc(model, img, snr)
    out = {"encoder": _export(model, enc, (img, snr), batch),
           "decoder": _export(model, dec, (z, snr), batch)}
    if getattr(model, "seg_classes", 0) > 0:
        def dec_seg(m, z_hat, snr_db):
            return m.decode_seg(z_hat, snr_db)

        out["decoder_seg"] = _export(model, dec_seg, (z, snr), batch)
    return out


def _example_cloud(cfg: ExperimentConfig, n: int):
    """(points, mask) of ``n`` rows inside the LiDAR's ranges."""
    from multimodal_sc_torch.envs.datasets import (draw_pointcloud,
                                                   synthetic_pointcloud_batch)

    lid = cfg.lidar
    return synthetic_pointcloud_batch(
        draw_pointcloud(n, lid.max_points, torch.Generator().manual_seed(0),
                        "cpu", lid.x_range, lid.y_range),
        lid.x_range, lid.y_range)


def export_lidar_codec(cfg: ExperimentConfig, model: nn.Module,
                       batch: Optional[int] = None
                       ) -> Dict[str, torch.export.ExportedProgram]:
    """Export the LiDAR BEV codec ``model`` (config 3's LiDAR; the
    ``lidar`` module of a fusion model).

    The analog codec: ``(points, mask, snr_db) -> z`` and ``(z_hat,
    snr_db) -> BEV class logits``. The digital codec (``lidar.arch="vq"``):
    ``(points, mask) -> int32 indices`` and ``indices -> logits``."""
    from multimodal_sc_torch.codec.semantic_vq import vector_quantize
    from multimodal_sc_torch.train.fusion_jscc import build_lidar_codec

    cfg = _portable(cfg)
    model = _cpu_copy(lambda: build_lidar_codec(cfg), model)
    n = _rows(batch)
    pts, mask = _example_cloud(cfg, n)
    snr = torch.full((n,), cfg.channel.snr_db)

    if cfg.lidar.arch == "vq":
        # The indices alone: the re-seeding statistics are training's.
        def enc_vq(m, points, mask):
            idx = vector_quantize(m.encode_features(points, mask),
                                  m.codebook)[1]
            return idx.reshape(idx.shape[0], -1)

        def dec_vq(m, idx):
            return m.decode_tokens(idx)

        with torch.no_grad():
            idx = enc_vq(model, pts, mask)
        return {"lidar_encoder": _export(model, enc_vq, (pts, mask), batch),
                "lidar_decoder": _export(model, dec_vq, (idx,), batch)}

    def enc(m, points, mask, snr_db):
        return m.encode((points, mask), snr_db)

    def dec(m, z_hat, snr_db):
        return m.decode(z_hat, snr_db)

    with torch.no_grad():
        z = enc(model, pts, mask, snr)
    return {"lidar_encoder": _export(model, enc, (pts, mask, snr), batch),
            "lidar_decoder": _export(model, dec, (z, snr), batch)}


def export_policy(cfg: ExperimentConfig, net: nn.Module,
                  batch: Optional[int] = None
                  ) -> torch.export.ExportedProgram:
    """Export the greedy driving policy of ``net``: config 4's DQN argmax
    of Q or config 5's argmax of the actor's logits, by ``cfg.rl.algo``.

    The program takes ``(image, points, mask) -> action (b,) int32``; the
    trunk's channel noise is drawn inside it from the device's default
    generator, which the callable of :func:`load_artifact` seeds from its
    fourth argument, ``seed``. The observation shapes and dtypes come from
    the env."""
    from multimodal_sc_torch.envs import driving
    from multimodal_sc_torch.rl.perception import ActorCritic, QNetwork

    cfg = _portable(cfg)
    ppo = cfg.rl.algo == "ppo"
    net = _cpu_copy(lambda: (ActorCritic if ppo else QNetwork)(cfg), net)
    n = _rows(batch)
    states = driving.reset_batch(cfg.env, n, torch.Generator().manual_seed(0),
                                 "cpu")
    obs = driving.observe_batch(cfg.env, states)

    def policy(m, image, points, mask):
        out = m(image, points, mask)
        logits = out[0] if ppo else out
        return logits.argmax(dim=-1).to(torch.int32)

    return _export(net, policy, obs, batch)


def save_artifact(directory: str,
                  parts: Dict[str, torch.export.ExportedProgram],
                  cfg: ExperimentConfig) -> Dict[str, int]:
    """Write each part as ``<part>.pt2``, the pinned config and a manifest;
    returns the bytes written for each part."""
    os.makedirs(directory, exist_ok=True)
    sizes = {}
    for name, program in parts.items():
        path = os.path.join(directory, f"{name}.pt2")
        torch.export.save(program, path)
        sizes[name] = os.path.getsize(path)
    with open(os.path.join(directory, "config.json"), "w") as f:
        f.write(cfg.to_json())
    with open(os.path.join(directory, MANIFEST), "w") as f:
        json.dump({"parts": sorted(parts), "platforms": list(PLATFORMS),
                   "torch_version": torch.__version__, "format": FORMAT},
                  f, indent=1)
    return sizes


def _seeded(module: Callable, device: torch.device) -> Callable:
    """The policy's call: ``(image, points, mask, seed)``; the program's
    draws come from the device's default generator, seeded from ``seed``
    on a fork, so the caller's generators are left as they were."""
    devices = [device] if device.type == "cuda" else []

    def policy(image, points, mask, seed):
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(int(seed))
            return module(image, points, mask)

    return policy


def load_artifact(directory: str, device="cuda") -> Dict[str, Callable]:
    """Every part of a saved artifact as a callable on ``device`` (default
    the card; ``"cpu"`` to run there).

    Needs only torch at load time: no framework modules, weights or
    checkpoints. Each callable checks its inputs' dtypes and shapes
    against the exported signature (a symbolic batch takes any size) and
    raises on a mismatch. The ``policy`` part takes ``(image, points,
    mask, seed)``; the others the inputs they were exported with."""
    from torch.export.passes import move_to_device_pass

    from multimodal_sc_torch.device import resolve_device

    dev = resolve_device(device)
    with open(os.path.join(directory, MANIFEST)) as f:
        manifest = json.load(f)
    out: Dict[str, Callable] = {}
    for name in manifest["parts"]:
        program = torch.export.load(os.path.join(directory, f"{name}.pt2"))
        if dev.type != "cpu":
            program = move_to_device_pass(program, dev)
        module = program.module()
        out[name] = _seeded(module, dev) if name == "policy" else module
    return out
