"""Convenience API: the one-call flows users reach for first.

Counterpart of ``multimodal_sc_tpu/api.py``. The five public verbs
(encode / channel / decode / act / train_step) live in the package root;
this module adds the composed flows on top of them. A PyTorch module holds
its weights, so the JAX package's ``(model, params)`` is one ``model``
here, and its ``key`` an explicit ``torch.Generator`` (``None``: the
device's default generator).
"""

from __future__ import annotations

from typing import Optional

from multimodal_sc_torch.config.configs import ExperimentConfig


def reconstruct(model, img, snr_db, generator=None, kind: str = "awgn",
                normalize: bool = True, modulation: int = 0, pilots: int = 0,
                subcarriers: int = 64, taps: int = 8, rate_sym: int = 0,
                noise=None):
    """Full encode -> channel -> decode pass; returns ``(recon, symbols)``.

    A scalar ``snr_db`` is broadcast per example. The channel settings
    (``normalize``, ``modulation``, ``pilots``, ``subcarriers``, ``taps``)
    must match the training ``ChannelConfig`` so evaluation runs over the
    deployed transmission mode. ``rate_sym`` (adaptive-rate codecs only):
    transmit the first ``rate_sym`` of ``c_sym`` symbol channels, 0 for
    all; ignored by fixed-rate codecs. ``noise``: the channel's draws, in
    place of draws from ``generator``."""
    from multimodal_sc_torch.train.jscc import transmit

    return transmit(model, img, snr_db, kind, generator, noise=noise,
                    rate_sym=rate_sym, normalize=normalize,
                    modulation=modulation, pilots=pilots,
                    subcarriers=subcarriers, taps=taps)


def make_trainer(cfg: ExperimentConfig):
    """The training driver module of ``cfg.train.task``: its ``run`` trains
    the config."""
    task = cfg.train.task
    if task == "jscc":
        from multimodal_sc_torch.train import jscc

        return jscc
    if task == "jscc_fusion":
        from multimodal_sc_torch.train import fusion_jscc

        return fusion_jscc
    if task == "dqn":
        from multimodal_sc_torch.train import dqn

        return dqn
    if task == "ppo":
        from multimodal_sc_torch.train import ppo

        return ppo
    raise ValueError(f"unknown task {task!r}")


def train(cfg: ExperimentConfig, metrics_path: Optional[str] = None,
          device="cuda"):
    """Run the full training loop for any preset on ``device``; returns
    ``(state, metrics)``."""
    return make_trainer(cfg).run(cfg, metrics_path=metrics_path,
                                 device=device)
