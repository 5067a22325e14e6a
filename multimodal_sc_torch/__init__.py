"""PyTorch/CUDA port of ``multimodal_sc_tpu`` for NVIDIA Hopper.

Mirrors the JAX package's sub-package and module names and its public API:
the verbs ``encode / channel / decode / act / train_step`` (with
``make_train_step``), re-exported here, and the composed flows of ``api``.
Entry points take an explicit ``device`` (default ``"cuda"``); the
hand-written CUDA kernels under ``csrc/`` are built with ``nvcc`` at first
use (``kernels/_build.py``), never at import. Imports ``torch`` and numpy,
never JAX.

A PyTorch module holds its weights, so where the JAX verbs take
``(model, params)`` these take the module, and where they take a key these
take an optional ``torch.Generator``.
"""

from multimodal_sc_torch.version import __version__
from multimodal_sc_torch.channel import (
    awgn,
    channel,
    ofdm,
    power_normalize,
    rayleigh,
    rician,
)
from multimodal_sc_torch.config.configs import ExperimentConfig
from multimodal_sc_torch.config.presets import PRESETS, get_preset
from multimodal_sc_torch.device import resolve_device
from multimodal_sc_torch import api

__all__ = [
    "__version__",
    "awgn",
    "channel",
    "ofdm",
    "power_normalize",
    "rayleigh",
    "rician",
    "ExperimentConfig",
    "PRESETS",
    "get_preset",
    "api",
    "encode",
    "decode",
    "act",
    "make_train_step",
    "train_step",
    "resolve_device",
]


def encode(model, obs, snr_db=None):
    """Encode an observation into channel symbols with the given codec."""
    return model.encode(obs, snr_db)


def decode(model, z_hat, snr_db=None):
    """Decode (possibly noisy) channel symbols back to the signal domain."""
    return model.decode(z_hat, snr_db)


def act(cfg, net, image, points, mask, generator=None, **kw):
    """Select an action for a batch of observations.

    Dispatches on ``cfg.rl.algo``: DQN returns actions (int32 (B,), pass
    ``epsilon=`` for exploration); PPO returns ``(actions, logp, value)``.
    """
    if cfg.rl.algo == "ppo":
        from multimodal_sc_torch.rl import ppo as _ppo

        return _ppo.act(cfg, net, image, points, mask, generator, **kw)
    from multimodal_sc_torch.rl import dqn as _dqn

    return _dqn.act(cfg, net, image, points, mask, generator, **kw)


def make_train_step(cfg, *args, **kw):
    """The train step of ``cfg``'s task.

    jscc: ``step(state, batch, draws=None)``; jscc_fusion: ``step(state,
    img, pts, mask, cls, draws=None)`` (``cls`` the per-point classes, the
    semantic BEV target); dqn: the actor+learner ``iteration(state)``
    (``learn=`` and ``carry_obs=`` as keywords); ppo: the rollout + GAE +
    update ``train_step(state)``. Each returns ``(state, metrics)``; the
    state holds the model, so no model is passed here.
    """
    task = cfg.train.task
    if task == "jscc":
        from multimodal_sc_torch.train import jscc as _jscc

        return _jscc.make_train_step(cfg, *args, **kw)
    if task == "jscc_fusion":
        from multimodal_sc_torch.train import fusion_jscc as _fj

        return _fj.make_train_step(cfg, *args, **kw)
    if task == "dqn":
        from multimodal_sc_torch.rl import dqn as _dqn

        return _dqn.make_iteration(cfg, *args, **kw)
    if task == "ppo":
        from multimodal_sc_torch.rl import ppo as _ppo

        return _ppo.make_train_step(cfg, *args, **kw)
    raise ValueError(f"unknown task {task!r}")


def train_step(cfg, state, *args, **kw):
    """One optimization step: builds (and caches, per config) the train
    step of ``cfg`` and applies it. Returns ``(new_state, metrics)``."""
    step = _train_step_cache.get(cfg)
    if step is None:
        step = make_train_step(cfg)
        _train_step_cache[cfg] = step
    return step(state, *args, **kw)


_train_step_cache = {}
