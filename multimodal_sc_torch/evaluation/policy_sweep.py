"""Policy robustness against channel quality: episode return across an SNR
sweep.

Counterpart of ``multimodal_sc_tpu/evaluation/policy_sweep.py``: the
closed-loop episode return of a deployed DQN or PPO agent as the channel
its perception runs over degrades. Every link (camera, ego
LiDAR and, with V2X, the roadside unit's at ``channel.v2x_snr_offset_db``)
is deployed at the point's SNR. Every sweep point starts from the same
generator seeds, the envs' and the policy's apart, so it reuses the same
env resets and env draws (and, where the links draw alike, the same
action draws): the evaluation is paired, and curve differences are
channel effects, not reseeded episode noise. Fog (in the env states) and the V2X
offset are runtime values, as in the JAX package.

A digital link deploys as configured: ``channel.fec`` codes a VQ
checkpoint at deploy time, and under ``channel.harq`` each row also
carries the links' accounting, per step: ``link_syms_per_step`` (the
symbols the camera, ego LiDAR and V2X links really sent per observation,
retransmissions included, summed), ``harq_mean_rounds`` and
``harq_residual_fail_rate`` (each averaged over the links). As in the JAX
package, these count every step of the ``env.max_steps`` rollout, steps
after an env's first done included.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence

import torch
from torch import nn

from multimodal_sc_torch.config.configs import ExperimentConfig
from multimodal_sc_torch.evaluation.policy_eval import _rollout_returns

DEFAULT_SNRS = (-5.0, 0.0, 5.0, 10.0, 15.0, 20.0, 25.0)


def _deployed(net: nn.Module, cfg_k: ExperimentConfig) -> nn.Module:
    """``net``'s weights in a network built for ``cfg_k`` (another channel
    kind): the skeleton is built on the meta device and takes ``net``'s own
    tensors, so nothing is copied or drawn."""
    with torch.device("meta"):
        out = type(net)(cfg_k)
    out.load_state_dict(net.state_dict(), assign=True)
    return out.eval()


def _with_link_stats(cfg: ExperimentConfig, actions, aux: dict):
    """The actions, and under ``channel.harq`` the step's link accounting
    from the trunk's ``aux``, reduced over the HARQ links as the JAX
    package reduces its sown entries (symbols summed, rounds and residual
    failures averaged; zeros where no link ran HARQ)."""
    if not cfg.channel.harq:
        return actions
    zero = torch.zeros((), device=actions.device)
    return actions, {
        "link_syms_per_step": aux.get("harq_syms", zero),
        "harq_mean_rounds": aux.get("harq_rounds", zero),
        "harq_residual_fail_rate": aux.get("harq_resid", zero)}


def policy_snr_sweep(cfg: ExperimentConfig, net: nn.Module, seed: int,
                     snrs: Sequence[float] = DEFAULT_SNRS,
                     kinds: Sequence[str] = ("awgn", "rayleigh"),
                     num_envs: int = 256, epsilon: float = 0.0,
                     sample: bool = False) -> Dict[str, List[Dict]]:
    """Return-vs-SNR curves ``{kind: [{snr_db, episode_return_mean, ...}]}``
    of ``net`` (a ``QNetwork`` under ``rl.algo="dqn"``, an ``ActorCritic``
    under ``"ppo"``). ``epsilon`` is the DQN eval epsilon; ``sample``
    draws PPO's actions instead of taking the argmax. The deployed kind and
    SNR override the training config; everything else deploys as
    configured."""
    from multimodal_sc_torch.rl import dqn as dqn_lib
    from multimodal_sc_torch.rl import ppo as ppo_lib

    dev = next(net.parameters()).device
    v2x_off = cfg.channel.v2x_snr_offset_db
    curves: Dict[str, List[Dict]] = {}
    for kind in kinds:
        cfg_k = cfg.override_str([f"channel.kind={kind}"])
        net_k = _deployed(net, cfg_k)
        rows = []
        for snr in snrs:
            snr_vec = torch.full((num_envs,), float(snr), device=dev)

            if cfg.rl.algo == "ppo":
                def act_fn(img, pts, mask, g):
                    aux = {}
                    logits, _ = net_k(img, pts, mask, g, snr_vec, v2x_off,
                                      aux=aux)
                    if sample:
                        a = ppo_lib.sample_action(logits, g)
                    else:
                        a = logits.argmax(dim=-1).to(torch.int32)
                    return _with_link_stats(cfg, a, aux)
            else:
                def act_fn(img, pts, mask, g):
                    aux = {}
                    a = dqn_lib.act(cfg_k, net_k, img, pts, mask, g,
                                    epsilon, snr_db=snr_vec,
                                    v2x_offset_db=v2x_off, aux=aux)
                    return _with_link_stats(cfg, a, aux)

            out = _rollout_returns(cfg_k, act_fn, seed, num_envs, dev)
            rows.append({"snr_db": float(snr), **out})
        curves[kind] = rows
    return curves


def format_table(curves: Dict[str, List[Dict]],
                 metric: str = "episode_return_mean") -> str:
    kinds = sorted(curves)
    snrs = [r["snr_db"] for r in curves[kinds[0]]]
    lines = ["SNR(dB)  " + "  ".join(f"{k:>12s}" for k in kinds)]
    for i, snr in enumerate(snrs):
        vals = "  ".join(f"{curves[k][i][metric]:12.2f}" for k in kinds)
        lines.append(f"{snr:7.1f}  {vals}")
    return "\n".join(lines)


def save_curves(curves, path: str) -> None:
    with open(path, "w") as f:
        json.dump(curves, f, indent=1)
