"""Policy evaluation: mean episode return over N on-device episodes.

Counterpart of ``multimodal_sc_tpu/evaluation/policy_eval.py``: fixed
seed, a DQN (greedy or eps-greedy) or PPO (greedy or sampled) policy, every
env run for ``env.max_steps`` steps with the reward counted up to its FIRST
done.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from multimodal_sc_torch.config.configs import ExperimentConfig
from multimodal_sc_torch.device import resolve_device
from multimodal_sc_torch.envs import driving

# act_fn(image, points, mask, generator) -> int32 actions (B,)
ActFn = Callable[..., torch.Tensor]


@torch.no_grad()
def _rollout_returns(cfg: ExperimentConfig, act_fn: ActFn, seed: int,
                     num_envs: int, device) -> Dict[str, float]:
    """Shared episode-return rollout: accumulate reward to each env's first
    done over ``cfg.env.max_steps``; one host pull at the end."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    states = driving.reset_batch(cfg.env, num_envs, g, dev)
    ret = torch.zeros(num_envs, device=dev)
    done_seen = torch.zeros(num_envs, device=dev)
    reward_sum = torch.zeros((), device=dev)
    for _ in range(cfg.env.max_steps):
        img, pts, mask = driving.observe_batch(cfg.env, states)
        states, ts = driving.step_batch(cfg.env, states,
                                        act_fn(img, pts, mask, g), g)
        ret = ret + ts.reward * (1.0 - done_seen)
        done_seen = torch.maximum(done_seen, ts.done.float())
        reward_sum = reward_sum + ts.reward.mean()
    out = torch.stack([ret.mean(), ret.std(unbiased=False), done_seen.mean(),
                       reward_sum / cfg.env.max_steps]).tolist()
    return dict(zip(("episode_return_mean", "episode_return_std",
                     "episodes_terminated_frac", "reward_per_step"), out))


def evaluate_dqn(cfg: ExperimentConfig, net, seed: int = 0,
                 num_envs: int = 32, epsilon: float = 0.0
                 ) -> Dict[str, float]:
    """DQN policy eval of ``net`` (a ``QNetwork``), episodes run to
    ``cfg.env.max_steps``. ``epsilon=0`` is pure argmax; the standard DQN
    protocol also reports a small eval epsilon (0.05). The envs run on the
    device that holds the network's weights."""
    from multimodal_sc_torch.rl import dqn as dqn_lib

    def act_fn(img, pts, mask, g):
        return dqn_lib.act(cfg, net, img, pts, mask, g, epsilon=epsilon,
                           v2x_offset_db=cfg.channel.v2x_snr_offset_db)

    return _rollout_returns(cfg, act_fn, seed, num_envs,
                            next(net.parameters()).device)


def evaluate_ppo(cfg: ExperimentConfig, net, seed: int = 0,
                 num_envs: int = 32, greedy: bool = True,
                 temperature: float = 1.0) -> Dict[str, float]:
    """PPO policy eval of ``net`` (an ``ActorCritic``): argmax of the
    logits, or a draw from them scaled by 1 / ``temperature`` (T = 1 is the
    trained policy, T -> 0 approaches argmax). Episodes run to
    ``cfg.env.max_steps``, on the device that holds the network's
    weights."""
    from multimodal_sc_torch.rl import ppo as ppo_lib

    inv_t = 1.0 / max(temperature, 1e-6)

    def act_fn(img, pts, mask, g):
        logits, _ = net(img, pts, mask, g,
                        v2x_offset_db=cfg.channel.v2x_snr_offset_db)
        if greedy:
            return logits.argmax(dim=-1).to(torch.int32)
        return ppo_lib.sample_action(logits * inv_t, g)

    return _rollout_returns(cfg, act_fn, seed, num_envs,
                            next(net.parameters()).device)
