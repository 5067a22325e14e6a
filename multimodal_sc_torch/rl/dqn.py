"""DQN over the semantic-communication perception trunk: the act path.

Counterpart of ``multimodal_sc_tpu/rl/dqn.py``. One act-only iteration
reads the carried observation, acts eps-greedily through ``QNetwork``
(channel noise, exploration and env randomness all from the state's
``torch.Generator``), steps every env, pushes the n-step window and adds
the emitted transitions to the on-device replay, with the same metric keys
as the JAX package. The learner (``_td_loss``, the optimizer, replay
``sample``) comes with the training slice (ROADMAP item 9), and with it the
optimizer state in ``DQNState``.
"""

from __future__ import annotations

import copy
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F

from multimodal_sc_torch.config.configs import ExperimentConfig
from multimodal_sc_torch.device import resolve_device
from multimodal_sc_torch.envs import driving
from multimodal_sc_torch.rl import nstep, replay
from multimodal_sc_torch.rl.perception import QNetwork


class Transition(NamedTuple):
    image: Any
    points: Any
    mask: Any
    action: Any
    reward: Any
    done: Any
    next_image: Any
    next_points: Any
    next_mask: Any


def quantize_image(cfg: ExperimentConfig, img: torch.Tensor) -> torch.Tensor:
    """uint8 frame for replay / window storage when ``rl.replay_quantize``."""
    if not cfg.rl.replay_quantize:
        return img
    return replay.quantize_frame(img)


def quantize_obs(cfg: ExperimentConfig, trans: Transition) -> Transition:
    """uint8-quantize the image fields for replay storage."""
    if not cfg.rl.replay_quantize:
        return trans
    return trans._replace(image=quantize_image(cfg, trans.image),
                          next_image=quantize_image(cfg, trans.next_image))


def dequantize_image(img: torch.Tensor) -> torch.Tensor:
    return replay.dequantize_frame(img)


class DQNState(NamedTuple):
    params: QNetwork           # online network
    target_params: QNetwork
    ema_params: QNetwork       # deployment EMA (moves with learning only)
    env_states: driving.EnvState
    buffer: replay.ReplayBuffer
    window: nstep.NStepWindow
    generator: torch.Generator
    step: int                  # gradient steps taken
    ep_return: torch.Tensor    # (B,) running episode return per env
    last_return: torch.Tensor  # (B,) last completed episode return
    # Observation carried from the previous env step (replay dtype).
    obs_image: torch.Tensor    # (B, H, W, 3) f32 or uint8
    obs_points: torch.Tensor   # (B, R, 4)
    obs_mask: torch.Tensor     # (B, R)


def _epsilon(cfg: ExperimentConfig, step: int) -> float:
    r = cfg.rl
    frac = min(max(step / r.eps_decay_steps, 0.0), 1.0)
    return r.eps_start + frac * (r.eps_end - r.eps_start)


def init_params(cfg: ExperimentConfig, seed: int = 0,
                device="cuda") -> QNetwork:
    """A fresh Q-network, its weights drawn from ``seed`` (the global RNG
    is left as it was)."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = QNetwork(cfg)
    return net.to(dev)


def init(cfg: ExperimentConfig, seed: int = 0, num_envs: int = 64,
         device="cuda") -> DQNState:
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    env_states = driving.reset_batch(cfg.env, num_envs, g, dev)
    img, pts, mask = driving.observe_batch(cfg.env, env_states)
    params = init_params(cfg, seed, dev)
    example = quantize_obs(cfg, Transition(
        image=img[0], points=pts[0], mask=mask[0],
        action=torch.zeros((), dtype=torch.int32),
        reward=torch.zeros((), dtype=torch.float32),
        done=torch.zeros((), dtype=torch.bool),
        next_image=img[0], next_points=pts[0], next_mask=mask[0]))
    buf = replay.create(example, cfg.rl.replay_capacity, dev)
    window = nstep.create(
        {"image": quantize_image(cfg, img), "points": pts, "mask": mask,
         "action": torch.zeros((num_envs,), dtype=torch.int32, device=dev)},
        cfg.rl.n_step, num_envs)
    zeros = torch.zeros((num_envs,), dtype=torch.float32, device=dev)
    return DQNState(params=params, target_params=copy.deepcopy(params),
                    ema_params=copy.deepcopy(params), env_states=env_states,
                    buffer=buf, window=window, generator=g, step=0,
                    ep_return=zeros, last_return=zeros.clone(),
                    obs_image=quantize_image(cfg, img), obs_points=pts,
                    obs_mask=mask)


def act(cfg: ExperimentConfig, net: QNetwork, image, points, mask,
        generator: Optional[torch.Generator] = None, epsilon: float = 0.0,
        snr_db=None, channel_noise=None) -> torch.Tensor:
    """Eps-greedy action (B,) int32 for a batch of observations."""
    q = net(image, points, mask, generator, snr_db,
            channel_noise=channel_noise)
    greedy = q.argmax(dim=-1)
    rand = torch.randint(0, cfg.rl.num_actions, greedy.shape,
                         generator=generator, device=q.device)
    explore = torch.rand(greedy.shape, generator=generator,
                         device=q.device) < epsilon
    return torch.where(explore, rand, greedy).to(torch.int32)


def make_iteration(cfg: ExperimentConfig, learn: bool = True,
                   carry_obs: bool = True):
    """The act(-only) iteration: ``state -> (state, metrics)``.

    ``carry_obs=False`` re-renders the current observation instead of
    using the carried one. ``learn=True`` raises until the training slice.
    The JAX package's ``chunk`` (scan-per-dispatch) and ``carry_f32``
    options are not ported: PyTorch has no dispatch to amortize that way.
    """
    if learn:
        raise NotImplementedError(
            "the learner (_td_loss, optimizer, replay.sample) comes with the "
            "training slice (ROADMAP item 9); use learn=False")

    @torch.no_grad()
    def iteration(state: DQNState):
        if carry_obs:
            img_store = state.obs_image
            img = dequantize_image(img_store)
            pts, mask = state.obs_points, state.obs_mask
        else:
            img, pts, mask = driving.observe_batch(cfg.env, state.env_states)
            img_store = quantize_image(cfg, img)
        g = state.generator
        eps = _epsilon(cfg, state.step)
        snr = None
        if cfg.channel.random_snr:
            ch = cfg.channel
            snr = ch.snr_min_db + torch.rand(
                (img.shape[0],), generator=g, device=img.device) * (
                    ch.snr_max_db - ch.snr_min_db)
        actions = act(cfg, state.params, img, pts, mask, g, eps, snr_db=snr)
        env_states, ts = driving.step_batch(cfg.env, state.env_states,
                                            actions, g)

        ep_return = state.ep_return + ts.reward
        last_return = torch.where(ts.done, ep_return, state.last_return)
        ep_return = torch.where(ts.done, 0.0, ep_return)

        next_store = quantize_image(cfg, ts.image)
        window, oldest, n_ret, n_done, valid = nstep.push(
            state.window, {"image": img_store, "points": pts, "mask": mask,
                           "action": actions},
            ts.reward, ts.done, cfg.rl.gamma)
        buf = state.buffer
        # Until the window fills its rows are placeholders: nothing is
        # added (the JAX package scattered them but froze cursor/size).
        if valid:
            buf = replay.add_batch(buf, quantize_obs(cfg, Transition(
                image=oldest["image"], points=oldest["points"],
                mask=oldest["mask"], action=oldest["action"],
                reward=n_ret, done=n_done, next_image=next_store,
                next_points=ts.points, next_mask=ts.mask)))

        new_state = state._replace(
            env_states=env_states, buffer=buf, window=window,
            ep_return=ep_return, last_return=last_return,
            obs_image=next_store, obs_points=ts.points, obs_mask=ts.mask)
        hist = F.one_hot(actions.long(), cfg.rl.num_actions).float().mean(0)
        dev = img.device
        metrics = {
            "loss": torch.zeros((), device=dev),
            "epsilon": torch.tensor(eps, dtype=torch.float32, device=dev),
            "reward": ts.reward.mean(),
            "episode_return": last_return.mean(),
            "action_entropy": -(hist * torch.log(hist + 1e-9)).sum(),
            "buffer_size": torch.tensor(float(buf.size), device=dev)}
        return new_state, metrics

    return iteration
