"""DQN over the semantic-communication perception trunk: act and learn.

Counterpart of ``multimodal_sc_tpu/rl/dqn.py``. One iteration reads the
carried observation, acts eps-greedily through ``QNetwork`` (channel noise,
exploration and env randomness all from the state's ``torch.Generator``),
steps every env, pushes the n-step window and adds the emitted transitions
to the on-device replay. Once the replay holds a batch, the learner samples
one, takes a double-DQN Huber TD gradient step (global-norm clip, Adam),
and updates the target (hard sync or Polyak) and the deployment EMA. Same
metric keys as the JAX package.

Unlike the JAX package's pure update, the learner writes the online,
target and EMA networks and the optimizer moments IN PLACE: the returned
state holds the same modules. The digital (VQ) branches of the loss wait
for ROADMAP item 14.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.func import functional_call

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


def dequantize_obs(cfg: ExperimentConfig, batch: Transition) -> Transition:
    """Inverse of :func:`quantize_obs` for sampled batches."""
    if not cfg.rl.replay_quantize:
        return batch
    return batch._replace(image=replay.dequantize_frame(batch.image),
                          next_image=replay.dequantize_frame(batch.next_image))


def dequantize_image(img: torch.Tensor) -> torch.Tensor:
    return replay.dequantize_frame(img)


class DQNState(NamedTuple):
    params: QNetwork           # online network
    target_params: QNetwork
    ema_params: QNetwork       # deployment EMA (moves with learning only)
    opt_state: torch.optim.Adam   # over ``params``; holds the Adam moments
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


def make_optimizer(cfg: ExperimentConfig, net: QNetwork) -> torch.optim.Adam:
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8, no weight
    decay); the global-norm clip of the JAX package's chain is
    :func:`clip_by_global_norm_`, applied to the gradients before a step."""
    return torch.optim.Adam(net.parameters(), lr=cfg.train.lr,
                            betas=(0.9, 0.999), eps=1e-8)


def clip_by_global_norm_(grads: List[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place to a global L2 norm of at most ``max_norm``,
    as optax does: ``g * max_norm / max(norm, max_norm)`` (exactly 1 below
    the threshold; torch's ``clip_grad_norm_`` divides by ``norm + 1e-6``).
    Returns the norm before clipping."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, max_norm / torch.clamp(norm, min=max_norm))
    return norm


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
                    ema_params=copy.deepcopy(params),
                    opt_state=make_optimizer(cfg, params),
                    env_states=env_states,
                    buffer=buf, window=window, generator=g, step=0,
                    ep_return=zeros, last_return=zeros.clone(),
                    obs_image=quantize_image(cfg, img), obs_points=pts,
                    obs_mask=mask)


def act(cfg: ExperimentConfig, net: QNetwork, image, points, mask,
        generator: Optional[torch.Generator] = None, epsilon: float = 0.0,
        snr_db=None, channel_noise=None, v2x_offset_db=None) -> torch.Tensor:
    """Eps-greedy action (B,) int32 for a batch of observations."""
    q = net(image, points, mask, generator, snr_db, v2x_offset_db,
            channel_noise=channel_noise)
    greedy = q.argmax(dim=-1)
    rand = torch.randint(0, cfg.rl.num_actions, greedy.shape,
                         generator=generator, device=q.device)
    explore = torch.rand(greedy.shape, generator=generator,
                         device=q.device) < epsilon
    return torch.where(explore, rand, greedy).to(torch.int32)


def _sample_snr(cfg: ExperimentConfig, generator, batch: int, device):
    """Per-example deployed-SNR draw for channel.random_snr; None (the
    config constant inside the trunk) when the flag is off."""
    ch = cfg.channel
    if not ch.random_snr:
        return None
    return ch.snr_min_db + torch.rand(
        (batch,), generator=generator, device=device) * (
            ch.snr_max_db - ch.snr_min_db)


class LearnDraws(NamedTuple):
    """The random draws of one learn step. A ``None`` noise entry is drawn
    from the generator inside that forward."""
    indices: torch.Tensor               # (batch,) replay rows
    snr_db: Optional[torch.Tensor]      # (batch,), channel.random_snr only
    noise_online: Optional[Sequence[torch.Tensor]] = None   # batch.image
    noise_target: Optional[Sequence[torch.Tensor]] = None   # target, next obs
    noise_double: Optional[Sequence[torch.Tensor]] = None   # online, next obs


def draw_learn(cfg: ExperimentConfig, buffer_size: int,
               generator: torch.Generator, device) -> LearnDraws:
    bs = cfg.rl.batch_size
    idx = torch.randint(0, max(buffer_size, 1), (bs,), generator=generator,
                        device=device)
    return LearnDraws(indices=idx,
                      snr_db=_sample_snr(cfg, generator, bs, device))


def learner_forward(cfg: ExperimentConfig) -> Callable[..., torch.Tensor]:
    """``forward(net, *args, **kwargs)`` as the learner runs a Q-network.

    The fused blocks' kernel has no backward kernel (its gradient recomputes
    through the plain version), so under ``pallas_mha_block`` the learner's
    three forwards run the fused blocks through the plain version, as the
    JAX package does: a second network skeleton built with
    ``mha_block_kernel=False`` (on the meta device, it owns no weights) is
    driven with the given network's own parameters. ``act`` keeps running
    the kernel, and nothing is copied."""
    if not (cfg.pallas_mha_block and cfg.mha_block_kernel):
        return lambda net, *args, **kwargs: net(*args, **kwargs)
    with torch.device("meta"):
        skeleton = QNetwork(cfg.override(mha_block_kernel=False))

    def forward(net, *args, **kwargs):
        return functional_call(skeleton, dict(net.named_parameters()), args,
                               kwargs)

    return forward


def _td_loss(cfg: ExperimentConfig, forward, online: QNetwork,
             target_net: QNetwork, batch: Transition, draws: LearnDraws,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Double-DQN Huber TD loss on one batch. Only the online forward on
    ``batch.image`` carries gradient; one SNR vector is shared by the three
    forwards, each with its own channel noise."""
    if cfg.camera.arch == "vq" or cfg.lidar.arch == "vq":
        raise NotImplementedError(
            "the VQ branches of the TD loss (codebook loss, dead-code "
            "reseed, token pruning) are not ported yet (ROADMAP item 14)")
    snr = draws.snr_db
    q = forward(online, batch.image, batch.points, batch.mask, generator,
                snr, channel_noise=draws.noise_online)
    q_taken = q.gather(1, batch.action.long()[:, None])[:, 0]
    with torch.no_grad():
        q_next_t = forward(target_net, batch.next_image, batch.next_points,
                           batch.next_mask, generator, snr,
                           channel_noise=draws.noise_target)
        if cfg.rl.double_dqn:
            q_next_o = forward(online, batch.next_image, batch.next_points,
                               batch.next_mask, generator, snr,
                               channel_noise=draws.noise_double)
            a_star = q_next_o.argmax(dim=-1)
        else:
            a_star = q_next_t.argmax(dim=-1)
        q_boot = q_next_t.gather(1, a_star[:, None])[:, 0]
        # batch.reward is the n-step return and batch.next_* the observation
        # n steps later, so the bootstrap discount is gamma^n (rl/nstep.py).
        gamma_n = cfg.rl.gamma ** cfg.rl.n_step
        target = batch.reward + gamma_n * (1.0 - batch.done.float()) * q_boot
    return F.huber_loss(q_taken, target, delta=1.0)


def learn_step(cfg: ExperimentConfig, state: DQNState, batch: Transition,
               draws: LearnDraws, forward=None):
    """One gradient step on ``batch``: ``(state', loss)``.

    Updates ``state.params``, the Adam moments, ``state.target_params``
    (hard sync every ``rl.target_update_period`` steps, or Polyak under
    ``rl.target_tau``) and ``state.ema_params`` in place."""
    if forward is None:
        forward = learner_forward(cfg)
    opt = state.opt_state
    params = list(state.params.parameters())
    loss = _td_loss(cfg, forward, state.params, state.target_params, batch,
                    draws, state.generator)
    # Parameters the loss does not reach get zero gradients, as jax.grad
    # gives them: their Adam moments then decay as optax's do.
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    with torch.no_grad():
        clip_by_global_norm_(grads, cfg.train.grad_clip)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)
        step = state.step + 1
        targets = list(state.target_params.parameters())
        if cfg.rl.target_tau > 0:
            torch._foreach_lerp_(targets, params, cfg.rl.target_tau)
        elif step % cfg.rl.target_update_period == 0:
            torch._foreach_copy_(targets, params)
        if cfg.rl.ema_tau > 0:
            torch._foreach_lerp_(list(state.ema_params.parameters()), params,
                                 cfg.rl.ema_tau)
    return state._replace(step=step), loss.detach()


def make_iteration(cfg: ExperimentConfig, learn: bool = True,
                   carry_obs: bool = True):
    """The actor(+learner) iteration: ``state -> (state, metrics)``.

    ``carry_obs=False`` re-renders the current observation instead of
    using the carried one. With ``learn`` the learner takes one gradient
    step per iteration once the replay holds ``rl.batch_size`` transitions
    (``buffer.size``, ``step`` and the window's fill are host ints, so the
    test costs no device sync). The JAX package's ``chunk``
    (scan-per-dispatch) and ``carry_f32`` options are not ported: PyTorch
    has no dispatch to amortize that way.
    """
    if learn and (cfg.camera.arch == "vq" or cfg.lidar.arch == "vq"):
        raise NotImplementedError(
            "learning with a digital (VQ) trunk is not ported yet (ROADMAP "
            "item 14); use learn=False")
    forward = learner_forward(cfg) if learn else None

    @torch.no_grad()
    def act_and_store(state: DQNState):
        if carry_obs:
            img_store = state.obs_image
            img = dequantize_image(img_store)
            pts, mask = state.obs_points, state.obs_mask
        else:
            img, pts, mask = driving.observe_batch(cfg.env, state.env_states)
            img_store = quantize_image(cfg, img)
        g = state.generator
        eps = _epsilon(cfg, state.step)
        snr = _sample_snr(cfg, g, img.shape[0], img.device)
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

    def iteration(state: DQNState):
        state, metrics = act_and_store(state)
        buf = state.buffer
        if learn and buf.size >= cfg.rl.batch_size:
            draws = draw_learn(cfg, buf.size, state.generator,
                               buf.data[0].device)
            batch = dequantize_obs(cfg, replay.sample(
                buf, None, cfg.rl.batch_size, draws.indices))
            state, metrics["loss"] = learn_step(cfg, state, batch, draws,
                                                forward)
        return state, metrics

    return iteration
