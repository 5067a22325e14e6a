"""PPO actor-critic over the semantic-communication perception trunk.

Counterpart of ``multimodal_sc_tpu/rl/ppo.py``. One update: a rollout of
``rl.rollout_length`` steps of every env (observe -> sample an action
through the ``ActorCritic`` -> step; channel noise, SNR draws, actions and
env randomness all from the state's ``torch.Generator``), the bootstrap
value of the final state, GAE, then ``rl.ppo_epochs`` passes over a fresh
permutation of the rollout, each of ``rl.num_minibatches`` clipped-surrogate
steps (global-norm clip, Adam) with fresh channel noise, and one lerp of the
deployment EMA. Same metric keys as the JAX package.

The rollout acts through the fused blocks' kernel; the loss runs them
through their plain version on the same parameters, as the JAX package's
``_ppo_loss`` runs their XLA twin (``rl/dqn.py`` ``learner_forward``).
Unlike the JAX package's pure update, an update writes the network, the
EMA and the Adam moments IN PLACE: the returned state holds the same
modules. Over a digital link (``camera.arch="vq"``, ``lidar.arch="vq"``)
the loss adds ``rl.vq_loss_coef`` x the summed VQ losses and each
minibatch step re-seeds the dead codes of the re-seeding codebooks after
its optimizer step; under ``lidar.vq_prune`` the loss forward trains at
random kept fractions, as the DQN learner does. ``make_train_step_chunked``
has no counterpart: PyTorch runs eagerly, so there is no per-dispatch
round trip to amortize.

On a mesh whose data axis has S > 1 ranks (``runtime/mesh.py``) an update
keeps the JAX package's one global batch, as GSPMD does: each rank steps
``rl.num_envs / S`` envs from a generator of its own, the rollouts are
gathered into the global ``(T, rl.num_envs)`` one (every rank computes the
same GAE on it), every permutation is the first rank's draw over the
global ``T x B`` rows, and each minibatch step normalises the advantages
over the whole global minibatch, then takes its 1/S of the rows. The loss
is a mean over equal slices, so the gradients meaned over the data group
are the global minibatch's; the entropy floor reads the global entropy.
Over a digital link the trunk's usage losses, usage counts and re-seeding
candidates are the global minibatch's (``rl/perception.py`` and
``codec/semantic_vq.py`` pool them over the data group) and the re-seeding
coins are the first rank's, so every rank re-seeds the same rows with the
same codes. ``shard_state`` puts the network under tensor parallelism on
the model axis (``runtime/tp.py``).
"""

from __future__ import annotations

import copy
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from multimodal_sc_torch.config.configs import ExperimentConfig
from multimodal_sc_torch.device import resolve_device
from multimodal_sc_torch.envs import driving
from multimodal_sc_torch.rl import replay
from multimodal_sc_torch.rl.dqn import (clip_by_global_norm_, learner_forward,
                                        learner_keep, make_optimizer)
from multimodal_sc_torch.rl.gae import gae
from multimodal_sc_torch.rl.perception import (ActorCritic, LinkDraws,
                                               apply_codebook_reseed,
                                               collect_reseed_stats)
from multimodal_sc_torch.codec.semantic_vq import reseed_coin
from multimodal_sc_torch.runtime.mesh import (Mesh, all_gather_rows,
                                              all_reduce_mean_,
                                              data_parallel,
                                              local_batch_size,
                                              mean_over_data, replicate,
                                              shard_batch, shard_seed)


class PPOState(NamedTuple):
    params: ActorCritic
    ema_params: ActorCritic        # deployment EMA, one lerp per update
    opt_state: torch.optim.Adam    # over ``params``; holds the Adam moments
    env_states: driving.EnvState
    generator: torch.Generator
    update: int                    # updates taken
    ep_return: torch.Tensor        # (B,) running episode return per env
    last_return: torch.Tensor      # (B,) last completed episode return


class Rollout(NamedTuple):
    """One rollout, every field (T, B, ...)."""
    image: torch.Tensor            # f32, or uint8 under rl.rollout_quantize
    points: torch.Tensor
    mask: torch.Tensor
    action: torch.Tensor           # int32
    logp: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    snr_db: torch.Tensor           # the SNR each step was acted under


class UpdateDraws(NamedTuple):
    """The random draws of one update's minibatch steps, each indexed
    ``[epoch][minibatch]`` but the permutations. A ``None`` entry is drawn
    from the state's generator."""
    perms: Optional[Sequence[torch.Tensor]] = None   # one (T*B,) per epoch
    # the link draws of that step's loss forward (perception.LinkDraws)
    noise: Optional[Sequence[Sequence[LinkDraws]]] = None
    # lidar.vq_prune: the step's (minibatch,) kept fractions
    keep: Optional[Sequence[Sequence[torch.Tensor]]] = None
    # the step's (K,) re-seeding coins: (camera's, LiDAR's), None for a
    # codebook that does not re-seed
    coins: Optional[Sequence[Sequence[Tuple]]] = None


def init_params(cfg: ExperimentConfig, seed: int = 0,
                device="cuda") -> ActorCritic:
    """A fresh actor-critic, its weights drawn from ``seed`` (the global RNG
    is left as it was)."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = ActorCritic(cfg)
    return net.to(dev)


def init(cfg: ExperimentConfig, seed: int = 0, device="cuda",
         mesh: Optional[Mesh] = None) -> PPOState:
    """A fresh network, its EMA and Adam, and ``rl.num_envs`` envs; on a
    data axis of S ranks this rank's ``rl.num_envs / S`` of them, from a
    generator seeded by ``runtime/mesh.py``'s ``shard_seed``, and the
    network broadcast from the first rank."""
    dev = resolve_device(device)
    n_envs = cfg.rl.num_envs
    if data_parallel(mesh):
        n_envs = local_batch_size(mesh, n_envs)
        g = torch.Generator(device=dev).manual_seed(
            shard_seed(seed, mesh.data_index))
    else:
        g = torch.Generator(device=dev).manual_seed(seed)
    env_states = driving.reset_batch(cfg.env, n_envs, g, dev)
    params = init_params(cfg, seed, dev)
    if mesh is not None:
        replicate(mesh, params)
    zeros = torch.zeros((n_envs,), dtype=torch.float32, device=dev)
    return PPOState(params=params, ema_params=copy.deepcopy(params),
                    opt_state=make_optimizer(cfg, params),
                    env_states=env_states, generator=g, update=0,
                    ep_return=zeros, last_return=zeros.clone())


def sample_action(logits: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One categorical draw per row of ``logits``, int32 (B,)."""
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=generator)[:, 0].to(torch.int32)


def act(cfg: ExperimentConfig, net: ActorCritic, image, points, mask,
        generator: Optional[torch.Generator] = None, snr_db=None,
        channel_noise=None):
    """Sample ``(action (B,) int32, logp (B,), value (B,))``. ``snr_db``
    (optional (B,)): the per-env deployed SNR; the config constant by
    default."""
    logits, value = net(image, points, mask, generator, snr_db,
                        channel_noise=channel_noise)
    action = sample_action(logits, generator)
    logp = F.log_softmax(logits, dim=-1).gather(
        1, action.long()[:, None])[:, 0]
    return action, logp, value


def _sample_snr(cfg: ExperimentConfig, generator: torch.Generator,
                batch: int, device) -> torch.Tensor:
    """Per-env deployed SNR: uniform in [snr_min_db, snr_max_db] under
    ``channel.random_snr``, else the config constant (no draw). The loss
    re-forwards each transition under the SNR it was acted under."""
    ch = cfg.channel
    if not ch.random_snr:
        return torch.full((batch,), ch.snr_db, dtype=torch.float32,
                          device=device)
    return ch.snr_min_db + torch.rand(
        (batch,), generator=generator, device=device) * (
            ch.snr_max_db - ch.snr_min_db)


@torch.no_grad()
def _collect_rollout(cfg: ExperimentConfig, net: ActorCritic, env_states,
                     ep_return, last_return, generator):
    """``rl.rollout_length`` closed-loop steps of every env. Returns
    ``(env_states, ep_return, last_return, rollout, obs)``, ``obs`` the
    observation of the final state (each step's observation is the one the
    previous step rendered)."""
    img, pts, mask = driving.observe_batch(cfg.env, env_states)
    steps = []
    for _ in range(cfg.rl.rollout_length):
        snr = _sample_snr(cfg, generator, img.shape[0], img.device)
        action, logp, value = act(cfg, net, img, pts, mask, generator,
                                  snr_db=snr)
        env_states, ts = driving.step_batch(cfg.env, env_states, action,
                                            generator)
        ep_return = ep_return + ts.reward
        last_return = torch.where(ts.done, ep_return, last_return)
        ep_return = torch.where(ts.done, 0.0, ep_return)
        # Acting used the full-precision render; the stored frame is uint8
        # under rl.rollout_quantize.
        store = replay.quantize_frame(img) if cfg.rl.rollout_quantize else img
        steps.append(Rollout(image=store, points=pts, mask=mask,
                             action=action, logp=logp, value=value,
                             reward=ts.reward, done=ts.done, snr_db=snr))
        img, pts, mask = ts.image, ts.points, ts.mask
    rollout = Rollout(*(torch.stack(field) for field in zip(*steps)))
    return env_states, ep_return, last_return, rollout, (img, pts, mask)


def _ppo_loss(cfg: ExperimentConfig, forward, net: ActorCritic,
              batch: Dict[str, torch.Tensor], entropy_coef: float,
              generator: Optional[torch.Generator] = None,
              channel_noise=None, keep: Optional[torch.Tensor] = None,
              aux: Optional[dict] = None, mesh: Optional[Mesh] = None):
    """``(total, {"pg_loss", "v_loss", "entropy"})`` of one minibatch: the
    clipped surrogate on normalised advantages, the value loss and the
    entropy bonus (and the entropy floor's hinge under
    ``rl.entropy_floor``); over a digital link plus ``rl.vq_loss_coef`` x
    the forward's summed VQ losses. ``keep``: the kept fractions of the
    pruned digital LiDAR (``lidar.vq_prune``), else drawn from
    ``generator``; ``aux`` (optional dict) receives what the trunk returns
    (the re-seeding inputs among them). On a data axis of more than one
    rank (``mesh``) ``batch`` is this rank's slice of the global minibatch
    and its advantages come normalised over the whole of it; the entropy
    floor reads the global entropy, the digital links' statistics the
    global minibatch's."""
    r = cfg.rl
    aux = {} if aux is None else aux
    keep = learner_keep(cfg, batch["action"].shape[0], generator,
                        batch["action"].device, keep)
    logits, value = forward(net, replay.dequantize_frame(batch["image"]),
                            batch["points"], batch["mask"], generator,
                            batch["snr"], channel_noise=channel_noise,
                            aux=aux, lidar_keep=keep, data_mesh=mesh)
    logp_all = F.log_softmax(logits, dim=-1)
    logp = logp_all.gather(1, batch["action"].long()[:, None])[:, 0]
    ratio = torch.exp(logp - batch["logp"])
    adv = batch["adv"]
    if mesh is None or mesh.data == 1:
        adv = _normalise(adv)
    clipped = torch.clamp(ratio, 1 - r.clip_eps, 1 + r.clip_eps)
    pg_loss = -torch.minimum(ratio * adv, clipped * adv).mean()
    v_loss = 0.5 * (value - batch["ret"]).square().mean()
    entropy = -(logp_all.exp() * logp_all).sum(-1).mean()
    total = pg_loss + r.value_coef * v_loss - entropy_coef * entropy
    if r.entropy_floor > 0:
        # Inactive above the floor; pushes back only when the policy
        # collapses below it.
        total = total + r.entropy_floor_coef * F.relu(
            r.entropy_floor - mean_over_data(entropy, mesh))
    if "vq_loss" in aux:
        total = total + r.vq_loss_coef * aux["vq_loss"]
    return total, {"pg_loss": pg_loss, "v_loss": v_loss, "entropy": entropy}


def _normalise(adv: torch.Tensor) -> torch.Tensor:
    # jnp.std is the population standard deviation.
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)


def _entropy_coef(cfg: ExperimentConfig, update: int) -> float:
    """The entropy coefficient at ``update``: constant, or annealed
    linearly to ``rl.entropy_coef_final`` over ``train.steps`` updates."""
    c0, c1 = cfg.rl.entropy_coef, cfg.rl.entropy_coef_final
    if c1 < 0:
        return c0
    frac = min(max(update / max(1, cfg.train.steps - 1), 0.0), 1.0)
    return c0 + frac * (c1 - c0)


def _step_draw(draws: Optional[UpdateDraws], name: str, e: int, i: int):
    field = None if draws is None else getattr(draws, name)
    return None if field is None else field[e][i]


def _update(cfg: ExperimentConfig, state: PPOState, rollout: Rollout,
            last_value: torch.Tensor, forward,
            draws: Optional[UpdateDraws] = None,
            mesh: Optional[Mesh] = None):
    """GAE, the minibatch epochs and the EMA lerp on a collected rollout:
    ``(state', metrics)``. On a data axis of more than one rank
    (``mesh``) the rollout is this rank's envs: it is gathered into the
    global one, and each minibatch step trains on this rank's slice of the
    global minibatch (given ``draws.noise`` and ``draws.keep`` are the
    global minibatch's; this rank reads its rows)."""
    r = cfg.rl
    net, opt, g = state.params, state.opt_state, state.generator
    dp = data_parallel(mesh)
    last_return = state.last_return
    if dp:
        rollout = Rollout(*(all_gather_rows(x, mesh, 1) for x in rollout))
        last_value = all_gather_rows(last_value, mesh)
        last_return = all_gather_rows(last_return, mesh)
    t_len, b = rollout.reward.shape
    n = t_len * b
    mb = n // r.num_minibatches
    ent_coef = _entropy_coef(cfg, state.update)
    adv, ret = gae(rollout.reward, rollout.value, rollout.done, last_value,
                   r.gamma, r.gae_lambda)
    flat = {"image": rollout.image, "points": rollout.points,
            "mask": rollout.mask, "action": rollout.action,
            "logp": rollout.logp, "adv": adv, "ret": ret,
            "snr": rollout.snr_db}
    flat = {k: v.reshape(n, *v.shape[2:]) for k, v in flat.items()}
    params = list(net.parameters())
    losses, auxes = [], []
    if dp:
        part = local_batch_size(mesh, mb)
        rows = slice(mesh.data_index * part, (mesh.data_index + 1) * part)
    for e in range(r.ppo_epochs):
        perm = (draws.perms[e] if draws is not None and draws.perms is not None
                else torch.randperm(n, generator=g, device=g.device))
        if dp:
            # Every rank walks the first rank's permutation.
            perm = perm.contiguous()
            torch.distributed.broadcast(perm, src=mesh.data_ranks[0],
                                        group=mesh.data_group)
        for i in range(r.num_minibatches):
            idx = perm[i * mb:(i + 1) * mb]
            batch = {k: v[idx] for k, v in flat.items()}
            noise, keep, coins = (_step_draw(draws, name, e, i)
                                  for name in ("noise", "keep", "coins"))
            if dp:
                batch["adv"] = _normalise(batch["adv"])
                batch = {k: v[rows] for k, v in batch.items()}
                if noise is not None:
                    noise = shard_batch(mesh, noise)
                if keep is not None:
                    keep = shard_batch(mesh, keep)
            trunk = {}
            loss, aux = _ppo_loss(cfg, forward, net, batch, ent_coef, g,
                                  noise, keep, trunk, mesh if dp else None)
            # Parameters the loss does not reach (the last fusion layer's
            # LiDAR stream) get zero gradients, as jax.grad gives them:
            # their Adam moments then decay as optax's do.
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [torch.zeros_like(p) if gr is None else gr
                     for p, gr in zip(params, grads)]
            loss, aux = loss.detach(), {k: v.detach() for k, v in aux.items()}
            with torch.no_grad():
                if dp:
                    loss, *vals = all_reduce_mean_(grads, mesh,
                                                   [loss, *aux.values()])
                    aux = dict(zip(aux, vals))
                clip_by_global_norm_(grads, cfg.train.grad_clip, params)
                for p, gr in zip(params, grads):
                    p.grad = gr
                opt.step()
                opt.zero_grad(set_to_none=True)
                rs = collect_reseed_stats(cfg, trunk)
                coins = coins or (None, None)
                if dp:
                    # The same coins on every rank, camera's first, as
                    # apply_codebook_reseed draws them.
                    coins = [reseed_coin(rs[n][0], g, c, mesh) if n in rs
                             else c for n, c in zip(("cam", "lid"), coins)]
                apply_codebook_reseed(cfg, net, rs, g, *coins)
            losses.append(loss)
            auxes.append(aux)
    with torch.no_grad():
        if r.ema_tau > 0:
            torch._foreach_lerp_(list(state.ema_params.parameters()), params,
                                 r.ema_tau)
    dev = rollout.reward.device
    metrics = {
        "loss": torch.stack(losses).mean(),
        **{k: torch.stack([a[k] for a in auxes]).mean()
           for k in ("pg_loss", "v_loss", "entropy")},
        "entropy_coef": torch.tensor(ent_coef, dtype=torch.float32,
                                     device=dev),
        "reward": rollout.reward.mean(),
        "episode_return": last_return.mean(),
    }
    return state._replace(update=state.update + 1), metrics


def make_train_step(cfg: ExperimentConfig, mesh: Optional[Mesh] = None):
    """``train_step(state) -> (state, metrics)``: one full PPO update
    (rollout, bootstrap value, GAE, ``rl.ppo_epochs`` x
    ``rl.num_minibatches`` minibatch steps, EMA lerp), data-parallel over
    ``mesh``'s data axis."""
    r = cfg.rl
    t_len, b, n_mb = r.rollout_length, r.num_envs, r.num_minibatches
    if (t_len * b) % n_mb != 0:
        raise ValueError(
            f"rollout_length*num_envs ({t_len}*{b}) must be divisible by "
            f"num_minibatches ({n_mb}); the tail would be silently dropped")
    forward = learner_forward(cfg, ActorCritic)

    def train_step(state: PPOState):
        g = state.generator
        env_states, ep_return, last_return, rollout, (img, pts, mask) = (
            _collect_rollout(cfg, state.params, state.env_states,
                             state.ep_return, state.last_return, g))
        # Bootstrap value of the final state, under an SNR of its own.
        with torch.no_grad():
            snr = _sample_snr(cfg, g, img.shape[0], img.device)
            _, _, last_value = act(cfg, state.params, img, pts, mask, g,
                                   snr_db=snr)
        state = state._replace(env_states=env_states, ep_return=ep_return,
                               last_return=last_return)
        return _update(cfg, state, rollout, last_value, forward, mesh=mesh)

    return train_step


def shard_state(state: PPOState, mesh: Mesh, tp: bool = True) -> PPOState:
    """Place a ``PPOState`` on ``mesh``: with ``tp`` and a model axis of
    more than one rank the network and its EMA (and the Adam moments)
    keep this model rank's slice of the tensor-parallel weights
    (``runtime/tp.py``); the envs are this process's already. A no-op on a
    ``1 x 1`` mesh."""
    if tp and mesh.model > 1:
        from multimodal_sc_torch.runtime.tp import apply_tp

        apply_tp(state.params, mesh, state.opt_state)
        apply_tp(state.ema_params, mesh)
    return state
