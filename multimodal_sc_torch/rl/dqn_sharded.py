"""Data-parallel DQN: the actor+learner iteration over the mesh's ``data``
axis.

Counterpart of ``multimodal_sc_tpu/rl/dqn_sharded.py``. Each process holds
its shard: ``envs_per_shard`` envs, their carried observation, its own
replay buffer and n-step window and its own generator. The networks, the
target, the EMA and the Adam moments are replicated. One iteration is
``rl/dqn.py``'s: act, step, push the window and add to the local replay;
once warm, each process samples its own batch and takes the TD gradient,
and the gradients are meaned over the data group (one flattened bucket,
the loss riding in it for logging) before the clip and Adam, so every
replica takes the same step. That mean is the only collective of a learn
step, as the JAX package's ``pmean`` is.

Metrics are pooled as the JAX package pools them: reward and episode
return meaned over the shards, the action entropy taken from the meaned
histogram, ``buffer_size`` the process's own (the same on every shard).
Codebook re-seeding reads replicated inputs so every replica edits its
codebook alike: usage counts summed over the shards, candidates and coins
from the first shard (the coins from its generator, as the single-process
learner draws them).

Rank r's generator is seeded ``seed`` for data index 0 and
``seed + r * 0x9E3779B1`` (mod 2^63) for data index r, so a world of one
is ``rl/dqn.py``'s ``init`` exactly and its iteration bit-equal to
``rl/dqn.py``'s ``make_iteration``. Under tensor parallelism the ranks of
one model group share a data index, hence their envs and draws.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist

from multimodal_sc_torch.config.configs import ExperimentConfig
from multimodal_sc_torch.rl import dqn as dqn_lib
from multimodal_sc_torch.rl import replay
from multimodal_sc_torch.codec.semantic_vq import reseed_coin
from multimodal_sc_torch.rl.perception import QNetwork
from multimodal_sc_torch.runtime.mesh import (Mesh, all_reduce_mean_,
                                              from_first_shard, replicate,
                                              shard_seed)

# The per-shard fields: what a checkpoint holds once for each process.
SHARD_FIELDS = ("env_states", "buffer_data", "buffer_cursor", "buffer_size",
                "window", "keys", "ep_return", "last_return", "obs_image",
                "obs_points", "obs_mask")


class ShardedDQNState(NamedTuple):
    params: QNetwork           # replicated
    target_params: QNetwork    # replicated
    ema_params: QNetwork       # replicated deployment EMA
    opt_state: torch.optim.Adam   # replicated moments
    env_states: Any            # this shard's (E, ...) envs
    buffer_data: Any           # this shard's replay stores (capacity, ...)
    buffer_cursor: int         # this shard's write cursor
    buffer_size: int           # this shard's valid rows
    window: Any                # this shard's n-step window
    keys: torch.Generator      # this shard's generator
    step: int                  # replicated gradient-step counter
    ep_return: torch.Tensor    # (E,)
    last_return: torch.Tensor  # (E,)
    obs_image: torch.Tensor    # (E, H, W, 3) f32 or uint8
    obs_points: torch.Tensor   # (E, R, 4)
    obs_mask: torch.Tensor     # (E, R)


def to_dqn_state(cfg: ExperimentConfig,
                 state: ShardedDQNState) -> dqn_lib.DQNState:
    return dqn_lib.DQNState(
        params=state.params, target_params=state.target_params,
        ema_params=state.ema_params, opt_state=state.opt_state,
        env_states=state.env_states,
        buffer=replay.ReplayBuffer(data=state.buffer_data,
                                   cursor=state.buffer_cursor,
                                   size=state.buffer_size,
                                   capacity=cfg.rl.replay_capacity),
        window=state.window, generator=state.keys, step=state.step,
        ep_return=state.ep_return, last_return=state.last_return,
        obs_image=state.obs_image, obs_points=state.obs_points,
        obs_mask=state.obs_mask)


def from_dqn_state(state: dqn_lib.DQNState) -> ShardedDQNState:
    buf = state.buffer
    return ShardedDQNState(
        params=state.params, target_params=state.target_params,
        ema_params=state.ema_params, opt_state=state.opt_state,
        env_states=state.env_states, buffer_data=buf.data,
        buffer_cursor=buf.cursor, buffer_size=buf.size, window=state.window,
        keys=state.generator, step=state.step, ep_return=state.ep_return,
        last_return=state.last_return, obs_image=state.obs_image,
        obs_points=state.obs_points, obs_mask=state.obs_mask)


def replicate_networks(state: ShardedDQNState, mesh: Mesh) -> None:
    """Broadcast the replicated fields (networks and Adam moments) from the
    mesh's first rank, IN PLACE."""
    replicate(mesh, (state.params, state.target_params, state.ema_params,
                     state.opt_state))


def init(cfg: ExperimentConfig, seed: int, mesh: Mesh,
         envs_per_shard: int = 8, device="cuda") -> ShardedDQNState:
    """This process's shard of a fresh sharded state: ``rl/dqn.py``'s
    ``init`` at the shard's seed and ``envs_per_shard`` envs, the networks
    then broadcast from the first rank."""
    state = from_dqn_state(dqn_lib.init(
        cfg, shard_seed(seed, mesh.data_index), envs_per_shard, device))
    replicate_networks(state, mesh)
    return state


class DataSync:
    """The learner's collectives over the data group (``rl/dqn.py``
    ``learn_step``'s ``sync``)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def grads(self, grads, loss: torch.Tensor) -> torch.Tensor:
        """Mean the gradients IN PLACE; returns the meaned loss."""
        return all_reduce_mean_(grads, self.mesh, [loss])[0]

    def reseed(self, rs: dict, generator: torch.Generator,
               coin: Optional[torch.Tensor],
               lid_coin: Optional[torch.Tensor]):
        """Usage counts summed over the shards; candidates and coins (the
        first shard's generator's, camera's first, where not given) from
        the first shard."""
        mesh = self.mesh
        coins = {"cam": coin, "lid": lid_coin}
        out = {}
        for name in ("cam", "lid"):
            if name not in rs:
                continue
            counts, cands = rs[name]
            coins[name] = reseed_coin(counts, generator, coins[name], mesh)
            if mesh.data > 1:
                counts = counts.clone()
                dist.all_reduce(counts, group=mesh.data_group)
                cands = from_first_shard(cands, mesh)
            out[name] = (counts, cands)
        return out, coins["cam"], coins["lid"]


def _check_warm(warm: bool, mesh: Mesh) -> None:
    """Every shard must agree on whether the learner runs (a shard that
    skipped the gradient mean would leave the others waiting)."""
    t = torch.tensor([float(warm)])
    if dist.get_backend(mesh.data_group) == "nccl":
        t = t.cuda()
    dist.all_reduce(t, group=mesh.data_group)
    n = int(t.item())
    if n not in (0, mesh.data):
        raise RuntimeError(f"{n} of {mesh.data} data shards hold a warm "
                           "replay: the shards disagree on the learn step")


def make_iteration(cfg: ExperimentConfig, mesh: Mesh):
    """The sharded actor(+learner) iteration: ``state -> (state,
    metrics)``, the metrics pooled over the data group. On a data axis of
    one rank it is ``rl/dqn.py``'s ``make_iteration``, bit for bit."""
    forward = dqn_lib.learner_forward(cfg)
    sync = DataSync(mesh)
    s = mesh.data
    warm_seen = [False]

    def iteration(state: ShardedDQNState):
        st, metrics, actions = dqn_lib.act_and_store(
            cfg, to_dqn_state(cfg, state))
        buf = st.buffer
        warm = buf.size >= cfg.rl.batch_size
        if s > 1:
            hist = torch.nn.functional.one_hot(
                actions.long(), cfg.rl.num_actions).float().mean(0)
            pooled = torch.cat([metrics["reward"].reshape(1),
                                metrics["episode_return"].reshape(1), hist])
            dist.all_reduce(pooled, group=mesh.data_group)
            pooled /= s
            hist = pooled[2:]
            metrics["reward"], metrics["episode_return"] = pooled[0], \
                pooled[1]
            metrics["action_entropy"] = -(hist * torch.log(hist + 1e-9)).sum()
            if not warm_seen[0]:
                # Checked until the replay warms (it never cools again).
                _check_warm(warm, mesh)
                warm_seen[0] = warm
        if warm:
            draws = dqn_lib.draw_learn(cfg, buf.size, st.generator,
                                       buf.data[0].device)
            batch = dqn_lib.dequantize_obs(cfg, replay.sample(
                buf, None, cfg.rl.batch_size, draws.indices))
            st, metrics["loss"] = dqn_lib.learn_step(
                cfg, st, batch, draws, forward, sync if s > 1 else None)
        return from_dqn_state(st), metrics

    return iteration
