"""Multi-process jobs for the port's distributed tests, on gloo.

Imports neither JAX nor the JAX package: the ranks are spawned processes
that import this module, and JAX (which ``tests/conftest.py`` loads) would
cost each of them seconds and threads. A ``RankPool`` starts its processes
once (one per rank, one torch thread each), joins them into one process
group through a ``file://`` rendezvous under a temporary directory (no
fixed TCP port, so test workers running side by side never collide) and
then runs named jobs of this module on every rank, returning each rank's
result. A job that raises on any rank fails the call with that rank's
traceback; a rank that never answers fails it at the timeout.
"""

from __future__ import annotations

import os
import queue
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# c4 at the tiny widths of the JAX package's sharded-DQN tests.
TINY_C4 = ["camera.features=8,16,16,16", "camera.c_sym=2",
           "camera.image_hw=16,16", "env.image_hw=16,16",
           "lidar.pillar_dim=16", "lidar.c_sym=2", "lidar.bev_hw=8,8",
           "fusion.dim=32", "fusion.depth=1", "fusion.heads=2",
           "fusion.state_dim=32", "env.num_npcs=2", "env.lidar_rays=16",
           "rl.replay_capacity=32", "rl.batch_size=8",
           "rl.target_update_period=4"]


def _worker(rank, world, init_file, jobs, results):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=world)
    except Exception:
        # Every job of this rank reports the failed rendezvous.
        err = traceback.format_exc()
        while jobs.get() is not None:
            results.put((rank, False, err))
        return
    while True:
        job = jobs.get()
        if job is None:
            break
        name, kwargs = job
        try:
            results.put((rank, True, globals()[name](**kwargs)))
        except Exception:            # the test reads the rank's traceback
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """``world`` spawned ranks in one gloo process group."""

    def __init__(self, world: int, tmpdir: str):
        ctx = mp.get_context("spawn")
        self.world = world
        self.jobs = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        os.makedirs(str(tmpdir), exist_ok=True)
        init_file = os.path.join(str(tmpdir), f"rendezvous_{world}")
        self.procs = [ctx.Process(target=_worker, daemon=True,
                                  args=(r, world, init_file, self.jobs[r],
                                        self.results))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, name: str, timeout: float = 240.0, **kwargs):
        """Run job ``name`` of this module on every rank; returns the
        results by rank."""
        for q in self.jobs:
            q.put((name, kwargs))
        out, errors = {}, []
        for _ in range(self.world):
            try:
                rank, ok, value = self.results.get(timeout=timeout)
            except queue.Empty:
                self.close(force=True)
                raise TimeoutError(f"job {name}: no answer from every rank "
                                   f"in {timeout} s; {errors}") from None
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                if len(errors) == 1:
                    # The other ranks may wait in a collective forever.
                    self.close(force=True)
                    raise RuntimeError(f"job {name} failed on {errors[0]}")
        return [out[r] for r in range(self.world)]

    def close(self, force: bool = False) -> None:
        for p, q in zip(self.procs, self.jobs):
            if p.is_alive() and not force:
                q.put(None)
        for p in self.procs:
            p.join(timeout=0 if force else 30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)


# --------------------------------------------------------------- helpers


def _tiny_c4(extra=()):
    from multimodal_sc_torch.config import get_preset

    return get_preset("c4").override_str(TINY_C4 + list(extra))


def _flat_params(net) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in net.parameters()])


def _equal_across_ranks(x: torch.Tensor, group=None) -> bool:
    """Whether ``x`` is bit-equal on every rank of ``group``."""
    n = dist.get_world_size(group)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return all(torch.equal(parts[0], p) for p in parts[1:])


def _numpy_state(net) -> dict:
    return {k: v.detach().numpy().copy() for k, v in net.state_dict().items()}


# ------------------------------------------------------------ DQN jobs


def dqn_iterations(iters: int, envs_per_shard: int, extra=(), seed=0):
    """The sharded iteration at 2 x ``envs_per_shard`` envs: whether the
    networks stayed bit-equal across ranks after every iteration, the
    buffer size, the learn steps and the last metrics."""
    from multimodal_sc_torch.rl import dqn_sharded
    from multimodal_sc_torch.runtime.mesh import make_mesh

    cfg = _tiny_c4(extra)
    mesh = make_mesh()
    state = dqn_sharded.init(cfg, seed, mesh, envs_per_shard, "cpu")
    it = dqn_sharded.make_iteration(cfg, mesh)
    equal, first_rewards = [], None
    for _ in range(iters):
        state, metrics = it(state)
        if first_rewards is None and state.buffer_size:
            first_rewards = state.buffer_data.reward[:envs_per_shard].clone()
        equal.append(all(_equal_across_ranks(_flat_params(n)) for n in (
            state.params, state.target_params, state.ema_params)))
    moments = [v for s in state.opt_state.state.values()
               for v in s.values() if v.dim() > 0]
    return {"equal": equal, "buffer_size": state.buffer_size,
            "step": state.step,
            "moments_equal": _equal_across_ranks(torch.cat(
                [m.reshape(-1) for m in moments])) if moments else True,
            "rewards_differ": not _equal_across_ranks(first_rewards),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def dqn_learn_step(params, target, batches, noises, adam, extra=()):
    """One sharded learn step from the given networks (port state dicts)
    and Adam state (``(count, mu, nu)``, the moments as port state dicts),
    each rank on ``batches[rank]`` with ``noises[rank]`` (the three
    forwards' link draws, as numpy): the online network and the loss
    afterwards."""
    from multimodal_sc_torch.rl import dqn, dqn_sharded
    from multimodal_sc_torch.rl.perception import LinkDraws
    from multimodal_sc_torch.runtime.mesh import make_mesh

    rank = dist.get_rank()
    cfg = _tiny_c4(extra)
    mesh = make_mesh()
    state = dqn.init(cfg, 0, 2, "cpu")
    for net, sd in ((state.params, params), (state.target_params, target),
                    (state.ema_params, params)):
        net.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    count, mu, nu = adam
    for name, p in state.params.named_parameters():
        state.opt_state.state[p] = {"step": torch.tensor(float(count)),
                                    "exp_avg": torch.tensor(mu[name]),
                                    "exp_avg_sq": torch.tensor(nu[name])}
    batch = dqn.Transition(*(torch.tensor(x) for x in batches[rank]))
    noise = [LinkDraws(*(torch.tensor(x) for x in n)) for n in noises[rank]]
    draws = dqn.LearnDraws(indices=torch.arange(len(batch.action)),
                           snr_db=None, noise_online=noise[0],
                           noise_target=noise[1], noise_double=noise[2])
    state, loss = dqn.learn_step(cfg, state, batch, draws,
                                 sync=dqn_sharded.DataSync(mesh))
    return {"params": _numpy_state(state.params), "loss": float(loss),
            "equal": _equal_across_ranks(_flat_params(state.params))}


def dqn_driver(ckpt_dir: str, steps: int, every: int, metrics_path=None,
               extra=()):
    """``train.dqn.run`` at 2 ranks x 2 envs with checkpoints every
    ``every`` iterations: rank 0's result and each rank's final replay,
    networks and generator state."""
    from multimodal_sc_torch.train import dqn as train_dqn

    cfg = _tiny_c4([f"train.steps={steps}", "train.log_every=1",
                    f"train.checkpoint_every={every}",
                    f"train.checkpoint_dir={ckpt_dir}", "rl.num_envs=4",
                    *extra])
    state, result = train_dqn.run(cfg, metrics_path=metrics_path,
                                  device="cpu")
    lead = not dist.is_initialized() or dist.get_rank() == 0
    if not dist.is_initialized():         # one process: a DQNState
        from multimodal_sc_torch.rl.dqn_sharded import from_dqn_state

        state = from_dqn_state(state)
    return {"result": result if lead else None,
            "params": _flat_params(state.params).numpy(),
            "ema": _flat_params(state.ema_params).numpy(),
            "reward": state.buffer_data.reward.numpy().copy(),
            "size": state.buffer_size, "step": state.step,
            "gen": state.keys.get_state().numpy()}


def dqn_driver_refuses(ckpt_dir: str, steps: int):
    """The error a resume of ``ckpt_dir`` at this world size raises."""
    try:
        dqn_driver(ckpt_dir, steps, steps)
    except ValueError as e:
        return str(e)
    return None


def mesh_layout(data: int, model: int):
    """This rank's mesh coordinates and group ranks."""
    from multimodal_sc_torch.runtime.mesh import make_mesh

    m = make_mesh(data=data, model=model)
    return {"data_index": m.data_index, "model_index": m.model_index,
            "data_ranks": list(m.data_ranks), "shape": dict(m.shape)}


def mesh_collectives():
    """shard_batch, replicate and the gradient mean on 2 ranks."""
    from multimodal_sc_torch.runtime.mesh import (all_reduce_mean_,
                                                  make_mesh, replicate,
                                                  shard_batch)

    rank = dist.get_rank()
    m = make_mesh()
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    local = shard_batch(m, {"x": x, "s": torch.tensor(5.0)})
    net = torch.nn.Linear(3, 2)
    with torch.no_grad():
        net.weight.fill_(float(rank))
    replicate(m, net)
    g = [torch.full((2, 2), float(rank + 1)), torch.full((3,), 2.0 * rank)]
    loss_mean = all_reduce_mean_(g, m, [torch.tensor(float(rank))])
    return {"local": local["x"].numpy(), "scalar": float(local["s"]),
            "weight": net.weight.detach().numpy(),
            "g0": g[0].numpy(), "g1": g[1].numpy(),
            "loss": float(loss_mean[0])}


# ----------------------------------------------------- attention jobs


def ring_job(q, k, v, kind: str, grad_out=None, data=-1, model=1):
    """Ring or Ulysses attention over the data group of a ``data x model``
    mesh on this rank's block of the sequence: the output and, given
    ``grad_out``, the gradients of q, k and v, gathered over the data
    group."""
    from multimodal_sc_torch.kernels.ring_attention import (ring_attention,
                                                            shard_sequence,
                                                            ulysses_attention)
    from multimodal_sc_torch.runtime.mesh import make_mesh

    m = make_mesh(data=data, model=model)
    fn = ring_attention if kind == "ring" else ulysses_attention
    qs, ks, vs = (shard_sequence(torch.tensor(a), m).requires_grad_(True)
                  for a in (q, k, v))
    out = fn(qs, ks, vs, m)

    def gather(t):
        parts = [torch.empty_like(t) for _ in range(m.data)]
        dist.all_gather(parts, t.contiguous(), group=m.data_group)
        return torch.cat(parts, dim=2).detach().numpy()

    res = {"out": gather(out), "local_shape": list(out.shape)}
    if grad_out is not None:
        out.backward(shard_sequence(torch.tensor(grad_out), m))
        res.update({n: gather(t.grad) for n, t in
                    (("dq", qs), ("dk", ks), ("dv", vs))})
    return res


def ulysses_heads_error(heads: int):
    from multimodal_sc_torch.kernels.ring_attention import ulysses_attention
    from multimodal_sc_torch.runtime.mesh import make_mesh

    m = make_mesh()
    q = torch.zeros(1, heads, 8, 4)
    try:
        ulysses_attention(q, q, q, m)
    except ValueError as e:
        return str(e)
    return None


# ------------------------------------------------------------ TP jobs


def tp_fusion_step(sd, cam, lid, tgt, data: int, model: int, cfg_kw: dict,
                   lr: float = 1e-2):
    """A ``FusionTransformer`` under tensor parallelism on a ``data x
    model`` mesh: its forward on this rank's rows, then one SGD step on
    the MSE to ``tgt`` with gradients meaned over the data group. Returns
    the gathered output, the loss, the full updated parameters and this
    rank's parameter shapes."""
    from multimodal_sc_torch.fusion.transformer import FusionTransformer
    from multimodal_sc_torch.runtime.mesh import (all_reduce_mean_,
                                                  make_mesh, shard_batch)
    from multimodal_sc_torch.runtime.tp import apply_tp, tp_param_shardings

    mesh = make_mesh(data=data, model=model)
    net = FusionTransformer(**cfg_kw)
    net.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    specs = tp_param_shardings(net)
    apply_tp(net, mesh)
    cam_l, lid_l, tgt_l = shard_batch(mesh, (torch.tensor(cam),
                                            torch.tensor(lid),
                                            torch.tensor(tgt)))
    y = net(cam_l, lid_l)
    loss = (y - tgt_l).square().mean()
    params = list(net.parameters())
    # The last layer's LiDAR stream is not read: zero gradients.
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
        params, torch.autograd.grad(loss, params, allow_unused=True))]
    with torch.no_grad():
        loss_mean = all_reduce_mean_(grads, mesh, [loss.detach()])[0] \
            if mesh.data > 1 else loss.detach()
        for p, g in zip(params, grads):
            p -= lr * g
    # The full parameters: each sharded one gathered over the model group.
    full = {}
    for name, p in net.named_parameters():
        spec = specs[name]
        t = p.detach()
        if spec and mesh.model > 1:
            dim = 0 if spec[0] is None else 1
            parts = [torch.empty_like(t) for _ in range(mesh.model)]
            dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
            t = torch.cat(parts, dim=dim)
        full[name] = t.numpy()
    ys = [torch.empty_like(y) for _ in range(dist.get_world_size())]
    dist.all_gather(ys, y.detach().contiguous())
    # Rows of data index i come from any rank of model group i.
    out = torch.cat([ys[i * mesh.model] for i in range(mesh.data)])
    return {"y": out.numpy(), "loss": float(loss_mean), "params": full,
            "shapes": {n: list(p.shape) for n, p in net.named_parameters()}}


def tp_dqn_iterations(iters: int, data: int, model: int, extra=()):
    """The sharded DQN iteration with the networks under tensor
    parallelism (``dqn.shard_state``) on a ``data x model`` mesh: the
    metrics of each iteration and the gathered online network."""
    from multimodal_sc_torch.rl import dqn_sharded
    from multimodal_sc_torch.rl.dqn import shard_state
    from multimodal_sc_torch.runtime.mesh import make_mesh
    from multimodal_sc_torch.runtime.tp import tp_param_shardings

    cfg = _tiny_c4(extra)
    mesh = make_mesh(data=data, model=model)
    state = dqn_sharded.init(cfg, 0, mesh, 2, "cpu")
    specs = tp_param_shardings(state.params)
    state = dqn_sharded.from_dqn_state(shard_state(
        dqn_sharded.to_dqn_state(cfg, state), mesh))
    it = dqn_sharded.make_iteration(cfg, mesh)
    metrics = []
    for _ in range(iters):
        state, m = it(state)
        metrics.append({k: float(v) for k, v in m.items()})
    full = []
    for name, p in state.params.named_parameters():
        t = p.detach()
        if specs[name] and mesh.model > 1:
            parts = [torch.empty_like(t) for _ in range(mesh.model)]
            dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
            t = torch.cat(parts, dim=0 if specs[name][0] is None else 1)
        full.append(t.reshape(-1))
    return {"metrics": metrics, "params": torch.cat(full).numpy(),
            "sharded": sum(1 for s in specs.values() if s)}


# ------------------------------------------------- PPO and JSCC jobs


def ppo_update(cfg_over, rollout, last_value, params, perms, noises,
               update: int = 0, adam=None, keep=None, coins=None):
    """One data-parallel PPO update (``rl/ppo.py`` ``_update`` over the
    mesh) on this rank's envs of the given global rollout, with the given
    permutations and each global minibatch's link draws (a ``None`` field
    drawn), kept fractions and re-seeding coins: the network and metrics
    afterwards. ``adam`` is ``(count, exp_avg, exp_avg_sq)``, the moments
    by parameter name, to start from (default: a fresh Adam)."""
    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.rl import ppo
    from multimodal_sc_torch.rl.dqn import learner_forward
    from multimodal_sc_torch.rl.perception import ActorCritic, LinkDraws
    from multimodal_sc_torch.runtime.mesh import make_mesh

    cfg = get_preset("c5").override_str(list(cfg_over))
    mesh = make_mesh()
    state = ppo.init(cfg, 0, "cpu")
    state.params.load_state_dict({k: torch.tensor(v)
                                  for k, v in params.items()})
    state.ema_params.load_state_dict(state.params.state_dict())
    if adam is not None:
        count, mu, nu = adam
        for name, p in state.params.named_parameters():
            state.opt_state.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": torch.tensor(mu[name]),
                "exp_avg_sq": torch.tensor(nu[name])}
    state = state._replace(update=update)
    ro = ppo.Rollout(*(torch.tensor(x) for x in rollout))
    b = ro.reward.shape[1] // mesh.data
    sl = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    local = ppo.Rollout(*(x[:, sl] for x in ro))
    def tensors(xs):
        return tuple(None if x is None else torch.tensor(x) for x in xs)

    draws = ppo.UpdateDraws(
        perms=[torch.tensor(p) for p in perms],
        noise=[[LinkDraws(*tensors(n)) for n in epoch] for epoch in noises],
        keep=None if keep is None else [[torch.tensor(k) for k in epoch]
                                        for epoch in keep],
        coins=None if coins is None else [[tensors(c) for c in epoch]
                                          for epoch in coins])
    state, metrics = ppo._update(cfg, state, local,
                                 torch.tensor(last_value)[sl],
                                 learner_forward(cfg, ActorCritic), draws,
                                 mesh=mesh)
    return {"params": _numpy_state(state.params),
            "equal": _equal_across_ranks(_flat_params(state.params)),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def jscc_step(cfg_over, params, batch, draws, seed: int = 0):
    """One data-parallel JSCC train step (``train/jscc.py``) on this
    rank's rows of the global batch, with its rows of the given draws."""
    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.train import jscc
    from multimodal_sc_torch.channel import ChannelDraws
    from multimodal_sc_torch.runtime.mesh import make_mesh, shard_batch

    cfg = get_preset("c1").override_str(list(cfg_over))
    mesh = make_mesh()
    state = jscc.create_train_state(cfg, seed, "cpu")
    state.params.load_state_dict({k: torch.tensor(v)
                                  for k, v in params.items()})
    step = jscc.make_train_step(cfg, mesh=mesh)
    given = {k: (ChannelDraws(*(torch.tensor(x) for x in v))
                 if isinstance(v, tuple) else torch.tensor(v))
             for k, v in draws.items()}
    batch = (tuple(torch.tensor(x) for x in batch)
             if isinstance(batch, tuple) else torch.tensor(batch))
    state, metrics = step(state, shard_batch(mesh, batch),
                          jscc.StepDraws(**given))
    return {"params": _numpy_state(state.params),
            "equal": _equal_across_ranks(_flat_params(state.params)),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def ppo_tp_driver(ckpt_dir: str, steps: int, every: int, cfg_over=()):
    """``train.ppo.run`` on a data 1 x model 2 mesh with checkpoints every
    ``every`` updates: this rank's slices of the final network, EMA and
    Adam moments, and the network gathered whole."""
    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.runtime.tp import whole_state_dict
    from multimodal_sc_torch.train import ppo as train_ppo

    cfg = get_preset("c5").override_str(list(cfg_over) + [
        "mesh.model_axis=2", f"train.steps={steps}",
        f"train.checkpoint_every={every}",
        f"train.checkpoint_dir={ckpt_dir}"])
    state, _ = train_ppo.run(cfg, device="cpu")
    moments = [v.numpy().copy() for st in state.opt_state.state.values()
               for v in st.values() if v.dim() > 0]
    return {"params": _numpy_state(state.params),
            "ema": _numpy_state(state.ema_params), "moments": moments,
            "whole": {k: v.numpy().copy()
                      for k, v in whole_state_dict(state.params).items()},
            "update": state.update}


def jscc_batch_rows(seed: int, batch: int):
    """This rank's rows of the dataset's global batch at step 0."""
    from multimodal_sc_torch.envs.datasets import ImageDataset
    from multimodal_sc_torch.runtime.mesh import make_mesh, shard_batch

    m = make_mesh()
    data = ImageDataset("synthetic", batch, seed=seed, device="cpu")
    return shard_batch(m, next(data)).numpy()


def barrier():
    dist.barrier()
    return np.int64(dist.get_rank())
