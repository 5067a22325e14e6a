"""DQN training loop (config 4).

Counterpart of ``multimodal_sc_tpu/train/dqn.py``: the host loop around the
actor+learner iteration, metrics pulled from the device every
``train.log_every`` iterations (one transfer), the watchdogs, the
best-snapshot eval and the same result keys. ``init_from`` warm-starts the
perception trunk from a JSCC checkpoint (``rl/warmstart.py``); the target
and the EMA start from the warm weights. With ``train.checkpoint_dir`` the
run pins its config there, resumes from the newest checkpoint (networks,
Adam moments, env states, replay, n-step window, generator, counters) and
saves every ``train.checkpoint_every`` iterations; the best snapshot of
``rl.eval_snapshot_every`` is kept as host copies and written to
``<checkpoint_dir>/best`` at the end. Checkpoint and snapshot time is kept
out of the steady rate and reported as ``ckpt_save_s`` / ``ckpt_close_s``.

A digital trunk (``camera.arch="vq"``, ``lidar.arch="vq"``) starting cold
seeds its codebooks from its encoders' outputs on rendered env
observations; a warm start seeds only a codebook it did not bring, and a
resume keeps its own.

On more than one process (``torchrun --nproc-per-node N``, one process a
card) the run takes the sharded iteration (``rl/dqn_sharded.py``):
``rl.num_envs`` is split over the data shards, each with its own replay,
and the gradients are meaned over them. As in the JAX package's driver,
every process lies on the data axis (``make_mesh()``): ``mesh.data_axis``
/ ``mesh.model_axis`` are read by the PPO and JSCC drivers, not by this
one. Metrics, prints, the snapshot evaluation and the result come from
rank 0 only; the rate is each card's own. A checkpoint holds the replicated fields once
(rank 0's file, which ``eval-policy`` reads as it reads a single-card one)
and each rank's envs, replay, window and generator in a file of its own;
a resume needs the world size that wrote it and refuses another.
``train.iters_per_dispatch`` has no counterpart: PyTorch runs eagerly, so
there is no per-dispatch round trip to amortize, and the value is ignored.

As a script it trains a preset and evaluates the result:

    python -m multimodal_sc_torch.train.dqn --config c4 \\
        [--set train.steps=200 --set train.checkpoint_dir=DIR ...] \\
        [--init-from JSCC_DIR] [--eval-envs 256] [--device cuda]
    torchrun --nproc-per-node N -m multimodal_sc_torch.train.dqn \\
        --config c4 [...]

prints the card, then one JSON object: the result of ``run``, the wall time
and the greedy and eps-0.05 ``evaluate_dqn`` of the EMA and the online
network.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

import torch.distributed as dist

from multimodal_sc_torch.config.configs import ExperimentConfig
from multimodal_sc_torch.device import card_name, resolve_device, synchronize
from multimodal_sc_torch.evaluation import policy_eval
from multimodal_sc_torch.io.checkpoint import (CheckpointManager,
                                               guard_world, restore_sharded,
                                               save_sharded)
from multimodal_sc_torch.obs.metrics_writer import (MetricsWriter, Timer,
                                                    steps_per_sec_per_chip,
                                                    to_host)
from multimodal_sc_torch.obs.profiling import (CollapseWatchdog, NaNWatchdog,
                                               maybe_trace)
from multimodal_sc_torch.rl import dqn as dqn_lib
from multimodal_sc_torch.rl import dqn_sharded
from multimodal_sc_torch.rl.warmstart import cold_start, warm_start
from multimodal_sc_torch.runtime.mesh import init_distributed, make_mesh


def guard_replay_dtype(cfg: ExperimentConfig) -> None:
    """Refuse to resume across an ``rl.replay_quantize`` flip: the replay's
    image store is uint8 one way and float32 the other. The config pinned
    beside the checkpoints records the flag the run was trained with (a
    config that predates the flag trained f32 stores); an unreadable or
    foreign config is not compared."""
    path = os.path.join(cfg.train.checkpoint_dir, "config.json")
    if not os.path.exists(path):
        return
    try:
        with open(path) as f:
            saved_flag = json.load(f)["rl"].get("replay_quantize", False)
    except (json.JSONDecodeError, KeyError, TypeError):
        return
    if bool(saved_flag) != bool(cfg.rl.replay_quantize):
        raise ValueError(
            f"checkpoint dir {cfg.train.checkpoint_dir!r} was trained with "
            f"rl.replay_quantize={saved_flag} but the current config has "
            f"{cfg.rl.replay_quantize}; the replay image store would change "
            "dtype across the flip. Re-run with --set "
            f"rl.replay_quantize={str(bool(saved_flag)).lower()} or start "
            "a fresh checkpoint dir.")


def _host_copy(net) -> dict:
    return {k: v.detach().to("cpu", copy=True)
            for k, v in net.state_dict().items()}


def run(cfg: ExperimentConfig, num_envs: Optional[int] = None,
        metrics_path: Optional[str] = None, init_from: Optional[str] = None,
        device="cuda"):
    """Train config-4 DQN for ``cfg.train.steps`` iterations (resuming from
    ``train.checkpoint_dir`` when it holds a checkpoint); returns
    ``(state, result)``. ``num_envs`` defaults to ``cfg.rl.num_envs`` (the
    count a resume must use: the env and replay shapes are checked)."""
    if num_envs is None:
        num_envs = cfg.rl.num_envs
    dev = resolve_device(device)
    init_distributed(dev)
    mesh = make_mesh()
    n_shards = mesh.data
    sharded = n_shards > 1
    lead = mesh.rank == 0
    if sharded:
        if num_envs % n_shards != 0:
            raise ValueError(
                f"num_envs {num_envs} not divisible by data shards {n_shards}")
        envs_here = num_envs // n_shards
        state = dqn_sharded.init(cfg, cfg.train.seed, mesh, envs_here, dev)
    else:
        envs_here = num_envs
        state = dqn_lib.init(cfg, cfg.train.seed, num_envs, dev)
    nets = (state.params, state.target_params, state.ema_params)
    if init_from:
        warm_start(cfg, nets, init_from)
    else:
        # A cold VQ start seeds its codebooks (a resume below overwrites
        # them).
        cold_start(cfg, nets)
    if sharded:
        dqn_sharded.replicate_networks(state, mesh)
        iteration = dqn_sharded.make_iteration(cfg, mesh)
    else:
        iteration = dqn_lib.make_iteration(cfg)

    writer = MetricsWriter(metrics_path if lead else None, stdout=lead,
                           config_json=cfg.to_json())
    watchdog = NaNWatchdog()
    collapse_dog = CollapseWatchdog(num_actions=cfg.rl.num_actions)
    ckpt = None
    if cfg.train.checkpoint_dir:
        guard_replay_dtype(cfg)
        ckpt = CheckpointManager(cfg.train.checkpoint_dir)
        guard_world(ckpt, n_shards)
        if lead:
            ckpt.save_config(cfg.to_json())
        restored = (restore_sharded(ckpt, state, mesh)
                    if sharded else ckpt.restore_latest(state))
        if restored is not None:
            state = restored
    start_it = (ckpt.latest_step() or 0) if ckpt else 0

    # First-iteration wall (allocator warm-up, kernel build and load) and
    # the in-loop checkpoint writes recorded apart from the steady rate.
    first_s = None
    ckpt_s = 0.0

    # Best-snapshot selection (rl.eval_snapshot_every > 0): greedy-eval the
    # online network with a FIXED seed every ese iterations and keep the
    # best networks as host copies; eval wall time is excluded from the
    # steady rate.
    ese = cfg.rl.eval_snapshot_every
    snap_s = 0.0
    best_ret, best_it, best_tree = None, None, None

    def snapshot_eval(it: int) -> None:
        nonlocal snap_s, best_ret, best_it, best_tree
        if not lead:
            return
        synchronize(dev)
        t_ev = time.perf_counter()
        out = policy_eval.evaluate_dqn(cfg, state.params,
                                       cfg.train.seed + 0xBE57,
                                       num_envs=cfg.rl.eval_snapshot_envs)
        r = out["episode_return_mean"]
        writer.write(it, {"snapshot_eval_return": r})
        if best_ret is None or r > best_ret:
            best_ret, best_it = r, it
            best_tree = {name: _host_copy(getattr(state, name))
                         for name in ("params", "target_params",
                                      "ema_params")}
        snap_s += time.perf_counter() - t_ev

    last = {}
    with maybe_trace(cfg.train.profile_dir), Timer() as t:
        for it in range(start_it + 1, cfg.train.steps + 1):
            t0 = time.perf_counter() if first_s is None else None
            state, last = iteration(state)
            if t0 is not None:
                synchronize(dev)
                first_s = time.perf_counter() - t0
            if it % cfg.train.log_every == 0:
                writer.write(it, last)
                watchdog.check(it, last)
                collapse_dog.check(it, last)
            if ese and it % ese == 0:
                snapshot_eval(it)
            if ckpt and it % cfg.train.checkpoint_every == 0:
                t_ck = time.perf_counter()
                if sharded:
                    save_sharded(ckpt, it, state, mesh,
                                 dqn_sharded.SHARD_FIELDS)
                else:
                    ckpt.save(it, state)
                ckpt_s += time.perf_counter() - t_ck
        synchronize(dev)

    n_iters = cfg.train.steps - start_it
    extra = {"agent_steps_per_sec_per_chip": steps_per_sec_per_chip(
        n_iters * envs_here, t.elapsed)}
    if ckpt:
        t_ck = time.perf_counter()
        ckpt.close()
        extra["ckpt_save_s"] = round(ckpt_s, 2)
        extra["ckpt_close_s"] = round(time.perf_counter() - t_ck, 2)
    if best_ret is not None:
        extra["best_eval_return"] = round(best_ret, 3)
        extra["best_eval_iter"] = best_it
        extra["snapshot_eval_s"] = round(snap_s, 2)
        if ckpt and lead:
            ckpt.save_best_policy({**best_tree, "step": best_it,
                                   "eval_return": best_ret})
    steady_steps = n_iters - 1
    if first_s is not None and steady_steps > 0 and \
            t.elapsed > first_s + ckpt_s + snap_s:
        extra["first_dispatch_s"] = round(first_s, 2)
        extra["steady_steps_per_sec_per_chip"] = steps_per_sec_per_chip(
            steady_steps * envs_here, t.elapsed - first_s - ckpt_s - snap_s)
    if sharded:
        extra["data_shards"] = n_shards
    writer.write(cfg.train.steps, {**last, **extra})
    writer.close()
    return state, {**to_host(last), **extra}


def main(argv=None) -> int:
    from multimodal_sc_torch.config import get_preset

    ap = argparse.ArgumentParser(description="Train a DQN preset, then "
                                 "evaluate its EMA and online networks.")
    ap.add_argument("--config", default="c4")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="config override, e.g. train.steps=200 (repeatable)")
    ap.add_argument("--num-envs", type=int, default=None)
    ap.add_argument("--metrics-path", default=None)
    ap.add_argument("--init-from", default=None, metavar="JSCC_DIR",
                    help="JSCC checkpoint dir to warm-start the perception "
                         "trunk from")
    ap.add_argument("--eval-envs", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_preset(args.config).override_str(args.set).validate()
    dev = resolve_device(args.device)
    init_distributed(dev)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    card = card_name(dev)
    if lead:
        print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    state, result = run(cfg, args.num_envs, args.metrics_path,
                        init_from=args.init_from, device=dev)
    if not lead:
        return 0
    result["train_wall_s"] = round(time.perf_counter() - t0, 2)
    seed = cfg.train.seed + 0xE7A1
    for name, net in (("ema", state.ema_params), ("online", state.params)):
        for eps in (0.0, 0.05):
            out = policy_eval.evaluate_dqn(cfg, net, seed, args.eval_envs,
                                           epsilon=eps)
            result[f"eval_{name}_eps{eps:g}_return"] = out[
                "episode_return_mean"]
    result["learn_steps"] = state.step
    result["card"] = card
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
