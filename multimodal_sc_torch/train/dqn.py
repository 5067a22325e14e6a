"""DQN training loop (config 4).

Counterpart of ``multimodal_sc_tpu/train/dqn.py``: the host loop around the
actor+learner iteration, metrics pulled from the device every
``train.log_every`` iterations (one transfer), the watchdogs, the
best-snapshot eval and the same result keys.

Not ported yet, each raising: checkpoints and resume
(``train.checkpoint_dir``, ROADMAP item 10), the ``init_from`` warm start
and VQ codebook seeding (items 14-15), the sharded iteration (item 16: one
process drives one card). ``train.iters_per_dispatch`` has no counterpart:
PyTorch runs eagerly, so there is no per-dispatch round trip to amortize,
and the value is ignored.

As a script it trains a preset and evaluates the result:

    python -m multimodal_sc_torch.train.dqn --config c4 \\
        [--set train.steps=200 ...] [--eval-envs 64] [--device cuda]

prints the card, then one JSON object: the result of ``run``, the wall time
and the greedy ``evaluate_dqn`` of the EMA and the online network.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Optional

import torch

from multimodal_sc_torch.config.configs import ExperimentConfig
from multimodal_sc_torch.device import resolve_device
from multimodal_sc_torch.evaluation import policy_eval
from multimodal_sc_torch.obs.metrics_writer import (MetricsWriter, Timer,
                                                    steps_per_sec_per_chip,
                                                    to_host)
from multimodal_sc_torch.obs.profiling import (CollapseWatchdog, NaNWatchdog,
                                               maybe_trace)
from multimodal_sc_torch.rl import dqn as dqn_lib


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cfg: ExperimentConfig, num_envs: Optional[int] = None,
        metrics_path: Optional[str] = None, init_from: Optional[str] = None,
        device="cuda"):
    """Train config-4 DQN for ``cfg.train.steps`` iterations; returns
    ``(state, result)``. ``num_envs`` defaults to ``cfg.rl.num_envs``."""
    if init_from:
        raise NotImplementedError(
            "the JSCC warm start is not ported yet (ROADMAP item 15)")
    if cfg.train.checkpoint_dir:
        raise NotImplementedError(
            "checkpoints and resume are not ported yet (ROADMAP item 10)")
    if cfg.camera.arch == "vq" or cfg.lidar.arch == "vq":
        raise NotImplementedError(
            "VQ codebook seeding is not ported yet (ROADMAP item 14)")
    if num_envs is None:
        num_envs = cfg.rl.num_envs
    dev = resolve_device(device)
    state = dqn_lib.init(cfg, cfg.train.seed, num_envs, dev)
    iteration = dqn_lib.make_iteration(cfg)

    writer = MetricsWriter(metrics_path, config_json=cfg.to_json())
    watchdog = NaNWatchdog()
    collapse_dog = CollapseWatchdog(num_actions=cfg.rl.num_actions)

    # First-iteration wall (allocator warm-up, kernel build and load)
    # recorded apart from the steady rate.
    first_s = None

    # Best-snapshot selection (rl.eval_snapshot_every > 0): greedy-eval the
    # online network with a FIXED seed every ese iterations and record the
    # best return and its iteration. The JAX package persists that snapshot
    # under the checkpoint directory; until checkpoints are ported there is
    # nowhere to keep it. Eval wall time is excluded from the steady rate.
    ese = cfg.rl.eval_snapshot_every
    snap_s = 0.0
    best_ret, best_it = None, None

    def snapshot_eval(it: int) -> None:
        nonlocal snap_s, best_ret, best_it
        _sync(dev)
        t_ev = time.perf_counter()
        out = policy_eval.evaluate_dqn(cfg, state.params,
                                       cfg.train.seed + 0xBE57,
                                       num_envs=cfg.rl.eval_snapshot_envs)
        r = out["episode_return_mean"]
        writer.write(it, {"snapshot_eval_return": r})
        if best_ret is None or r > best_ret:
            best_ret, best_it = r, it
        snap_s += time.perf_counter() - t_ev

    last = {}
    with maybe_trace(cfg.train.profile_dir), Timer() as t:
        for it in range(1, cfg.train.steps + 1):
            t0 = time.perf_counter() if first_s is None else None
            state, last = iteration(state)
            if t0 is not None:
                _sync(dev)
                first_s = time.perf_counter() - t0
            if it % cfg.train.log_every == 0:
                writer.write(it, last)
                watchdog.check(it, last)
                collapse_dog.check(it, last)
            if ese and it % ese == 0:
                snapshot_eval(it)
        _sync(dev)

    sps = steps_per_sec_per_chip(cfg.train.steps * num_envs, t.elapsed)
    extra = {"agent_steps_per_sec_per_chip": sps}
    if best_ret is not None:
        extra["best_eval_return"] = round(best_ret, 3)
        extra["best_eval_iter"] = best_it
        extra["snapshot_eval_s"] = round(snap_s, 2)
    steady_steps = cfg.train.steps - 1
    if first_s is not None and steady_steps > 0 and \
            t.elapsed > first_s + snap_s:
        extra["first_dispatch_s"] = round(first_s, 2)
        extra["steady_steps_per_sec_per_chip"] = steps_per_sec_per_chip(
            steady_steps * num_envs, t.elapsed - first_s - snap_s)
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
    ap.add_argument("--eval-envs", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_preset(args.config).override_str(args.set)
    dev = resolve_device(args.device)
    card = "cpu"
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    state, result = run(cfg, args.num_envs, args.metrics_path, device=dev)
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
