"""PPO training loop (config 5).

Counterpart of ``multimodal_sc_tpu/train/ppo.py``: the host loop around the
full PPO update (rollout, GAE, minibatch epochs), metrics pulled from the
device every ``train.log_every`` updates (one transfer), the NaN watchdog
and the same result keys. Env steps count updates x T x B. ``init_from``
warm-starts the perception trunk from a JSCC checkpoint and the EMA starts
from the warm weights; with ``train.checkpoint_dir`` the run pins its
config, resumes from the newest checkpoint (network, EMA, Adam moments, env
states, generator, counters) and saves every ``train.checkpoint_every``
updates, the writes kept out of the steady rate.

A digital trunk starting cold seeds its codebooks, and after a warm start
only a codebook the source did not bring, as the DQN driver does.

Under ``torchrun --nproc-per-node N`` (one process a card) the run lays
the processes out as ``mesh.data_axis`` x ``mesh.model_axis``
(``runtime/mesh.py``): the data axis splits the envs and trains on slices
of one global batch (``rl/ppo.py``), the model axis puts the network under
tensor parallelism (``shard_state``). Metrics, prints and the result come
from rank 0; the rate is each card's own. A checkpoint holds the
replicated fields once, in the single-card layout (the network, the EMA
and the Adam moments gathered whole from the model ranks, as orbax writes
the JAX package's global arrays), and each data shard's envs and
generator beside them. A resume restores the whole network, then keeps
this model rank's slice: it may run at another model-axis size, or on one
card (``eval-policy``), but needs the data-axis size that wrote it.
``train.iters_per_dispatch`` has no counterpart: PyTorch runs eagerly, so
there is no per-dispatch round trip to amortize, and the value is ignored.

As a script it trains a preset and evaluates the result:

    python -m multimodal_sc_torch.train.ppo --config c5 \\
        [--set train.steps=150 --set rl.num_envs=64 ...] \\
        [--init-from JSCC_DIR] [--eval-envs 256] [--device cuda]
    torchrun --nproc-per-node N -m multimodal_sc_torch.train.ppo \\
        --config c5 [--set mesh.model_axis=2 ...]

prints the card, then one JSON object: the result of ``run``, the wall time
and ``evaluate_ppo`` of the online and the EMA network, sampled (T = 1)
and greedy.
"""

from __future__ import annotations

import argparse
import json
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
from multimodal_sc_torch.obs.profiling import NaNWatchdog, maybe_trace
from multimodal_sc_torch.rl import ppo as ppo_lib
from multimodal_sc_torch.rl.warmstart import cold_start, warm_start
from multimodal_sc_torch.runtime.mesh import (init_distributed,
                                              mesh_from_config, replicate)

# What each data shard holds of its own: a checkpoint writes it per shard.
SHARD_FIELDS = ("env_states", "generator", "ep_return", "last_return")


def run(cfg: ExperimentConfig, metrics_path: Optional[str] = None,
        init_from: Optional[str] = None, device="cuda"):
    """Train config-5 PPO for ``cfg.train.steps`` updates (resuming from
    ``train.checkpoint_dir`` when it holds a checkpoint); returns
    ``(state, result)``."""
    dev = resolve_device(device)
    init_distributed(dev)
    mesh = mesh_from_config(cfg.mesh)
    lead = mesh.rank == 0
    state = ppo_lib.init(cfg, cfg.train.seed, dev, mesh)
    nets = (state.params, state.ema_params)
    if init_from:
        warm_start(cfg, nets, init_from)
    else:
        cold_start(cfg, nets)       # a resume below overwrites it
    replicate(mesh, nets)
    train_step = ppo_lib.make_train_step(cfg, mesh)
    writer = MetricsWriter(metrics_path if lead else None, stdout=lead,
                           config_json=cfg.to_json())
    watchdog = NaNWatchdog()
    ckpt = None
    if cfg.train.checkpoint_dir:
        ckpt = CheckpointManager(cfg.train.checkpoint_dir)
        guard_world(ckpt, mesh.data)
        if lead:
            ckpt.save_config(cfg.to_json())
        # Any mesh's checkpoint: the data shards' parts, the number of
        # shards left out of the state.
        restored = restore_sharded(ckpt, state, mesh)
        if restored is not None:
            state = restored
    # Tensor parallelism once the whole network is in place.
    state = ppo_lib.shard_state(state, mesh)
    start_it = (ckpt.latest_step() or 0) if ckpt else 0

    # First-update wall (allocator warm-up, kernel build and load) and the
    # in-loop checkpoint writes recorded apart from the steady rate.
    first_s = None
    ckpt_s = 0.0
    last = {}
    steps = cfg.train.steps
    with maybe_trace(cfg.train.profile_dir), Timer() as t:
        for it in range(start_it + 1, steps + 1):
            t0 = time.perf_counter() if first_s is None else None
            state, last = train_step(state)
            if t0 is not None:
                synchronize(dev)
                first_s = time.perf_counter() - t0
            if it % cfg.train.log_every == 0:
                writer.write(it, last)
                watchdog.check(it, last)
            if ckpt and it % cfg.train.checkpoint_every == 0:
                t_ck = time.perf_counter()
                save_sharded(ckpt, it, state, mesh, SHARD_FIELDS)
                ckpt_s += time.perf_counter() - t_ck
        synchronize(dev)
    per_update = cfg.rl.rollout_length * cfg.rl.num_envs // mesh.data
    n_updates = steps - start_it
    extra = {"agent_steps_per_sec_per_chip": steps_per_sec_per_chip(
        n_updates * per_update, t.elapsed)}
    if ckpt:
        t_ck = time.perf_counter()
        ckpt.close()
        extra["ckpt_save_s"] = round(ckpt_s, 2)
        extra["ckpt_close_s"] = round(time.perf_counter() - t_ck, 2)
    if first_s is not None and n_updates > 1 and \
            t.elapsed > first_s + ckpt_s:
        extra["first_dispatch_s"] = round(first_s, 2)
        extra["steady_steps_per_sec_per_chip"] = steps_per_sec_per_chip(
            (n_updates - 1) * per_update, t.elapsed - first_s - ckpt_s)
    if mesh.data > 1:
        extra["data_shards"] = mesh.data
    writer.write(steps, {**last, **extra})
    writer.close()
    return state, {**to_host(last), **extra}


def main(argv=None) -> int:
    from multimodal_sc_torch.config import get_preset

    ap = argparse.ArgumentParser(description="Train a PPO preset, then "
                                 "evaluate its online and EMA networks.")
    ap.add_argument("--config", default="c5")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="config override, e.g. train.steps=150 (repeatable)")
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
    state, result = run(cfg, args.metrics_path, init_from=args.init_from,
                        device=dev)
    if not lead:
        return 0
    result["train_wall_s"] = round(time.perf_counter() - t0, 2)
    if getattr(state.params, "tp_mesh", None) is not None:
        # A network under tensor parallelism runs only with all its model
        # ranks: rank 0 alone cannot evaluate it.
        result["card"] = card
        result["updates"] = state.update
        print(json.dumps(result), flush=True)
        return 0
    seed = cfg.train.seed + 0xE7A1
    for name, net in (("online", state.params), ("ema", state.ema_params)):
        for mode, greedy in (("sampled", False), ("greedy", True)):
            out = policy_eval.evaluate_ppo(cfg, net, seed, args.eval_envs,
                                           greedy=greedy)
            result[f"eval_{name}_{mode}_return"] = out["episode_return_mean"]
    result["updates"] = state.update
    result["card"] = card
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
