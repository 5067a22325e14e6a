"""CLI: ``python -m multimodal_sc_torch.cli train --config c4 --set k=v``.

Counterpart of ``multimodal_sc_tpu/cli.py``: the same verbs with the same
flags, flag for flag, plus ``--device`` (default ``cuda``) on every verb
but ``show``:

* ``show`` prints a resolved config as JSON;
* ``train`` runs the task's training loop and prints its last metrics as
  one JSON object (``--metrics`` the JSONL path, ``--init-from`` a JSCC
  checkpoint to warm-start an RL trunk from);
* ``eval`` sweeps a JSCC checkpoint (``evaluation/snr_sweep.py``);
* ``eval-policy`` evaluates a DQN or PPO checkpoint
  (``evaluation/policy_eval.py``);
* ``export`` writes the trained codec or greedy policy as ``torch.export``
  deployment artifacts (``io/export.py``): encoder for the transmitter,
  decoder for the receiver, policy for the agent.

Every verb but ``show`` validates the final config first (flag
combinations the code would silently ignore are refused). ``eval`` and
``eval-policy`` share their flags and bodies with the module scripts
``python -m multimodal_sc_torch.evaluation.snr_sweep`` and
``... .policy_eval``. A missing checkpoint is a hard error for ``eval``,
``eval-policy`` and a policy ``export`` (unless ``--allow-untrained`` where
offered); a codec ``export`` warns and exports fresh weights.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _codec_params(cfg, module):
    """The newest checkpoint's parameters into ``module``; without one, a
    warning and the fresh weights."""
    restored = None
    if cfg.train.checkpoint_dir:
        from multimodal_sc_torch.io.checkpoint import CheckpointManager

        restored = CheckpointManager(
            cfg.train.checkpoint_dir).restore_params_latest(module)
    if restored is None:
        print("warning: no checkpoint found (train.checkpoint_dir="
              f"{cfg.train.checkpoint_dir!r}): exporting UNTRAINED params",
              file=sys.stderr)
        return module
    return restored


def _export(cfg, args, dev) -> int:
    from multimodal_sc_torch.evaluation import policy_eval
    from multimodal_sc_torch.io import export as export_lib

    seed = cfg.train.seed
    task = cfg.train.task
    if (args.use_target or args.use_best) and task != "dqn":
        print("--use-target/--use-best apply to DQN exports only; ignoring",
              file=sys.stderr)
    if args.use_ema and task not in ("dqn", "ppo"):
        print("--use-ema applies to policy (DQN/PPO) exports only; ignoring",
              file=sys.stderr)
    if task == "jscc":
        from multimodal_sc_torch.train import jscc

        model = _codec_params(cfg, jscc.create_train_state(cfg, seed,
                                                           dev).params)
        parts = export_lib.export_camera_codec(cfg, model, batch=args.batch)
    elif task == "jscc_fusion":
        from multimodal_sc_torch.train import fusion_jscc

        model = _codec_params(cfg, fusion_jscc.create_train_state(
            cfg, seed, dev).params)
        parts = {
            # The fusion pipeline's own camera builder: its parameters
            # match the checkpoint's.
            **export_lib.export_camera_codec(
                cfg, model.camera, batch=args.batch,
                model_builder=fusion_jscc.build_camera_codec),
            **export_lib.export_lidar_codec(cfg, model.lidar,
                                            batch=args.batch),
        }
    elif task == "dqn":
        net = policy_eval.select_dqn_policy(
            cfg, seed, dev, use_target=args.use_target,
            use_ema=args.use_ema, use_best=args.use_best)
        parts = {"policy": export_lib.export_policy(cfg, net,
                                                    batch=args.batch)}
    elif task == "ppo":
        net = policy_eval.select_ppo_policy(cfg, seed, dev,
                                            use_ema=args.use_ema)
        parts = {"policy": export_lib.export_policy(cfg, net,
                                                    batch=args.batch)}
    else:
        print(f"unknown task {task!r}", file=sys.stderr)
        return 2
    sizes = export_lib.save_artifact(args.out, parts, cfg)
    print(json.dumps({"out": args.out, "parts": sorted(parts),
                      "bytes": sizes}))
    return 0


def _train(cfg, args, dev) -> int:
    from multimodal_sc_torch import api

    task = cfg.train.task
    if task not in ("jscc", "jscc_fusion", "dqn", "ppo"):
        print(f"unknown task {task!r}", file=sys.stderr)
        return 2
    run = api.make_trainer(cfg).run
    if task in ("dqn", "ppo"):
        _, last = run(cfg, metrics_path=args.metrics,
                      init_from=args.init_from, device=dev)
    else:
        _, last = run(cfg, metrics_path=args.metrics, device=dev)
    import torch.distributed as dist

    # Under torchrun the result is rank 0's to print.
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(json.dumps({k: float(v) for k, v in last.items()}))
    return 0


def _device_flag(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="the device to run on (default: the card; cpu runs "
                        "the kernels' plain versions)")


def main(argv=None) -> int:
    from multimodal_sc_torch.evaluation import policy_eval, snr_sweep

    p = argparse.ArgumentParser(prog="multimodal_sc_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="run a training config")
    t.add_argument("--config", required=True,
                   help="preset name (c1..c5 or full names)")
    t.add_argument("--set", action="append", default=[], dest="overrides",
                   help="dotted override, e.g. train.steps=100")
    t.add_argument("--metrics", default=None, help="JSONL metrics path")
    t.add_argument("--init-from", default=None, dest="init_from",
                   help="JSCC checkpoint dir to warm-start the RL "
                        "perception trunk from (dqn/ppo tasks)")
    _device_flag(t)

    e = sub.add_parser("eval", help="SNR-sweep evaluation of a jscc config")
    e.add_argument("--config", required=True)
    e.add_argument("--set", action="append", default=[], dest="overrides")
    snr_sweep.add_arguments(e)
    _device_flag(e)

    s = sub.add_parser("show", help="print a resolved config as JSON")
    s.add_argument("--config", required=True)
    s.add_argument("--set", action="append", default=[], dest="overrides")

    pe = sub.add_parser("eval-policy",
                        help="mean episode reward of a DQN/PPO policy")
    pe.add_argument("--config", required=True)
    pe.add_argument("--set", action="append", default=[], dest="overrides")
    policy_eval.add_arguments(pe)
    _device_flag(pe)

    x = sub.add_parser(
        "export",
        help="serialize the trained codec/policy of a config as standalone "
             "torch.export deployment artifacts: encoder for the "
             "transmitter, decoder for the receiver, greedy policy for the "
             "agent")
    x.add_argument("--config", required=True)
    x.add_argument("--set", action="append", default=[], dest="overrides")
    x.add_argument("--out", required=True, help="artifact directory")
    x.add_argument("--batch", type=int, default=None,
                   help="fix the exported batch size (default: "
                        "batch-size-polymorphic)")
    x.add_argument("--use-target", action="store_true", dest="use_target",
                   help="DQN: export the target network (Polyak average "
                        "under rl.target_tau) instead of the online params")
    x.add_argument("--use-ema", action="store_true",
                   help="DQN/PPO: export the Polyak-averaged deployment "
                        "policy (rl.ema_tau)")
    x.add_argument("--use-best", action="store_true", dest="use_best",
                   help="DQN: export the best-measured-return snapshot "
                        "(rl.eval_snapshot_every)")
    _device_flag(x)

    args = p.parse_args(argv)

    from multimodal_sc_torch.config.presets import get_preset

    cfg = get_preset(args.config).override_str(args.overrides)
    if args.cmd == "show":
        print(cfg.to_json())
        return 0
    # Cross-field validation on the FINAL config: a flag combination the
    # code would silently ignore is a hard error. ``show`` skips it, so an
    # invalid combination can still be inspected.
    cfg.validate()

    from multimodal_sc_torch.device import card_name, resolve_device

    dev = resolve_device(args.device)
    if os.environ.get("RANK", "0") == "0":     # torchrun: rank 0 alone
        print(f"card: {card_name(dev)}", file=sys.stderr, flush=True)
    if args.cmd == "train":
        return _train(cfg, args, dev)
    if args.cmd == "eval":
        return snr_sweep.run_command(cfg, args, dev)
    if args.cmd == "eval-policy":
        return policy_eval.run_command(cfg, args, dev)
    if args.cmd == "export":
        return _export(cfg, args, dev)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
