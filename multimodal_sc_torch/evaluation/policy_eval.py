"""Policy evaluation: mean episode return over N on-device episodes.

Counterpart of ``multimodal_sc_tpu/evaluation/policy_eval.py``: fixed
seed, a DQN (greedy or eps-greedy) or PPO (greedy or sampled) policy, every
env run for ``env.max_steps`` steps with the reward counted up to its FIRST
done. Its ``main`` is the ``eval-policy`` verb of
``multimodal_sc_tpu/cli.py``, and shares its flags and body
(:func:`add_arguments`, :func:`run_command`) with the port's
``multimodal_sc_torch.cli eval-policy``:

    python -m multimodal_sc_torch.evaluation.policy_eval --config c4 \\
        --set train.checkpoint_dir=DIR [--set env.fog_range=20 ...] \\
        [--use-ema | --use-target | --use-best] [--episodes 256] \\
        [--seed 0] [--eps 0.05] [--sample] [--temperature T] \\
        [--snr-sweep --kinds awgn,rayleigh --snrs -5,0,5 --out curves.json] \\
        [--allow-untrained] [--device cuda]

It restores one network of the newest checkpoint (the online network by
default, ``--use-ema`` the deployment EMA, ``--use-target`` a DQN's target,
``--use-best`` a DQN's best-eval snapshot under ``<dir>/best``; PPO keeps
no target and no snapshot and ignores those two with a warning), refuses
to evaluate untrained weights unless ``--allow-untrained``, prints the card
and one JSON object of the evaluation, or with ``--snr-sweep`` the
return-vs-SNR table (``evaluation/policy_sweep.py``). A checkpoint of the
digital link (``camera.arch=vq``, ``lidar.arch=vq``, or both) deploys
coded with ``--set channel.fec=hamming74_soft`` (or ``hamming74``) or under
HARQ with ``--set channel.harq=true``, whose link accounting (summed over
the camera, ego LiDAR and V2X links) the sweep's ``--out`` JSON carries;
a pruned LiDAR checkpoint (``lidar.vq_prune``) deploys at ``--set
channel.token_keep=F`` under ``channel.token_select`` ``scatter`` or
``random``. The configuration is validated first, as the JAX package's CLI
validates it: HARQ with pruning, a damage selection rule on the RL path
and ``camera.vq_prune`` on the RL path are refused.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict

import torch

from multimodal_sc_torch.config.configs import ExperimentConfig
from multimodal_sc_torch.device import card_name, resolve_device
from multimodal_sc_torch.envs import driving

# act_fn(image, points, mask, generator) -> int32 actions (B,), or
# (actions, {name: 0-d tensor}) of per-step statistics
ActFn = Callable[..., torch.Tensor]


@torch.no_grad()
def _rollout_returns(cfg: ExperimentConfig, act_fn: ActFn, seed: int,
                     num_envs: int, device) -> Dict[str, float]:
    """Shared episode-return rollout: accumulate reward to each env's first
    done over ``cfg.env.max_steps``; one host pull at the end. Statistics
    an ``act_fn`` returns beside its actions are summed over every step
    (steps after an env's first done included, as the JAX package counts
    them) and reported per step.

    The envs draw from a generator of their own (seeded ``seed``), the
    policy (``act_fn``: channel noise, exploration) from another, as the
    JAX package's envs carry their own key: deployments that draw
    differently (Hamming's longer codewords, HARQ's rounds) then meet the
    same env randomness, and their returns compare pair by pair."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    g_act = torch.Generator(device=dev).manual_seed(
        (seed * 0x9E3779B1 + 0xAC7) & 0xFFFFFFFF)
    states = driving.reset_batch(cfg.env, num_envs, g, dev)
    ret = torch.zeros(num_envs, device=dev)
    done_seen = torch.zeros(num_envs, device=dev)
    reward_sum = torch.zeros((), device=dev)
    acc: Dict[str, torch.Tensor] = {}
    for _ in range(cfg.env.max_steps):
        img, pts, mask = driving.observe_batch(cfg.env, states)
        actions = act_fn(img, pts, mask, g_act)
        if isinstance(actions, tuple):
            actions, stats = actions
            for name, v in stats.items():
                acc[name] = acc.get(name, 0.0) + v
        states, ts = driving.step_batch(cfg.env, states, actions, g)
        ret = ret + ts.reward * (1.0 - done_seen)
        done_seen = torch.maximum(done_seen, ts.done.float())
        reward_sum = reward_sum + ts.reward.mean()
    names = ("episode_return_mean", "episode_return_std",
             "episodes_terminated_frac", "reward_per_step", *acc)
    out = torch.stack([ret.mean(), ret.std(unbiased=False), done_seen.mean(),
                       reward_sum / cfg.env.max_steps,
                       *(torch.as_tensor(v, device=dev) / cfg.env.max_steps
                         for v in acc.values())]).tolist()
    return dict(zip(names, out))


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


def _untrained_fallback(cfg: ExperimentConfig, fresh, allow_untrained: bool):
    """No checkpoint: a hard error unless ``allow_untrained`` (a silent
    fallback would measure untrained weights and report them as a
    policy)."""
    if allow_untrained:
        print("warning: no checkpoint found (train.checkpoint_dir="
              f"{cfg.train.checkpoint_dir!r}): using UNTRAINED init params "
              "(--allow-untrained)", file=sys.stderr)
        return fresh
    raise SystemExit(
        "error: no checkpoint found at train.checkpoint_dir="
        f"{cfg.train.checkpoint_dir!r}; evaluating untrained params is "
        "almost never intended: train first, fix the path, or pass "
        "--allow-untrained to evaluate a fresh init")


def _restore(cfg: ExperimentConfig, fresh, field: str, allow_untrained: bool):
    from multimodal_sc_torch.io.checkpoint import CheckpointManager

    restored = None
    if cfg.train.checkpoint_dir:
        restored = CheckpointManager(
            cfg.train.checkpoint_dir).restore_params_latest(fresh, field)
    if restored is None:
        return _untrained_fallback(cfg, fresh, allow_untrained)
    return restored


def select_dqn_policy(cfg: ExperimentConfig, seed: int, device,
                      use_target=False, use_ema=False, use_best=False,
                      allow_untrained=False):
    """The ``QNetwork`` that deploys: the online network, the target
    (``use_target``), the EMA (``use_ema``, which wins over the target) or
    the best-eval snapshot's copy of that field (``use_best``, falling back
    to the latest checkpoint when there is no snapshot)."""
    from multimodal_sc_torch.io.checkpoint import CheckpointManager
    from multimodal_sc_torch.rl import dqn as dqn_lib

    field = "target_params" if use_target else "params"
    if use_ema:
        if use_target:
            print("--use-ema and --use-target are exclusive; using "
                  "--use-ema", file=sys.stderr)
        if cfg.rl.ema_tau <= 0:
            print("--use-ema: rl.ema_tau == 0 in this config; the EMA was "
                  "never updated during training and equals the init "
                  "params", file=sys.stderr)
        field = "ema_params"
    fresh = dqn_lib.init_params(cfg, seed, device)
    if use_best:
        best = (CheckpointManager(cfg.train.checkpoint_dir)
                .restore_best_policy() if cfg.train.checkpoint_dir else None)
        if best is None:
            print("--use-best: no <checkpoint_dir>/best snapshot (train "
                  "with rl.eval_snapshot_every > 0); falling back to the "
                  "latest checkpoint", file=sys.stderr)
        else:
            print(f"best snapshot: iter {int(best['step'])}, train-time "
                  f"eval {float(best['eval_return']):.2f}", file=sys.stderr)
            if field not in best:
                print(f"--use-best: snapshot predates {field}; using its "
                      "online params", file=sys.stderr)
            fresh.load_state_dict(best.get(field, best["params"]))
            return fresh
    return _restore(cfg, fresh, field, allow_untrained)


def select_ppo_policy(cfg: ExperimentConfig, seed: int, device,
                      use_target=False, use_ema=False, use_best=False,
                      allow_untrained=False):
    """The ``ActorCritic`` that deploys: the online network, or the EMA
    (``use_ema``). ``use_target`` and ``use_best`` are DQN-only and are
    ignored with a warning."""
    from multimodal_sc_torch.rl import ppo as ppo_lib

    if use_target:
        print("--use-target applies to DQN policies only (PPO keeps no "
              "target network); ignoring", file=sys.stderr)
    if use_best:
        print("--use-best applies to DQN policies only (best-snapshot "
              "selection is a DQN-driver feature); ignoring",
              file=sys.stderr)
    field = "params"
    if use_ema:
        if cfg.rl.ema_tau <= 0:
            print("--use-ema: rl.ema_tau == 0 in this config; the EMA was "
                  "never updated during training and equals the init "
                  "params", file=sys.stderr)
        field = "ema_params"
    fresh = ppo_lib.init_params(cfg, seed, device)
    return _restore(cfg, fresh, field, allow_untrained)


def add_arguments(ap) -> None:
    """The ``eval-policy`` verb's flags, shared by this module's script and
    ``multimodal_sc_torch.cli`` (the JAX package's ``eval-policy``
    flags)."""
    ap.add_argument("--episodes", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=1.0,
                    help="PPO sampled-mode logit temperature")
    ap.add_argument("--sample", action="store_true",
                    help="PPO: sample the policy instead of its argmax")
    ap.add_argument("--eps", type=float, default=0.0,
                    help="DQN: eval-time epsilon (0 = pure argmax)")
    ap.add_argument("--use-best", action="store_true",
                    help="DQN: the best-eval snapshot under <dir>/best")
    ap.add_argument("--use-target", action="store_true",
                    help="DQN: the target network")
    ap.add_argument("--use-ema", action="store_true",
                    help="DQN/PPO: the deployment EMA (rl.ema_tau > 0)")
    ap.add_argument("--allow-untrained", action="store_true",
                    help="evaluate fresh weights when no checkpoint exists")
    ap.add_argument("--snr-sweep", action="store_true",
                    help="sweep episode return across the deployed SNR x "
                         "channel kind instead of one evaluation")
    ap.add_argument("--kinds", default="awgn,rayleigh",
                    help="channel kinds for --snr-sweep")
    ap.add_argument("--snrs", default=None,
                    help="comma list of SNR dB points for --snr-sweep "
                         "(default -5..25 step 5)")
    ap.add_argument("--out", default=None,
                    help="curve JSON output path for --snr-sweep")


def run_command(cfg: ExperimentConfig, args, dev) -> int:
    """The ``eval-policy`` verb on a validated ``cfg`` and the parsed flags
    of :func:`add_arguments`, on ``dev``: prints one JSON object of the
    evaluation, or the return-vs-SNR table; returns the exit code."""
    from multimodal_sc_torch.evaluation import policy_sweep

    flags = dict(use_target=args.use_target, use_ema=args.use_ema,
                 use_best=args.use_best,
                 allow_untrained=args.allow_untrained)
    dqn = cfg.train.task == "dqn" or cfg.rl.algo == "dqn"
    if dqn:
        if args.sample:
            print("--sample applies to PPO policies only; DQN eval is "
                  "greedy or eps-greedy (--eps)", file=sys.stderr)
        net = select_dqn_policy(cfg, args.seed, dev, **flags)
    else:
        net = select_ppo_policy(cfg, args.seed, dev, **flags)
    net.eval()
    if args.snr_sweep:
        snrs = (policy_sweep.DEFAULT_SNRS if args.snrs is None else
                tuple(float(s) for s in args.snrs.split(",")))
        kinds = tuple(k.strip() for k in args.kinds.split(","))
        curves = policy_sweep.policy_snr_sweep(
            cfg, net, args.seed, snrs=snrs, kinds=kinds,
            num_envs=args.episodes, epsilon=args.eps if dqn else 0.0,
            sample=args.sample and not dqn)
        print("episode return (mean):")
        print(policy_sweep.format_table(curves), flush=True)
        if args.out:
            policy_sweep.save_curves(curves, args.out)
        return 0
    if dqn:
        out = evaluate_dqn(cfg, net, args.seed, args.episodes,
                           epsilon=args.eps)
    else:
        out = evaluate_ppo(cfg, net, args.seed, args.episodes,
                           greedy=not args.sample,
                           temperature=args.temperature)
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    from multimodal_sc_torch.config import get_preset

    ap = argparse.ArgumentParser(
        description="Mean episode return of a trained DQN / PPO policy, or "
                    "its return across the channel's SNR.")
    ap.add_argument("--config", required=True)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="config override, e.g. train.checkpoint_dir=DIR")
    add_arguments(ap)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # The JAX package's refusals of flag combinations it would ignore.
    cfg = get_preset(args.config).override_str(args.set).validate()
    dev = resolve_device(args.device)
    print(f"card: {card_name(dev)}", flush=True)
    return run_command(cfg, args, dev)


if __name__ == "__main__":
    sys.exit(main())
