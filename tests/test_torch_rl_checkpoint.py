"""The port's RL checkpoints, the ``eval-policy`` verb and its SNR sweep,
and ``corrupt_symbols``, on the CPU.

* Kill and resume: a DQN run (tiny c4 with fog, 8 RSU rays and a quantized
  replay) and a PPO run (tiny c5) stopped at a checkpoint and resumed in a
  fresh state end bit-equal to uninterrupted runs.
* A restore never casts, reshapes or drops: a ``replay_quantize`` flip, a
  dtype, a shape, a missing or an extra entry each raise by name.
* The best-eval snapshot round-trips; a params-only restore builds no
  replay buffer.
* ``eval-policy``: the refusal without a checkpoint, ``--use-ema`` /
  ``--use-target`` / ``--use-best``, PPO ignoring the DQN-only flags, the
  sweep's JSON keys and ``format_table`` text against the JAX package's,
  and the paired evaluation (the ideal channel: one return at every SNR).
"""

import collections
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sc_torch.config import get_preset as t_preset
from multimodal_sc_torch.evaluation import policy_eval as teval
from multimodal_sc_torch.evaluation import policy_sweep as tsweep
from multimodal_sc_torch.io.checkpoint import CheckpointManager
from multimodal_sc_torch.obs import profiling as tprof
from multimodal_sc_torch.rl import dqn as tdqn
from multimodal_sc_torch.rl import replay as treplay
from multimodal_sc_torch.train import dqn as tdqn_train
from multimodal_sc_torch.train import ppo as tppo_train
from multimodal_sc_tpu.config import get_preset as j_preset
from multimodal_sc_tpu.evaluation import policy_sweep as jsweep
from multimodal_sc_tpu.obs import profiling as jprof

TINY = ["camera.features=8,16,16,16", "camera.c_sym=2",
        "camera.image_hw=16,16", "env.image_hw=16,16", "lidar.pillar_dim=16",
        "lidar.c_sym=2", "lidar.bev_hw=8,8", "fusion.dim=32", "fusion.depth=1",
        "fusion.heads=2", "fusion.state_dim=32", "env.num_npcs=2",
        "env.lidar_rays=16", "env.max_steps=8", "train.log_every=2",
        "train.checkpoint_every=2"]
DQN = TINY + ["env.fog_range=20", "env.v2x_rays=8", "rl.replay_capacity=64",
              "rl.batch_size=8", "rl.num_envs=4", "rl.eval_snapshot_every=2",
              "rl.eval_snapshot_envs=2"]
PPO = TINY + ["rl.num_envs=4", "rl.rollout_length=4", "rl.ppo_epochs=1",
              "rl.num_minibatches=2"]


def _dqn_cfg(steps, ckpt_dir, extra=()):
    return t_preset("c4").override_str(
        DQN + [f"train.steps={steps}", f"train.checkpoint_dir={ckpt_dir}",
               *extra])


def _dqn_resume_cfg(steps, ckpt_dir):
    """``_dqn_cfg`` learning from the second iteration, with no snapshot
    evaluations (they touch no state)."""
    return _dqn_cfg(steps, ckpt_dir, ["rl.n_step=2", "rl.batch_size=4",
                                      "rl.eval_snapshot_every=0"])


def _ppo_cfg(steps, ckpt_dir):
    return t_preset("c5").override_str(
        PPO + [f"train.steps={steps}", f"train.checkpoint_dir={ckpt_dir}"])


def _leaves(x, path=""):
    """Every tensor, generator state and plain value of a state, by path."""
    if isinstance(x, torch.Generator):
        yield path, x.get_state()
    elif isinstance(x, torch.nn.Module):
        for k, v in x.state_dict().items():
            yield f"{path}.{k}", v
    elif isinstance(x, torch.optim.Optimizer):
        for i, st in x.state_dict()["state"].items():
            for k, v in st.items():
                yield f"{path}.{i}.{k}", v
    elif hasattr(x, "_fields"):
        for f in x._fields:
            yield from _leaves(getattr(x, f), f"{path}.{f}")
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, f"{path}.{k}")
    else:
        yield path, x


def _assert_bit_equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k, v in la.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == lb[k].dtype and torch.equal(v, lb[k]), k
        else:
            assert v == lb[k], k


@pytest.mark.parametrize("algo", ["dqn", "ppo"])
def test_kill_and_resume_is_bit_equal(tmp_path, algo):
    """4 iterations straight against 2, then a fresh process's worth of
    state restored from the checkpoint at 2 and 2 more (for DQN the first
    learn steps): every network, moment, env state, replay row, window
    entry, generator and counter equal, bit for bit."""
    make, train = ((_dqn_resume_cfg, tdqn_train) if algo == "dqn"
                   else (_ppo_cfg, tppo_train))
    straight, _ = train.run(make(4, tmp_path / "a"), device="cpu")
    train.run(make(2, tmp_path / "b"), device="cpu")
    assert CheckpointManager(str(tmp_path / "b")).latest_step() == 2
    resumed, out = train.run(make(4, tmp_path / "b"), device="cpu")
    _assert_bit_equal(straight, resumed)
    assert {"ckpt_save_s", "ckpt_close_s"} <= set(out)
    assert CheckpointManager(str(tmp_path / "b")).steps() == [2, 4]
    if algo == "dqn":
        assert resumed.buffer.data.image.dtype == torch.uint8
        assert resumed.buffer.data.points.shape[1] == 16 + 8


def test_restore_names_what_does_not_match(tmp_path):
    cfg = _dqn_cfg(2, tmp_path)
    tdqn_train.run(cfg, device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    # The flip, through the driver: JAX's advice, read from config.json.
    with pytest.raises(ValueError, match="rl.replay_quantize=true"):
        tdqn_train.run(cfg.override_str(["rl.replay_quantize=false"]),
                       device="cpu")
    # The same flip straight into the manager: the dtype, by path.
    flat = tdqn.init(cfg.override_str(["rl.replay_quantize=false"]), 0, 4,
                     "cpu")
    with pytest.raises(ValueError, match=r"'buffer\.data\.image': "
                                         r"torch\.uint8"):
        mgr.restore_latest(flat)
    with pytest.raises(ValueError, match=r"'env_states\.ego'"):
        mgr.restore_latest(tdqn.init(cfg, 0, 3, "cpu"))
    state = tdqn.init(cfg, 0, 4, "cpu")
    win = state.window
    extra = win._replace(entries={**win.entries, "snr": win.reward})
    with pytest.raises(KeyError, match=r"at 'window\.entries': missing "
                                       r"\['snr'\]"):
        mgr.restore_latest(state._replace(window=extra))
    wide = collections.namedtuple("Wide", state._fields + ("extra",))
    with pytest.raises(KeyError, match=r"missing \['extra'\]"):
        mgr.restore_latest(wide(*state, extra=0))
    with pytest.raises(TypeError, match=r"'step': float"):
        mgr.restore_latest(state._replace(step=0.0))
    assert mgr.restore_latest(state).step == 0     # still restores


def test_best_snapshot_and_params_only_restore(tmp_path, monkeypatch):
    cfg = _dqn_cfg(4, tmp_path)
    state, out = tdqn_train.run(cfg, device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    best = mgr.restore_best_policy()
    assert best["step"] == out["best_eval_iter"]
    assert round(best["eval_return"], 3) == out["best_eval_return"]
    assert set(best) == {"params", "target_params", "ema_params", "step",
                         "eval_return"}
    # Only a better return overwrites it.
    assert not mgr.save_best_policy({**best, "eval_return": -1e9})
    assert mgr.save_best_policy({**best, "eval_return": 1e9})
    assert mgr.restore_best_policy()["eval_return"] == 1e9
    # One network alone: no replay buffer, no env, the saved weights.
    monkeypatch.setattr(treplay, "create", None)
    for field in ("params", "target_params", "ema_params"):
        net = mgr.restore_params_latest(tdqn.init_params(cfg, 7, "cpu"),
                                        field)
        for p, q in zip(net.parameters(), getattr(state, field).parameters()):
            assert torch.equal(p, q), field


def _main(argv, capsys):
    rc = teval.main(argv + ["--device", "cpu"])
    return rc, capsys.readouterr()


def _over(cfg_over):
    return [a for o in cfg_over for a in ("--set", o)]


def test_eval_policy_restores_the_field_asked_for(tmp_path, capsys,
                                                  monkeypatch):
    over = DQN + ["train.steps=4", f"train.checkpoint_dir={tmp_path}"]
    state, _ = tdqn_train.run(t_preset("c4").override_str(over),
                              device="cpu")
    seen = []
    monkeypatch.setattr(teval, "evaluate_dqn", lambda cfg, net, *a, **k: (
        seen.append(net) or {"episode_return_mean": 1.0}))
    best = CheckpointManager(str(tmp_path)).restore_best_policy()
    for flags, want in ((["--use-ema"], state.ema_params),
                        (["--use-target"], state.target_params),
                        ([], state.params),
                        (["--use-best", "--use-ema"], best["ema_params"])):
        rc, out = _main(["--config", "c4", *flags] + _over(over), capsys)
        assert rc == 0
        assert json.loads(out.out.splitlines()[-1]) == {
            "episode_return_mean": 1.0}
        want = want if isinstance(want, dict) else want.state_dict()
        for k, v in seen[-1].state_dict().items():
            assert torch.equal(v, want[k]), (flags, k)


def test_eval_policy_refuses_untrained_and_runs_with_allow(tmp_path, capsys):
    over = _over(DQN + [f"train.checkpoint_dir={tmp_path / 'none'}"])
    with pytest.raises(SystemExit, match="no checkpoint found"):
        teval.main(["--config", "c4", "--device", "cpu"] + over)
    rc, out = _main(["--config", "c4", "--allow-untrained", "--episodes",
                     "2"] + over, capsys)
    assert rc == 0 and "UNTRAINED" in out.err
    res = json.loads(out.out.splitlines()[-1])
    assert np.isfinite(res["episode_return_mean"])


def test_eval_policy_ppo_ignores_dqn_flags(tmp_path, capsys):
    over = PPO + ["train.steps=2", f"train.checkpoint_dir={tmp_path}"]
    state, _ = tppo_train.run(t_preset("c5").override_str(over),
                              device="cpu")
    rc, out = _main(["--config", "c5", "--use-target", "--use-best",
                     "--sample", "--episodes", "2"] + _over(over), capsys)
    assert rc == 0
    assert "--use-target applies to DQN" in out.err
    assert "--use-best applies to DQN" in out.err
    assert np.isfinite(json.loads(out.out.splitlines()[-1])[
        "episode_return_mean"])
    net = teval.select_ppo_policy(t_preset("c5").override_str(over), 0,
                                  "cpu", use_ema=True)
    for p, q in zip(net.parameters(), state.ema_params.parameters()):
        assert torch.equal(p, q)


def test_snr_sweep_keys_table_and_pairing(tmp_path, capsys):
    """The sweep's JSON holds JAX's keys, ``format_table`` gives JAX's
    text for the same curves, and over the ideal channel every SNR point
    replays the same episodes: one return everywhere."""
    # JAX's rows, from its sweep loop around a constant policy.
    jcfg = j_preset("c4").override_str(DQN + ["env.max_steps=4"])
    want = jsweep._sweep_one_kind(
        jcfg, None, lambda p, img, *a: (jnp.zeros(img.shape[0], jnp.int32),
                                        {}), jax.random.key(1), 2, (0.0,))
    path = tmp_path / "curves.json"
    rc, out = _main(["--config", "c4", "--allow-untrained", "--snr-sweep",
                     "--kinds", "ideal,awgn", "--snrs=-5,25",
                     "--episodes", "3", "--eps", "0.1", "--out", str(path)]
                    + _over(DQN + ["env.max_steps=4"]), capsys)
    assert rc == 0
    curves = json.loads(path.read_text())
    assert list(curves) == ["ideal", "awgn"]
    for rows in curves.values():
        assert [r["snr_db"] for r in rows] == [-5.0, 25.0]
        for row in rows:
            assert list(row) == list(want[0])
    ideal = [r["episode_return_mean"] for r in curves["ideal"]]
    assert ideal == [ideal[0]] * 2
    table = tsweep.format_table(curves)
    assert table == jsweep.format_table(curves)
    assert "episode return (mean):\n" + table in out.out


@pytest.mark.parametrize("mode", ["nan", "inf", "burst"])
def test_corrupt_symbols_matches_jax(mode):
    z = np.random.default_rng(0).standard_normal((3, 10, 2)).astype(
        np.float32)
    want = np.asarray(jprof.corrupt_symbols(jnp.asarray(z), mode))
    got = tprof.corrupt_symbols(torch.tensor(z), mode).numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown corruption mode"):
        tprof.corrupt_symbols(torch.tensor(z), "quantum")
