"""The port's front door on the CPU: ``multimodal_sc_torch.cli`` against the
JAX package's CLI (``show``'s JSON, every verb and flag, the config
refusals, the ``train`` dispatch, ``eval`` and ``eval-policy`` on tiny
checkpoints), the config refusals of the module scripts, and the package
root's verbs and ``api`` (``encode``, ``decode`` and ``api.reconstruct``
held to 1e-5 against JAX's with bridged weights and JAX's channel draws;
``act``, ``make_train_step``, ``train_step`` and its cache).
"""

import contextlib
import io
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_sc_torch as tmsc
import multimodal_sc_tpu as jmsc
from test_torch_c4_digital import flax_like
from multimodal_sc_torch import api as tapi
from multimodal_sc_torch import bridge
from multimodal_sc_torch import cli as tcli
from multimodal_sc_torch.config import get_preset as t_preset
from multimodal_sc_torch.envs import driving as tenv
from multimodal_sc_torch.evaluation import snr_sweep as tsweep
from multimodal_sc_torch.io.checkpoint import CheckpointManager
from multimodal_sc_torch.rl import dqn as tdqn
from multimodal_sc_torch.rl import ppo as tppo
from multimodal_sc_torch.train import dqn as tdqn_train
from multimodal_sc_torch.train import fusion_jscc as tfj
from multimodal_sc_torch.train import jscc as tjscc
from multimodal_sc_torch.train import ppo as tppo_train
from multimodal_sc_tpu import api as japi
from multimodal_sc_tpu import cli as jcli
from multimodal_sc_tpu.config import get_preset as j_preset
from multimodal_sc_tpu.train import jscc as jjscc

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

VERBS = ("train", "eval", "show", "eval-policy", "export")
# The codec pair's images are 16x16; a training run's batches come from
# the dataset at 32x32.
C1 = ["camera.features=8,16,16,16", "camera.image_hw=16,16",
      "train.batch_size=2"]
C1_RUN = ["camera.features=8,16,16,16", "train.batch_size=2"]
TINY4 = ["camera.features=8,16,16,16", "camera.c_sym=2",
         "camera.image_hw=16,16", "env.image_hw=16,16", "lidar.pillar_dim=16",
         "lidar.c_sym=2", "lidar.bev_hw=8,8", "fusion.dim=32",
         "fusion.depth=1", "fusion.heads=2", "fusion.state_dim=32",
         "env.num_npcs=2", "env.lidar_rays=16", "env.max_steps=4",
         "rl.replay_capacity=16", "rl.batch_size=4"]
BATCH = 2


def _sets(overrides):
    return [a for o in overrides for a in ("--set", o)]


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


def _t(x):
    return torch.tensor(np.array(x))


@pytest.fixture(autouse=True)
def _no_jax_cache_redirect(monkeypatch):
    # JAX's CLI points the compilation cache at its own directory.
    monkeypatch.setenv("MSC_NO_JAX_CACHE", "1")


@pytest.mark.parametrize("name,overrides", [
    ("c1", []), ("c2", []), ("c3", []), ("c4", []), ("c5", []),
    ("c4", ["camera.arch=vq", "lidar.arch=vq", "channel.harq=true"]),
    ("c1", ["channel.fec=hamming74", "train.steps=7"]),   # invalid: shown
])
def test_show_prints_jax_json(name, overrides):
    argv = ["show", "--config", name] + _sets(overrides)
    want = _stdout(jcli.main, argv)
    got = _stdout(tcli.main, argv)
    assert got == want
    assert want[0] == 0 and json.loads(want[1])["name"]


def _options(main, verb):
    """The option strings of ``main``'s ``verb`` parser, read from its
    help text."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
        main([verb, "--help"])
    return set(re.findall(r"(?<![\w-])(--[a-z][a-z0-9-]*)", buf.getvalue()))


@pytest.mark.parametrize("verb", VERBS)
def test_every_verb_and_flag_of_jax_cli(verb):
    want = _options(jcli.main, verb)
    got = _options(tcli.main, verb)
    assert "--config" in want and want <= got
    assert got - want == (set() if verb == "show" else {"--device"})


# Each entry point refuses what JAX's validate() refuses, with its message.
REFUSING = [
    ("cli train", tcli.main, ["train", "--config", "c1"], "train"),
    ("cli eval", tcli.main, ["eval", "--config", "c2"], "eval"),
    ("cli eval-policy", tcli.main, ["eval-policy", "--config", "c4"],
     "eval-policy"),
    ("cli export", tcli.main, ["export", "--config", "c1", "--out", "x"],
     "export"),
    ("train.jscc", tjscc.main, ["--config", "c1"], "train"),
    ("train.fusion_jscc", tfj.main, ["--config", "c3"], "train"),
    ("evaluation.snr_sweep", tsweep.main, ["--config", "c1"], "eval"),
]
FAULTS = [["channel.fec=hamming74"],        # FEC on an analog codec
          ["channel.token_keep=0.5"]]       # pruning with no pruned codec


@pytest.mark.parametrize("fault", FAULTS, ids=["fec", "token_keep"])
@pytest.mark.parametrize("what,main,argv,verb", REFUSING,
                         ids=[r[0] for r in REFUSING])
def test_refuses_what_jax_refuses(what, main, argv, verb, fault):
    jargv = [verb] + argv[argv.index("--config"):]
    with pytest.raises(ValueError) as want:
        jcli.main(jargv + _sets(fault))
    with pytest.raises(ValueError) as got:
        main(argv + _sets(fault) + ["--device", "cpu"])
    assert str(got.value) == str(want.value)


def _fake_run(calls):
    def run(cfg, **kw):
        calls.append((cfg.train.task, kw))
        return None, {"loss": torch.tensor(0.25), "steps": 3}
    return run


@pytest.mark.parametrize("name,module", [
    ("c3", tfj), ("c4", tdqn_train), ("c5", tppo_train)])
def test_train_dispatches_to_the_tasks_run(name, module, monkeypatch,
                                           tmp_path):
    calls = []
    monkeypatch.setattr(module, "run", _fake_run(calls))
    metrics = str(tmp_path / "m.jsonl")
    rc, out = _stdout(tcli.main, ["train", "--config", name, "--metrics",
                                  metrics, "--init-from", "J", "--device",
                                  "cpu"])
    assert rc == 0
    assert json.loads(out) == {"loss": 0.25, "steps": 3.0}
    task, kw = calls[0]
    assert task == t_preset(name).train.task
    assert kw["metrics_path"] == metrics
    assert kw["device"] == torch.device("cpu")
    assert kw.get("init_from") == (None if name == "c3" else "J")


def test_train_c1_prints_the_last_metrics(tmp_path):
    """A real c1 run through ``cli train``: the printed JSON is the run's
    result, the JSONL holds its records; ``api.train`` runs the same."""
    over = C1_RUN + ["train.steps=2", "train.log_every=1",
                     "train.eval_every=2"]
    metrics = tmp_path / "m.jsonl"
    rc, out = _stdout(tcli.main, ["train", "--config", "c1", "--metrics",
                                  str(metrics), "--device", "cpu"]
                      + _sets(over))
    assert rc == 0
    last = json.loads(out)
    assert {"loss", "psnr", "eval_psnr"} <= set(last)
    assert all(np.isfinite(v) for v in last.values())
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert records[-1]["step"] == 2
    state, again = tapi.train(t_preset("c1").override_str(over),
                              device="cpu")
    assert state.step == 2
    assert again["loss"] == pytest.approx(last["loss"])
    assert tapi.make_trainer(t_preset("c1")) is tjscc
    with pytest.raises(ValueError, match="unknown task 'nope'"):
        tapi.make_trainer(t_preset("c1").override_str(["train.task=nope"]))


def test_eval_on_a_checkpoint_and_the_untrained_refusal(tmp_path, capsys):
    over = C1_RUN + [f"train.checkpoint_dir={tmp_path / 'ck'}"]
    tjscc.run(t_preset("c2").override_str(over + [
        "train.steps=1", "train.checkpoint_every=1"]), device="cpu")
    out = tmp_path / "c.json"
    argv = ["eval", "--config", "c2", "--kinds", "awgn", "--out", str(out),
            "--device", "cpu"]
    capsys.readouterr()
    assert tcli.main(argv + _sets(over)) == 0
    assert "restored step 1" in capsys.readouterr().err
    curve = json.loads(out.read_text())["awgn"]
    assert [p["snr_db"] for p in curve] == list(map(float,
                                                    tsweep.DEFAULT_SNRS))
    empty = C1_RUN + [f"train.checkpoint_dir={tmp_path / 'none'}"]
    with pytest.raises(SystemExit, match="no checkpoint found"):
        tcli.main(argv + _sets(empty))
    assert tcli.main(argv + _sets(empty) + ["--allow-untrained"]) == 0


def test_eval_policy_on_a_checkpoint(tmp_path, capsys):
    ckpt = tmp_path / "ck"
    cfg = t_preset("c4").override_str(TINY4 + [f"train.checkpoint_dir={ckpt}"])
    mgr = CheckpointManager(str(ckpt))
    mgr.save(1, tdqn.init(cfg, seed=0, num_envs=2, device="cpu"))
    mgr.close()
    argv = ["eval-policy", "--config", "c4", "--use-ema", "--episodes", "2",
            "--device", "cpu"]
    rc, out = _stdout(tcli.main, argv + _sets(
        TINY4 + [f"train.checkpoint_dir={ckpt}"]))
    assert rc == 0
    res = json.loads(out)
    assert {"episode_return_mean", "episodes_terminated_frac"} <= set(res)
    with pytest.raises(SystemExit, match="no checkpoint found"):
        tcli.main(argv + _sets(TINY4))


def test_package_root_exports_jax_names_and_version():
    assert set(jmsc.__all__) <= set(tmsc.__all__)
    for name in tmsc.__all__:
        assert getattr(tmsc, name) is not None, name
    assert tmsc.__version__ == jmsc.__version__
    assert tmsc.get_preset("c3").to_json() == jmsc.get_preset("c3").to_json()


def _codec_pair(extra=()):
    """A c1 camera codec in both packages on one set of (numpy-drawn)
    parameters, and an image batch."""
    over = C1 + list(extra)
    jcfg, tcfg = (j_preset("c1").override_str(over),
                  t_preset("c1").override_str(over))
    model = jjscc.build_model(jcfg)
    img = np.random.default_rng(3).uniform(
        0, 1, (BATCH, 16, 16, 3)).astype(np.float32)
    rate = ({"rate": jnp.ones((BATCH,))} if jcfg.camera.adaptive_rate
            else {})
    params = flax_like(jax.eval_shape(lambda k: model.init(
        k, jnp.asarray(img), jnp.full((BATCH,), 10.0), **rate)["params"],
        jax.random.key(0)), 4)
    tm = tjscc.build_model(tcfg)
    tm.load_state_dict(bridge.to_state_dict(params, tm))
    return model, params, tm, img


def test_encode_decode_verbs_match_jax():
    model, params, tm, img = _codec_pair(["camera.snr_conditioning=true"])
    snr = np.array([3.0, 12.0], np.float32)
    z = jax.jit(lambda p, x, s: jmsc.encode(model, p, x, s))(params, img, snr)
    z_hat = z + 0.2 * jax.random.normal(jax.random.key(1), z.shape)
    rec = jax.jit(lambda p, x, s: jmsc.decode(model, p, x, s))(
        params, z_hat, snr)
    with torch.no_grad():
        tz = tmsc.encode(tm, _t(img), _t(snr))
        trec = tmsc.decode(tm, _t(z_hat), _t(snr))
    np.testing.assert_allclose(tz.numpy(), np.asarray(z), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(trec.numpy(), np.asarray(rec), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("extra,rate_sym", [
    ([], 0), (["camera.adaptive_rate=true"], 3)], ids=["awgn", "adaptive"])
def test_api_reconstruct_matches_jax(extra, rate_sym):
    """A scalar SNR broadcast per example; JAX's AWGN draws (its key's
    standard normals) handed to the port."""
    model, params, tm, img = _codec_pair(extra)
    key = jax.random.key(7)
    recon, z = jax.jit(lambda p, x: japi.reconstruct(
        model, p, x, 4.0, key, rate_sym=rate_sym))(params, img)
    noise = _t(jax.random.normal(key, z.shape))
    with torch.no_grad():
        trecon, tz = tapi.reconstruct(tm, _t(img), 4.0, rate_sym=rate_sym,
                                      noise=noise)
    np.testing.assert_allclose(tz.numpy(), np.asarray(z), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(trecon.numpy(), np.asarray(recon), atol=1e-5,
                               rtol=1e-5)


def _obs(cfg, n=3):
    states = tenv.reset_batch(cfg.env, n, torch.Generator().manual_seed(1),
                              "cpu")
    return tenv.observe_batch(cfg.env, states)


def test_act_verb_dispatches_on_the_algorithm():
    cfg = t_preset("c4").override_str(TINY4)
    net = tdqn.init_params(cfg, 0, "cpu")
    obs = _obs(cfg)
    with torch.no_grad():
        a = tmsc.act(cfg, net, *obs, torch.Generator().manual_seed(5),
                     epsilon=0.5)
        want = tdqn.act(cfg, net, *obs, torch.Generator().manual_seed(5),
                        epsilon=0.5)
    assert a.dtype == torch.int32 and torch.equal(a, want)
    pcfg = t_preset("c5").override_str(TINY4)
    pnet = tppo.init_params(pcfg, 0, "cpu")
    with torch.no_grad():
        got = tmsc.act(pcfg, pnet, *obs, torch.Generator().manual_seed(6))
        want = tppo.act(pcfg, pnet, *obs, torch.Generator().manual_seed(6))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name,module,qualname", [
    ("c1", "multimodal_sc_torch.train.jscc", "make_train_step"),
    ("c3", "multimodal_sc_torch.train.fusion_jscc", "make_train_step"),
    ("c4", "multimodal_sc_torch.rl.dqn", "make_iteration"),
    ("c5", "multimodal_sc_torch.rl.ppo", "make_train_step")])
def test_make_train_step_dispatches_on_the_task(name, module, qualname):
    cfg = t_preset(name).override_str(TINY4)
    step = tmsc.make_train_step(cfg)
    assert step.__module__ == module
    assert step.__qualname__.startswith(f"{qualname}.<locals>.")
    with pytest.raises(ValueError, match="unknown task 'nope'"):
        tmsc.make_train_step(cfg.override_str(["train.task=nope"]))


def test_train_step_caches_its_step_per_config():
    cfg = t_preset("c1").override_str(C1_RUN + ["train.steps=4"])
    state = tjscc.create_train_state(cfg, 0, "cpu")
    batch = torch.rand((BATCH, 32, 32, 3),
                       generator=torch.Generator().manual_seed(2))
    tmsc._train_step_cache.clear()
    state, m = tmsc.train_step(cfg, state, batch)
    step = tmsc._train_step_cache[cfg]
    state, m = tmsc.train_step(cfg, state, batch)
    assert tmsc._train_step_cache == {cfg: step}
    assert state.step == 2 and np.isfinite(float(m["loss"]))
