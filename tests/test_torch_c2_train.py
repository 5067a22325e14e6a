"""The port's c2 training path against the JAX package on the CPU: one train
step of the c2 preset (a per-example SNR, the segmentation loss and mIoU,
the SNR FiLM) and of the adaptive-rate codec (rate FiLM, rate masks) from
the same parameters and Adam state, with JAX's own draws (SNR, rate and
channel noise), against ``jscc._step_body`` under optax; a kill-and-resume
run bit-equal to an uninterrupted one (c2, and c3 on the CNN codec); the
sweep's command on a checkpoint; the CIFAR / KITTI file loaders on tiny
files the test writes, and the prefetcher. Narrow widths (8, 16, 16, 16);
f32, TF32 off, JAX at ``highest`` precision.
"""

import collections
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sc_torch import bridge
from multimodal_sc_torch.channel import ChannelDraws
from multimodal_sc_torch.config import get_preset as t_preset
from multimodal_sc_torch.envs import datasets as tdata
from multimodal_sc_torch.evaluation import snr_sweep as tsweep
from multimodal_sc_torch.io.checkpoint import CheckpointManager
from multimodal_sc_torch.runtime.prefetch import prefetch_to_device
from multimodal_sc_torch.train import fusion_jscc as tfj
from multimodal_sc_torch.train import jscc as tjscc
from multimodal_sc_tpu.config import get_preset as j_preset
from multimodal_sc_tpu.envs import datasets as jdata
from multimodal_sc_tpu.train import jscc as jjscc

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

SMALL = ["camera.features=8,16,16,16", "train.steps=300",
         "train.warmup_steps=100", "train.grad_clip=0.01"]
VIT_SMALL = ["camera.dim=32", "camera.depth=1", "camera.heads=2"]
BATCH = 2


def _t(x):
    return torch.tensor(np.array(x))


def _perturb(tree, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + scale * jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32)), tree)


def _jax_channel_draws(jcfg, kch, z_shape):
    """The channel's draws that ``channel(..., key=kch)`` makes."""
    kind = jcfg.channel.kind
    if kind == "awgn":
        return ChannelDraws(noise=_t(jax.random.normal(kch, z_shape)))
    key_h, key_n = jax.random.split(kch)
    csi = jax.random.fold_in(kch, 2)
    if kind == "ofdm":
        ch = jcfg.channel
        return ChannelDraws(
            noise=_t(jax.random.normal(key_n, z_shape)),
            h=_t(jax.random.normal(key_h, (z_shape[0], ch.ofdm_taps, 2))),
            csi=_t(jax.random.normal(csi, (z_shape[0], ch.ofdm_subcarriers,
                                           2))) if ch.pilots else None)
    return ChannelDraws(
        noise=_t(jax.random.normal(key_n, z_shape)),
        h=_t(jax.random.normal(key_h, (z_shape[0], 2))),
        csi=_t(jax.random.normal(csi, (z_shape[0], 1, 2)))
        if jcfg.channel.pilots else None)


@pytest.mark.parametrize("preset,extra", [
    ("c2", []),                                       # random SNR, seg, FiLM
    ("c2", ["camera.adaptive_rate=true", "channel.kind=ofdm",
            "channel.pilots=2"]),
    ("c1", ["camera.adaptive_rate=true", "camera.rate_min_sym=2",
            "channel.modulation=16"]),
    ("c1", ["camera.arch=vit"] + VIT_SMALL),          # ViTJSCC
    ("c2", ["camera.arch=vit"] + VIT_SMALL),          # + its SNR token
])
def test_train_step_matches_jax(preset, extra):
    """One step at update 150 (inside the cosine), the clip active: loss,
    metrics, parameters and Adam moments after it."""
    over = SMALL + extra
    jcfg, tcfg = (j_preset(preset).override_str(over),
                  t_preset(preset).override_str(over))
    count = 150
    model = jjscc.build_model(jcfg)
    jstate = jjscc.create_train_state(jcfg, jax.random.key(0))
    params = _perturb(jstate.params, 1, 0.02)
    adam, decay, sched = jstate.opt_state[1]
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    mu = _perturb(zeros, 2, 1e-3)
    nu = jax.tree_util.tree_map(jnp.abs, _perturb(zeros, 3, 1e-4))
    c = jnp.asarray(count, jnp.int32)
    jstate = jstate.replace(params=params, opt_state=(
        jstate.opt_state[0], (adam._replace(count=c, mu=mu, nu=nu), decay,
                              sched._replace(count=c))))
    h, w = jcfg.camera.image_hw
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (BATCH, h, w, 3)).astype(np.float32)
    with_seg = jcfg.camera.seg_classes > 0 and jcfg.camera.arch == "cnn"
    seg = rng.integers(0, 4, (BATCH, h, w)).astype(np.int32)
    key = jax.random.key(5)
    jstate, jmetrics = jax.jit(jjscc._step_body(jcfg, model))(
        jstate, jnp.asarray(img), jnp.asarray(seg) if with_seg else None, key)

    # The body's draws: ksnr, kch = split(key); the rate from fold_in(key,
    # 0xA7E) when adaptive.
    ksnr, kch = jax.random.split(key)
    ch, cam = jcfg.channel, jcfg.camera
    snr = (jax.random.uniform(ksnr, (BATCH,), minval=ch.snr_min_db,
                              maxval=ch.snr_max_db) if ch.random_snr
           else jnp.full((BATCH,), ch.snr_db))
    m = (jax.random.randint(jax.random.fold_in(key, 0xA7E), (BATCH,),
                            cam.rate_min_sym, cam.c_sym + 1)
         if cam.adaptive_rate else None)
    k = (h // 4) * (w // 4) * cam.c_sym
    draws = tjscc.StepDraws(snr_db=_t(snr), m=_t(m) if m is not None else None,
                            channel=_jax_channel_draws(jcfg, kch,
                                                       (BATCH, k, 2)))

    state = tjscc.create_train_state(tcfg, 0, "cpu")
    tm = state.params
    tm.load_state_dict(bridge.to_state_dict(params, tm))
    bridge.load_adam_state(state.opt_state, tm, count, mu, nu)
    state.schedule.last_epoch = count
    for group in state.opt_state.param_groups:
        group["lr"] = tjscc.lr_schedule(tcfg, count)
    batch = (_t(img), _t(seg)) if with_seg else _t(img)
    state, metrics = tjscc.make_train_step(tcfg)(state, batch, draws)
    assert state.step == 1
    assert set(metrics) == set(jmetrics) == (
        {"loss", "psnr", "miou"} if with_seg else {"loss", "psnr"})
    for name in metrics:
        np.testing.assert_allclose(float(metrics[name]),
                                   float(jmetrics[name]), atol=1e-5,
                                   rtol=1e-5, err_msg=name)
    want = bridge.to_state_dict(jstate.params, tm)
    j_adam = jstate.opt_state[1][0]
    jmu, jnu = (bridge.to_state_dict(t, tm) for t in (j_adam.mu, j_adam.nu))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-5, err_msg=name)
        st = state.opt_state.state[p]
        np.testing.assert_allclose(st["exp_avg"].numpy(), jmu[name].numpy(),
                                   atol=1e-6, rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                   jnu[name].numpy(), atol=1e-8, rtol=1e-3,
                                   err_msg=name)


def _c2_small(steps, ckpt_dir, extra=()):
    return t_preset("c2").override_str([
        "camera.features=8,16,16,16", "train.batch_size=2",
        f"train.steps={steps}", "train.eval_every=2", "train.log_every=100",
        "train.checkpoint_every=2", f"train.checkpoint_dir={ckpt_dir}",
        *extra])


def _c3_cnn_small(steps, ckpt_dir):
    return t_preset("c3").override_str([
        "camera.arch=cnn", "camera.features=8,16,16,16",
        "train.dataset=synthetic_cifar", "camera.image_hw=32,32",
        "channel.random_snr=true", "lidar.pillar_dim=16",
        "lidar.max_points=64", "lidar.bev_hw=8,8", "train.batch_size=2",
        f"train.steps={steps}", "train.log_every=100",
        "train.checkpoint_every=2", f"train.checkpoint_dir={ckpt_dir}"])


def _assert_same_state(a, b):
    assert a.step == b.step
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    for (name, p), q in zip(a.params.named_parameters(),
                            b.params.parameters()):
        assert torch.equal(p, q), name
        sa, sb = a.opt_state.state[p], b.opt_state.state[q]
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[k], sb[k]), (name, k)


@pytest.mark.parametrize("trainer,make", [(tjscc, _c2_small),
                                         (tfj, _c3_cnn_small)])
def test_kill_and_resume_is_bit_equal(tmp_path, trainer, make):
    """4 steps straight against 2, a new process's worth of state restored
    from the checkpoint, and 2 more: the same parameters, moments,
    generator and step, bit for bit."""
    straight, _ = trainer.run(make(4, tmp_path / "a"), device="cpu")
    trainer.run(make(2, tmp_path / "b"), device="cpu")
    assert CheckpointManager(str(tmp_path / "b")).latest_step() == 2
    resumed, out = trainer.run(make(4, tmp_path / "b"), device="cpu")
    _assert_same_state(straight, resumed)
    assert CheckpointManager(str(tmp_path / "b")).steps() == [2, 4]
    assert json.loads((tmp_path / "b" / "config.json").read_text())
    if trainer is tjscc:
        assert resumed.schedule.last_epoch == 4
        assert {"ckpt_save_s", "ckpt_close_s", "eval_psnr"} <= set(out)


def test_checkpoints_keep_the_last_and_name_what_does_not_match(tmp_path):
    cfg = _c2_small(2, tmp_path)
    state = tjscc.create_train_state(cfg, 0, "cpu")
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_step() is None and mgr.restore_latest(state) is None
    for step in (1, 2, 3):
        mgr.save(step, state._replace(step=step))
    assert mgr.steps() == [2, 3]
    assert not [p for p in tmp_path.iterdir() if ".tmp" in p.name]
    assert mgr.restore_latest(state).step == 3
    other = tjscc.create_train_state(
        cfg.override_str(["camera.adaptive_rate=true"]), 0, "cpu")
    with pytest.raises(KeyError, match="rate_film"):
        mgr.restore_latest(other)
    wide = collections.namedtuple("Wide", state._fields + ("extra",))
    with pytest.raises(KeyError, match=r"missing \['extra'\]"):
        mgr.restore_latest(wide(*state, extra=0))
    fused = tfj.create_train_state(_c3_cnn_small(2, tmp_path), 0, "cpu")
    with pytest.raises(KeyError, match=r"not in the state \['schedule'\]"):
        mgr.restore_latest(fused)
    fresh = tjscc.build_model(cfg)
    assert mgr.restore_params_latest(fresh) is fresh
    for p, q in zip(fresh.parameters(), state.params.parameters()):
        assert torch.equal(p, q)


def test_sweep_command_on_a_checkpoint(tmp_path, capsys):
    ckpt = tmp_path / "ck"
    with pytest.raises(SystemExit, match="no checkpoint found"):
        tsweep.main(["--config", "c2", "--device", "cpu",
                     "--set", f"train.checkpoint_dir={ckpt}"])
    over = ["camera.features=8,16,16,16", "train.batch_size=2",
            f"train.checkpoint_dir={ckpt}", "camera.adaptive_rate=true"]
    tjscc.run(_c2_small(2, ckpt, ["camera.adaptive_rate=true"]),
              device="cpu")
    capsys.readouterr()
    out = tmp_path / "curves.json"
    args = ["--config", "c2", "--device", "cpu", "--out", str(out),
            "--kinds", "awgn,rayleigh,rician"]
    for o in over:
        args += ["--set", o]
    assert tsweep.main(args) == 0
    curves = json.loads(out.read_text())
    assert list(curves) == ["awgn", "rayleigh", "rician"]
    for curve in curves.values():
        assert [p["snr_db"] for p in curve] == list(map(float,
                                                        tsweep.DEFAULT_SNRS))
        assert all(np.isfinite([p["psnr"], p["ssim"], p["miou"]]).all()
                   for p in curve)
    printed = capsys.readouterr().out
    assert tsweep.format_table(curves, "miou") in printed
    assert tsweep.main(args + ["--rate-sweep"]) == 0
    rate = json.loads(out.read_text())["awgn"]
    assert [p["rate_sym"] for p in rate] == list(range(1, 9))
    fixed = [a for a in args if a != "camera.adaptive_rate=true"]
    fixed = fixed[:-1] if fixed[-1] == "--set" else fixed
    assert tsweep.main(fixed + ["--rate-sweep", "--allow-untrained", "--set",
                                f"train.checkpoint_dir={tmp_path / 'none'}"]
                       ) == 2


def test_fusion_sweep_command_untrained(tmp_path, capsys):
    over = ["camera.arch=cnn", "camera.features=8,16,16,16",
            "train.dataset=synthetic_cifar", "camera.image_hw=32,32",
            "lidar.pillar_dim=16", "lidar.max_points=64", "lidar.bev_hw=8,8",
            "train.batch_size=2", f"train.checkpoint_dir={tmp_path}"]
    args = ["--config", "c3", "--device", "cpu", "--allow-untrained",
            "--kinds", "awgn,ofdm", "--out", str(tmp_path / "c.json")]
    for o in over:
        args += ["--set", o]
    assert tsweep.main(args) == 0
    curves = json.loads((tmp_path / "c.json").read_text())
    assert set(curves) == {"camera", "lidar"}
    assert set(curves["lidar"]) == {"awgn", "ofdm"}
    assert "lidar BEV mIoU:" in capsys.readouterr().out


# --- the real-file loaders and the prefetcher --------------------------------

def _write_cifar(root, n_per_batch=8, batches=2):
    d = root / "cifar-10-batches-py"
    d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(1, batches + 1):
        data = rng.integers(0, 256, (n_per_batch, 3 * 32 * 32), np.uint8)
        with open(d / f"data_batch_{i}", "wb") as f:
            pickle.dump({b"data": data, b"labels": [0] * n_per_batch}, f)
    return str(root)


def _write_kitti(root, frames=2):
    pytest.importorskip("PIL")
    from PIL import Image

    d = root / "kitti"
    d.mkdir()
    rng = np.random.default_rng(1)
    for i in range(frames):
        arr = (rng.random((96, 320, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(d / f"frame{i:03d}.png")
    return str(root)


def test_cifar_loader_matches_jax_and_feeds_training(tmp_path):
    root = _write_cifar(tmp_path)
    bank = tdata._try_load_cifar(root)
    np.testing.assert_array_equal(bank, jdata._try_load_cifar(root))
    assert bank.shape == (16, 32, 32, 3) and bank.dtype == np.float32
    d = tdata.ImageDataset("cifar", 4, seed=0, device="cpu", data_root=root)
    j = jdata.ImageDataset("cifar", 4, seed=0, data_root=root)
    for _ in range(2):                     # the same rows, step by step
        np.testing.assert_array_equal(next(d).numpy(), next(j))
    cfg = t_preset("c1").override_str([
        "camera.features=8,16,16,16", "camera.c_sym=2", "train.steps=2",
        "train.batch_size=4", "train.log_every=1", "train.dataset=cifar",
        f"train.data_root={root}"])
    _, out = tjscc.run(cfg, device="cpu")
    assert np.isfinite(out["loss"])


def test_kitti_loader_matches_jax(tmp_path):
    root = _write_kitti(tmp_path)
    bank = tdata._try_load_kitti_crops(root, (64, 64))
    np.testing.assert_array_equal(bank, jdata._try_load_kitti_crops(root,
                                                                    (64, 64)))
    assert bank.shape == (8, 64, 64, 3)
    d = tdata.ImageDataset("kitti", 3, device="cpu", data_root=root)
    assert next(d).shape == (3, 64, 64, 3)


def test_missing_files_fall_back_and_seg_warns(tmp_path):
    a = tdata.ImageDataset("cifar", 2, seed=3, device="cpu",
                           data_root=str(tmp_path))
    b = tdata.ImageDataset("synthetic_cifar", 2, seed=3, device="cpu")
    assert a._real is None and torch.equal(next(a), next(b))
    root = _write_cifar(tmp_path)
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        d = tdata.ImageDataset("cifar", 2, with_seg=True, device="cpu",
                               data_root=root)
    img, seg = next(d)
    assert img.shape == (2, 32, 32, 3) and seg.shape == (2, 32, 32)
    reuse = tdata.ImageDataset("cifar", 2, device="cpu", data_root="/nowhere",
                               real_bank=d._real)
    assert reuse._real is d._real


def test_prefetch_keeps_order_and_passes_tuples():
    batches = [(torch.full((2,), float(i)), torch.tensor([i])) for i in range(5)]
    got = list(prefetch_to_device(iter(batches), size=2, device="cpu"))
    assert len(got) == 5
    for (a, b), (x, y) in zip(got, batches):
        assert a is x and b is y             # already on the device
    assert list(prefetch_to_device(iter([]), device="cpu")) == []
