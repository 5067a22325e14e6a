"""The c3 late-fusion JSCC training step of the port against the JAX
package on the CPU, in both arms:

* arm P: a ViT the packed attention kernel takes (dim 128, 4 heads);
* arm F: a ViT it refuses (dim 96, 3 heads), which runs the flash kernels.

The JAX side runs its Pallas kernels in interpret mode (forward and
backward); the port, on CPU tensors, runs their plain versions. Both sides
get the same parameters and Adam state (``multimodal_sc_torch.bridge``),
the same batch (made from a seed with numpy) and JAX's own channel noise,
at a reduced c3 (16x16 images, depth 1, narrow LiDAR codec). f32
everywhere, JAX at ``highest`` matmul precision.
"""

import ast
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import multimodal_sc_torch
from multimodal_sc_torch import bridge
from multimodal_sc_torch.codec import lidar_bev as tlid
from multimodal_sc_torch.config import get_preset as t_preset
from multimodal_sc_torch.envs import datasets as tdata
from multimodal_sc_torch.train import fusion_jscc as tfj
from multimodal_sc_tpu.codec import lidar_bev as jlid
from multimodal_sc_tpu.config import get_preset as j_preset
from multimodal_sc_tpu.train import fusion_jscc as jfj

PKG = pathlib.Path(multimodal_sc_torch.__file__).parent
SMALL = ["camera.image_hw=16,16", "camera.depth=1", "camera.c_sym=4",
         "lidar.pillar_dim=16", "lidar.max_points=48", "lidar.bev_hw=8,8",
         "train.batch_size=2", "pallas_attention=true"]
ARMS = {"P": ["camera.dim=128", "camera.heads=4"],
        "F": ["camera.dim=96", "camera.heads=3"]}
BATCH = 2


def _np(x):
    return np.array(x)


def _t(x):
    return torch.tensor(np.array(x))


def _perturb(tree, seed, scale=0.1):
    """Parameters moved off their init (zero biases, unit LayerNorm
    scales), so a dropped bias or a swapped norm shows."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + scale * jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32)), tree)


def _points(rng, b=BATCH, n=48):
    pts = np.stack([rng.uniform(-4, 52, (b, n)), rng.uniform(-14, 14, (b, n)),
                    rng.uniform(0, 1.8, (b, n)), rng.uniform(0, 1, (b, n))],
                   -1).astype(np.float32)
    mask = rng.uniform(0, 1, (b, n)) < 0.85
    cls = rng.integers(1, 4, (b, n)).astype(np.int32)
    return pts, mask, cls


# --- the slice as a whole --------------------------------------------------

def _configs(arm, extra=()):
    over = SMALL + ARMS[arm] + list(extra)
    return j_preset("c3").override_str(over), t_preset("c3").override_str(over)


def _batch():
    rng = np.random.default_rng(70)
    img = rng.uniform(0, 1, (BATCH, 16, 16, 3)).astype(np.float32)
    return (img,) + _points(rng)


def _jax_noise(jcfg, key):
    """The standard-normal draws of the camera and LiDAR links that
    ``LateFusionJSCC.__call__`` makes from ``key``."""
    k_cam, k_lid = jax.random.split(key)
    n_cam = (16 // 4) ** 2 * jcfg.camera.c_sym
    n_lid = jcfg.lidar.bev_hw[0] * jcfg.lidar.bev_hw[1] * jcfg.lidar.c_sym
    return tuple(_t(jax.random.normal(k, (BATCH, n, 2)))
                 for k, n in ((k_cam, n_cam), (k_lid, n_lid)))


def _jax_loss(jcfg, params, img, pts, mask, target, snr, key):
    """The loss of ``fusion_jscc._step_body`` (its ``loss_fn``)."""
    recon, logits, _ = jfj.LateFusionJSCC(jcfg).apply(
        {"params": params}, img, pts, mask, snr, key)
    cam_loss = jnp.mean(jnp.square(recon - img))
    if jcfg.lidar.seg_classes > 1:
        lid_loss = jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            logits, target))
    else:
        l = logits[..., 0]
        lid_loss = jnp.mean(jnp.maximum(l, 0) - l * target
                            + jnp.log1p(jnp.exp(-jnp.abs(l))))
    return cam_loss + 0.5 * lid_loss, (recon, logits)


@functools.lru_cache(maxsize=None)
def _jax_slice(arm, seg_classes=4):
    """One jitted JAX loss + gradient per arm, shared by the cases."""
    jcfg, _ = _configs(arm, [f"lidar.seg_classes={seg_classes}"])
    img, pts, mask, cls = (jnp.asarray(a) for a in _batch())
    params = _perturb(jfj.create_train_state(jcfg, jax.random.key(0)).params,
                      71, 0.02)
    lid = jcfg.lidar
    if seg_classes > 1:
        target = jlid.semantic_bev_target(pts, mask, cls, lid.bev_hw,
                                          lid.x_range, lid.y_range,
                                          num_classes=seg_classes)
    else:
        target = jlid.occupancy_target(pts, mask, lid.bev_hw, lid.x_range,
                                       lid.y_range)
    snr = jnp.full((BATCH,), jcfg.channel.snr_db, jnp.float32)
    key = jax.random.key(72)
    (loss, (recon, logits)), grads = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(jcfg, p, img, pts, mask, target, snr, key),
        has_aux=True))(params)
    return params, key, float(loss), _np(recon), _np(logits), grads


def _port_loss(arm, seg_classes=4):
    jcfg, tcfg = _configs(arm, [f"lidar.seg_classes={seg_classes}"])
    params, key, *_ = _jax_slice(arm, seg_classes)
    model = tfj.LateFusionJSCC(tcfg)
    model.load_state_dict(bridge.to_state_dict(params, model))
    img, pts, mask, cls = (_t(a) for a in _batch())
    target = tfj.bev_target(tcfg, pts, mask, cls)
    snr = torch.full((BATCH,), tcfg.channel.snr_db)
    loss, (recon, logits, *_) = tfj.loss_fn(
        tcfg, model, img, pts, mask, target, snr,
        channel_noise=_jax_noise(jcfg, key))
    return model, loss, recon, logits


@pytest.mark.parametrize("arm", ["P", "F"])
def test_late_fusion_forward_and_loss_match_jax(arm):
    _, _, want_loss, want_recon, want_logits, _ = _jax_slice(arm)
    _, loss, recon, logits = _port_loss(arm)
    # f32 through ~15 layers, summed in other orders: 1e-4 on activations.
    np.testing.assert_allclose(recon.detach().numpy(), want_recon, atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(float(loss.detach()), want_loss, atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("arm", ["P", "F"])
def test_loss_gradients_match_jax(arm):
    *_, grads = _jax_slice(arm)
    model, loss, _, _ = _port_loss(arm)
    loss.backward()
    want = bridge.to_state_dict(grads, model)
    assert len(want) == len(list(model.parameters()))
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-5, rtol=1e-3, err_msg=name)


def test_binary_occupancy_loss_matches_jax():
    _, _, want_loss, _, want_logits, _ = _jax_slice("F", 1)
    _, loss, _, logits = _port_loss("F", 1)
    assert logits.shape == (BATCH, 8, 8, 1)
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(float(loss.detach()), want_loss, atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("arm,extra", [("P", ["train.grad_clip=0.05"]),
                                       ("F", ["train.grad_clip=100.0"])])
def test_train_step_matches_optax(arm, extra):
    """One full train step (clip + AdamW) from the same parameters and Adam
    state against ``fusion_jscc.make_train_step``: parameters, moments and
    metrics afterwards."""
    jcfg, tcfg = _configs(arm, extra)
    params, _, _, _, _, grads = _jax_slice(arm)
    norm = float(optax.global_norm(grads))
    assert (norm > jcfg.train.grad_clip) == (arm == "P")
    jstate = jfj.create_train_state(jcfg, jax.random.key(0))
    # A non-trivial optimizer state: one earlier update on other gradients.
    _, opt_state = jstate.tx.update(_perturb(grads, 73, 1e-3),
                                    jstate.tx.init(params), params)
    jstate = jstate.replace(params=params, opt_state=opt_state)
    batch = _batch()
    key = jax.random.key(74)
    j_new, j_metrics = jfj.make_train_step(jcfg)(
        jstate, *(jnp.asarray(a) for a in batch), key)

    state = tfj.create_train_state(tcfg, seed=0, device="cpu")
    state.params.load_state_dict(bridge.to_state_dict(params, state.params))
    adam = opt_state[1][0]
    bridge.load_adam_state(state.opt_state, state.params, int(adam.count),
                           adam.mu, adam.nu)
    _, kch = jax.random.split(key)          # train_step: ksnr, kch = split
    draws = tfj.StepDraws(channel_noise=_jax_noise(jcfg, kch))
    state, metrics = tfj.make_train_step(tcfg)(
        state, *(_t(a) for a in batch), draws)

    assert state.step == 1
    assert set(metrics) == set(j_metrics)
    for k in metrics:
        # PSNR in dB and a loss near 1: 1e-4 relative.
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]),
                                   atol=1e-5, rtol=1e-4, err_msg=k)
    want = bridge.to_state_dict(j_new.params, state.params)
    j_adam = j_new.opt_state[1][0]
    mu, nu = (bridge.to_state_dict(t, state.params)
              for t in (j_adam.mu, j_adam.nu))
    for name, p in state.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-5, err_msg=name)
        st = state.opt_state.state[p]
        assert int(st["step"]) == int(j_adam.count) == 2
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu[name].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu[name].numpy(),
                                   atol=1e-7, rtol=1e-3, err_msg=name)


def test_adamw_is_optax_adamw():
    """The decoupled decay, at a decay large enough to show (the preset's
    1e-4 times lr 1e-3 is below f32 resolution after one step): two steps of
    ``torch.optim.AdamW`` against ``optax.adamw``, and the preset's
    optimizer decays every parameter by optax's default."""
    rng = np.random.default_rng(75)
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in (("w", (5, 3)), ("b", (3,)))}
    tx = optax.adamw(0.1, weight_decay=0.3)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = [torch.nn.Parameter(torch.tensor(v)) for v in p0.values()]
    opt = torch.optim.AdamW(tp, lr=0.1, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.3)
    js = tx.init(jp)
    for step in range(2):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in p0.items()}
        up, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, up)
        for p, v in zip(tp, g.values()):
            p.grad = torch.tensor(v)
        opt.step()
    # Steps of 0.1 in f32 with the bias corrections taken in another order:
    # 1e-5 (a decay left out or coupled into the gradient moves a parameter
    # by lr * wd * p = 3e-2 p).
    for p, k in zip(tp, p0):
        np.testing.assert_allclose(p.detach().numpy(), _np(jp[k]), atol=1e-5,
                                   rtol=1e-5)
    _, tcfg = _configs("F")
    model = tfj.LateFusionJSCC(tcfg)
    opt = tfj.make_optimizer(tcfg, model)
    assert len(opt.param_groups) == 1
    group = opt.param_groups[0]
    assert group["weight_decay"] == 1e-4 and group["lr"] == tcfg.train.lr
    assert len(group["params"]) == len(list(model.parameters()))


def test_run_three_steps_on_the_cpu_returns_the_jax_keys(tmp_path):
    over = ["camera.depth=1", "camera.dim=48", "camera.heads=3",
            "lidar.pillar_dim=16", "lidar.max_points=64", "lidar.bev_hw=8,8",
            "train.batch_size=2", "train.steps=3", "train.log_every=2",
            "train.dataset=synthetic_cifar", "camera.image_hw=32,32",
            "pallas_attention=true"]
    cfg = t_preset("c3").override_str(over)
    path = tmp_path / "metrics.jsonl"
    state, out = tfj.run(cfg, metrics_path=str(path), device="cpu")
    assert state.step == 3
    assert set(out) == {"loss", "cam_loss", "lidar_loss", "psnr", "miou",
                        "first_dispatch_s", "steady_steps_per_sec"}
    assert all(np.isfinite(v) for v in out.values())
    assert 0.0 <= out["miou"] <= 1.0 and out["psnr"] > 5.0
    lines = path.read_text().splitlines()
    assert len(lines) == 3          # the config, step 2, the final record
    assert tfj.main(["--config", "c3", "--device", "cpu"]
                    + [a for o in over for a in ("--set", o)]) == 0


def test_c3_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_preset("c3")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfj.create_train_state(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfj.run(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdata.ImageDataset("synthetic_kitti", 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(tfj.make_batches(cfg, multimodal_sc_torch.resolve_device()))


@pytest.mark.parametrize("what", ["lidar_vq_codec", "lidar.arch=vq",
                                  "camera.arch=vq", "train.bf16=true"])
def test_what_the_c3_slice_does_not_port_raises(what):
    """``camera.arch=vq`` raises (refused by the JAX package too).
    ``train.bf16`` builds on the analog and on the digital LiDAR, bf16
    activations on f32 parameters. The digital LiDAR codec is ported: it
    builds, and keeps the JAX package's refusals of a codebook that is no
    power of 4 and of FEC over a payload that is no whole number of
    bytes."""
    cfg = t_preset("c3")
    if what == "lidar_vq_codec":
        assert tlid.LidarBEVVQCodec(pillar_dim=16).n_tokens == 16 * 16
        with pytest.raises(ValueError, match="power of 4"):
            tlid.LidarBEVVQCodec(pillar_dim=16, vq_codes=32)
    elif what == "lidar.arch=vq":
        tfj.make_train_step(cfg.override_str([what]))
        with pytest.raises(ValueError, match="divisible by 8"):
            tfj.build_lidar_codec(cfg.override_str([
                what, "lidar.vq_codes=4", "lidar.bev_hw=3,3",
                "channel.fec=hamming74"]))
    elif what == "train.bf16=true":
        tfj.make_train_step(cfg.override_str([what]))
        codec = tfj.build_lidar_codec(cfg.override_str([what,
                                                        "lidar.arch=vq"]))
        assert isinstance(codec, tlid.LidarBEVVQCodec)
        assert codec.dtype == codec.to_code.act_dtype == torch.bfloat16
        assert all(p.dtype == torch.float32 for p in codec.parameters())
    else:
        with pytest.raises(NotImplementedError):
            tfj.make_train_step(cfg.override_str([what]))


@pytest.mark.parametrize("module", [
    "kernels/attention.py", "codec/camera_vit.py", "codec/lidar_bev.py",
    "evaluation/metrics.py", "envs/datasets.py", "train/fusion_jscc.py",
    "bridge.py", "channel/entropy_coding.py", "codec/semantic_vq.py",
    "evaluation/snr_sweep.py"])
def test_c3_modules_import_no_jax(module):
    banned = ("jax", "flax", "optax", "multimodal_sc_tpu")
    for node in ast.walk(ast.parse((PKG / module).read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in banned, (module, name)
