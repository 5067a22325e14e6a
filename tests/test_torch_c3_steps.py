"""Many train steps of the port against the JAX package on the CPU, held
step by step: the loss, the metrics and every parameter after each step,
from the same bridged weights, on the same batches, with JAX's own draws.

* c3 late fusion (the ViT camera codec and the LiDAR BEV codec, constant
  learning rate under optax's clip + AdamW), 12 steps;
* c2 (the CNN codec with the SNR FiLM and the seg head, a per-example SNR),
  12 steps through optax's warm-up (4 updates) and into its cosine.

Reduced widths (16x16 images for c3, depth 1); f32, TF32 off, JAX at
``highest`` precision. One step differs only in the last bits (f32 sums in
other orders). c2's parameters are held to 1e-5 after every step. c3's are
held to 1e-4: an attention's key bias gets a gradient that is zero but for
rounding (softmax ignores a shift shared by every key), and Adam divides
that rounding by its own size, so both sides move those biases by up to
lr x 1e-2 in directions of their own (1.2e-5 apart after the second step).
The loss and the metrics are held to 1e-4 relative.
"""

import jax
import numpy as np
import pytest
import torch

from multimodal_sc_torch import bridge
from multimodal_sc_torch.config import get_preset as t_preset
from multimodal_sc_torch.train import fusion_jscc as tfj
from multimodal_sc_torch.train import jscc as tjscc
from multimodal_sc_tpu.config import get_preset as j_preset
from multimodal_sc_tpu.train import fusion_jscc as jfj
from multimodal_sc_tpu.train import jscc as jjscc

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

STEPS = 12
BATCH = 2


def _t(x):
    return torch.tensor(np.array(x))


def _hold(step, metrics, jmetrics, module, jparams, atol):
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-4, atol=1e-5,
                                   err_msg=f"step {step}: {k}")
    want = bridge.to_state_dict(jparams, module)
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=atol, err_msg=f"step {step}: {name}")


def _points(rng, n):
    pts = np.stack([rng.uniform(-4, 52, (BATCH, n)),
                    rng.uniform(-14, 14, (BATCH, n)),
                    rng.uniform(0, 1.8, (BATCH, n)),
                    rng.uniform(0, 1, (BATCH, n))], -1).astype(np.float32)
    mask = rng.uniform(0, 1, (BATCH, n)) < 0.85
    cls = rng.integers(1, 4, (BATCH, n)).astype(np.int32)
    return pts, mask, cls


def test_c3_twelve_steps_follow_jax():
    over = ["camera.image_hw=16,16", "camera.depth=1", "camera.c_sym=4",
            "camera.dim=48", "camera.heads=3", "lidar.pillar_dim=16",
            "lidar.max_points=48", "lidar.bev_hw=8,8",
            f"train.batch_size={BATCH}", "channel.random_snr=true"]
    jcfg, tcfg = j_preset("c3").override_str(over), t_preset(
        "c3").override_str(over)
    jstate = jfj.create_train_state(jcfg, jax.random.key(0))
    j_step = jfj.make_train_step(jcfg)
    state = tfj.create_train_state(tcfg, 0, "cpu")
    state.params.load_state_dict(bridge.to_state_dict(jstate.params,
                                                      state.params))
    t_step = tfj.make_train_step(tcfg)
    rng = np.random.default_rng(0)
    n_cam = 4 * 4 * jcfg.camera.c_sym
    n_lid = 8 * 8 * jcfg.lidar.c_sym
    ch = jcfg.channel
    for step in range(STEPS):
        img = rng.uniform(0, 1, (BATCH, 16, 16, 3)).astype(np.float32)
        pts, mask, cls = _points(rng, 48)
        key = jax.random.fold_in(jax.random.key(1), step)
        jstate, jm = j_step(jstate, img, pts, mask, cls, key)
        # train_step: ksnr, kch = split(key); the forward splits kch into
        # the camera and LiDAR links.
        ksnr, kch = jax.random.split(key)
        k_cam, k_lid = jax.random.split(kch)
        draws = tfj.StepDraws(
            snr_db=_t(jax.random.uniform(ksnr, (BATCH,), minval=ch.snr_min_db,
                                         maxval=ch.snr_max_db)),
            channel_noise=(_t(jax.random.normal(k_cam, (BATCH, n_cam, 2))),
                           _t(jax.random.normal(k_lid, (BATCH, n_lid, 2)))))
        state, m = t_step(state, *(torch.from_numpy(a) for a in (
            img, pts, mask, cls)), draws)
        _hold(step, m, jm, state.params, jstate.params, 1e-4)
    assert state.step == STEPS


def test_c2_twelve_steps_through_the_warm_up_follow_jax():
    over = ["camera.features=8,16,16,16", f"train.batch_size={BATCH}",
            f"train.steps={STEPS}", "train.warmup_steps=4"]
    jcfg, tcfg = j_preset("c2").override_str(over), t_preset(
        "c2").override_str(over)
    model = jjscc.build_model(jcfg)
    jstate = jjscc.create_train_state(jcfg, jax.random.key(0))
    body = jax.jit(jjscc._step_body(jcfg, model))
    state = tjscc.create_train_state(tcfg, 0, "cpu")
    state.params.load_state_dict(bridge.to_state_dict(jstate.params,
                                                      state.params))
    t_step = tjscc.make_train_step(tcfg)
    rng = np.random.default_rng(1)
    ch = jcfg.channel
    k = 8 * 8 * jcfg.camera.c_sym
    lrs = []
    for step in range(STEPS):
        img = rng.uniform(0, 1, (BATCH, 32, 32, 3)).astype(np.float32)
        seg = rng.integers(0, 4, (BATCH, 32, 32)).astype(np.int32)
        key = jax.random.fold_in(jax.random.key(2), step)
        jstate, jm = body(jstate, img, seg, key)
        ksnr, kch = jax.random.split(key)
        draws = tjscc.StepDraws(
            snr_db=_t(jax.random.uniform(ksnr, (BATCH,), minval=ch.snr_min_db,
                                         maxval=ch.snr_max_db)),
            channel=_t(jax.random.normal(kch, (BATCH, k, 2))))
        lrs.append(state.opt_state.param_groups[0]["lr"])
        state, m = t_step(state, (_t(img), _t(seg)), draws)
        _hold(step, m, jm, state.params, jstate.params, 1e-5)
    # Warm-up from 0 to lr over 4 updates, then the cosine down.
    assert lrs[0] == 0 and lrs[4] == pytest.approx(tcfg.train.lr)
    assert lrs[3] < lrs[4] and lrs[-1] < lrs[5]
