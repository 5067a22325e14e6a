"""The port's c1 camera CNN JSCC path against the JAX package on the CPU:
``CameraJSCC`` (its transposed convs included) on bridged weights, one
train step (clip + AdamW under optax's warm-up cosine schedule) from the
same parameters and Adam state with JAX's own channel noise, the schedule,
the driver's result keys and the refusals. Narrow codec widths
(16, 32, 64, 64); f32 everywhere, TF32 off, JAX at ``highest`` precision.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from multimodal_sc_torch import bridge
from multimodal_sc_torch.codec.camera_cnn import CameraJSCC, ConvTransposeSame
from multimodal_sc_torch.config import get_preset as t_preset
from multimodal_sc_torch.train import jscc as tjscc
from multimodal_sc_tpu.channel import channel as jchannel
from multimodal_sc_tpu.config import get_preset as j_preset
from multimodal_sc_tpu.evaluation.metrics import psnr as jpsnr
from multimodal_sc_tpu.train import jscc as jjscc

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

SMALL = ["camera.features=16,32,64,64", "train.batch_size=8"]
BATCH = 2


def _configs(extra=()):
    over = SMALL + list(extra)
    return j_preset("c1").override_str(over), t_preset("c1").override_str(over)


def _t(x):
    return torch.tensor(np.array(x))


def _perturb(tree, seed, scale=0.02):
    """Parameters moved off their init (zero biases), so a dropped bias or
    a misplaced one shows."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + scale * jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32)), tree)


def _load(tmodel, params):
    tmodel.load_state_dict(bridge.to_state_dict(params, tmodel))
    return tmodel


@pytest.mark.parametrize("hw,cin", [((8, 8), 6), ((5, 7), 3)])
def test_conv_transpose_same_matches_flax(hw, cin):
    """flax ConvTranspose(k 5, stride 2, SAME): an unflipped kernel and
    lax's (3, 2) padding, against F.conv_transpose2d with the flipped
    kernel, padding 1 and the last row and column cropped."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, *hw, cin)).astype(np.float32)
    m = fnn.ConvTranspose(4, (5, 5), strides=(2, 2), padding="SAME")
    params = _perturb(m.init(jax.random.key(0), x)["params"], 2, 0.1)
    want = np.asarray(m.apply({"params": params}, x))
    holder = torch.nn.Module()
    holder.deconv = ConvTransposeSame(cin, 4, 5, 2)
    _load(holder, {"deconv": params})
    got = holder.deconv(torch.tensor(x)).detach().numpy()
    assert got.shape == want.shape == (2, 2 * hw[0], 2 * hw[1], 4)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_model(hw):
    jcfg, _ = _configs([f"camera.image_hw={hw[0]},{hw[1]}"])
    model = jjscc.build_model(jcfg)
    img = jnp.zeros((BATCH, *hw, 3))
    params = _perturb(model.init(jax.random.key(3), img)["params"], 4)
    return jcfg, model, params


@pytest.mark.parametrize("hw", [(32, 32), (16, 24)])
def test_camera_jscc_encode_decode_match_jax(hw):
    jcfg, model, params = _jax_model(hw)
    img = np.random.default_rng(5).uniform(0, 1, (BATCH, *hw, 3)).astype(
        np.float32)
    z = jax.jit(functools.partial(model.apply, method="encode"))(
        {"params": params}, img)
    z_hat = z + 0.3 * jax.random.normal(jax.random.key(6), z.shape)
    recon = jax.jit(functools.partial(model.apply, method="decode"))(
        {"params": params}, z_hat)
    tcfg = t_preset("c1").override_str(SMALL + [
        f"camera.image_hw={hw[0]},{hw[1]}"])
    tm = _load(tjscc.build_model(tcfg), params)
    with torch.no_grad():
        tz = tm.encode(torch.tensor(img))
        trecon = tm.decode(_t(z_hat))
    assert tz.shape == z.shape == (BATCH, tm.k, 2)
    assert trecon.shape == recon.shape == (BATCH, *hw, 3)
    np.testing.assert_allclose(tz.numpy(), np.asarray(z), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(trecon.numpy(), np.asarray(recon), atol=1e-5,
                               rtol=1e-5)


def test_lr_schedule_is_optax_warmup_cosine():
    """Against optax's schedule, which computes in f32."""
    _, tcfg = _configs(["train.steps=300", "train.warmup_steps=100"])
    tr = tcfg.train
    sched = optax.warmup_cosine_decay_schedule(
        0.0, tr.lr, tr.warmup_steps, max(tr.steps, tr.warmup_steps + 1))
    for count in (0, 1, 50, 99, 100, 101, 250, 299, 300, 400):
        np.testing.assert_allclose(tjscc.lr_schedule(tcfg, count),
                                   float(sched(count)), rtol=1e-5, atol=1e-10,
                                   err_msg=str(count))


def _jax_loss(model, params, img, snr, kch):
    """The loss of ``jscc._step_body`` for the fixed-rate, no-seg codec."""
    z = model.apply({"params": params}, img, snr, method="encode")
    z_hat = jchannel(z, snr, "awgn", kch)
    recon = model.apply({"params": params}, z_hat, snr, method="decode")
    return jnp.mean(jnp.square(recon - img)), recon


@pytest.mark.parametrize("count", [0, 150])
def test_train_step_matches_jax(count):
    """One train step from the same parameters and Adam state at update
    ``count`` (0: inside the warm-up, where optax's lr is 0; 150: inside
    the cosine), the clip active: loss, gradients, parameters and moments
    after it."""
    jcfg, tcfg = _configs(["train.steps=300", "train.warmup_steps=100",
                           "train.grad_clip=0.005"])
    hw = jcfg.camera.image_hw
    _, model, params = _jax_model(hw)
    rng = np.random.default_rng(7)
    img = jnp.asarray(rng.uniform(0, 1, (BATCH, *hw, 3)), jnp.float32)
    jstate = jjscc.create_train_state(jcfg, jax.random.key(0))
    adam, decay, sched = jstate.opt_state[1]
    mu = _perturb(jax.tree_util.tree_map(jnp.zeros_like, params), 8, 1e-3)
    nu = jax.tree_util.tree_map(jnp.abs, _perturb(
        jax.tree_util.tree_map(jnp.zeros_like, params), 9, 1e-4))
    c = jnp.asarray(count, jnp.int32)
    opt_state = (jstate.opt_state[0], (adam._replace(count=c, mu=mu, nu=nu),
                                       decay, sched._replace(count=c)))
    jstate = jstate.replace(params=params, opt_state=opt_state)
    key = jax.random.key(10)
    _, kch = jax.random.split(key)
    snr = jnp.full((BATCH,), jcfg.channel.snr_db, jnp.float32)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(model, p, img, snr, kch), has_aux=True))(params)
    assert float(optax.global_norm(grads)) > jcfg.train.grad_clip  # clips
    body = jax.jit(jjscc._step_body(jcfg, model))
    jstate, jmetrics = body(jstate, img, None, key)

    state = tjscc.create_train_state(tcfg, 0, "cpu")
    tm = _load(state.params, params)
    bridge.load_adam_state(state.opt_state, tm, count, mu, nu)
    state.schedule.last_epoch = count
    for group in state.opt_state.param_groups:
        group["lr"] = tjscc.lr_schedule(tcfg, count)
    noise = _t(jax.random.normal(kch, (BATCH, tm.k, 2)))
    timg = _t(img)
    tsnr = torch.full((BATCH,), tcfg.channel.snr_db)
    recon, _ = tjscc.reconstruct(tcfg, tm, timg, tsnr, noise=noise)
    tloss = (recon - timg).square().mean()
    tloss.backward()
    want = bridge.to_state_dict(grads, tm)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-5, rtol=1e-3, err_msg=name)
    tm.zero_grad(set_to_none=True)

    state, metrics = tjscc.make_train_step(tcfg)(state, timg, noise)
    assert state.step == 1 and state.schedule.last_epoch == count + 1
    for k in ("loss", "psnr"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(metrics["loss"]), float(loss), rtol=1e-5)
    want = bridge.to_state_dict(jstate.params, tm)
    moved = 0.0
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-5, err_msg=name)
        moved = max(moved, float((p.detach() - bridge.to_state_dict(
            params, tm)[name]).abs().max()))
    assert (moved > 0) == (count > 0)    # lr 0 on the first update
    j_adam = jstate.opt_state[1][0]
    jmu, jnu = (bridge.to_state_dict(t, tm) for t in (j_adam.mu, j_adam.nu))
    for name, p in tm.named_parameters():
        st = state.opt_state.state[p]
        assert int(st["step"]) == int(j_adam.count) == count + 1
        np.testing.assert_allclose(st["exp_avg"].numpy(), jmu[name].numpy(),
                                   atol=1e-6, rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                   jnu[name].numpy(), atol=1e-8, rtol=1e-3,
                                   err_msg=name)


def test_eval_step_is_psnr_through_the_channel():
    jcfg, tcfg = _configs()
    hw = jcfg.camera.image_hw
    _, model, params = _jax_model(hw)
    img = jnp.asarray(np.random.default_rng(11).uniform(
        0, 1, (BATCH, *hw, 3)), jnp.float32)
    key = jax.random.key(12)
    snr = jnp.full((BATCH,), jcfg.channel.snr_db, jnp.float32)
    z = model.apply({"params": params}, img, snr, method="encode")
    want = jpsnr(model.apply({"params": params},
                             jchannel(z, snr, "awgn", key), snr,
                             method="decode"), img)
    tm = _load(tjscc.build_model(tcfg), params)
    got = tjscc.make_eval_step(tcfg)(
        tm, _t(img), noise=_t(jax.random.normal(key, z.shape)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def _records(path):
    return [json.loads(line) for line in open(path)]


def test_train_run_keys_match_jax_run(tmp_path):
    over = ["camera.features=8,16,16,16", "train.steps=4",
            "train.eval_every=2", "train.log_every=2", "train.warmup_steps=2"]
    jcfg, tcfg = _configs(over)
    jpath, tpath = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    _, jout = jjscc.run(jcfg, metrics_path=jpath)
    state, tout = tjscc.run(tcfg, metrics_path=tpath, device="cpu")
    assert set(tout) == set(jout)
    assert all(np.isfinite(v) for v in tout.values())
    assert state.step == 4
    assert {frozenset(r) for r in _records(tpath)} == {
        frozenset(r) for r in _records(jpath)}
    assert [r["step"] for r in _records(tpath) if "eval_psnr" in r] == [
        2, 4, 4]


@pytest.mark.parametrize("over,exc,match", [
    # Token pruning is ported; UEP together with it, refused by the JAX
    # package too, still raises.
    (["camera.arch=vq", "camera.vq_prune=true", "channel.uep_alpha=0.25"],
     ValueError, "uep_alpha with camera.vq_prune"),
])
def test_refusals(over, exc, match):
    _, tcfg = _configs(over)
    with pytest.raises(exc, match=match):
        tjscc.make_train_step(tcfg)


def test_bf16_vq_codec_builds():
    """train.bf16 on the VQ codec, refused until its bf16 slice: the train
    step builds, the codec computes in bf16 on f32 parameters."""
    _, tcfg = _configs(["train.bf16=true", "camera.arch=vq"])
    tjscc.make_train_step(tcfg)
    model = tjscc.build_model(tcfg)
    assert model.dtype == model.to_code.act_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_vit_codec_trains(capsys):
    """``camera.arch=vit``, refused until the ViT JSCC path was ported: the
    driver builds a ``ViTJSCC`` (its parameter tree JAX's, the attention
    flag reaching its MHA) and trains it, the held-out PSNR finite."""
    over = ["camera.arch=vit", "camera.dim=32", "camera.depth=1",
            "camera.heads=2", "pallas_attention=true", "train.steps=2",
            "train.eval_every=2"]
    jcfg, tcfg = _configs(over)
    model = tjscc.build_model(tcfg)
    assert model.encoder.block0.attn.use_pallas
    jparams = jjscc.create_train_state(jcfg, jax.random.key(0)).params
    model.load_state_dict(bridge.to_state_dict(jparams, model))
    assert tjscc.main(["--config", "c1", "--device", "cpu"] + [
        a for o in SMALL + over for a in ("--set", o)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["train_steps"] == 2 and np.isfinite(out["eval_psnr"])


def test_main_trains(capsys):
    over = ["camera.features=8,16,16,16", "train.steps=2",
            "train.eval_every=2"]
    assert tjscc.main(["--config", "c1", "--device", "cpu"] + [
        a for o in SMALL + over for a in ("--set", o)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["train_steps"] == 2 and np.isfinite(out["eval_psnr"])


def test_run_refuses_checkpoints_and_needs_the_card(tmp_path, monkeypatch):
    """What is still refused: a checkpoint of another model, an adaptive
    codec without its rate, and the card when it is absent."""
    _, tcfg = _configs(["train.steps=1", f"train.checkpoint_dir={tmp_path}",
                        "train.checkpoint_every=1",
                        "camera.features=8,16,16,16"])
    tjscc.run(tcfg, device="cpu")
    with pytest.raises(KeyError, match="rate_film"):
        tjscc.run(tcfg.override_str(["camera.adaptive_rate=true"]),
                  device="cpu")
    with pytest.raises(ValueError, match="requires a rate"):
        CameraJSCC(adaptive_rate=True).encode(torch.zeros(1, 32, 32, 3))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tjscc.create_train_state(tcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tjscc.run(tcfg)
