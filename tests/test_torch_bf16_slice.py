"""``train.bf16`` on the paths the port runs it on, against the JAX package's
bf16 run on the CPU, and the refusals of everything else.

* c4 (``QNetwork`` over the CNN camera, the analog LiDAR and the fused
  blocks): Q given JAX's channel draws; ``_td_loss`` and its gradients;
  one learn step (clip, Adam, target and EMA) against optax, with f32
  parameters and f32 Adam moments;
* c5: ``_ppo_loss`` and its gradients;
* c1: one train step as JAX's ``tests/unit/test_bf16.py`` takes it
  (parameters stay f32, loss and PSNR finite) and its loss, PSNR and
  gradients against JAX's;
* c3 on the CNN camera (``camera.arch=cnn``): the loss and its gradients,
  then one train step's metrics and parameters;
* each combination builds in bf16 on f32 parameters, ``cli.main`` among
  them (the ViT camera, the packed and flash attention and the unfused
  fusion MHA since their bf16 slice: ``test_torch_bf16_attention.py``; the
  VQ codecs since theirs: ``test_torch_bf16_vq.py``).

JAX runs with ``use_pallas=True`` (its conv, scatter and fused-block
kernels in interpret mode on the CPU) where it only runs forward, on c1,
whose conv kernel has a custom VJP, and on the c3 step, whose LiDAR
branch it differentiates through the scatter's plain reference (its
scatter kernel has no VJP: ``_scatter_vjp``). The c4 and c5 losses run
JAX's XLA route (``use_pallas=False``), whose convs round three times
where the port's forward rounds once (both backwards recompute through
the three roundings). The exact gradients are JAX's f32 run on its XLA
route. Parameters are ``eval_shape`` of its init filled from numpy. Tolerances (as in ``test_torch_bf16.py``):
outputs within 2 bf16 steps of each tensor's largest entry; losses and
metrics within 1e-2 relative; greedy actions equal except where the top
two Q lie within the Q tolerance. Gradients, per tensor (``close_grads``): in
the L2 norm, within 2 bf16 steps of JAX's f32 gradient of the same loss
on the same parameters and draws, plus four times the distance of JAX's
bf16 gradient from it (at least the network's median distance), and
within 3/4 of the tensor's norm. At these depths JAX's own bf16 gradients
lie up to half a tensor's norm from its f32 ones, because ops amplify a
step's rounding: the TD error and the PPO advantage terms are
differences of values of like size; a LayerNorm over a near-constant row
(an empty BEV cell holds the conv's bias alone; a padded pillar point)
divides by that row's small spread; XLA sums a bf16 bias's gradient in
bf16; and the pillar scatter-max sends a cell's whole gradient to
whichever point of a near-tie a rounding makes the largest (the pillar
net's tensors are held at 8 times JAX's distance).
"""

import contextlib
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_sc_torch import bridge, cli
from multimodal_sc_torch.act_dtype import activation_dtype
from multimodal_sc_torch.config import get_preset as t_preset
from multimodal_sc_torch.io.checkpoint import CheckpointManager
from multimodal_sc_torch.rl import dqn as tdqn
from multimodal_sc_torch.rl import ppo as tppo
from multimodal_sc_torch.rl.perception import ActorCritic as TActorCritic
from multimodal_sc_torch.rl.perception import QNetwork as TQNetwork
from multimodal_sc_torch.train import fusion_jscc as tfj
from multimodal_sc_torch.train import jscc as tjscc
from multimodal_sc_tpu.channel import channel as jchannel
from multimodal_sc_tpu.codec import lidar_bev as jlid
from multimodal_sc_tpu.config import get_preset as j_preset
from multimodal_sc_tpu.envs import driving as jenv
from multimodal_sc_tpu.evaluation.metrics import psnr as jpsnr
from multimodal_sc_tpu.kernels import pillar_scatter as jscatter
from multimodal_sc_tpu.rl import dqn as jdqn
from multimodal_sc_tpu.rl import ppo as jppo
from multimodal_sc_tpu.train import fusion_jscc as jfj
from multimodal_sc_tpu.train import jscc as jjscc
from test_torch_bf16 import ULP, close_grads
from test_torch_c4_digital import flax_like

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

BF16 = ["train.bf16=true", "use_pallas=true"]
RL_LOSS = ["camera.features=8,16,32,32", "camera.c_sym=4", "fusion.dim=128",
           "fusion.depth=1", "fusion.heads=4", "fusion.state_dim=32",
           "lidar.pillar_dim=16", "lidar.bev_hw=8,8", "env.lidar_rays=16",
           "env.num_npcs=3", "rl.replay_capacity=64", "rl.n_step=2",
           "rl.batch_size=4", "train.bf16=true"]
RL = RL_LOSS + ["use_pallas=true"]
BATCH = 4
PFN = ["perception.pfn."]   # the parameters before the pillar scatter-max


def _configs(preset, over):
    return (j_preset(preset).override_str(over),
            t_preset(preset).override_str(over))


def _t(x):
    return torch.tensor(np.array(x))


def _rel(got, want, what, rtol=1e-2):
    np.testing.assert_allclose(float(got), float(want), rtol=rtol,
                               err_msg=what)


def _close(got, want, what, ulps=2):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=ulps * ULP * np.abs(want).max(), rtol=0,
                               err_msg=what)


@contextlib.contextmanager
def _scatter_vjp():
    """JAX's scatter kernel has no VJP (XLA differentiates ``segment_max``
    on its plain route): inside, a ``use_pallas`` model runs its convs and
    fused blocks on their kernels and the scatter on its plain reference,
    the same function (``test_torch_bf16``)."""
    kernel = jscatter.scatter_max_pallas
    jscatter.scatter_max_pallas = jscatter.scatter_max_reference
    try:
        yield
    finally:
        jscatter.scatter_max_pallas = kernel


def _f32(over):
    """The exact run's overrides: f32 activations, on JAX's XLA route (the
    same function as its kernels', to f32 rounding)."""
    return [o for o in over if o not in BF16]


def _by_name(net, tree):
    return bridge.to_state_dict(tree, net)


def _port_grads(net):
    """The gradients of ``net``'s parameters, zero where the loss did not
    reach one (as ``jax.grad`` gives it)."""
    return {n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in net.named_parameters()}


def _noise(cfg, key, batch):
    """The standard-normal draws of the JAX trunk's two AWGN links."""
    k_cam, k_lid = jax.random.split(key)
    hw = cfg.camera.image_hw
    n_cam = (hw[0] // 4) * (hw[1] // 4) * cfg.camera.c_sym
    n_lid = cfg.lidar.bev_hw[0] * cfg.lidar.bev_hw[1] * cfg.lidar.c_sym
    return tuple(_t(jax.random.normal(k, (batch, n, 2)))
                 for k, n in ((k_cam, n_cam), (k_lid, n_lid)))


@functools.lru_cache(maxsize=None)
def _params(preset):
    jcfg, _ = _configs(preset, RL_LOSS)
    lib = jppo if preset == "c5" else jdqn
    return flax_like(jax.eval_shape(lambda k: lib.init_params(jcfg, k),
                                    jax.random.key(0)), 1)


def _port(cls, tcfg, params):
    net = cls(tcfg)
    net.load_state_dict(bridge.to_state_dict(params, net))
    return net


@functools.lru_cache(maxsize=None)
def _obs(n, seed):
    jcfg, _ = _configs("c4", RL_LOSS)
    return jax.jit(lambda k: jenv.observe_batch(jcfg.env, jenv.reset_batch(
        jcfg.env, k, n)), static_argnums=())(jax.random.key(seed))


# --- c4 ---------------------------------------------------------------------

def test_c4_q_matches_jax_bf16():
    jcfg, tcfg = _configs("c4", RL)
    params = _params("c4")
    img, pts, mask = _obs(8, 5)
    key = jax.random.key(6)
    want = jax.jit(lambda p: jdqn.QNetwork(jcfg).apply(
        {"params": p}, img, pts, mask, key))(params)
    net = _port(TQNetwork, tcfg, params)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    with torch.no_grad():
        got = net(_t(img), _t(pts), _t(mask),
                  channel_noise=_noise(jcfg, key, 8))
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got.numpy(), want, "Q")
    # Greedy actions: equal but where the top two lie within the tolerance.
    tol = 2 * ULP * float(jnp.abs(want).max())
    top2 = jnp.sort(want, axis=-1)[:, -2:]
    near = np.asarray(top2[:, 1] - top2[:, 0]) <= 2 * tol
    same = got.argmax(-1).numpy() == np.asarray(jnp.argmax(want, -1))
    assert np.all(same | near)


def _batch(jcfg):
    rng = np.random.default_rng(0)
    (i0, p0, m0), (i1, p1, m1) = _obs(BATCH, 11), _obs(BATCH, 12)
    return jdqn.Transition(
        image=i0, points=p0, mask=m0,
        action=jnp.asarray(rng.integers(0, jcfg.rl.num_actions, BATCH),
                           jnp.int32),
        reward=jnp.asarray(rng.standard_normal(BATCH) * 2.0, jnp.float32),
        done=jnp.asarray(rng.uniform(size=BATCH) < 0.3),
        next_image=i1, next_points=p1, next_mask=m1)


def _perturb(tree, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + scale * jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32)), tree)


@functools.lru_cache(maxsize=None)
def _jax_td(over=tuple(RL_LOSS)):
    jcfg, _ = _configs("c4", list(over))
    batch, params = _batch(jcfg), _params("c4")
    target = _perturb(params, 2, 0.02)
    key = jax.random.key(21)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jdqn._td_loss(p, target, batch, key, jcfg),
        has_aux=True))(params)
    return params, target, batch, key, float(loss), grads


def _learn_draws(jcfg, key):
    k1, k2, k3 = jax.random.split(key, 3)
    return tdqn.LearnDraws(
        indices=torch.arange(BATCH), snr_db=None,
        noise_online=_noise(jcfg, k1, BATCH),
        noise_target=_noise(jcfg, k2, BATCH),
        noise_double=_noise(jcfg, k3, BATCH))


def test_c4_td_loss_and_gradients_match_jax_bf16():
    jcfg, tcfg = _configs("c4", RL_LOSS)
    params, target, batch, key, want_loss, grads = _jax_td()
    online, target_net = (_port(TQNetwork, tcfg, params),
                          _port(TQNetwork, tcfg, target))
    loss = tdqn._td_loss(tcfg, tdqn.learner_forward(tcfg), online,
                         target_net, tdqn.Transition(*(_t(x) for x in batch)),
                         _learn_draws(jcfg, key))
    assert loss.dtype == torch.float32
    _rel(loss.detach(), want_loss, "loss")
    loss.backward()
    exact = _jax_td(tuple(_f32(RL_LOSS)))[-1]
    close_grads(_port_grads(online), _by_name(online, grads),
                _by_name(online, exact), after_max=PFN)


def test_c4_learn_step_matches_optax_bf16():
    """One learn step from an Adam state whose second moments are 1 and
    whose count is large. The first moment (0.1 g) is held as the gradient
    is; the update, lr 0.1 g / sqrt(v_hat), falls under the f32 step of
    many parameters, so it is held through the EMA. Parameters, moments,
    target and EMA stay f32."""
    over = RL_LOSS + ["train.grad_clip=100.0"]
    jcfg, tcfg = _configs("c4", over)
    params, target, batch, key, want_loss, grads = _jax_td()
    exact = _jax_td(tuple(_f32(RL_LOSS)))[-1]
    ema = _perturb(params, 3, 0.01)
    tx = jdqn.make_optimizer(jcfg)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    ones = jax.tree_util.tree_map(jnp.ones_like, params)
    clip, (adam, *rest) = tx.init(params)
    opt_state = (clip, (adam._replace(count=jnp.asarray(1000, jnp.int32),
                                      mu=zeros, nu=ones), *rest))

    def step(g):
        updates, opt = tx.update(g, opt_state, params)
        return updates, opt[1][0].mu

    j_upd, j_mu = step(grads)
    _, x_mu = step(exact)
    j_params = optax.apply_updates(params, j_upd)
    e = jcfg.rl.ema_tau
    j_ema = jax.tree_util.tree_map(lambda m, p: (1.0 - e) * m + e * p, ema,
                                   j_params)

    state = tdqn.init(tcfg, seed=0, num_envs=2, device="cpu")
    for net, tree in ((state.params, params), (state.target_params, target),
                      (state.ema_params, ema)):
        net.load_state_dict(bridge.to_state_dict(tree, net))
    bridge.load_adam_state(state.opt_state, state.params, 1000, zeros, ones)
    state = state._replace(step=5)
    before = {n: p.detach().clone() for n, p in
              state.params.named_parameters()}
    state, loss = tdqn.learn_step(tcfg, state,
                                  tdqn.Transition(*(_t(x) for x in batch)),
                                  _learn_draws(jcfg, key))
    _rel(loss, want_loss, "loss")
    net = state.params
    close_grads({n: state.opt_state.state[p]["exp_avg"] for n, p in
                 net.named_parameters()}, _by_name(net, j_mu),
                _by_name(net, x_mu), "mu ", after_max=PFN)
    for net in (state.params, state.target_params, state.ema_params):
        assert all(p.dtype == torch.float32 for p in net.parameters())
    for st in state.opt_state.state.values():
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32
    want = bridge.to_state_dict(j_ema, state.ema_params)
    for name, p in state.ema_params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-6, err_msg=name)


def test_c4_bf16_checkpoint_round_trip_is_bit_equal(tmp_path):
    """A bf16 run's state (f32 parameters and moments) saves and restores
    bit for bit."""
    _, tcfg = _configs("c4", RL)
    state = tdqn.init(tcfg, seed=0, num_envs=2, device="cpu")
    it = tdqn.make_iteration(tcfg, learn=True)
    for _ in range(3):
        state, metrics = it(state)
    assert np.isfinite(float(metrics["loss"]))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, state)
    back = mgr.restore_latest(tdqn.init(tcfg, seed=1, num_envs=2,
                                        device="cpu"))
    for a, b in zip(state.params.parameters(), back.params.parameters()):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    for p, q in zip(state.params.parameters(), back.params.parameters()):
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(state.opt_state.state[p][k],
                               back.opt_state.state[q][k])


# --- c5 ---------------------------------------------------------------------

T, B = 2, 4


def test_c5_ppo_loss_and_gradients_match_jax_bf16():
    jcfg, tcfg = _configs("c5", RL_LOSS)
    params = _params("c5")
    rng = np.random.default_rng(32)
    img, pts, mask = _obs(T * B, 13)
    a = jcfg.rl.num_actions
    n = T * B
    batch = {"image": img, "points": pts, "mask": mask,
             "action": jnp.asarray(rng.integers(0, a, n), jnp.int32),
             "logp": jnp.asarray(np.log(1 / a) + 0.3 * rng.standard_normal(n),
                                 jnp.float32),
             "adv": jnp.asarray(rng.standard_normal(n) * 3 + 1, jnp.float32),
             "ret": jnp.asarray(rng.standard_normal(n), jnp.float32),
             "snr": jnp.full((n,), jcfg.channel.snr_db, jnp.float32)}
    key = jax.random.key(33)
    ent = float(jppo._entropy_coef(jcfg, jnp.int32(0)))

    def grad(cfg):
        return jax.jit(jax.value_and_grad(
            lambda p: jppo._ppo_loss(p, batch, cfg, key, ent),
            has_aux=True))(params)

    (loss, aux), grads = grad(jcfg)
    _, exact = grad(_configs("c5", _f32(RL_LOSS))[0])
    net = _port(TActorCritic, tcfg, params)
    got, taux = tppo._ppo_loss(tcfg, tdqn.learner_forward(tcfg, TActorCritic),
                               net, {k: _t(v) for k, v in batch.items()}, ent,
                               channel_noise=_noise(jcfg, key, n))
    _rel(got.detach(), loss, "loss")
    for k in ("pg_loss", "v_loss", "entropy"):
        _rel(taux[k].detach(), aux[k], k)
    got.backward()
    close_grads(_port_grads(net), _by_name(net, grads), _by_name(net, exact),
                after_max=PFN)


# --- c1 and c3 on the CNN camera ----------------------------------------------

C1 = ["camera.features=8,16,16,16", "camera.c_sym=2", "train.batch_size=8",
      *BF16]


def test_c1_step_bf16_matches_jax():
    """JAX's own bf16 test, at its widths: parameters stay f32, the loss and
    PSNR are finite; here also the loss and gradients of the step against
    JAX's, given its channel draw."""
    jcfg, tcfg = _configs("c1", C1)
    model = jjscc.build_model(jcfg)
    img = np.random.default_rng(7).uniform(0, 1, (8, 32, 32, 3)).astype(
        np.float32)
    params = flax_like(jax.eval_shape(model.init, jax.random.key(0),
                                      jnp.asarray(img))["params"], 8)
    snr = jnp.full((8,), jcfg.channel.snr_db, jnp.float32)
    kch = jax.random.key(9)

    def grad(m):
        def loss_fn(p):
            z = m.apply({"params": p}, img, snr, method="encode")
            recon = m.apply({"params": p}, jchannel(z, snr, "awgn", kch),
                            snr, method="decode")
            return jnp.mean(jnp.square(recon - img)), recon

        return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    (loss, recon), grads = grad(model)
    _, exact = grad(jjscc.build_model(_configs("c1", _f32(C1))[0]))
    state = tjscc.create_train_state(tcfg, 0, "cpu")
    net = state.params
    net.load_state_dict(bridge.to_state_dict(params, net))
    noise = _t(jax.random.normal(kch, (8, net.k, 2)))
    trecon, _ = tjscc.reconstruct(tcfg, net, _t(img), _t(snr), noise=noise)
    tloss = (trecon - _t(img)).square().mean()
    assert trecon.dtype == torch.float32
    _close(trecon.detach().numpy(), recon, "recon")
    _rel(tloss.detach(), loss, "loss")
    tloss.backward()
    close_grads(_port_grads(net), _by_name(net, grads), _by_name(net, exact))
    net.zero_grad(set_to_none=True)

    state, m = tjscc.make_train_step(tcfg)(state, _t(img), noise)
    _rel(m["loss"], loss, "step loss")
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["psnr"]))
    assert all(p.dtype == torch.float32 for p in net.parameters())
    for st in state.opt_state.state.values():
        assert st["exp_avg"].dtype == torch.float32


def test_c3_cnn_step_bf16_matches_jax():
    """The loss's gradients against JAX's (its train step's ``loss_fn`` on
    the same channel draws), then one train step: its metrics, and each
    parameter whose step the gradient check settles moved as JAX's step
    (``apply_gradients`` of those gradients, as JAX's train step ends)."""
    over = ["camera.arch=cnn", "camera.features=8,16,16,16",
            "camera.image_hw=16,16", "camera.c_sym=4", "lidar.pillar_dim=16",
            "lidar.max_points=48", "lidar.bev_hw=8,8", "train.batch_size=2",
            *BF16]
    jcfg, tcfg = _configs("c3", over)
    rng = np.random.default_rng(40)
    img = rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    pts = np.stack([rng.uniform(-4, 52, (2, 48)), rng.uniform(-14, 14, (2, 48)),
                    rng.uniform(0, 1.8, (2, 48)), rng.uniform(0, 1, (2, 48))],
                   -1).astype(np.float32)
    mask = rng.uniform(0, 1, (2, 48)) < 0.85
    cls = rng.integers(1, 4, (2, 48)).astype(np.int32)
    model = jfj.LateFusionJSCC(jcfg)
    snr = jnp.full((2,), jcfg.channel.snr_db, jnp.float32)
    params = flax_like(jax.eval_shape(
        model.init, jax.random.key(0), img, pts, mask, snr,
        jax.random.key(1))["params"], 41)
    key = jax.random.key(42)
    _, kch = jax.random.split(key)
    lid = jcfg.lidar
    target = jlid.semantic_bev_target(pts, mask, cls, lid.bev_hw, lid.x_range,
                                      lid.y_range, num_classes=lid.seg_classes)

    def grad(cfg):
        # JAX's train step's loss_fn (train/fusion_jscc.py), unpruned.
        m = jfj.LateFusionJSCC(cfg)

        def loss_fn(p):
            recon, logits, _ = m.apply({"params": p}, img, pts, mask, snr, kch)
            cam_loss = jnp.mean(jnp.square(recon - img))
            lid_loss = jnp.mean(
                optax.softmax_cross_entropy_with_integer_labels(logits,
                                                                target))
            return cam_loss + 0.5 * lid_loss, {
                "cam_loss": cam_loss, "lidar_loss": lid_loss,
                "psnr": jpsnr(recon, img)}

        return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    with _scatter_vjp():
        (loss, jm), grads = grad(jcfg)
        _, exact = grad(_configs("c3", _f32(over))[0])
    jm["loss"] = loss
    jstate = jfj.create_train_state(jcfg, jax.random.key(0)).replace(
        params=params)
    jstate = jstate.replace(opt_state=jstate.tx.init(params))
    jstate = jstate.apply_gradients(grads=grads)

    k_cam, k_lid = jax.random.split(kch)
    state = tfj.create_train_state(tcfg, 0, "cpu")
    net = state.params
    net.load_state_dict(bridge.to_state_dict(params, net))
    draws = tfj.StepDraws(channel_noise=(
        _t(jax.random.normal(k_cam, (2, 4 * 4 * 4, 2))),
        _t(jax.random.normal(k_lid, (2, 64 * jcfg.lidar.c_sym, 2)))))
    t_in = [torch.from_numpy(a) for a in (img, pts, mask, cls)]
    tloss, _ = tfj.loss_fn(tcfg, net, *t_in[:3], tfj.bev_target(
        tcfg, *t_in[1:]), _t(snr), channel_noise=draws.channel_noise)
    _rel(tloss.detach(), loss, "loss")
    tloss.backward()
    t_grads = {n: g.numpy().copy() for n, g in _port_grads(net).items()}
    j_grads = {n: g.numpy() for n, g in _by_name(net, grads).items()}
    close_grads(t_grads, j_grads, _by_name(net, exact),
                after_max=["lidar.pfn."])
    net.zero_grad(set_to_none=True)

    state, m = tfj.make_train_step(tcfg)(state, *t_in, draws)
    for k in ("loss", "cam_loss", "lidar_loss", "psnr"):
        _rel(m[k], jm[k], k)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    # One AdamW step from zero moments moves a parameter by lr g / (|g| +
    # eps), g the clipped gradient: where the port's and JAX's share a sign
    # and both lie over 100 eps, the two moves agree within lr / 100; where
    # the signs differ, they are rounding noise.
    def clipped(grads):
        norm = np.sqrt(sum(float(np.square(g).sum()) for g in grads.values()))
        return {n: g * min(1.0, tcfg.train.grad_clip / norm)
                for n, g in grads.items()}

    t_clip, j_clip = clipped(t_grads), clipped(j_grads)
    want = _by_name(net, jstate.params)
    lr = tcfg.train.lr
    settled = total = 0
    for name, p in net.named_parameters():
        t, j = t_clip[name], j_clip[name]
        sure = (np.sign(t) == np.sign(j)) & (np.minimum(np.abs(t), np.abs(j))
                                             > 100 * 1e-8)
        settled, total = settled + int(sure.sum()), total + sure.size
        np.testing.assert_allclose(p.detach().numpy()[sure],
                                   want[name].numpy()[sure], atol=lr / 100,
                                   rtol=0, err_msg=name)
    assert settled > total // 2


# --- what is ported ----------------------------------------------------------

PORTED = {
    "c4": ("c4", []), "c4 fog + v2x": ("c4", ["env.fog_range=20",
                                             "env.v2x_rays=32"]),
    "c4 plain blocks": ("c4", ["mha_block_kernel=false"]),
    "c4 late_concat": ("c4", ["fusion.mode=late_concat",
                              "pallas_mha_block=false"]),
    "c5": ("c5", []), "c1": ("c1", []), "c2": ("c2", []),
    "c3 cnn": ("c3", ["camera.arch=cnn"]),
    "c4 vit camera": ("c4", ["camera.arch=vit"]),
    "c5 vit camera": ("c5", ["camera.arch=vit"]),
    "c4 packed attention": ("c4", ["pallas_attention=true"]),
    "c4 unfused MHA": ("c4", ["pallas_mha_block=false"]),
    "c1 vit": ("c1", ["camera.arch=vit"]),
    "c3 vit (the preset)": ("c3", []),
    # The VQ codecs (their bf16 slice).
    "c4 vq camera": ("c4", ["camera.arch=vq"]),
    "c4 vq lidar": ("c4", ["lidar.arch=vq"]),
    "c5 vq camera": ("c5", ["camera.arch=vq"]),
    "c1 vq": ("c1", ["camera.arch=vq"]),
    "c3 cnn, vq lidar": ("c3", ["camera.arch=cnn", "lidar.arch=vq"]),
    "c3 vit, vq lidar": ("c3", ["lidar.arch=vq"]),
    "c4 vit camera, vq lidar": ("c4", ["camera.arch=vit", "lidar.arch=vq"]),
    "c4 unfused MHA, vq camera": ("c4", ["pallas_mha_block=false",
                                         "camera.arch=vq"]),
}


def _build(preset, over):
    cfg = t_preset(preset).override_str(["train.bf16=true", *over])
    if preset in ("c4", "c5"):
        with torch.device("meta"):
            return cfg, (TActorCritic if preset == "c5" else TQNetwork)(cfg)
    if preset == "c3":
        return cfg, torch.nn.ModuleList([tfj.build_camera_codec(cfg),
                                         tfj.build_lidar_codec(cfg)])
    return cfg, tjscc.build_model(cfg)


@pytest.mark.parametrize("name", sorted(PORTED))
def test_ported_bf16_combinations_build(name):
    """bf16 activations (``activation_dtype``) on f32 parameters."""
    cfg, net = _build(*PORTED[name])
    assert activation_dtype(cfg) == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in net.parameters())
    dtypes = {getattr(m, a) for m in net.modules()
              for a in ("dtype", "act_dtype") if hasattr(m, a)}
    assert torch.bfloat16 in dtypes and torch.float32 not in dtypes


def test_cli_trains_c1_with_bf16(capsys):
    """``--set train.bf16=true`` through the front door, on the CPU."""
    assert cli.main(["train", "--config", "c1", "--device", "cpu",
                     "--set", "camera.features=8,16,16,16",
                     "--set", "train.batch_size=2", "--set", "train.steps=2",
                     "--set", "train.bf16=true"]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(last["loss"])


def test_cli_exports_a_bf16_codec_on_the_plain_versions(tmp_path, capsys):
    """``export`` of a bf16 c1 codec: the artifact traces the plain versions
    in bf16 and gives the live module's symbols and image, bit for bit."""
    from multimodal_sc_torch.io import export as export_lib

    over = ["camera.features=8,16,16,16", "train.batch_size=2",
            "train.bf16=true"]
    out = tmp_path / "artifact"
    assert cli.main(["export", "--config", "c1", "--batch", "2", "--out",
                     str(out), "--device", "cpu"]
                    + [a for o in over for a in ("--set", o)]) == 0
    capsys.readouterr()
    fns = export_lib.load_artifact(str(out), device="cpu")
    cfg = t_preset("c1").override_str(over)
    live = tjscc.create_train_state(cfg, cfg.train.seed, "cpu").params
    img = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(4))
    snr = torch.full((2,), 10.0)
    with torch.no_grad():
        z = fns["encoder"](img, snr)
        assert z.dtype == torch.float32
        assert torch.equal(z, live.encode(img, snr))
        assert torch.equal(fns["decoder"](z, snr), live.decode(z, snr))
