"""The port's RL ViT trunk and its fog + V2X agent against the JAX package
on the CPU.

``QNetwork`` and ``ActorCritic`` with ``camera.arch=vit`` (a ViT encoder,
a ViT token decoder of half its depth, unconditioned) and with fog + 32 RSU
rays on the CNN trunk; one DQN learn step on the ViT trunk against optax.
Both sides get the same parameters (``multimodal_sc_torch.bridge``), the
same observations (JAX env states) and JAX's own channel noise, including
the V2X link's (``fold_in(k_lid, 0xB2C)``), at a reduced c4 / c5 (depth
1-2, narrow codecs). f32 everywhere, TF32 off, JAX at ``highest``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_c4_digital import flax_like
from multimodal_sc_torch import bridge
from multimodal_sc_torch.config import get_preset as t_preset
from multimodal_sc_torch.rl import dqn as tdqn
from multimodal_sc_torch.rl.perception import ActorCritic as TActorCritic
from multimodal_sc_torch.rl.perception import QNetwork as TQNetwork
from multimodal_sc_tpu.config import get_preset as j_preset
from multimodal_sc_tpu.envs import driving as jenv
from multimodal_sc_tpu.rl import dqn as jdqn
from multimodal_sc_tpu.rl.perception import ActorCritic as JActorCritic
from multimodal_sc_tpu.rl.perception import QNetwork as JQNetwork

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

SMALL = ["fusion.depth=1", "fusion.dim=32", "fusion.heads=2",
         "fusion.state_dim=32", "camera.features=8,16,16,16",
         "camera.c_sym=2", "camera.image_hw=16,16", "env.image_hw=16,16",
         "lidar.pillar_dim=16", "lidar.c_sym=2", "lidar.bev_hw=8,8",
         "env.lidar_rays=16", "env.num_npcs=3", "rl.batch_size=4"]
VIT = ["camera.arch=vit", "camera.dim=32", "camera.depth=2",
       "camera.heads=2"]
FOG_V2X = ["env.fog_range=20", "env.v2x_rays=8",
           "channel.v2x_snr_offset_db=-3"]
ARMS = {"vit": VIT, "fog_v2x": FOG_V2X, "vit_fog_v2x": VIT + FOG_V2X}
BATCH = 4


def _configs(preset, arm, extra=()):
    over = SMALL + ARMS[arm] + list(extra)
    return (j_preset(preset).override_str(over),
            t_preset(preset).override_str(over))


def _t(x):
    return torch.tensor(np.array(x))


def _jax_noise(cfg, key, batch):
    """The standard-normal draws of the JAX trunk's links: camera, ego
    LiDAR and, with V2X, the RSU link."""
    k_cam, k_lid = jax.random.split(key)
    hw = cfg.camera.image_hw
    n_cam = (hw[0] // 4) * (hw[1] // 4) * cfg.camera.c_sym
    n_lid = cfg.lidar.bev_hw[0] * cfg.lidar.bev_hw[1] * cfg.lidar.c_sym
    links = [(k_cam, n_cam), (k_lid, n_lid)]
    if cfg.env.v2x_rays > 0:
        links.append((jax.random.fold_in(k_lid, 0xB2C), n_lid))
    return tuple(_t(jax.random.normal(k, (batch, n, 2))) for k, n in links)


def _obs(cfg, seed, n=BATCH):
    states = jenv.reset_batch(cfg.env, jax.random.key(seed), n)
    for t in range(3):
        states, _ = jenv.step_batch(cfg.env, states, jnp.full((n,), 4 + t))
    return jenv.observe_batch(cfg.env, states)


def _port(cls, tcfg, params):
    net = cls(tcfg)
    net.load_state_dict(bridge.to_state_dict(params, net))
    return net


def _filled(jnet, *args):
    """Parameters of ``jnet``'s structure drawn with numpy (``flax_like``
    of ``eval_shape`` of its init): the comparisons need JAX's tree, not
    flax's initial values, and its init compiles for tens of seconds."""
    return flax_like(jax.eval_shape(
        lambda k: jnet.init(k, *args)["params"], jax.random.key(7)), 7)


@pytest.mark.parametrize("arm", ["vit", "fog_v2x", "vit_fog_v2x"])
def test_qnetwork_matches_jax(arm):
    jcfg, tcfg = _configs("c4", arm)
    img, pts, mask = _obs(jcfg, 5)
    assert pts.shape[1] == jcfg.env.lidar_rays + jcfg.env.v2x_rays
    key = jax.random.key(6)
    jnet = JQNetwork(jcfg)
    params = _filled(jnet, img, pts, mask, key)
    want = jax.jit(lambda p: jnet.apply({"params": p}, img, pts, mask,
                                        key))(params)
    tnet = _port(TQNetwork, tcfg, params)
    with torch.no_grad():
        got = tnet(_t(img), _t(pts), _t(mask),
                   channel_noise=_jax_noise(jcfg, key, BATCH))
    # f32 through ~20 layers, summed in other orders: 1e-4.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("arm", ["vit", "fog_v2x"])
def test_actor_critic_matches_jax(arm):
    jcfg, tcfg = _configs("c5", arm, ["camera.snr_conditioning=true"])
    img, pts, mask = _obs(jcfg, 8)
    key = jax.random.key(9)
    snr = jnp.asarray([0.0, 5.0, 10.0, 20.0], jnp.float32)
    jnet = JActorCritic(jcfg)
    params = _filled(jnet, img, pts, mask, key)
    logits, value = jax.jit(lambda p: jnet.apply(
        {"params": p}, img, pts, mask, key, snr_db=snr))(params)
    tnet = _port(TActorCritic, tcfg, params)
    with torch.no_grad():
        t_logits, t_value = tnet(_t(img), _t(pts), _t(mask), snr_db=_t(snr),
                                 channel_noise=_jax_noise(jcfg, key, BATCH))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(logits),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(t_value.numpy(), np.asarray(value), atol=1e-4,
                               rtol=1e-4)
    if arm == "vit":
        # The ViT camera branch is unconditioned: no SNR token anywhere.
        assert not any("snr" in n for n, _ in tnet.named_parameters())


def _perturb(tree, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + scale * jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32)), tree)


@functools.lru_cache(maxsize=None)
def _jax_learn_step(arm):
    """JAX's TD loss, gradients and one optax update on the arm's trunk."""
    jcfg, _ = _configs("c4", arm)
    obs = [_obs(jcfg, s) for s in (11, 12)]
    rng = np.random.default_rng(0)
    batch = jdqn.Transition(
        image=obs[0][0], points=obs[0][1], mask=obs[0][2],
        action=jnp.asarray(rng.integers(0, 9, BATCH), jnp.int32),
        reward=jnp.asarray(rng.standard_normal(BATCH) * 2.0, jnp.float32),
        done=jnp.asarray([False, True, False, False]),
        next_image=obs[1][0], next_points=obs[1][1], next_mask=obs[1][2])
    params = flax_like(jax.eval_shape(
        lambda k: jdqn.init_params(jcfg, k), jax.random.key(0)), 1)
    target = _perturb(params, 2, 0.02)
    key = jax.random.key(21)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jdqn._td_loss(p, target, batch, key, jcfg),
        has_aux=True))(params)
    tx = jdqn.make_optimizer(jcfg)
    # A non-trivial optimizer state: one earlier update on other gradients
    # (a first Adam step divides rounding-level gradients, such as the
    # attention key biases', by their own size).
    _, opt_state = tx.update(_perturb(grads, 4, 1e-3), tx.init(params),
                             params)
    adam = opt_state[1][0]
    updates, _ = tx.update(grads, opt_state, params)
    return (params, target, batch, key, float(loss), grads, adam,
            optax.apply_updates(params, updates), float(
                optax.global_norm(grads)))


@pytest.mark.parametrize("arm", ["vit_fog_v2x"])
def test_vit_learn_step_matches_optax(arm):
    """One learn step of the ViT trunk from the same parameters: loss,
    every gradient, and the online parameters after the clipped Adam step
    against optax."""
    jcfg, tcfg = _configs("c4", arm)
    params, target, batch, key, want_loss, grads, adam, j_params, norm = (
        _jax_learn_step(arm))
    k1, k2, k3 = jax.random.split(key, 3)
    draws = tdqn.LearnDraws(
        indices=torch.arange(BATCH), snr_db=None,
        noise_online=_jax_noise(jcfg, k1, BATCH),
        noise_target=_jax_noise(jcfg, k2, BATCH),
        noise_double=_jax_noise(jcfg, k3, BATCH))
    pbatch = tdqn.Transition(*(_t(x) for x in batch))
    state = tdqn.init(tcfg, seed=0, num_envs=2, device="cpu")
    for net, tree in ((state.params, params), (state.target_params, target),
                      (state.ema_params, params)):
        net.load_state_dict(bridge.to_state_dict(tree, net))
    bridge.load_adam_state(state.opt_state, state.params, int(adam.count),
                           adam.mu, adam.nu)
    # The gradients alone, then the full step on the same state.
    loss = tdqn._td_loss(tcfg, tdqn.learner_forward(tcfg), state.params,
                         state.target_params, pbatch, draws)
    np.testing.assert_allclose(float(loss.detach()), want_loss, atol=1e-5,
                               rtol=1e-5)
    got = torch.autograd.grad(loss, list(state.params.parameters()),
                              allow_unused=True)
    want = bridge.to_state_dict(grads, state.params)
    for (name, p), g in zip(state.params.named_parameters(), got):
        g = torch.zeros_like(p) if g is None else g
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5,
                                   rtol=1e-3, err_msg=name)
    assert norm > jcfg.train.grad_clip              # the clip is active
    state, loss = tdqn.learn_step(tcfg, state, pbatch, draws)
    want = bridge.to_state_dict(j_params, state.params)
    for name, p in state.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-5, err_msg=name)


def test_vit_trunk_shapes_and_names():
    """The ViT trunk as JAX builds it: a token decoder of half the
    encoder's depth (at least 1), the fusion's camera projection from the
    ViT width, the attention flag reaching the ViT's MHA."""
    _, tcfg = _configs("c4", "vit", ["camera.depth=3",
                                     "pallas_attention=true"])
    per = TQNetwork(tcfg).perception
    assert per.cam_enc.depth == 3 and per.cam_tok.depth == 1
    assert per.fusion.cam_proj.in_features == tcfg.camera.dim
    assert per.cam_enc.block0.attn.use_pallas
    assert not hasattr(per.cam_enc, "snr_token")
    # The digital LiDAR builds its link's modules and not the analog's.
    digital = TQNetwork(tcfg.override_str(["lidar.arch=vq"])).perception
    assert {"lid_to_code", "lid_codebook", "lid_from_code"} <= {
        n.split(".")[0] for n, _ in digital.named_parameters()}
    assert not hasattr(digital, "lid_sym_head")
    # train.bf16 builds the ViT in bf16 (parameters f32), and the digital
    # LiDAR under it.
    bf16 = TQNetwork(tcfg.override_str(["train.bf16=true"])).perception
    assert bf16.cam_enc.dtype == bf16.cam_tok.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    bf16 = TQNetwork(tcfg.override_str(["train.bf16=true",
                                        "lidar.arch=vq"])).perception
    assert bf16.lid_to_code.act_dtype == bf16.lid_from_code.act_dtype == \
        torch.bfloat16
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
