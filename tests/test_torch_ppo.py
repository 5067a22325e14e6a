"""The port's c5 PPO path against the JAX package on the CPU, and the fresh
weights of the port's five networks against flax's initialisers (a VQ
codebook against flax's fan-in uniform draw).

Both sides get the same parameters (``multimodal_sc_torch.bridge``), the
same rollout (observations from JAX env resets, the rest made from a seed
with numpy), the same permutations and JAX's own channel noise, at a tiny
c5 (fusion dim 32, depth 1, narrow codecs, 4 envs, T 4, 2 epochs x 2
minibatches). At fusion dim 32 the fused blocks are kernel-ineligible, so
both sides run their plain version. f32 everywhere, TF32 off.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from multimodal_sc_torch import bridge
from multimodal_sc_torch.config import get_preset as t_preset
from multimodal_sc_torch.evaluation import policy_eval as teval
from multimodal_sc_torch.io.checkpoint import CheckpointManager
from multimodal_sc_torch.rl import dqn as tdqn
from multimodal_sc_torch.rl import gae as tgae
from multimodal_sc_torch.rl import ppo as tppo
from multimodal_sc_torch.rl.perception import ActorCritic as TActorCritic
from multimodal_sc_torch.train import fusion_jscc as tfj
from multimodal_sc_torch.train import jscc as tjscc
from multimodal_sc_torch.train import ppo as ttrain
from multimodal_sc_tpu.config import get_preset as j_preset
from multimodal_sc_tpu.envs import driving as jenv
from multimodal_sc_tpu.evaluation import policy_eval as jeval
from multimodal_sc_tpu.rl import dqn as jdqn
from multimodal_sc_tpu.rl import gae as jgae
from multimodal_sc_tpu.rl import ppo as jppo
from multimodal_sc_tpu.rl.perception import ActorCritic as JActorCritic
from multimodal_sc_tpu.train import fusion_jscc as jfj
from multimodal_sc_tpu.train import jscc as jjscc
from multimodal_sc_tpu.train import ppo as jtrain

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

TINY = ["camera.features=8,16,16,16", "camera.c_sym=2",
        "camera.image_hw=16,16", "env.image_hw=16,16", "lidar.pillar_dim=16",
        "lidar.c_sym=2", "lidar.bev_hw=8,8", "fusion.dim=32", "fusion.depth=1",
        "fusion.heads=2", "fusion.state_dim=32", "env.num_npcs=2",
        "env.lidar_rays=32", "env.max_steps=8", "rl.num_envs=4",
        "rl.rollout_length=4", "rl.ppo_epochs=2", "rl.num_minibatches=2",
        "train.log_every=1"]
T, B = 4, 4
MB = T * B // 2


def _configs(extra=()):
    over = TINY + list(extra)
    return j_preset("c5").override_str(over), t_preset("c5").override_str(over)


def _t(x):
    return torch.tensor(np.array(x))


def _jax_noise(cfg, key, batch):
    """The standard-normal draws the JAX trunk's two AWGN links make."""
    k_cam, k_lid = jax.random.split(key)
    hw = cfg.camera.image_hw
    n_cam = (hw[0] // 4) * (hw[1] // 4) * cfg.camera.c_sym
    n_lid = cfg.lidar.bev_hw[0] * cfg.lidar.bev_hw[1] * cfg.lidar.c_sym
    return tuple(_t(jax.random.normal(k, (batch, n, 2)))
                 for k, n in ((k_cam, n_cam), (k_lid, n_lid)))


def _perturb(tree, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + scale * jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32)), tree)


def _port_net(tcfg, flax_params):
    net = TActorCritic(tcfg)
    net.load_state_dict(bridge.to_state_dict(flax_params, net))
    return net


# --- fresh weights as flax draws them ---------------------------------------

_TRUNC = 2.0 / 0.87962566103423978      # flax's truncation, in 1/sqrt(fan_in)


def _flax_fan_ins(flat):
    """flax path -> fan-in of every ``lecun_normal`` kernel of a tree."""
    out = {}
    for path, a in flat.items():
        mod, _, leaf = path.rpartition(".")
        if leaf in ("wq", "wk", "wv", "wo"):          # FusedMHABlock (in, out)
            out[path] = a.shape[0]
        elif leaf == "kernel" and a.ndim == 3:        # DenseGeneral
            split_out = flat[f"{mod}.bias"].ndim == 2
            out[path] = a.shape[0] if split_out else a.shape[0] * a.shape[1]
        elif leaf == "kernel":                        # Dense; (Transpose)Conv
            out[path] = int(np.prod(a.shape[:-1]))
    return out


def _init_gate_failures(net, flax_params):
    """Where ``net``'s weights are not drawn as flax draws a fresh tree: a
    weight of 1024 entries or more whose std is more than 10% off the JAX
    draw's, an entry beyond flax's truncation, or a constant (zero bias,
    LayerNorm one, PReLU 0.25) that differs."""
    want = bridge.to_state_dict(flax_params, net)
    flat = bridge._flatten(flax_params)
    state = net.state_dict()
    bound = {}
    for path, fan_in in _flax_fan_ins(flat).items():
        mod, _, leaf = path.rpartition(".")
        key = path if path in state else f"{mod}.weight"
        bound[key] = _TRUNC / np.sqrt(fan_in)
    for path, a in flat.items():
        if path.rpartition(".")[2] == "codebook":    # uniform, fan_in = K
            bound[path] = np.sqrt(3.0 / a.shape[0])
    fails = []
    for name, p in net.named_parameters():
        p, w = p.detach(), want[name]
        if torch.equal(w.min(), w.max()):
            if not torch.equal(p, w):
                fails.append(f"{name}: not the constant {float(w.min())}")
            continue
        if name in bound and p.abs().max() > bound[name] * (1 + 1e-6):
            fails.append(f"{name}: beyond the truncation")
        if p.numel() >= 1024:
            ratio = float(p.std() / w.std())
            if abs(ratio - 1.0) > 0.1:
                fails.append(f"{name}: std {ratio:.3f} of flax's")
    return fails


C3_SMALL = ["camera.image_hw=16,16", "camera.depth=1", "camera.c_sym=4",
            "lidar.pillar_dim=16", "lidar.max_points=48", "lidar.bev_hw=8,8",
            "train.batch_size=2"]
C1_SMALL = ["camera.features=16,32,64,64"]
C1_VQ_SMALL = C1_SMALL + ["camera.arch=vq"]


@functools.lru_cache(maxsize=None)
def _flax_fresh(network):
    """A fresh flax tree of ``network``, drawn once and shared."""
    if network == "QNetwork":
        return jdqn.init_params(j_preset("c4").override_str(TINY),
                                jax.random.key(0))
    if network == "ActorCritic":
        return jppo.init_params(_configs()[0], jax.random.key(0))
    if network == "LateFusionJSCC":
        return jfj.create_train_state(j_preset("c3").override_str(C3_SMALL),
                                      jax.random.key(0)).params
    small = C1_VQ_SMALL if network == "VQCameraJSCC" else C1_SMALL
    return jjscc.create_train_state(j_preset("c1").override_str(small),
                                    jax.random.key(0)).params


FRESH = {
    "QNetwork": lambda: tdqn.init_params(
        t_preset("c4").override_str(TINY), 0, "cpu"),
    "ActorCritic": lambda: tppo.init_params(_configs()[1], 0, "cpu"),
    "LateFusionJSCC": lambda: tfj.create_train_state(
        t_preset("c3").override_str(C3_SMALL), 0, "cpu").params,
    "CameraJSCC": lambda: tjscc.create_train_state(
        t_preset("c1").override_str(C1_SMALL), 0, "cpu").params,
    "VQCameraJSCC": lambda: tjscc.create_train_state(
        t_preset("c1").override_str(C1_VQ_SMALL), 0, "cpu").params,
}


@pytest.mark.parametrize("network", sorted(FRESH))
def test_fresh_weights_are_drawn_as_flax_draws_them(network):
    assert _init_gate_failures(FRESH[network](), _flax_fresh(network)) == []


@pytest.mark.parametrize("network", sorted(FRESH))
def test_torch_default_init_fails_the_flax_gate(network):
    """The gate sees PyTorch's own initialisation of the Linear and Conv
    layers (kaiming-uniform weights, std 1/sqrt(3 fan_in), uniform
    biases), which the port's networks had before."""
    net = FRESH[network]()
    torch.manual_seed(0)
    for m in net.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            m.reset_parameters()
    fails = _init_gate_failures(net, _flax_fresh(network))
    assert any("std" in f for f in fails)
    assert any("constant" in f for f in fails)


# --- GAE ----------------------------------------------------------------------

@pytest.mark.parametrize("lam", [0.95, 1.0])
def test_gae_matches_jax(lam):
    rng = np.random.default_rng(3)
    t_len, b = 9, 5
    rewards = rng.standard_normal((t_len, b)).astype(np.float32)
    values = rng.standard_normal((t_len, b)).astype(np.float32)
    dones = rng.uniform(size=(t_len, b)) < 0.25
    dones[-1, 0] = dones[0, 1] = True
    last = rng.standard_normal(b).astype(np.float32)
    want = jgae.gae(jnp.asarray(rewards), jnp.asarray(values),
                    jnp.asarray(dones), jnp.asarray(last), 0.99, lam)
    got = tgae.gae(torch.tensor(rewards), torch.tensor(values),
                   torch.tensor(dones), torch.tensor(last), 0.99, lam)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


# --- ActorCritic ----------------------------------------------------------------

def _observations(jcfg, n, seed=5):
    states = jenv.reset_batch(jcfg.env, jax.random.key(seed), n)
    return jenv.observe_batch(jcfg.env, states)


def test_actor_critic_matches_jax():
    jcfg, tcfg = _configs()
    img, pts, mask = _observations(jcfg, 3)
    params = _perturb(_flax_fresh("ActorCritic"), 8, 0.02)
    key = jax.random.key(9)
    want_logits, want_value = jax.jit(JActorCritic(jcfg).apply)(
        {"params": params}, img, pts, mask, key)
    net = _port_net(tcfg, params)
    with torch.no_grad():
        logits, value = net(_t(img), _t(pts), _t(mask),
                            channel_noise=_jax_noise(jcfg, key, 3))
    assert logits.shape == (3, jcfg.rl.num_actions) and value.shape == (3,)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value),
                               atol=1e-5, rtol=1e-5)


# --- the loss ---------------------------------------------------------------------

def _rollout(jcfg, seed=11):
    """A (T, B) rollout: observations of T*B fresh envs, the rest from numpy."""
    rng = np.random.default_rng(seed)
    img, pts, mask = _observations(jcfg, T * B, seed)
    a = jcfg.rl.num_actions
    return jppo.Rollout(
        image=img.reshape(T, B, *img.shape[1:]),
        points=pts.reshape(T, B, *pts.shape[1:]),
        mask=mask.reshape(T, B, *mask.shape[1:]),
        action=jnp.asarray(rng.integers(0, a, (T, B)), jnp.int32),
        logp=jnp.asarray(np.log(1 / a) + 0.3 * rng.standard_normal((T, B)),
                         jnp.float32),
        value=jnp.asarray(rng.standard_normal((T, B)), jnp.float32),
        reward=jnp.asarray(rng.standard_normal((T, B)), jnp.float32),
        done=jnp.asarray(rng.uniform(size=(T, B)) < 0.2),
        snr_db=jnp.full((T, B), jcfg.channel.snr_db, jnp.float32))


def _flat(ro, adv, ret):
    n = T * B
    return {"image": ro.image.reshape(n, *ro.image.shape[2:]),
            "points": ro.points.reshape(n, *ro.points.shape[2:]),
            "mask": ro.mask.reshape(n, *ro.mask.shape[2:]),
            "action": ro.action.reshape(n), "logp": ro.logp.reshape(n),
            "adv": adv.reshape(n), "ret": ret.reshape(n),
            "snr": ro.snr_db.reshape(n)}


@functools.lru_cache(maxsize=None)
def _jax_loss_grad(extra):
    """One jitted ``value_and_grad(_ppo_loss)`` per config, shared."""
    jcfg, _ = _configs(extra)
    return jax.jit(jax.value_and_grad(
        lambda p, batch, key, ent: jppo._ppo_loss(p, batch, jcfg, key, ent),
        has_aux=True))


LOSS_CASES = {
    "plain": ((), 0),
    "entropy floor": (("rl.entropy_floor=3.0", "rl.entropy_floor_coef=0.5"), 0),
    "annealed": (("rl.entropy_coef_final=0.0", "train.steps=7"), 4),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_ppo_loss_and_gradients_match_jax(case):
    extra, update = LOSS_CASES[case]
    jcfg, tcfg = _configs(extra)
    ent = tppo._entropy_coef(tcfg, update)
    np.testing.assert_allclose(
        ent, float(jppo._entropy_coef(jcfg, jnp.int32(update))), rtol=1e-6)
    ro = _rollout(jcfg)
    rng = np.random.default_rng(12)
    adv = jnp.asarray(rng.standard_normal((T, B)) * 3 + 1, jnp.float32)
    ret = jnp.asarray(rng.standard_normal((T, B)), jnp.float32)
    batch = {k: v[:MB] for k, v in _flat(ro, adv, ret).items()}
    params = _perturb(_flax_fresh("ActorCritic"), 14, 0.02)
    key = jax.random.key(15)
    (loss, aux), grads = _jax_loss_grad(extra)(params, batch, key,
                                               jnp.float32(ent))
    net = _port_net(tcfg, params)
    tbatch = {k: _t(v) for k, v in batch.items()}
    got, taux = tppo._ppo_loss(tcfg, tdqn.learner_forward(tcfg, TActorCritic),
                               net, tbatch, ent,
                               channel_noise=_jax_noise(jcfg, key, MB))
    np.testing.assert_allclose(float(got.detach()), float(loss), atol=1e-5,
                               rtol=1e-5)
    for k in ("pg_loss", "v_loss", "entropy"):
        np.testing.assert_allclose(float(taux[k]), float(aux[k]), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    if case == "entropy floor":
        assert float(aux["entropy"]) < 3.0      # the hinge is active
    got.backward()
    want = bridge.to_state_dict(grads, net)
    for name, p in net.named_parameters():
        # The last fusion layer's LiDAR stream feeds nothing: no gradient
        # here, an exactly zero one in JAX.
        g = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5,
                                   rtol=1e-3, err_msg=name)


# --- one full update ---------------------------------------------------------------

def test_ppo_update_matches_jax_composition():
    """GAE, 2 epochs x 2 minibatch steps (clip + Adam, given permutations
    and JAX's noise) and the EMA lerp, from the same parameters, Adam state
    and rollout, against JAX's gae, _ppo_loss and make_optimizer composed
    in _update_body's order."""
    extra = LOSS_CASES["annealed"][0]    # the loss of that case, compiled once
    jcfg, tcfg = _configs(extra + ("train.grad_clip=0.5",))
    r = jcfg.rl
    update0 = 3
    ro = _rollout(jcfg, seed=21)
    rng = np.random.default_rng(22)
    last_value = jnp.asarray(rng.standard_normal(B), jnp.float32)
    last_return = jnp.asarray(rng.standard_normal(B) * 5, jnp.float32)
    perms = [rng.permutation(T * B) for _ in range(r.ppo_epochs)]
    keys = [[jax.random.key(100 + 10 * e + i)
             for i in range(r.num_minibatches)] for e in range(r.ppo_epochs)]
    params = _perturb(_flax_fresh("ActorCritic"), 24, 0.02)
    ema = _perturb(params, 25, 0.01)
    tx = jppo.make_optimizer(jcfg)
    _, opt_state = tx.update(_perturb(params, 26, 1e-3), tx.init(params),
                             params)   # a non-trivial Adam state
    apply = jax.jit(lambda g, o, p: (lambda u, o: (optax.apply_updates(p, u),
                                                   o))(*tx.update(g, o, p)))

    ent = jppo._entropy_coef(jcfg, jnp.int32(update0))
    adv, ret = jgae.gae(ro.reward, ro.value, ro.done, last_value, r.gamma,
                        r.gae_lambda)
    flat = _flat(ro, adv, ret)
    loss_grad = _jax_loss_grad(extra)
    j_params, j_opt, losses, norms = params, opt_state, [], []
    for e in range(r.ppo_epochs):
        for i in range(r.num_minibatches):
            idx = jnp.asarray(perms[e][i * MB:(i + 1) * MB])
            batch = {k: v[idx] for k, v in flat.items()}
            (loss, aux), grads = loss_grad(j_params, batch, keys[e][i], ent)
            norms.append(float(optax.global_norm(grads)))
            j_params, j_opt = apply(grads, j_opt, j_params)
            losses.append((float(loss), {k: float(v) for k, v in aux.items()
                                         if k != "reseed_stats"}))
    assert max(norms) > jcfg.train.grad_clip        # the clip acts
    j_ema = jax.tree_util.tree_map(
        lambda m, p: (1.0 - r.ema_tau) * m + r.ema_tau * p, ema, j_params)

    state = tppo.init(tcfg, seed=0, device="cpu")
    for net, tree in ((state.params, params), (state.ema_params, ema)):
        net.load_state_dict(bridge.to_state_dict(tree, net))
    adam = opt_state[1][0]
    bridge.load_adam_state(state.opt_state, state.params, int(adam.count),
                           adam.mu, adam.nu)
    state = state._replace(update=update0, last_return=_t(last_return))
    draws = tppo.UpdateDraws(
        perms=[torch.tensor(p) for p in perms],
        noise=[[_jax_noise(jcfg, k, MB) for k in row] for row in keys])
    state, metrics = tppo._update(
        tcfg, state, tppo.Rollout(*(_t(x) for x in ro)), _t(last_value),
        tdqn.learner_forward(tcfg, TActorCritic), draws)

    assert state.update == update0 + 1
    want_metrics = {
        "loss": np.mean([l for l, _ in losses]),
        **{k: np.mean([a[k] for _, a in losses])
           for k in ("pg_loss", "v_loss", "entropy")},
        "entropy_coef": float(ent), "reward": float(jnp.mean(ro.reward)),
        "episode_return": float(jnp.mean(last_return))}
    assert set(metrics) == set(want_metrics)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), v, atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    for net, tree, what in ((state.params, j_params, "online"),
                            (state.ema_params, j_ema, "ema")):
        want = bridge.to_state_dict(tree, net)
        for name, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       atol=1e-5, err_msg=f"{what} {name}")
    j_adam = j_opt[1][0]
    mu, nu = (bridge.to_state_dict(t, state.params)
              for t in (j_adam.mu, j_adam.nu))
    for name, p in state.params.named_parameters():
        st = state.opt_state.state[p]
        assert int(st["step"]) == int(j_adam.count)
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu[name].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu[name].numpy(),
                                   atol=1e-7, rtol=1e-3, err_msg=name)


def test_train_step_runs_updates_and_moves_the_ema():
    """Whole updates through ``make_train_step``: the rollout, the bootstrap
    value and the minibatch steps on the port's own draws."""
    _, tcfg = _configs(["rl.rollout_quantize=true"])
    state = tppo.init(tcfg, seed=1, device="cpu")
    online0 = [p.detach().clone() for p in state.params.parameters()]
    ema0 = [p.detach().clone() for p in state.ema_params.parameters()]
    train_step = tppo.make_train_step(tcfg)
    for _ in range(2):
        state, metrics = train_step(state)
    assert state.update == 2
    assert all(np.isfinite(float(v)) for v in metrics.values())
    for net, before in ((state.params, online0), (state.ema_params, ema0)):
        assert any(not torch.equal(a, b)
                   for a, b in zip(before, net.parameters()))
    assert all(p.grad is None for p in state.params.parameters())


# --- evaluator, driver, refusals ------------------------------------------------------

def test_evaluate_ppo_keys_and_greedy_determinism():
    jcfg, tcfg = _configs()
    params = _flax_fresh("ActorCritic")
    jout = jeval.evaluate_ppo(jcfg, params, jax.random.key(1), num_envs=4)
    net = _port_net(tcfg, params)
    greedy = teval.evaluate_ppo(tcfg, net, seed=1, num_envs=4)
    assert set(greedy) == set(jout)
    assert all(np.isfinite(v) for v in greedy.values())
    assert greedy["episodes_terminated_frac"] == 1.0     # max_steps 8
    assert teval.evaluate_ppo(tcfg, net, seed=1, num_envs=4) == greedy
    sampled = teval.evaluate_ppo(tcfg, net, seed=1, num_envs=4, greedy=False,
                                 temperature=0.5)
    assert set(sampled) == set(jout)
    assert teval.evaluate_ppo(tcfg, net, seed=1, num_envs=4, greedy=False,
                              temperature=0.5) == sampled
    # Logits scaled by 1 / temperature -> infinity sample the argmax.
    logits = torch.randn(64, 9, generator=torch.Generator().manual_seed(2))
    assert torch.equal(tppo.sample_action(logits * 1e9, torch.Generator()),
                       logits.argmax(-1).to(torch.int32))


def _records(path):
    return [json.loads(line) for line in open(path)]


def test_train_run_keys_match_jax_run(tmp_path):
    # The JAX run shards its envs over the 8 host devices of the tests.
    jcfg, tcfg = _configs(["rl.num_envs=8", "rl.rollout_length=2",
                           "rl.ppo_epochs=1", "rl.num_minibatches=1",
                           "train.steps=2"])
    jpath, tpath = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    _, jout = jtrain.run(jcfg, metrics_path=jpath)
    state, tout = ttrain.run(tcfg.override_str(["train.steps=3"]),
                             metrics_path=tpath, device="cpu")
    assert set(tout) == set(jout)
    assert all(np.isfinite(v) for v in tout.values())
    assert state.update == 3
    assert {frozenset(r) for r in _records(tpath)} == {
        frozenset(r) for r in _records(jpath)}
    assert _records(tpath)[-1]["step"] == 3


def test_main_trains_and_evaluates_both_networks(capsys):
    over = [a for o in TINY + ["train.steps=2"] for a in ("--set", o)]
    assert ttrain.main(["--config", "c5", "--device", "cpu", "--eval-envs",
                        "2"] + over) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["updates"] == 2 and out["card"] == "cpu"
    for name in ("online", "ema"):
        for mode in ("sampled", "greedy"):
            assert np.isfinite(out[f"eval_{name}_{mode}_return"])


def test_refusals(tmp_path, monkeypatch):
    """What is still refused (what JAX's config validation refuses, a
    rollout the minibatches do not divide, the card when it is absent);
    the warm start, the checkpoints and the digital LiDAR, refused until
    they were ported, now run."""
    _, tcfg = _configs(["train.steps=1"])
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        ttrain.run(tcfg, init_from=str(tmp_path), device="cpu")
    _, out = ttrain.run(tcfg.override_str([
        f"train.checkpoint_dir={tmp_path}", "train.checkpoint_every=1"]),
        device="cpu")
    assert CheckpointManager(str(tmp_path)).steps() == [1]
    assert "ckpt_save_s" in out
    _, out = ttrain.run(tcfg.override_str(["lidar.arch=vq"]), device="cpu")
    assert np.isfinite(out["loss"])
    with pytest.raises(ValueError, match="divisible by num_minibatches"):
        tppo.make_train_step(tcfg.override_str(["rl.num_minibatches=3"]))
    with pytest.raises(ValueError, match="camera.vq_prune"):
        ttrain.main(["--config", "c5", "--device", "cpu"] + [
            a for o in TINY + ["train.steps=1", "camera.arch=vq",
                               "camera.vq_prune=true"] for a in ("--set", o)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tppo.init(tcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.run(tcfg)
