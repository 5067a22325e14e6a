"""The port's DQN learner, training loop and evaluator against the JAX
package on the CPU, in both arms of the c4 training slice:

* arm A: the c4 preset (fused blocks; the learner runs their plain version);
* arm B: ``pallas_mha_block=False, pallas_attention=True`` (unfused fusion
  layers whose attention is the packed kernel; the JAX side runs it in
  interpret mode, forward and backward).

Both sides get the same parameters (``multimodal_sc_torch.bridge``), the
same batch (made from a seed) and JAX's own channel noise, at a reduced c4
(depth 1, narrow codecs, fusion dim 128 so every attention stays
kernel-eligible). f32 everywhere, TF32 off, JAX at ``highest`` precision.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_sc_torch import bridge
from multimodal_sc_torch.config import get_preset as t_preset
from multimodal_sc_torch.envs import driving as tenv
from multimodal_sc_torch.evaluation import policy_eval as teval
from multimodal_sc_torch.obs import profiling as tprof
from multimodal_sc_torch.rl import dqn as tdqn
from multimodal_sc_torch.rl import replay as treplay
from multimodal_sc_torch.rl.perception import QNetwork as TQNetwork
from multimodal_sc_torch.train import dqn as ttrain
from multimodal_sc_tpu.config import get_preset as j_preset
from multimodal_sc_tpu.envs import driving as jenv
from multimodal_sc_tpu.evaluation import policy_eval as jeval
from multimodal_sc_tpu.rl import dqn as jdqn
from multimodal_sc_tpu.rl import replay as jreplay
from multimodal_sc_tpu.rl.perception import QNetwork as JQNetwork
from multimodal_sc_tpu.train import dqn as jtrain

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

SMALL = ["fusion.depth=1", "camera.features=8,16,32,32", "camera.c_sym=4",
         "lidar.pillar_dim=16", "env.lidar_rays=16", "env.num_npcs=3",
         "rl.replay_capacity=64", "rl.n_step=2", "rl.batch_size=8"]
ARMS = {"A": [], "B": ["pallas_mha_block=false", "pallas_attention=true"]}
BATCH = 4


def _configs(arm, extra=()):
    over = SMALL + ARMS[arm] + list(extra)
    return j_preset("c4").override_str(over), t_preset("c4").override_str(over)


def _jax_noise(cfg, key, batch):
    """The standard-normal draws the JAX trunk's two AWGN links make."""
    k_cam, k_lid = jax.random.split(key)
    hw = cfg.camera.image_hw
    n_cam = (hw[0] // 4) * (hw[1] // 4) * cfg.camera.c_sym
    n_lid = cfg.lidar.bev_hw[0] * cfg.lidar.bev_hw[1] * cfg.lidar.c_sym
    return tuple(torch.tensor(np.array(jax.random.normal(k, (batch, n, 2))))
                 for k, n in ((k_cam, n_cam), (k_lid, n_lid)))


def _t(x):
    return torch.tensor(np.array(x))


def _batch(jcfg):
    """A transition batch from two independent env resets (JAX arrays)."""
    rng = np.random.default_rng(0)
    obs = [jenv.observe_batch(jcfg.env, jenv.reset_batch(
        jcfg.env, jax.random.key(k), BATCH)) for k in (11, 12)]
    return jdqn.Transition(
        image=obs[0][0], points=obs[0][1], mask=obs[0][2],
        action=jnp.asarray(rng.integers(0, jcfg.rl.num_actions, BATCH),
                           jnp.int32),
        reward=jnp.asarray(rng.standard_normal(BATCH) * 2.0, jnp.float32),
        done=jnp.asarray(rng.uniform(size=BATCH) < 0.3),
        next_image=obs[1][0], next_points=obs[1][1], next_mask=obs[1][2])


def _learn_draws(jcfg, key):
    """The port's draws of one learn step from the key JAX's _td_loss gets."""
    k1, k2, k3 = jax.random.split(key, 3)
    return tdqn.LearnDraws(
        indices=torch.arange(BATCH), snr_db=None,
        noise_online=_jax_noise(jcfg, k1, BATCH),
        noise_target=_jax_noise(jcfg, k2, BATCH),
        noise_double=_jax_noise(jcfg, k3, BATCH))


def _perturb(tree, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + scale * jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32)), tree)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arm):
    """One jitted JAX TD loss + gradient per arm, shared by every case."""
    jcfg, _ = _configs(arm)
    batch = _batch(jcfg)
    params = _perturb(jdqn.init_params(jcfg, jax.random.key(0)), 1, 0.02)
    target = _perturb(params, 2, 0.02)
    key = jax.random.key(21)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jdqn._td_loss(p, target, batch, key, jcfg),
        has_aux=True))(params)
    return params, target, batch, key, float(loss), grads


def _port_batch(batch):
    return tdqn.Transition(*(_t(x) for x in batch))


def _port_net(tcfg, flax_params):
    net = TQNetwork(tcfg)
    net.load_state_dict(bridge.to_state_dict(flax_params, net))
    return net


def _assert_tree_close(net, flax_tree, atol, rtol=0.0, what=""):
    want = bridge.to_state_dict(flax_tree, net)
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=atol, rtol=rtol,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("extra", [[], ["rl.ablate_lidar=true"]])
def test_qnetwork_arm_b_matches_jax(extra):
    jcfg, tcfg = _configs("B", extra)
    states = jenv.reset_batch(jcfg.env, jax.random.key(5), 2)
    img, pts, mask = jenv.observe_batch(jcfg.env, states)
    net_key = jax.random.key(6)
    jnet = JQNetwork(jcfg)
    params = jnet.init(jax.random.key(7), img, pts, mask, net_key)["params"]
    want = jnet.apply({"params": params}, img, pts, mask, net_key)
    tnet = _port_net(tcfg, params)
    with torch.no_grad():
        got = tnet(_t(img), _t(pts), _t(mask),
                   channel_noise=_jax_noise(jcfg, net_key, 2))
    # f32 through ~20 layers, summed in other orders: 1e-4.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("arm", ["A", "B"])
def test_td_loss_and_gradients_match_jax(arm):
    jcfg, tcfg = _configs(arm)
    params, target, batch, key, want_loss, want_grads = _jax_loss_and_grads(arm)
    online, target_net = _port_net(tcfg, params), _port_net(tcfg, target)
    loss = tdqn._td_loss(tcfg, tdqn.learner_forward(tcfg), online, target_net,
                         _port_batch(batch), _learn_draws(jcfg, key))
    np.testing.assert_allclose(float(loss.detach()), want_loss, atol=1e-5,
                               rtol=1e-5)
    loss.backward()
    want = bridge.to_state_dict(want_grads, online)
    for name, p in online.named_parameters():
        # A parameter the loss does not reach (the last layer's LiDAR tail)
        # has no gradient here and an exactly zero one in JAX.
        got = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                   atol=1e-5, rtol=1e-3, err_msg=name)
    assert all(p.grad is None for p in target_net.parameters())


@pytest.mark.parametrize("arm,step0,extra,clipped", [
    ("A", 5, ["train.grad_clip=100.0"], False),
    ("A", 199, ["train.grad_clip=0.01"], True),           # ends on a hard sync
    ("A", 5, ["rl.target_tau=0.05", "train.lr=0.001"], True),   # Polyak target
    ("B", 5, [], True),
])
def test_learn_step_matches_optax(arm, step0, extra, clipped):
    """One full learn step from the same parameters and Adam state: online
    parameters, Adam moments, target and EMA afterwards against optax."""
    jcfg, tcfg = _configs(arm, extra)
    params, target, batch, key, want_loss, grads = _jax_loss_and_grads(arm)
    ema = _perturb(params, 3, 0.01)
    tx = jdqn.make_optimizer(jcfg)
    # A non-trivial optimizer state: one earlier update on other gradients.
    _, opt_state = tx.update(_perturb(grads, 4, 1e-3), tx.init(params), params)

    norm = float(optax.global_norm(grads))
    assert (norm > jcfg.train.grad_clip) == clipped
    updates, j_opt = tx.update(grads, opt_state, params)
    j_params = optax.apply_updates(params, updates)
    step = step0 + 1
    r = jcfg.rl
    if r.target_tau > 0:
        j_target = jax.tree_util.tree_map(
            lambda t, p: (1.0 - r.target_tau) * t + r.target_tau * p,
            target, j_params)
    else:
        j_target = j_params if step % r.target_update_period == 0 else target
    j_ema = jax.tree_util.tree_map(
        lambda m, p: (1.0 - r.ema_tau) * m + r.ema_tau * p, ema, j_params)

    state = tdqn.init(tcfg, seed=0, num_envs=2, device="cpu")
    for net, tree in ((state.params, params), (state.target_params, target),
                      (state.ema_params, ema)):
        net.load_state_dict(bridge.to_state_dict(tree, net))
    adam = opt_state[1][0]
    bridge.load_adam_state(state.opt_state, state.params, int(adam.count),
                           adam.mu, adam.nu)
    state = state._replace(step=step0)
    state, loss = tdqn.learn_step(tcfg, state, _port_batch(batch),
                                  _learn_draws(jcfg, key))

    assert state.step == step
    np.testing.assert_allclose(float(loss), want_loss, atol=1e-5, rtol=1e-5)
    _assert_tree_close(state.params, j_params, 1e-5, what="online")
    _assert_tree_close(state.target_params, j_target, 1e-5, what="target")
    _assert_tree_close(state.ema_params, j_ema, 1e-5, what="ema")
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
    if step % r.target_update_period == 0 and r.target_tau == 0:
        for t, p in zip(state.target_params.parameters(),
                        state.params.parameters()):
            assert torch.equal(t, p)


def test_clip_by_global_norm_matches_optax():
    rng = np.random.default_rng(5)
    grads = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in (("a", (3, 4)), ("b", (7,)))}
    for max_norm in (0.5, 100.0):       # active / inactive
        want, _ = optax.clip_by_global_norm(max_norm).update(
            {k: jnp.asarray(v) for k, v in grads.items()}, optax.EmptyState())
        got = [torch.tensor(v) for v in grads.values()]
        norm = tdqn.clip_by_global_norm_(got, max_norm)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            {k: jnp.asarray(v) for k, v in grads.items()})), rtol=1e-6)
        for g, w in zip(got, want.values()):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)
    # Below the threshold the factor is exactly 1.
    same = [torch.tensor(grads["a"])]
    tdqn.clip_by_global_norm_(same, 100.0)
    np.testing.assert_array_equal(same[0].numpy(), grads["a"])


def test_replay_sample_with_given_indices_matches_jax():
    jcfg, tcfg = _configs("A")
    batch = _batch(jcfg)
    jbuf = jreplay.add_batch(jreplay.create(
        jax.tree_util.tree_map(lambda x: x[0], jdqn.quantize_obs(jcfg, batch)),
        16), jdqn.quantize_obs(jcfg, batch))
    pbatch = tdqn.quantize_obs(tcfg, _port_batch(batch))
    tbuf = treplay.add_batch(treplay.create(
        type(pbatch)(*(x[0] for x in pbatch)), 16, "cpu"), pbatch)
    idx = np.array([3, 0, 0, 2, 1, 3])
    want = jax.tree_util.tree_map(lambda s: s[jnp.asarray(idx)], jbuf.data)
    got = treplay.sample(tbuf, None, len(idx), torch.tensor(idx))
    for g, w in zip(got, want):
        assert g.dtype == _t(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # Own draws: with replacement, inside the valid prefix only.
    drawn = treplay.sample(tbuf, torch.Generator().manual_seed(0), 64)
    assert drawn.action.shape == (64,)
    valid = set(np.asarray(batch.action).tolist())
    assert set(drawn.action.tolist()) <= valid


def test_dequantize_obs_round_trip():
    jcfg, tcfg = _configs("A")
    batch = _port_batch(_batch(jcfg))
    back = tdqn.dequantize_obs(tcfg, tdqn.quantize_obs(tcfg, batch))
    want = jdqn.dequantize_obs(jcfg, jdqn.quantize_obs(jcfg, _batch(jcfg)))
    assert back.image.dtype == torch.float32
    np.testing.assert_allclose(back.image.numpy(), np.asarray(want.image),
                               atol=1e-7)
    assert (back.image - batch.image).abs().max() <= 0.5 / 255 + 1e-6
    off = tcfg.override_str(["rl.replay_quantize=false"])
    assert tdqn.dequantize_obs(off, batch) is batch


@pytest.mark.parametrize("arm", ["A", "B"])
def test_learn_iterations_match_jax_bookkeeping(arm):
    """Four act+learn iterations at 4 envs: the learner starts on the same
    iteration, and step / buffer size / epsilon follow the JAX package's."""
    jcfg, tcfg = _configs(arm)
    num_envs = 4
    js = jdqn.init(jcfg, jax.random.key(0), num_envs)
    it_j = jdqn.make_iteration(jcfg)
    ts = tdqn.init(tcfg, seed=0, num_envs=num_envs, device="cpu")
    it_t = tdqn.make_iteration(tcfg)
    online0 = [p.detach().clone() for p in ts.params.parameters()]
    for i in range(4):
        js, jm = it_j(js)
        ts, tm = it_t(ts)
        assert set(tm) == set(jm)
        assert ts.step == int(js.step), i
        assert ts.buffer.size == int(js.buffer.size), i
        assert float(tm["buffer_size"]) == float(jm["buffer_size"])
        np.testing.assert_allclose(float(tm["epsilon"]), float(jm["epsilon"]),
                                   rtol=1e-6)
        assert (float(tm["loss"]) != 0) == (float(jm["loss"]) != 0), i
        assert np.isfinite(float(tm["loss"]))
    # n_step 2: first add on iteration 2 (4 rows), warm (8 rows) on 3.
    assert ts.step == 2
    assert any(not torch.equal(a, b)
               for a, b in zip(online0, ts.params.parameters()))
    assert all(p.grad is None for p in ts.target_params.parameters())


TINY = ["camera.features=8,16,16,16", "camera.c_sym=2",
        "camera.image_hw=16,16", "env.image_hw=16,16", "lidar.pillar_dim=16",
        "lidar.c_sym=2", "lidar.bev_hw=8,8", "fusion.dim=32", "fusion.depth=1",
        "fusion.heads=2", "fusion.state_dim=32", "env.num_npcs=2",
        "env.lidar_rays=32", "env.max_steps=8", "rl.replay_capacity=64",
        "rl.batch_size=8", "rl.num_envs=8", "rl.eval_snapshot_every=2",
        "rl.eval_snapshot_envs=4", "train.log_every=2",
        "train.iters_per_dispatch=1"]


def _records(path):
    return [json.loads(line) for line in open(path)]


def test_train_run_keys_match_jax_run(tmp_path):
    """The port's ``train.dqn.run`` for 20 iterations and the JAX one for 4:
    the same result keys and the same kinds of JSONL record, key for key."""
    jcfg = j_preset("c4").override_str(TINY + ["train.steps=4"])
    tcfg = t_preset("c4").override_str(TINY + ["train.steps=20"])
    jpath, tpath = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    _, jout = jtrain.run(jcfg, metrics_path=jpath)
    state, tout = ttrain.run(tcfg, metrics_path=tpath, device="cpu")
    assert set(tout) == set(jout)
    assert all(np.isfinite(v) for v in tout.values())
    assert state.step == 20 - 2          # n_step 3: 8 rows from iteration 3
    assert tout["best_eval_iter"] % 2 == 0
    jkinds = {frozenset(r) for r in _records(jpath)}
    tkinds = {frozenset(r) for r in _records(tpath)}
    assert tkinds == jkinds
    trecs = _records(tpath)
    assert "config" in trecs[0]
    assert trecs[-1]["step"] == 20
    assert [r["step"] for r in trecs if "snapshot_eval_return" in r] == list(
        range(2, 21, 2))


def test_train_run_refuses_what_is_not_ported(tmp_path):
    tcfg = t_preset("c4").override_str(TINY + ["train.steps=2"])
    with pytest.raises(NotImplementedError, match="item 15"):
        ttrain.run(tcfg, init_from=str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        ttrain.run(tcfg.override_str([f"train.checkpoint_dir={tmp_path}"]),
                   device="cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
        ttrain.run(tcfg.override_str(["lidar.arch=vq"]), device="cpu")


def test_evaluate_dqn_keys_and_first_done_accounting():
    jcfg = j_preset("c4").override_str(TINY)
    tcfg = t_preset("c4").override_str(TINY)
    jparams = jdqn.init_params(jcfg, jax.random.key(0))
    jout = jeval.evaluate_dqn(jcfg, jparams, jax.random.key(1), num_envs=4)
    net = _port_net(tcfg, jparams)
    tout = teval.evaluate_dqn(tcfg, net, seed=1, num_envs=4)
    assert set(tout) == set(jout)
    assert all(np.isfinite(v) for v in tout.values())
    # max_steps 8: every env hits its time limit at the latest.
    assert tout["episodes_terminated_frac"] == 1.0
    again = teval.evaluate_dqn(tcfg, net, seed=1, num_envs=4)
    assert again == tout                       # fixed seed: reproducible

    # First-done accounting against a loop written out per env: the same
    # seed and a constant action give the same trajectory.
    def act_fn(img, pts, mask, g):
        return torch.full((img.shape[0],), 5, dtype=torch.int32)

    got = teval._rollout_returns(tcfg, act_fn, 3, 6, "cpu")
    g = torch.Generator().manual_seed(3)
    states = tenv.reset_batch(tcfg.env, 6, g, "cpu")
    rewards, dones = [], []
    for _ in range(tcfg.env.max_steps):
        states, ts = tenv.step_batch(tcfg.env, states, act_fn(states.ego, None, None, g), g)
        rewards.append(ts.reward.numpy())
        dones.append(ts.done.numpy())
    rewards, dones = np.stack(rewards), np.stack(dones)
    rets = [rewards[:int(np.argmax(dones[:, e])) + 1, e].sum()
            for e in range(6)]
    assert dones.any(0).all()
    np.testing.assert_allclose(got["episode_return_mean"], np.mean(rets),
                               rtol=1e-5)
    np.testing.assert_allclose(got["episode_return_std"], np.std(rets),
                               rtol=1e-4)
    np.testing.assert_allclose(got["reward_per_step"], rewards.mean(),
                               rtol=1e-5)


def test_watchdogs_trip():
    nan_dog = tprof.NaNWatchdog()
    nan_dog.check(1, {"loss": torch.tensor(0.5), "reward": torch.tensor(1.0)})
    with pytest.raises(FloatingPointError, match="non-finite 'loss'"):
        nan_dog.check(2, {"loss": torch.tensor(float("nan")),
                          "reward": torch.tensor(1.0)})
    dog = tprof.CollapseWatchdog(num_actions=9, consecutive=3)
    eps = 0.05
    floor = dog.collapsed_entropy(eps, 9)
    from multimodal_sc_tpu.obs.profiling import CollapseWatchdog as JDog
    assert floor == pytest.approx(JDog.collapsed_entropy(eps, 9))
    # A constant-action histogram under eps-greedy sits on the floor.
    collapsed = {"epsilon": torch.tensor(eps),
                 "action_entropy": torch.tensor(floor)}
    healthy = {"epsilon": torch.tensor(eps), "action_entropy": torch.tensor(1.9)}
    early = {"epsilon": torch.tensor(0.9), "action_entropy": torch.tensor(0.0)}
    for i, m in enumerate((early, collapsed, collapsed, healthy, collapsed,
                           collapsed)):
        dog.check(i, m)
        assert not dog.tripped
    dog.check(6, collapsed)
    assert dog.tripped
