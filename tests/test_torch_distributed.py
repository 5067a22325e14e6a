"""The port's process mesh and data parallelism on gloo, at 1 and 2 ranks.

The ranks are spawned processes (``tests/torch_dist_ranks.py``, which
imports no JAX) joined once per module through a ``file://`` rendezvous
under ``tmp_path``. At the tiny c4 of the JAX package's sharded-DQN tests:

* the mesh: row-major layout, ``shard_batch`` / ``replicate`` / the
  gradient mean, JAX's error texts;
* the sharded DQN iteration: a world of one bit-equal to ``rl/dqn.py``'s;
  at 2 ranks the networks and Adam moments bit-equal across ranks after
  every iteration, JAX's buffer-size formula, and codebook re-seeding that
  keeps the replicas equal; one learn step from given batches and draws
  against JAX's meaned ``_td_loss`` gradients through ``optax`` (1e-5, as
  ``test_torch_learner.py``'s single-process step);
* the driver: a resume at the same world size bit-equal to an
  uninterrupted run, a refusal at another;
* PPO and JSCC data parallelism at 2 ranks against one process on the
  global batch, and one PPO update at 2 ranks against JAX's pieces (their
  metrics also as run sharded on two of the 8 CPU devices), within
  ``tests/distributed/test_sharding.py``'s atol 1e-5 / rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_dist_ranks as ranks
from test_torch_c4_digital import flax_like
from multimodal_sc_torch import bridge
from multimodal_sc_torch.config import get_preset as t_preset
from multimodal_sc_torch.rl import dqn as tdqn
from multimodal_sc_torch.rl import dqn_sharded
from multimodal_sc_torch.rl import ppo as tppo
from multimodal_sc_torch.runtime import mesh as tmesh
from multimodal_sc_torch.train import jscc as tjscc
from multimodal_sc_tpu.config import get_preset as j_preset
from multimodal_sc_tpu.envs import driving as jenv
from multimodal_sc_tpu.rl import dqn as jdqn

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

ATOL, RTOL = 1e-5, 1e-4          # tests/distributed/test_sharding.py:77-80


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = ranks.RankPool(2, tmp_path_factory.mktemp("rendezvous"))
    yield p
    p.close()


def _tiny(extra=()):
    return t_preset("c4").override_str(ranks.TINY_C4 + list(extra))


# ------------------------------------------------------------------ mesh


def test_mesh_of_one_process_and_jax_errors():
    m = tmesh.make_mesh()
    assert m.shape == {"data": 1, "model": 1}
    assert (m.data_group, m.model_group) == (None, None)
    assert tmesh.batch_sharding(m, 3) == ("data", None, None)
    assert tmesh.replicated(m) == ()
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        tmesh.make_mesh(data=2)
    with pytest.raises(ValueError, match="1 devices not divisible by model=2"):
        tmesh.make_mesh(model=2)
    with pytest.raises(ValueError,
                       match="global batch 5 not divisible by data=2"):
        tmesh.local_batch_size(_fake_mesh(2), 5)
    assert tmesh.backend_for("cuda") == "nccl"
    assert tmesh.backend_for("cpu") == "gloo"


def _fake_mesh(data, model=1, index=0):
    return tmesh.Mesh(shape={"data": data, "model": model},
                      axis_names=("data", "model"), rank=index,
                      data_index=index, model_index=0)


@pytest.mark.parametrize("data,model", [(2, 1), (1, 2)])
def test_mesh_is_row_major_over_ranks(pool, data, model):
    got = pool.run("mesh_layout", data=data, model=model)
    for rank, m in enumerate(got):
        assert (m["data_index"], m["model_index"]) == divmod(rank, model)
        assert m["shape"] == {"data": data, "model": model}
        # Ranks sharing a model index form one data group.
        assert m["data_ranks"] == [i * model + m["model_index"]
                                   for i in range(data)]


def test_shard_batch_replicate_and_gradient_mean(pool):
    got = pool.run("mesh_collectives")
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    for rank, r in enumerate(got):
        np.testing.assert_array_equal(r["local"], x[rank * 4:(rank + 1) * 4])
        assert r["scalar"] == 5.0
        np.testing.assert_array_equal(r["weight"], np.zeros((2, 3)))
        np.testing.assert_array_equal(r["g0"], np.full((2, 2), 1.5))
        np.testing.assert_array_equal(r["g1"], np.full((3,), 1.0))
        assert r["loss"] == 0.5


# ------------------------------------------------------------ sharded DQN


@pytest.mark.parametrize("extra", [[], ["camera.arch=vq",
                                        "camera.vq_reseed=1.0"]])
def test_world_of_one_is_bit_equal_to_the_single_process_iteration(extra):
    torch.set_num_threads(1)
    cfg = _tiny(extra)
    mesh = tmesh.make_mesh()
    plain = tdqn.init(cfg, 3, 4, "cpu")
    shard = dqn_sharded.init(cfg, 3, mesh, 4, "cpu")
    it_plain = tdqn.make_iteration(cfg)
    it_shard = dqn_sharded.make_iteration(cfg, mesh)
    for i in range(6):
        plain, m_p = it_plain(plain)
        shard, m_s = it_shard(shard)
        assert m_p.keys() == m_s.keys()
        for k in m_p:
            assert torch.equal(m_p[k], m_s[k]), (i, k)
    assert plain.step == shard.step >= 1
    for name in ("params", "target_params", "ema_params"):
        for a, b in zip(getattr(plain, name).parameters(),
                        getattr(shard, name).parameters()):
            assert torch.equal(a, b), name
    for a, b in zip(plain.buffer.data, shard.buffer_data):
        assert torch.equal(a, b)
    assert (plain.buffer.size, plain.buffer.cursor) == (shard.buffer_size,
                                                        shard.buffer_cursor)
    assert torch.equal(plain.generator.get_state(), shard.keys.get_state())


@pytest.mark.parametrize("extra", [[], ["camera.arch=vq",
                                        "camera.vq_reseed=1.0"]])
def test_two_ranks_keep_the_replicas_bit_equal(pool, extra):
    iters, envs = 8, 2
    got = pool.run("dqn_iterations", iters=iters, envs_per_shard=envs,
                   extra=extra)
    cfg = _tiny(extra)
    for r in got:
        assert all(r["equal"]), r["equal"]
        assert r["moments_equal"]
        # Per-shard buffers: iterations minus the n-step window fill.
        assert r["buffer_size"] == (iters - (cfg.rl.n_step - 1)) * envs
        assert r["step"] >= 1
        # Each shard's own envs: its transitions differ from the other's.
        assert r["rewards_differ"]
        assert np.isfinite(r["metrics"]["loss"])
    # Pooled metrics agree on every rank.
    assert got[0]["metrics"] == got[1]["metrics"]


def _jax_batch(jcfg, seeds, batch=4):
    rng = np.random.default_rng(seeds[0])
    obs = [jenv.observe_batch(jcfg.env, jenv.reset_batch(
        jcfg.env, jax.random.key(k), batch)) for k in seeds]
    return jdqn.Transition(
        image=obs[0][0], points=obs[0][1], mask=obs[0][2],
        action=jnp.asarray(rng.integers(0, jcfg.rl.num_actions, batch),
                           jnp.int32),
        reward=jnp.asarray(rng.standard_normal(batch) * 2.0, jnp.float32),
        done=jnp.asarray(rng.uniform(size=batch) < 0.3),
        next_image=obs[1][0], next_points=obs[1][1], next_mask=obs[1][2])


def _jax_noise(cfg, key, batch):
    """The standard-normal draws of the JAX trunk's two AWGN links."""
    k_cam, k_lid = jax.random.split(key)
    hw = cfg.camera.image_hw
    n_cam = (hw[0] // 4) * (hw[1] // 4) * cfg.camera.c_sym
    n_lid = cfg.lidar.bev_hw[0] * cfg.lidar.bev_hw[1] * cfg.lidar.c_sym
    return tuple(np.array(jax.random.normal(k, (batch, n, 2)))
                 for k, n in ((k_cam, n_cam), (k_lid, n_lid)))


def test_learn_step_matches_jax_meaned_gradients_through_optax(pool):
    """Each rank's TD gradient on its own batch, meaned over the data
    group, then clip (engaged: the meaned norm is above the preset's 1.0)
    and Adam: JAX's ``pmean`` before ``tx.update``."""
    over = ranks.TINY_C4 + ["train.grad_clip=1.0"]
    jcfg, tcfg = j_preset("c4").override_str(over), _tiny(["train.grad_clip=1.0"])
    params = flax_like(jax.eval_shape(
        lambda k: jdqn.init_params(jcfg, k), jax.random.key(0)), 1)
    rng = np.random.default_rng(2)
    target = jax.tree_util.tree_map(
        lambda a: a + 0.02 * jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32)), params)
    batches = [_jax_batch(jcfg, (11, 12)), _jax_batch(jcfg, (13, 14))]
    keys = [jax.random.key(21), jax.random.key(22)]
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b, k: jdqn._td_loss(p, target, b, k, jcfg), has_aux=True))
    losses, grads = zip(*((l, g) for (l, _), g in (
        grad_fn(params, b, k) for b, k in zip(batches, keys))))
    mean_grads = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, *grads)
    assert float(optax.global_norm(mean_grads)) > jcfg.train.grad_clip
    tx = jdqn.make_optimizer(jcfg)
    # A non-trivial optimizer state (one earlier update on other
    # gradients): Adam's first step is sign-like and would turn rounding
    # noise near zero into +-lr flips.
    _, opt_state = tx.update(jax.tree_util.tree_map(
        lambda a: 1e-2 * jnp.asarray(rng.standard_normal(a.shape).astype(
            np.float32)), params), tx.init(params), params)
    updates, _ = tx.update(mean_grads, opt_state, params)
    want = optax.apply_updates(params, updates)

    net = tdqn.init_params(tcfg, 0, "cpu")
    sd = {k: v.numpy() for k, v in bridge.to_state_dict(params, net).items()}
    sd_t = {k: v.numpy()
            for k, v in bridge.to_state_dict(target, net).items()}
    noises = [[_jax_noise(jcfg, k, 4) for k in jax.random.split(key, 3)]
              for key in keys]
    adam = opt_state[1][0]
    moments = [{k: v.numpy() for k, v in bridge.to_state_dict(t, net).items()}
               for t in (adam.mu, adam.nu)]
    got = pool.run("dqn_learn_step", params=sd, target=sd_t,
                   batches=[tuple(np.asarray(x) for x in b) for b in batches],
                   noises=noises, adam=(int(adam.count), *moments))
    want_sd = bridge.to_state_dict(want, net)
    for r in got:
        assert r["equal"]
        np.testing.assert_allclose(r["loss"], np.mean([float(x)
                                                       for x in losses]),
                                   atol=1e-5, rtol=1e-5)
        for name, w in want_sd.items():
            np.testing.assert_allclose(r["params"][name], w.numpy(),
                                       atol=1e-5, err_msg=name)


def test_reseed_pools_counts_and_takes_the_first_shards_inputs():
    """One rank's view of ``DataSync.reseed`` on a mesh of one: the coins
    come from the generator in the single-process learner's order."""
    sync = dqn_sharded.DataSync(tmesh.make_mesh())
    counts, cands = torch.tensor([0, 3, 0]), torch.randn(3, 2)
    g = torch.Generator().manual_seed(5)
    rs, coin, lid_coin = sync.reseed({"cam": (counts, cands),
                                      "lid": (counts, cands)}, g, None, None)
    g2 = torch.Generator().manual_seed(5)
    assert torch.equal(coin, torch.rand(3, generator=g2))
    assert torch.equal(lid_coin, torch.rand(3, generator=g2))
    assert rs["cam"][0] is counts


# ------------------------------------------------------------------ driver


def test_driver_resumes_bit_equal_and_refuses_another_world(pool, tmp_path):
    a = pool.run("dqn_driver", ckpt_dir=str(tmp_path / "a"), steps=8,
                 every=4)
    pool.run("dqn_driver", ckpt_dir=str(tmp_path / "b"), steps=4, every=4)
    b = pool.run("dqn_driver", ckpt_dir=str(tmp_path / "b"), steps=8,
                 every=4)
    for ra, rb in zip(a, b):
        for k in ("params", "ema", "reward", "gen"):
            np.testing.assert_array_equal(ra[k], rb[k], err_msg=k)
        assert (ra["size"], ra["step"]) == (rb["size"], rb["step"])
    assert a[0]["result"]["data_shards"] == 2
    assert a[0]["result"]["loss"] == b[0]["result"]["loss"]
    assert a[1]["result"] is None                 # rank 0's alone
    files = sorted(p.name for p in (tmp_path / "b").iterdir())
    assert files == ["ckpt_4.pt", "ckpt_4.shard1.pt", "ckpt_8.pt",
                     "ckpt_8.shard1.pt", "config.json"]
    # One process cannot resume two shards' checkpoint ...
    torch.set_num_threads(1)
    msg = ranks.dqn_driver_refuses(str(tmp_path / "b"), 12)
    assert "holds a run of 2 data shard(s) but this run has 1" in msg
    # ... nor two processes one process's.
    ranks.dqn_driver(str(tmp_path / "c"), 4, 4)
    msg = pool.run("dqn_driver_refuses", ckpt_dir=str(tmp_path / "c"),
                   steps=8)
    assert all("holds a run of 1 data shard(s) but this run has 2" in m
               for m in msg)


def test_driver_puts_every_rank_on_the_data_axis(pool, tmp_path):
    """As JAX's driver (``make_mesh()``), the DQN driver ignores
    ``mesh.model_axis``: two processes asked for data 1 x model 2 run two
    data shards on envs of their own, and write one checkpoint apiece."""
    out = pool.run("dqn_driver", ckpt_dir=str(tmp_path), steps=4, every=4,
                   extra=["mesh.data_axis=1", "mesh.model_axis=2"])
    assert out[0]["result"]["data_shards"] == 2
    assert out[1]["result"] is None
    np.testing.assert_array_equal(out[0]["params"], out[1]["params"])
    assert not np.array_equal(out[0]["reward"], out[1]["reward"])
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_4.pt", "ckpt_4.shard1.pt", "config.json"]


def test_eval_policy_reads_a_sharded_checkpoint(pool, tmp_path):
    from multimodal_sc_torch.evaluation import policy_eval
    from multimodal_sc_torch.io.checkpoint import CheckpointManager

    out = pool.run("dqn_driver", ckpt_dir=str(tmp_path), steps=4, every=4)
    cfg = _tiny(["rl.num_envs=4"])
    net = tdqn.init_params(cfg, 9, "cpu")
    CheckpointManager(str(tmp_path)).restore_params_latest(net, "ema_params")
    flat = torch.cat([p.detach().reshape(-1) for p in net.parameters()])
    np.testing.assert_array_equal(flat.numpy(), out[0]["ema"])
    res = policy_eval.evaluate_dqn(cfg, net, 0, num_envs=2)
    assert np.isfinite(res["episode_return_mean"])


# ---------------------------------------------------- PPO and JSCC


PPO_TINY = ranks.TINY_C4[:-3] + ["rl.num_envs=4", "rl.rollout_length=4",
                                 "rl.num_minibatches=2", "rl.ppo_epochs=2"]


@pytest.mark.parametrize("extra", [[], ["rl.entropy_floor=5.0"]])
def test_ppo_update_on_two_ranks_matches_one_process(pool, extra):
    """The global rollout split by envs over 2 ranks, the same
    permutations and link draws: one update equals the single-process one
    (the floor case keeps the entropy hinge active: a global entropy)."""
    torch.set_num_threads(1)
    from multimodal_sc_torch.rl.dqn import learner_forward
    from multimodal_sc_torch.rl.perception import ActorCritic, LinkDraws

    over = PPO_TINY + extra
    cfg = t_preset("c5").override_str(over)
    st = tppo.init(cfg, 0, "cpu")
    g = st.generator
    _, _, last_return, ro, (img, pts, mask) = tppo._collect_rollout(
        cfg, st.params, st.env_states, st.ep_return, st.last_return, g)
    with torch.no_grad():
        _, _, last_value = tppo.act(cfg, st.params, img, pts, mask, g,
                                    snr_db=tppo._sample_snr(cfg, g, 4, "cpu"))
    rng = np.random.default_rng(0)
    perms = [rng.permutation(16) for _ in range(2)]
    hw = cfg.camera.image_hw
    n_cam = (hw[0] // 4) * (hw[1] // 4) * cfg.camera.c_sym
    n_lid = cfg.lidar.bev_hw[0] * cfg.lidar.bev_hw[1] * cfg.lidar.c_sym
    noises = [[tuple(rng.standard_normal((8, n, 2)).astype(np.float32)
                     for n in (n_cam, n_lid)) for _ in range(2)]
              for _ in range(2)]
    params = {k: v.numpy().copy() for k, v in st.params.state_dict().items()}

    ref = tppo.init(cfg, 0, "cpu")
    ref.params.load_state_dict(st.params.state_dict())
    ref.ema_params.load_state_dict(st.params.state_dict())
    draws = tppo.UpdateDraws(
        perms=[torch.tensor(p) for p in perms],
        noise=[[LinkDraws(*(torch.tensor(x) for x in n)) for n in e]
               for e in noises])
    ref, want = tppo._update(cfg, ref._replace(last_return=last_return), ro,
                             last_value, learner_forward(cfg, ActorCritic),
                             draws)
    got = pool.run("ppo_update", cfg_over=over,
                   rollout=[x.numpy() for x in ro],
                   last_value=last_value.numpy(), params=params,
                   perms=perms, noises=noises)
    for r in got:
        assert r["equal"]
        for k, w in want.items():
            np.testing.assert_allclose(r["metrics"][k], float(w), atol=ATOL,
                                       rtol=RTOL, err_msg=k)
        for k, w in ref.params.state_dict().items():
            np.testing.assert_allclose(r["params"][k], w.numpy(), atol=ATOL,
                                       rtol=RTOL, err_msg=k)


def test_ppo_update_on_two_ranks_matches_jax_on_a_mesh(pool):
    """One PPO update of JAX's pieces (GAE, then 2 epochs x 2 minibatch
    steps of ``_ppo_loss`` through ``make_optimizer``: advantages
    normalised over the global minibatch, the entropy floor's hinge active
    on the global entropy) against the port's ``_update`` at 2 ranks,
    given the same parameters, Adam state, rollout, permutations and JAX's
    link noise, within atol 1e-5 / rtol 1e-4.

    JAX runs twice: on one device, and sharded as GSPMD runs it (the
    rollout over ``data`` by envs, each minibatch by rows, the parameters
    replicated) on two of the 8 CPU devices. The port's metrics and
    parameters are held against both.

    The data are ``test_torch_ppo.py``'s update test's (rollout seed 21,
    parameters 24, Adam 26). On another rollout (seed 31) JAX's own two
    runs end up to 1.1e-4 apart in the pillar net's first layer, and the
    port follows one or the other within 1.2e-7 depending on XLA's flags:
    most likely a near-tie at a pillar's max, which one rounding makes a
    tie (the gradient split among the tied points) and another breaks,
    carried by Adam."""
    torch.set_num_threads(1)
    from jax.sharding import NamedSharding, PartitionSpec as P

    import test_torch_ppo as tp
    from multimodal_sc_tpu.rl import gae as jgae
    from multimodal_sc_tpu.rl import ppo as jppo
    from multimodal_sc_tpu.runtime import mesh as jmesh

    extra = tp.LOSS_CASES["entropy floor"][0]
    over = tp.TINY + list(extra) + ["train.grad_clip=0.5"]
    jcfg = j_preset("c5").override_str(over)
    r = jcfg.rl
    m2 = jmesh.make_mesh(devices=jax.devices()[:2])
    assert m2.shape["data"] == 2
    repl = NamedSharding(m2, P())

    rollout = tp._rollout(jcfg, seed=21)
    rng = np.random.default_rng(22)
    last_value = jnp.asarray(rng.standard_normal(tp.B), jnp.float32)
    perms = [rng.permutation(tp.T * tp.B) for _ in range(r.ppo_epochs)]
    keys = [[jax.random.key(100 + 10 * e + i)
             for i in range(r.num_minibatches)] for e in range(r.ppo_epochs)]
    params = tp._perturb(tp._flax_fresh("ActorCritic"), 24, 0.02)
    tx = jppo.make_optimizer(jcfg)
    # A non-trivial Adam state, as the single-process test's: from a fresh
    # one the first step moves a parameter whose gradient is rounding
    # noise (the key biases) by the learning rate in the noise's sign.
    _, opt_state = tx.update(tp._perturb(params, 26, 1e-3), tx.init(params),
                             params)
    apply = jax.jit(lambda g, o, p: (lambda u, o: (optax.apply_updates(p, u),
                                                   o))(*tx.update(g, o, p)))
    gae = jax.jit(jgae.gae, static_argnums=(4, 5))
    ent = jppo._entropy_coef(jcfg, jnp.int32(0))
    loss_grad = tp._jax_loss_grad(extra)

    def jax_update(sharded):
        def place(x, axis):
            if not sharded:
                return x
            spec = [None] * x.ndim
            spec[axis] = "data"
            return jax.device_put(x, NamedSharding(m2, P(*spec)))

        ro = jppo.Rollout(*(place(x, 1) for x in rollout))
        adv, ret = gae(ro.reward, ro.value, ro.done, place(last_value, 0),
                       r.gamma, r.gae_lambda)
        flat = tp._flat(ro, adv, ret)
        j_params, j_opt = ((jax.device_put(params, repl),
                            jax.device_put(opt_state, repl)) if sharded
                           else (params, opt_state))
        losses, norms = [], []
        for e in range(r.ppo_epochs):
            for i in range(r.num_minibatches):
                idx = jnp.asarray(perms[e][i * tp.MB:(i + 1) * tp.MB])
                batch = {k: place(v[idx], 0) for k, v in flat.items()}
                (loss, aux), grads = loss_grad(j_params, batch, keys[e][i],
                                               ent)
                if sharded:
                    assert all(g.sharding.is_fully_replicated
                               for g in jax.tree_util.tree_leaves(grads))
                norms.append(float(optax.global_norm(grads)))
                j_params, j_opt = apply(grads, j_opt, j_params)
                losses.append((float(loss), {k: float(aux[k]) for k in
                                             ("pg_loss", "v_loss",
                                              "entropy")}))
        assert max(a["entropy"] for _, a in losses) < r.entropy_floor
        assert max(norms) > jcfg.train.grad_clip    # the hinge, the clip
        metrics = {
            "loss": np.mean([l for l, _ in losses]),
            **{k: np.mean([a[k] for _, a in losses])
               for k in ("pg_loss", "v_loss", "entropy")},
            "entropy_coef": float(ent), "reward": float(jnp.mean(ro.reward))}
        return j_params, metrics

    runs = [jax_update(False), jax_update(True)]

    net = tp._port_net(t_preset("c5").override_str(over), params)
    adam = opt_state[1][0]
    got = pool.run(
        "ppo_update", cfg_over=over,
        rollout=[np.asarray(x) for x in rollout],
        last_value=np.asarray(last_value),
        params={k: v.detach().numpy().copy()
                for k, v in net.state_dict().items()},
        perms=perms,
        noises=[[tuple(x.numpy() for x in tp._jax_noise(jcfg, k, tp.MB))
                 for k in row] for row in keys],
        adam=(int(adam.count),
              *({k: v.numpy() for k, v in bridge.to_state_dict(t, net).items()}
                for t in (adam.mu, adam.nu))))
    for j_params, want_metrics in runs:
        want = bridge.to_state_dict(j_params, net)
        for rk in got:
            assert rk["equal"]
            for k, w in want_metrics.items():
                np.testing.assert_allclose(rk["metrics"][k], w, atol=ATOL,
                                           rtol=RTOL, err_msg=k)
            for k, w in want.items():
                np.testing.assert_allclose(rk["params"][k], w.numpy(),
                                           atol=ATOL, rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("extra", [
    [],
    ["channel.random_snr=true", "channel.kind=rayleigh", "channel.pilots=2"],
    ["camera.seg_classes=4"],
])
def test_jscc_step_on_two_ranks_matches_one_process(pool, extra):
    """Each rank's rows of one global batch and of its draws: the step
    equals the single-process one, the loss, PSNR and mIoU pooled."""
    torch.set_num_threads(1)
    from multimodal_sc_torch.channel import ChannelDraws

    over = ["camera.features=8,16,16,16", "camera.c_sym=2",
            "train.batch_size=16", "train.lr=1e-3"] + extra
    cfg = t_preset("c1").override_str(over)
    st = tjscc.create_train_state(cfg, 0, "cpu")
    params = {k: v.numpy().copy() for k, v in st.params.state_dict().items()}
    rng = np.random.default_rng(1)
    img = rng.uniform(size=(16, 32, 32, 3)).astype(np.float32)
    batch = img
    if cfg.camera.seg_classes:
        batch = (img, rng.integers(0, 4, (16, 32, 32)).astype(np.int32))
    d0 = tjscc.draw_step(cfg, 16, st.generator, "cpu")
    z = st.params.encode(torch.tensor(img), d0.snr_db)
    noise = rng.standard_normal(tuple(z.shape)).astype(np.float32)
    channel = (ChannelDraws(noise=noise,
                            h=rng.standard_normal((16, 2)).astype(np.float32),
                            csi=rng.standard_normal((16, 1, 2)).astype(
                                np.float32))
               if cfg.channel.kind == "rayleigh" else noise)
    draws = {"snr_db": d0.snr_db.numpy(), "channel": channel}
    given = tjscc.StepDraws(
        snr_db=d0.snr_db,
        channel=(ChannelDraws(*(torch.tensor(x) for x in channel))
                 if isinstance(channel, tuple) else torch.tensor(noise)))
    tb = (tuple(torch.tensor(x) for x in batch) if isinstance(batch, tuple)
          else torch.tensor(batch))
    st, want = tjscc.make_train_step(cfg)(st, tb, given)
    got = pool.run("jscc_step", cfg_over=over, params=params, batch=batch,
                   draws=draws)
    for r in got:
        assert r["equal"]
        assert r["metrics"].keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_allclose(r["metrics"][k], float(w), atol=ATOL,
                                       rtol=RTOL, err_msg=k)
        for k, w in st.params.state_dict().items():
            np.testing.assert_allclose(r["params"][k], w.numpy(), atol=ATOL,
                                       rtol=RTOL, err_msg=k)


def test_data_parallel_refuses_the_digital_codecs():
    """Data-parallel training of the digital codecs is no longer refused:
    a VQ JSCC step builds on a data axis of two ranks, and PPO shards a
    digital trunk's envs over any data axis of more than one rank
    (``tests/test_torch_distributed_vq.py`` holds both to JAX on a
    mesh)."""
    mesh = _fake_mesh(2)
    assert callable(tjscc.make_train_step(
        t_preset("c1").override_str(["camera.arch=vq"]), mesh=mesh))
    assert tmesh.data_parallel(mesh)
    assert not tmesh.data_parallel(_fake_mesh(1, 2))
