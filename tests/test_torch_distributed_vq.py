"""Data-parallel training of the digital codecs and checkpoints of a
tensor-parallel PPO run, on gloo at 2 ranks, against the JAX package on 2
of the 8 CPU devices.

The ranks are spawned processes (``tests/torch_dist_ranks.py``, which
imports no JAX) joined once per module through a ``file://`` rendezvous.
JAX runs each step as GSPMD runs it: the batch sharded over ``data`` on
two CPU devices, the state replicated, so its batch statistics are the
global batch's. Given the same parameters, batch and JAX's draws:

* one c1_vq JSCC step (``camera.vq_usage_coef > 0``) with every dead code
  re-seeded (``camera.vq_reseed=1.0``), and at 0.3 on a pruned codec and
  under UEP: the usage loss's scale and soft usage over the global batch,
  the usage counts summed, the candidates the global batch's worst rows,
  the perplexity from the summed histogram, the index error rate over the
  global tokens, the coins the same on both ranks;
* one c5 PPO update over the digital camera and the pruned digital LiDAR,
  usage and re-seeding on both codebooks, as GSPMD runs JAX's
  ``_ppo_loss`` on the global minibatch;

each within ``tests/distributed/test_sharding.py``'s atol 1e-5 / rtol
1e-4, the replicas bit-equal. Then a data 1 x model 2 PPO run stopped at a
checkpoint and resumed is bit-equal to the run without a stop, and its
checkpoint, written whole, loads into one process's network.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import test_torch_c4_digital as dig
import torch_dist_ranks as ranks
from multimodal_sc_torch import bridge
from multimodal_sc_torch.config import get_preset as t_preset
from multimodal_sc_torch.io.checkpoint import CheckpointManager
from multimodal_sc_torch.rl.perception import ActorCritic as TActorCritic
from multimodal_sc_torch.train import jscc as tjscc
from multimodal_sc_tpu.config import get_preset as j_preset
from multimodal_sc_tpu.rl import gae as jgae
from multimodal_sc_tpu.rl import perception as jper
from multimodal_sc_tpu.rl import ppo as jppo
from multimodal_sc_tpu.runtime import mesh as jmesh
from multimodal_sc_tpu.train import jscc as jjscc

ATOL, RTOL = 1e-5, 1e-4          # tests/distributed/test_sharding.py:77-80


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = ranks.RankPool(2, tmp_path_factory.mktemp("rendezvous"))
    yield p
    p.close()


def _mesh2():
    m2 = jmesh.make_mesh(devices=jax.devices()[:2])
    assert m2.shape["data"] == 2
    return m2


def _close(got, want, what):
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=what)


# ------------------------------------------------------------- c1_vq JSCC

VQ = ["camera.arch=vq", "camera.image_hw=16,16", "camera.features=8,8,16,16",
      "camera.vq_codes=16", "camera.vq_dim=8", "train.batch_size=4",
      "camera.vq_usage_coef=0.1", "train.warmup_steps=0", "train.steps=10"]
BATCH, N_TOK, CODES = 4, 16, 16
JSCC_CASES = {"reseed 1.0": ["camera.vq_reseed=1.0"],
              "reseed 0.3, pruned": ["camera.vq_reseed=0.3",
                                     "camera.vq_prune=true"],
              "reseed 0.3, UEP": ["camera.vq_reseed=0.3",
                                  "channel.uep_alpha=0.25"]}


def _jscc_draws(jcfg, key):
    """JAX's draws of one VQ step from its key, as numpy: the SNR and the
    channel's, the kept fractions and random selection scores of a pruned
    codec, the UEP probes, the re-seeding coin."""
    ksnr, kch = jax.random.split(key)
    ch, cam = jcfg.channel, jcfg.camera
    draws = {"snr_db": jjscc._sample_snr(jcfg, ksnr, BATCH),
             "channel": jax.random.normal(kch, (BATCH, N_TOK * 2, 2)),
             "coin": jax.random.uniform(jax.random.fold_in(key, 0xD0D0),
                                        (CODES,))}
    if cam.vq_prune:
        draws["keep"] = jax.random.uniform(
            jax.random.fold_in(key, 0x6EE9), (BATCH,),
            minval=cam.vq_keep_min, maxval=1.0)
        draws["select"] = jax.random.uniform(jax.random.fold_in(kch, 88),
                                             (BATCH, N_TOK))
    if ch.uep_alpha > 0:
        draws["uep"] = jax.random.normal(jax.random.fold_in(kch, 77),
                                         (ch.uep_probes, BATCH, 16, 16, 3))
    return {k: np.array(v) for k, v in draws.items()}


@pytest.mark.parametrize("case", sorted(JSCC_CASES))
def test_vq_jscc_step_on_two_ranks_matches_jax_on_a_mesh(pool, case):
    """One c1_vq step at 2 ranks x 2 images against JAX's step with the
    batch sharded over two devices: every metric and parameter (the
    re-seeded codebook rows among them)."""
    over = VQ + JSCC_CASES[case]
    jcfg = j_preset("c1").override_str(over)
    model = jjscc.build_model(jcfg)
    jstate = jax.jit(lambda k: jjscc.create_train_state(jcfg, k))(
        jax.random.key(0))
    jstate = jstate.replace(params=dig._perturb(jstate.params, 2, 0.02))
    m2 = _mesh2()
    img = np.random.default_rng(3).uniform(
        0, 1, (BATCH, 16, 16, 3)).astype(np.float32)
    key = jax.random.key(7)
    j_next, jm = jax.jit(jjscc._step_body(jcfg, model))(
        jax.device_put(jstate, NamedSharding(m2, P())),
        jax.device_put(jnp.asarray(img), NamedSharding(m2, P("data"))),
        None, key)
    assert float(jm["vq_reseeded"]) > 0

    net = tjscc.build_model(t_preset("c1").override_str(over))
    got = pool.run("jscc_step", cfg_over=over, batch=img,
                   params={k: v.numpy() for k, v in bridge.to_state_dict(
                       jstate.params, net).items()},
                   draws=_jscc_draws(jcfg, key))
    want = bridge.to_state_dict(j_next.params, net)
    for r in got:
        assert r["equal"]
        assert set(r["metrics"]) == set(jm)
        for k, w in jm.items():
            _close(r["metrics"][k], float(w), k)
        for k, w in want.items():
            _close(r["params"][k], w.numpy(), k)


# --------------------------------------------------- c5 PPO, both digital

PPO = (*dig.PPO, "camera.vq_usage_coef=0.05")


def test_digital_ppo_update_on_two_ranks_matches_jax_on_a_mesh(pool):
    """One update of one minibatch step over the digital camera and the
    pruned digital LiDAR, usage and re-seeding on both codebooks: GAE,
    JAX's ``_ppo_loss`` with the minibatch sharded over two devices, the
    clip and Adam from a non-trivial state, both codebooks re-seeded with
    JAX's coins from ``fold_in(key, 0xD0D0)``; the port's ``_update`` at 2
    ranks x 1 env on the same rollout, permutation, link draws, kept
    fractions and coins."""
    jcfg, _ = dig._configs("c5", PPO)
    r = jcfg.rl
    t_len, b = dig.T, dig.B
    params = dig._params("c5", PPO)
    img, pts, mask = dig._obs(3)
    rng = np.random.default_rng(32)
    a = r.num_actions
    ro = jppo.Rollout(
        image=img.reshape(t_len, b, *img.shape[1:]),
        points=pts.reshape(t_len, b, *pts.shape[1:]),
        mask=mask.reshape(t_len, b, *mask.shape[1:]),
        action=jnp.asarray(rng.integers(0, a, (t_len, b)), jnp.int32),
        logp=jnp.asarray(np.log(1 / a) + 0.3 * rng.standard_normal(
            (t_len, b)), jnp.float32),
        value=jnp.asarray(rng.standard_normal((t_len, b)), jnp.float32),
        reward=jnp.asarray(rng.standard_normal((t_len, b)), jnp.float32),
        done=jnp.asarray(rng.uniform(size=(t_len, b)) < 0.2),
        snr_db=jnp.zeros((t_len, b), jnp.float32))
    last_value = jnp.asarray(rng.standard_normal(b), jnp.float32)
    perm = rng.permutation(t_len * b)
    key = jax.random.key(33)
    ent = jppo._entropy_coef(jcfg, jnp.int32(0))
    adv, ret = jgae.gae(ro.reward, ro.value, ro.done, last_value, r.gamma,
                        r.gae_lambda)
    flat = {"image": ro.image, "points": ro.points, "mask": ro.mask,
            "action": ro.action, "logp": ro.logp, "adv": adv, "ret": ret,
            "snr": ro.snr_db}
    m2 = _mesh2()
    batch = {k: jax.device_put(
        v.reshape(t_len * b, *v.shape[2:])[jnp.asarray(perm)],
        NamedSharding(m2, P("data"))) for k, v in flat.items()}
    (loss, jaux), grads = jax.jit(jax.value_and_grad(
        lambda p, bt: jppo._ppo_loss(p, bt, jcfg, key, ent),
        has_aux=True))(jax.device_put(params, NamedSharding(m2, P())),
                       batch)
    rs = jaux.pop("reseed_stats")
    assert set(rs) == {"cam", "lid"}
    tx = jppo.make_optimizer(jcfg)
    update = jax.jit(tx.update)
    _, opt_state = update(dig._perturb(grads, 34, 1e-3), tx.init(params),
                          params)
    updates, _ = update(grads, opt_state, params)
    rkey = jax.random.fold_in(key, 0xD0D0)
    j_params = jper.apply_codebook_reseed(
        jcfg, optax.apply_updates(params, updates), rs, rkey)
    coins = tuple(np.array(jax.random.uniform(jax.random.fold_in(rkey, i),
                                              (dig.CODES,))) for i in (1, 2))
    keep = np.array(jax.random.uniform(
        jax.random.fold_in(key, 0x6EEA), (t_len * b,),
        minval=jcfg.lidar.vq_keep_min, maxval=1.0))
    draws = dig._jax_draws(jcfg, key, t_len * b)

    net = dig._port_net(TActorCritic, dig._configs("c5", PPO)[1], params)
    adam = opt_state[1][0]
    got = pool.run(
        "ppo_update", cfg_over=list(dig.SMALL) + list(PPO),
        rollout=[np.asarray(x) for x in ro],
        last_value=np.asarray(last_value),
        params={k: v.detach().numpy().copy()
                for k, v in net.state_dict().items()},
        perms=[perm], noises=[[tuple(None if x is None else x.numpy()
                                     for x in draws)]],
        adam=(int(adam.count),
              *({k: v.numpy() for k, v in bridge.to_state_dict(t, net).items()}
                for t in (adam.mu, adam.nu))),
        keep=[[keep]], coins=[[coins]])
    want = bridge.to_state_dict(j_params, net)
    per = net.perception
    before = {n: cb.detach().numpy() for n, cb in (
        ("perception.cam_vq.codebook", per.cam_vq.codebook),
        ("perception.lid_codebook", per.lid_codebook))}
    for rk in got:
        assert rk["equal"]
        _close(rk["metrics"]["loss"], float(loss), "loss")
        for k in ("pg_loss", "v_loss", "entropy"):
            _close(rk["metrics"][k], float(jaux[k]), k)
        for k, w in want.items():
            _close(rk["params"][k], w.numpy(), k)
        for k, old in before.items():
            assert int((np.abs(rk["params"][k] - old).max(1) > 0.05).sum())


# ------------------------------------------- a tensor-parallel PPO run

PPO_TP = ranks.TINY_C4[:-3] + ["rl.num_envs=4", "rl.rollout_length=4",
                               "rl.num_minibatches=2", "rl.ppo_epochs=2"]


def test_tp_ppo_run_resumes_bit_equal_and_loads_on_one_card(pool, tmp_path):
    """``train.ppo.run`` at data 1 x model 2: two updates with a checkpoint
    after each, against one update, a stop and a resume for the second;
    each rank's slices of the network, the EMA and the Adam moments
    bit-equal. The checkpoint holds the single-card layout: one process's
    network restores it, equal to the ranks' slices gathered whole."""
    whole = str(tmp_path / "whole")
    stopped = str(tmp_path / "stopped")
    a = pool.run("ppo_tp_driver", ckpt_dir=whole, steps=2, every=1,
                 cfg_over=PPO_TP)
    pool.run("ppo_tp_driver", ckpt_dir=stopped, steps=1, every=1,
             cfg_over=PPO_TP)
    b = pool.run("ppo_tp_driver", ckpt_dir=stopped, steps=2, every=1,
                 cfg_over=PPO_TP)
    for ra, rb in zip(a, b):
        assert ra["update"] == rb["update"] == 2
        for field in ("params", "ema", "whole"):
            assert ra[field].keys() == rb[field].keys()
            for k, v in ra[field].items():
                np.testing.assert_array_equal(rb[field][k], v,
                                              err_msg=f"{field} {k}")
        assert len(ra["moments"]) == len(rb["moments"]) > 0
        for x, y in zip(ra["moments"], rb["moments"]):
            np.testing.assert_array_equal(x, y)
    # The model ranks hold different slices of the sharded weights.
    sliced = [k for k, v in a[0]["params"].items()
              if v.shape != a[0]["whole"][k].shape]
    assert sliced and any(not np.array_equal(a[0]["params"][k],
                                             a[1]["params"][k])
                          for k in sliced)
    net = TActorCritic(t_preset("c5").override_str(PPO_TP))
    assert CheckpointManager(stopped).restore_params_latest(net) is net
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), b[0]["whole"][k], err_msg=k)
        np.testing.assert_array_equal(v.numpy(), b[1]["whole"][k], err_msg=k)
