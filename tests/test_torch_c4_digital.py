"""The port's full-digital agent (c4_digital) against the JAX package on the
CPU: the digital LiDAR link on the control path, for the DQN and the PPO
learners.

* ``QNetwork`` over the CNN camera + the digital LiDAR and over both
  digital links, with the roadside unit's V2X stream on the LiDAR codec,
  each uncoded, soft-FEC and under HARQ, given JAX's draws: Q and what the
  trunk sows, reduced as JAX's consumers reduce it (the VQ losses summed,
  the HARQ symbols summed and the rounds and residual failures averaged
  over the links, the LiDAR re-seeding counts summed over ego and V2X with
  the ego call's candidates);
* the pruned trunk (``lidar.vq_prune``) under a ``lidar_keep`` vector and
  at ``channel.token_keep=0.5`` with ``scatter`` selection;
* ``_td_loss`` with its gradients and one learn step with both codebooks'
  re-seeding given JAX's coins; ``_ppo_loss`` over both digital links with
  its gradients and one minibatch step with its re-seeding;
* the c3_vq_prune -> c4 warm start by name, and the LiDAR codebook seeding;
* ``eval-policy`` deploying a pruned full-digital checkpoint, and JAX's
  config refusals;
* the policy sweep's accounting over three HARQ links (its reduction of
  one forward's entries held to JAX's, a rollout's rows at 25 dB to the
  values JAX's sweep accounts there);
* ``train.dqn.run`` and ``train.ppo.run`` with a checkpoint, resumed bit
  for bit.

A reduced c4 (fusion dim 32, depth 1, narrow codecs, an 8x8 BEV, 16 codes
of dimension 8 on each link: 64 tokens of 4 bits, four HARQ blocks a
link, 16 ego and 8 RSU rays); f32, TF32 off. The JAX parameters are
``eval_shape`` of its init filled from numpy (no compile of the init). Q,
the losses and the gradients are held to 1e-5.
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
from multimodal_sc_torch.evaluation import policy_sweep as tsweep
from multimodal_sc_torch.io.checkpoint import CheckpointManager
from multimodal_sc_torch.rl import dqn as tdqn
from multimodal_sc_torch.rl import ppo as tppo
from multimodal_sc_torch.rl import warmstart as tws
from multimodal_sc_torch.rl.perception import ActorCritic as TActorCritic
from multimodal_sc_torch.rl.perception import LinkDraws
from multimodal_sc_torch.rl.perception import QNetwork as TQNetwork
from multimodal_sc_torch.rl.perception import collect_reseed_stats
from multimodal_sc_torch.train import dqn as tdqn_train
from multimodal_sc_torch.train import fusion_jscc as tfj
from multimodal_sc_torch.train import ppo as tppo_train
# The digital modules build module-level constants: import them before
# any JAX trace reaches their lazy imports in the trunk.
import multimodal_sc_tpu.channel.harq  # noqa: F401
import multimodal_sc_tpu.codec.semantic_vq  # noqa: F401
from multimodal_sc_tpu.config import get_preset as j_preset
from multimodal_sc_tpu.envs import driving as jenv
from multimodal_sc_tpu.rl import dqn as jdqn
from multimodal_sc_tpu.rl import gae as jgae
from multimodal_sc_tpu.rl import ppo as jppo
from multimodal_sc_tpu.rl import perception as jper

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
# The suite runs in several worker processes at once, and torch's intra-op
# threads in one spin against the next's (a sweep test of the port's took
# 25-50x its time alone). One thread each: every worker imports this module
# while it collects, and the port's test files import it for ``flax_like``.
torch.set_num_threads(1)

SMALL = ["camera.features=8,16,32,32", "camera.c_sym=4",
         "camera.vq_codes=16", "camera.vq_dim=8", "fusion.dim=32",
         "fusion.depth=1", "fusion.heads=2", "fusion.state_dim=32",
         "lidar.pillar_dim=16", "lidar.bev_hw=8,8", "lidar.arch=vq",
         "lidar.vq_codes=16", "lidar.vq_dim=8", "env.lidar_rays=16",
         "env.v2x_rays=8", "env.num_npcs=3", "rl.replay_capacity=64",
         "rl.n_step=2", "rl.batch_size=4"]
CAMS = {"cnn": [], "vq": ["camera.arch=vq"]}
LINKS = {"uncoded": [], "soft FEC": ["channel.fec=hamming74_soft"],
         "HARQ": ["channel.harq=true"]}
RESEED = ["camera.vq_reseed=0.7", "lidar.vq_reseed=0.7",
          "lidar.vq_usage_coef=0.05", "rl.vq_loss_coef=2.0"]
PRUNE = ["lidar.vq_prune=true"]
BATCH = 4
N_TOK = 64                      # 8x8 camera tokens, 8x8 BEV tokens
CODES = 16


def _configs(preset="c4", extra=()):
    over = SMALL + list(extra)
    return (j_preset(preset).override_str(over),
            t_preset(preset).override_str(over))


def _t(x):
    return torch.tensor(np.array(x))


def _link(cfg, key, batch):
    """JAX's draws of one digital link (64 tokens of 4 bits) from its key:
    one per HARQ round under ``channel.harq``."""
    ch = cfg.channel
    bits = N_TOK * 4
    if ch.harq:
        spb = (ch.harq_block_bits + 8) // 2
        shape = (batch, bits // ch.harq_block_bits * spb, 2)
        return [_t(jax.random.normal(jax.random.fold_in(key, r), shape))
                for r in range(ch.harq_rounds)]
    n = bits * 7 // 8 if ch.fec != "none" else bits // 2
    return _t(jax.random.normal(key, (batch, n, 2)))


def _jax_draws(cfg, key, batch):
    """JAX's draws of a trunk forward from its key: the camera link's, the
    ego and V2X LiDAR links' and their random prune scores."""
    k_cam, k_ego = jax.random.split(key)
    k_v2x = jax.random.fold_in(k_ego, 0xB2C)
    if cfg.camera.arch == "vq":
        cam = _link(cfg, k_cam, batch)
    else:
        cam = _t(jax.random.normal(
            k_cam, (batch, N_TOK * cfg.camera.c_sym, 2)))

    def scores(k):
        return _t(jax.random.uniform(jax.random.fold_in(k, 88),
                                     (batch, N_TOK)))

    return LinkDraws(camera=cam, lidar=_link(cfg, k_ego, batch),
                     v2x=_link(cfg, k_v2x, batch), lidar_scores=scores(k_ego),
                     v2x_scores=scores(k_v2x))


def _params(preset, extra):
    """The filled tree of ``extra``'s structure: one per camera arch,
    pruning and V2X, whatever the link flags."""
    return _filled_params(preset, tuple(e for e in extra if e.startswith((
        "camera.arch", "lidar.vq_prune", "env.v2x_rays"))))


@functools.lru_cache(maxsize=None)
def _filled_params(preset, structure):
    """``flax_like`` of JAX's init of the preset's network."""
    jcfg, _ = _configs(preset, structure)
    lib = jppo if preset == "c5" else jdqn
    shapes = jax.eval_shape(lambda k: lib.init_params(jcfg, k),
                            jax.random.key(0))
    return flax_like(shapes, 1)


def flax_like(shapes, seed):
    """A tree of ``shapes`` (flax parameter shapes, e.g. ``eval_shape`` of
    an init) drawn with numpy in place of flax's init, which compiles for
    seconds: kernels at 1/sqrt(fan-in), LayerNorm scales near 1, PReLU
    slopes near 0.25, codebooks spread at 0.3, the rest small."""
    rng = np.random.default_rng(seed)

    def fill(path, a):
        leaf = jax.tree_util.keystr(path[-1:])[2:-2]
        n = rng.standard_normal(a.shape)
        if leaf in ("kernel", "wq", "wk", "wv", "wo"):
            v = n / np.sqrt(np.prod(a.shape[:-1]))
        elif leaf.endswith("codebook"):
            v = 0.3 * n
        elif leaf.endswith("scale"):
            v = 1.0 + 0.02 * n
        elif leaf == "alpha":
            v = 0.25 + 0.02 * n
        else:
            v = 0.02 * n
        return jnp.asarray(v, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port_net(cls, tcfg, flax_params):
    net = cls(tcfg)
    net.load_state_dict(bridge.to_state_dict(flax_params, net))
    return net


@functools.lru_cache(maxsize=None)
def _renders():
    """Observations of 16 fresh envs, one render for every test."""
    jcfg, _ = _configs()
    return jax.jit(lambda k: jenv.observe_batch(jcfg.env, jenv.reset_batch(
        jcfg.env, k, 4 * BATCH)))(jax.random.key(5))


def _obs(i):
    """The ``i``-th (0-3) batch of BATCH observations."""
    return tuple(x[i * BATCH:(i + 1) * BATCH] for x in _renders())


def _close(got, want, what, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol, err_msg=what)


def _check_sown(jcfg, tcfg, inter, aux):
    """The port's reduced ``aux`` against JAX's sown entries (``inter``, the
    ``intermediates`` collection), reduced as its consumers reduce them."""
    per = inter["perception"]
    n_links = 3 if jcfg.camera.arch == "vq" else 2
    assert len(per["vq_loss"]) == n_links
    _close(float(aux["vq_loss"]), float(sum(per["vq_loss"])), "vq_loss")
    if jcfg.camera.arch == "vq":
        _close(float(aux["index_error_rate"]),
               float(per["index_error_rate"][0]), "index_error_rate")
    if jcfg.channel.harq:
        assert len(per["harq_syms"]) == n_links
        _close(float(aux["harq_syms"]), float(sum(per["harq_syms"])),
               "harq_syms")
        for k in ("harq_rounds", "harq_resid"):
            _close(float(aux[k]), float(sum(per[k]) / n_links), k)
        assert float(aux["harq_rounds"]) > 1.0
        # What the policy sweep accounts for this forward, as JAX's sweep
        # reduces the sown entries.
        _, stats = tsweep._with_link_stats(tcfg, torch.zeros(BATCH), aux)
        for k, want in (
                ("link_syms_per_step", sum(per["harq_syms"])),
                ("harq_mean_rounds", sum(per["harq_rounds"]) / n_links),
                ("harq_residual_fail_rate",
                 sum(per["harq_resid"]) / n_links)):
            _close(float(stats[k]), float(want), k)
    rs_j = jper.collect_reseed_stats(jcfg, inter)
    rs_t = collect_reseed_stats(tcfg, aux)
    assert set(rs_t) == set(rs_j)
    for name, (counts, cands) in rs_j.items():
        np.testing.assert_array_equal(rs_t[name][0].numpy(),
                                      np.asarray(counts), err_msg=name)
        _close(rs_t[name][1], cands, f"{name} candidates", 1e-6)
    assert int(rs_t["lid"][0].sum()) == 2 * BATCH * N_TOK   # ego + V2X


@pytest.mark.parametrize("link", sorted(LINKS))
@pytest.mark.parametrize("cam", sorted(CAMS))
def test_qnetwork_matches_jax_given_its_draws(cam, link):
    """At 0 dB every digital link makes index errors (and HARQ sends
    again); Q and the reduced sown entries agree with JAX's."""
    extra = tuple(CAMS[cam] + LINKS[link] + RESEED)
    jcfg, tcfg = _configs("c4", extra)
    params = _params("c4", extra)
    img, pts, mask = _obs(0)
    key = jax.random.key(6)
    snr = jnp.zeros((BATCH,), jnp.float32)
    want, col = jax.jit(lambda p: jdqn.QNetwork(jcfg).apply(
        {"params": p}, img, pts, mask, key, snr_db=snr,
        mutable=["intermediates"]))(params)
    aux = {}
    with torch.no_grad():
        got = _port_net(TQNetwork, tcfg, params)(
            _t(img), _t(pts), _t(mask), snr_db=_t(snr),
            channel_noise=_jax_draws(jcfg, key, BATCH), aux=aux)
    _close(got.numpy(), want, "Q")
    _check_sown(jcfg, tcfg, col["intermediates"], aux)


@pytest.mark.parametrize("how", ["lidar_keep", "token_keep 0.5 scatter"])
def test_pruned_trunk_matches_jax(how):
    """The pruned digital LiDAR: untransmitted tokens decode as
    ``lid_mask_embed``; kept at random under a ``lidar_keep`` vector (as
    the learners train it), by the farthest-point order at
    ``channel.token_keep``."""
    extra = tuple(CAMS["vq"] + PRUNE + (
        ["channel.token_keep=0.5"] if how.startswith("token") else []))
    jcfg, tcfg = _configs("c4", extra)
    params = _params("c4", extra)
    img, pts, mask = _obs(0)
    key = jax.random.key(7)
    keep = (jnp.asarray([0.3, 0.55, 0.8, 1.0], jnp.float32)
            if how == "lidar_keep" else None)
    want = jax.jit(lambda p: jdqn.QNetwork(jcfg).apply(
        {"params": p}, img, pts, mask, key, lidar_keep=keep))(params)
    net = _port_net(TQNetwork, tcfg, params)
    with torch.no_grad():
        got = net(_t(img), _t(pts), _t(mask),
                  channel_noise=_jax_draws(jcfg, key, BATCH),
                  lidar_keep=None if keep is None else _t(keep))
        full = net(_t(img), _t(pts), _t(mask),
                   channel_noise=_jax_draws(jcfg, key, BATCH),
                   lidar_keep=torch.ones(BATCH))
    _close(got.numpy(), want, "Q")
    assert (got - full).abs().max() > 1e-3       # pruning changed Q


def _batch(jcfg):
    rng = np.random.default_rng(0)
    (i0, p0, m0), (i1, p1, m1) = _obs(1), _obs(2)
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


TD = tuple(CAMS["vq"] + PRUNE + RESEED)


@functools.lru_cache(maxsize=None)
def _jax_td():
    jcfg, _ = _configs("c4", TD)
    batch = _batch(jcfg)
    params = _params("c4", TD)
    target = _perturb(params, 2, 0.02)
    key = jax.random.key(21)
    (loss, rs), grads = jax.jit(jax.value_and_grad(
        lambda p, t, b: jdqn._td_loss(p, t, b, key, jcfg),
        has_aux=True))(params, target, batch)
    return params, target, batch, key, float(loss), rs, grads


def _learn_draws(jcfg, key, coins=(None, None)):
    k1, k2, k3 = jax.random.split(key, 3)
    keep = jax.random.uniform(jax.random.fold_in(key, 0x6EEA), (BATCH,),
                              minval=jcfg.lidar.vq_keep_min, maxval=1.0)
    return tdqn.LearnDraws(
        indices=torch.arange(BATCH), snr_db=None,
        noise_online=_jax_draws(jcfg, k1, BATCH),
        noise_target=_jax_draws(jcfg, k2, BATCH),
        noise_double=_jax_draws(jcfg, k3, BATCH), coin=coins[0],
        keep=_t(keep), lid_coin=coins[1])


def test_td_loss_matches_jax():
    """The Huber TD loss plus ``rl.vq_loss_coef`` x the summed VQ losses of
    the camera, ego and V2X links, under one keep vector shared by the
    three forwards; its gradients (the codebooks' from the VQ terms alone,
    the mask embedding's through the untransmitted tokens) and both
    codebooks' re-seeding inputs."""
    jcfg, tcfg = _configs("c4", TD)
    params, target, batch, key, want_loss, rs, grads = _jax_td()
    online = _port_net(TQNetwork, tcfg, params)
    target_net = _port_net(TQNetwork, tcfg, target)
    aux = {}
    loss = tdqn._td_loss(tcfg, tdqn.learner_forward(tcfg), online,
                         target_net, tdqn.Transition(*(_t(x) for x in batch)),
                         _learn_draws(jcfg, key), aux=aux)
    _close(float(loss.detach()), want_loss, "loss")
    loss.backward()
    want = bridge.to_state_dict(grads, online)
    for name, p in online.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                   atol=1e-5, rtol=1e-3, err_msg=name)
    assert float(online.perception.lid_mask_embed.grad.abs().max()) > 0
    rs_t = collect_reseed_stats(tcfg, aux)
    for name in ("cam", "lid"):
        np.testing.assert_array_equal(rs_t[name][0].numpy(),
                                      np.asarray(rs[name][0]), err_msg=name)
        _close(rs_t[name][1], rs[name][1], name, 1e-6)
        assert int((rs_t[name][0] == 0).sum()) > 0      # dead codes


def test_learn_step_reseeds_both_codebooks_after_the_step():
    """One learn step against optax and JAX's re-seeding (coins from
    ``fold_in(fold_in(key(0xD0D0), step), 1 | 2)``): the online network with
    both codebooks' re-seeded rows; the EMA lerps the updated weights."""
    jcfg, tcfg = _configs("c4", TD)
    params, target, batch, key, want_loss, rs, grads = _jax_td()
    tx = jdqn.make_optimizer(jcfg)
    update = jax.jit(tx.update)
    _, opt_state = update(_perturb(grads, 4, 1e-3), tx.init(params), params)
    updates, _ = update(grads, opt_state, params)
    j_params = optax.apply_updates(params, updates)
    rkey = jax.random.fold_in(jax.random.key(0xD0D0), 1)
    j_params = jper.apply_codebook_reseed(jcfg, j_params, rs, rkey)
    coins = tuple(_t(jax.random.uniform(jax.random.fold_in(rkey, i),
                                        (CODES,))) for i in (1, 2))
    e = jcfg.rl.ema_tau
    j_ema = jax.tree_util.tree_map(lambda m, p: (1.0 - e) * m + e * p,
                                   params, j_params)

    state = tdqn.init(tcfg, seed=0, num_envs=2, device="cpu")
    for net, tree in ((state.params, params), (state.target_params, target),
                      (state.ema_params, params)):
        net.load_state_dict(bridge.to_state_dict(tree, net))
    adam = opt_state[1][0]
    bridge.load_adam_state(state.opt_state, state.params, int(adam.count),
                           adam.mu, adam.nu)
    per = state.params.perception
    before = [cb.detach().clone() for cb in (per.cam_vq.codebook,
                                             per.lid_codebook)]
    state, loss = tdqn.learn_step(
        tcfg, state, tdqn.Transition(*(_t(x) for x in batch)),
        _learn_draws(jcfg, key, coins))
    _close(float(loss), want_loss, "loss")
    for net, tree, what in ((state.params, j_params, "online"),
                            (state.ema_params, j_ema, "ema")):
        want = bridge.to_state_dict(tree, net)
        for name, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       atol=1e-5, err_msg=f"{what} {name}")
    for cb, old in zip((per.cam_vq.codebook, per.lid_codebook), before):
        moved = (cb.detach() - old).abs().amax(dim=1)
        assert int((moved > 0.05).sum()) > 0       # some rows jumped


# --- c5 PPO over both digital links ------------------------------------------

PPO = ("camera.arch=vq", "env.v2x_rays=0", "rl.num_envs=2",
       "rl.rollout_length=2", "rl.ppo_epochs=1", "rl.num_minibatches=1",
       *PRUNE, *RESEED)
T, B = 2, 2


def test_ppo_loss_and_minibatch_step_match_jax():
    """``_ppo_loss`` over the digital camera and the pruned digital LiDAR,
    its gradients, then one whole update of one minibatch step (GAE, the
    clip and Adam, both codebooks re-seeded with JAX's coins from
    ``fold_in(key, 0xD0D0)``, the EMA lerp) against JAX's composition in
    ``_update_body``'s order."""
    jcfg, tcfg = _configs("c5", PPO)
    r = jcfg.rl
    params = _params("c5", PPO)
    img, pts, mask = _obs(3)
    rng = np.random.default_rng(32)
    a = r.num_actions
    ro = jppo.Rollout(
        image=img.reshape(T, B, *img.shape[1:]),
        points=pts.reshape(T, B, *pts.shape[1:]),
        mask=mask.reshape(T, B, *mask.shape[1:]),
        action=jnp.asarray(rng.integers(0, a, (T, B)), jnp.int32),
        logp=jnp.asarray(np.log(1 / a) + 0.3 * rng.standard_normal((T, B)),
                         jnp.float32),
        value=jnp.asarray(rng.standard_normal((T, B)), jnp.float32),
        reward=jnp.asarray(rng.standard_normal((T, B)), jnp.float32),
        done=jnp.asarray(rng.uniform(size=(T, B)) < 0.2),
        snr_db=jnp.zeros((T, B), jnp.float32))
    last_value = jnp.asarray(rng.standard_normal(B), jnp.float32)
    perm = rng.permutation(T * B)
    key = jax.random.key(33)
    ent = jppo._entropy_coef(jcfg, jnp.int32(0))
    adv, ret = jgae.gae(ro.reward, ro.value, ro.done, last_value, r.gamma,
                        r.gae_lambda)
    flat = {"image": ro.image, "points": ro.points, "mask": ro.mask,
            "action": ro.action, "logp": ro.logp, "adv": adv, "ret": ret,
            "snr": ro.snr_db}
    batch = {k: v.reshape(T * B, *v.shape[2:])[jnp.asarray(perm)]
             for k, v in flat.items()}
    (loss, jaux), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jppo._ppo_loss(p, b, jcfg, key, ent),
        has_aux=True))(params, batch)
    rs = jaux.pop("reseed_stats")
    assert set(rs) == {"cam", "lid"}

    keep = _t(jax.random.uniform(jax.random.fold_in(key, 0x6EEA), (T * B,),
                                 minval=jcfg.lidar.vq_keep_min, maxval=1.0))
    draws = _jax_draws(jcfg, key, T * B)
    net = _port_net(TActorCritic, tcfg, params)
    forward = tdqn.learner_forward(tcfg, TActorCritic)
    got, taux = tppo._ppo_loss(tcfg, forward, net,
                               {k: _t(v) for k, v in batch.items()},
                               float(ent), channel_noise=draws, keep=keep)
    _close(float(got.detach()), float(loss), "loss")
    for k in ("pg_loss", "v_loss", "entropy"):
        _close(float(taux[k].detach()), float(jaux[k]), k)
    got.backward()
    want = bridge.to_state_dict(grads, net)
    for name, p in net.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5,
                                   rtol=1e-3, err_msg=name)

    # A non-trivial Adam state (one earlier update on other gradients), so
    # Adam does not divide rounding-level gradients by their own size.
    tx = jppo.make_optimizer(jcfg)
    update = jax.jit(tx.update)
    _, opt_state = update(_perturb(grads, 34, 1e-3), tx.init(params), params)
    updates, _ = update(grads, opt_state, params)
    rkey = jax.random.fold_in(key, 0xD0D0)
    j_params = jper.apply_codebook_reseed(
        jcfg, optax.apply_updates(params, updates), rs, rkey)
    coins = tuple(_t(jax.random.uniform(jax.random.fold_in(rkey, i),
                                        (CODES,))) for i in (1, 2))
    j_ema = jax.tree_util.tree_map(
        lambda m, p: (1.0 - r.ema_tau) * m + r.ema_tau * p, params, j_params)

    state = tppo.init(tcfg, seed=0, device="cpu")
    for tnet in (state.params, state.ema_params):
        tnet.load_state_dict(bridge.to_state_dict(params, tnet))
    adam = opt_state[1][0]
    bridge.load_adam_state(state.opt_state, state.params, int(adam.count),
                           adam.mu, adam.nu)
    per = state.params.perception
    before = [cb.detach().clone() for cb in (per.cam_vq.codebook,
                                             per.lid_codebook)]
    state, metrics = tppo._update(
        tcfg, state, tppo.Rollout(*(_t(x) for x in ro)), _t(last_value),
        forward, tppo.UpdateDraws(perms=[torch.tensor(perm)],
                                  noise=[[draws]], keep=[[keep]],
                                  coins=[[coins]]))
    _close(float(metrics["loss"]), float(loss), "update loss")
    for tnet, tree, what in ((state.params, j_params, "online"),
                             (state.ema_params, j_ema, "ema")):
        want = bridge.to_state_dict(tree, tnet)
        for name, p in tnet.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       atol=1e-5, err_msg=f"{what} {name}")
    for cb, old in zip((per.cam_vq.codebook, per.lid_codebook), before):
        assert int(((cb.detach() - old).abs().amax(1) > 0.05).sum()) > 0


# --- warm start, seeding, the sweep, the drivers ------------------------------

def test_c3_vq_prune_checkpoint_warm_starts_the_digital_trunk(tmp_path):
    """A c3_vq_prune codec's LiDAR half lands in the pruned digital trunk by
    name (``to_code``, ``codebook``, ``from_code``, ``mask_embed`` ->
    ``lid_*``) in JAX's order, its ViT camera is skipped by name, and only
    the camera codebook, which did not come over, is seeded; target and
    EMA restart from the warm weights."""
    src = t_preset("c3").override_str(
        ["camera.dim=32", "camera.depth=1", "camera.heads=2",
         "lidar.pillar_dim=16", "lidar.bev_hw=8,8", "lidar.arch=vq",
         "lidar.vq_codes=16", "lidar.vq_dim=8", "lidar.vq_prune=true"])
    codec = tfj.create_train_state(src, 3, "cpu")
    CheckpointManager(str(tmp_path)).save(1, codec)
    _, tcfg = _configs("c4", tuple(CAMS["vq"] + PRUNE))
    nets = tuple(tdqn.init_params(tcfg, s, "cpu") for s in range(3))
    fresh_cam = nets[0].perception.cam_vq.codebook.detach().clone()
    with pytest.warns(UserWarning, match=r"skipped \['cam_enc'\]"):
        _, loaded = tws.load_jscc_into_perception(
            tcfg, nets[1], str(tmp_path), return_loaded=True)
    assert loaded == ["pfn", "lid_backbone", "lid_dec", "lid_to_code",
                      "lid_codebook", "lid_from_code", "lid_mask_embed"]
    with pytest.warns(UserWarning):
        tws.warm_start(tcfg, nets, str(tmp_path))
    want = codec.params.state_dict()
    per = nets[0].perception.state_dict()
    for dst, name in (("lid_to_code", "to_code"), ("lid_from_code",
                                                    "from_code"),
                      ("lid_backbone", "backbone"), ("pfn", "pfn"),
                      ("lid_dec", "dec_backbone")):
        for k, v in per.items():
            if k.startswith(dst + "."):
                assert torch.equal(v, want[f"lidar.{name}" + k[len(dst):]]), k
    for dst, name in (("lid_codebook", "codebook"),
                      ("lid_mask_embed", "mask_embed")):
        assert torch.equal(per[dst], want[f"lidar.{name}"]), dst
    assert not torch.equal(per["cam_vq.codebook"], fresh_cam)   # seeded
    for other in nets[1:]:
        for k, v in other.state_dict().items():
            assert torch.equal(v, nets[0].state_dict()[k]), k


def test_lidar_codebook_seeds_from_the_ego_features():
    """The cold seeding samples the LiDAR codebook from ``lid_to_code``'s
    outputs on the ego rays of 64 rendered observations (plus 0.01 jitter),
    and seeds the camera codebook from the same render."""
    _, tcfg = _configs("c4", tuple(CAMS["vq"]))
    net = tdqn.init_params(tcfg, 0, "cpu")
    per = net.perception
    fresh = per.lid_codebook.detach().clone()
    tws.seed_vq_codebook_params(tcfg, net)
    g = torch.Generator().manual_seed(0xC0DE)      # train.seed 0
    img, pts, mask = tenv.observe_batch(
        tcfg.env, tenv.reset_batch(tcfg.env, 64, g, "cpu"))
    r = tcfg.env.lidar_rays
    with torch.no_grad():
        bev = per.lid_backbone(per.pfn(pts[:, :r], mask[:, :r]))
        z = torch.nn.functional.linear(
            bev, per.lid_to_code.weight[:, :, 0, 0],
            per.lid_to_code.bias).reshape(-1, 8)
        z_cam = per.cam_vq.encode_features(img).reshape(-1, 8)
    cb = per.lid_codebook.detach()
    assert not torch.equal(cb, fresh)
    for book, feats in ((cb, z), (per.cam_vq.codebook.detach(), z_cam)):
        assert float(torch.cdist(book, feats).min(dim=1).values.max()) < 0.06


def test_policy_sweep_accounts_three_harq_links():
    """On a 4-env, 4-step rollout of the full-digital agent with V2X under
    HARQ: the rows carry JAX's keys; at 25 dB no block fails, so the port
    accounts, as JAX's sweep does, 3 links x 4 blocks x 36 symbols, one
    round and no residual failure, every step; at -4 dB it sends more.
    (The reduction over the links is held to JAX's sown entries, forward
    by forward, in ``test_qnetwork_matches_jax_given_its_draws``.)"""
    extra = tuple(CAMS["vq"] + ["channel.harq=true", "env.max_steps=4"])
    _, tcfg = _configs("c4", extra)
    net = _port_net(TQNetwork, tcfg, _params("c4", extra))
    got = tsweep.policy_snr_sweep(tcfg, net, 0, snrs=(25.0, -4.0),
                                  kinds=("awgn",), num_envs=4)["awgn"]
    assert set(got[0]) == {
        "snr_db", "episode_return_mean", "episode_return_std",
        "episodes_terminated_frac", "reward_per_step", "link_syms_per_step",
        "harq_mean_rounds", "harq_residual_fail_rate"}
    assert got[0]["link_syms_per_step"] == 3 * 4 * 36
    assert got[0]["harq_mean_rounds"] == 1.0
    assert got[0]["harq_residual_fail_rate"] == 0.0
    assert got[1]["link_syms_per_step"] > got[0]["link_syms_per_step"]
    assert got[1]["harq_mean_rounds"] > 1.0


def _same_state(a, b):
    for x, y in ((a.params, b.params), (a.ema_params, b.ema_params)):
        for (name, p), q in zip(x.state_dict().items(),
                                y.state_dict().values()):
            assert torch.equal(p, q), name


@pytest.mark.parametrize("algo", ["dqn", "ppo"])
def test_train_run_resumes_bit_equal(algo, tmp_path):
    """The drivers train the full-digital agent (both codebooks seeded
    cold, re-seeded as they learn); a run stopped at its checkpoint and
    resumed ends bit-equal to one that ran straight through."""
    if algo == "dqn":
        extra = ["rl.num_envs=4", "env.max_steps=4"]
        preset, run, steps = "c4", tdqn_train.run, 3
    else:
        extra = ["env.v2x_rays=0", "rl.num_envs=2", "rl.rollout_length=2",
                 "rl.ppo_epochs=1", "rl.num_minibatches=2",
                 "env.max_steps=4"]
        preset, run, steps = "c5", tppo_train.run, 2
    _, tcfg = _configs(preset, tuple(CAMS["vq"] + RESEED + extra))
    straight, out = run(tcfg.override_str([f"train.steps={steps}"]),
                        device="cpu")
    assert all(np.isfinite(v) for v in out.values() if isinstance(v, float))
    ck = [f"train.checkpoint_dir={tmp_path}", "train.checkpoint_every=1"]
    run(tcfg.override_str(ck + [f"train.steps={steps - 1}"]), device="cpu")
    resumed, _ = run(tcfg.override_str(ck + [f"train.steps={steps}"]),
                     device="cpu")
    if algo == "dqn":
        assert straight.step == resumed.step == steps - 1
    _same_state(straight, resumed)


def test_eval_policy_deploys_a_pruned_full_digital_checkpoint(tmp_path,
                                                             capsys):
    """``eval-policy`` on a pruned full-digital checkpoint: at every token,
    at half of them by the farthest-point order, at a quarter at random,
    soft-coded; HARQ with pruning and a damage selection rule are refused
    as the JAX package's config validation refuses them."""
    over = SMALL + CAMS["vq"] + PRUNE + [
        "rl.num_envs=4", "env.max_steps=4", "train.steps=2",
        "train.checkpoint_every=2", f"train.checkpoint_dir={tmp_path}"]
    tdqn_train.run(t_preset("c4").override_str(over), device="cpu")
    argv = ["--config", "c4", "--device", "cpu", "--episodes", "4",
            "--use-ema"] + [a for o in over for a in ("--set", o)]

    def deploy(*flags):
        return argv + [a for o in flags for a in ("--set", o)]

    for flags in ((), ("channel.token_keep=0.5",),
                  ("channel.token_keep=0.25", "channel.token_select=random"),
                  ("channel.fec=hamming74_soft",)):
        assert teval.main(deploy(*flags)) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert np.isfinite(out["episode_return_mean"]), flags
    with pytest.raises(ValueError, match="harq with token pruning"):
        teval.main(deploy("channel.harq=true"))
    with pytest.raises(ValueError, match="content-free selection"):
        teval.main(deploy("channel.token_keep=0.5",
                          "channel.token_select=drop_damage"))
