"""The port's c4 agent over the digital camera link (c4_vq) against the JAX
package on the CPU.

* the camera-VQ ``QNetwork`` given JAX's draws, uncoded, soft-FEC and
  under HARQ (one draw per round), with what JAX's trunk sows (the VQ loss,
  the index error rate, the HARQ accounting) against the port's ``aux``;
* ``_td_loss`` with its VQ term and its gradients, and one learn step with
  the dead-code re-seeding after the optimizer step given JAX's coin;
* the cold-start codebook seeding and the c1_vq -> ``cam_vq`` warm start
  by name;
* the policy sweep's HARQ link accounting on a tiny rollout.

A reduced c4 (fusion dim 32, depth 1, narrow codecs, 16 codes of dimension
8 on the 32x32 camera: 64 tokens, 256 bits, four HARQ blocks); f32, TF32
off. Q, the loss and the gradients are held to 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_sc_torch import bridge
from multimodal_sc_torch.config import get_preset as t_preset
from multimodal_sc_torch.envs import driving as tenv
from multimodal_sc_torch.evaluation import policy_sweep as tsweep
from multimodal_sc_torch.io.checkpoint import CheckpointManager
from multimodal_sc_torch.rl import dqn as tdqn
from multimodal_sc_torch.rl import warmstart as tws
from multimodal_sc_torch.rl.perception import QNetwork as TQNetwork
from multimodal_sc_torch.train import dqn as ttrain
from multimodal_sc_torch.train import jscc as tjscc
# The digital modules build module-level constants: import them before
# any JAX trace reaches their lazy imports in the trunk.
import multimodal_sc_tpu.channel.harq  # noqa: F401
import multimodal_sc_tpu.codec.semantic_vq  # noqa: F401
from multimodal_sc_tpu.config import get_preset as j_preset
from multimodal_sc_tpu.envs import driving as jenv
from multimodal_sc_tpu.evaluation import policy_sweep as jsweep
from multimodal_sc_tpu.rl import dqn as jdqn
from multimodal_sc_tpu.rl.perception import QNetwork as JQNetwork

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

SMALL = ["camera.arch=vq", "camera.features=8,16,32,32", "camera.vq_codes=16",
         "camera.vq_dim=8", "fusion.dim=32", "fusion.depth=1",
         "fusion.heads=2", "fusion.state_dim=32", "lidar.pillar_dim=16",
         "env.lidar_rays=16", "env.num_npcs=3", "rl.replay_capacity=64",
         "rl.n_step=2", "rl.batch_size=8"]
BATCH = 4
N_SYM = 64 * 4 // 2            # 64 tokens of 4 bits, uncoded QPSK
N_LID = 16 * 16 * 4            # the LiDAR link's symbols (bev 16x16, c_sym 4)


def _configs(extra=()):
    over = SMALL + list(extra)
    return j_preset("c4").override_str(over), t_preset("c4").override_str(over)


def _t(x):
    return torch.tensor(np.array(x))


def _perturb(tree, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + scale * jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32)), tree)


def _jax_noise(cfg, key, batch):
    """JAX's draws of the camera link (one per HARQ round under
    ``channel.harq``) and of the LiDAR link, from the trunk's key."""
    k_cam, k_lid = jax.random.split(key)
    ch = cfg.channel
    n_cam = N_SYM * 7 // 4 if ch.fec != "none" else N_SYM
    if ch.harq:
        spb = (ch.harq_block_bits + 8) // 2
        shape = (batch, 256 // ch.harq_block_bits * spb, 2)
        cam = [_t(jax.random.normal(jax.random.fold_in(k_cam, r), shape))
               for r in range(ch.harq_rounds)]
    else:
        cam = _t(jax.random.normal(k_cam, (batch, n_cam, 2)))
    return cam, _t(jax.random.normal(k_lid, (batch, N_LID, 2)))


def _port_net(tcfg, flax_params):
    net = TQNetwork(tcfg)
    net.load_state_dict(bridge.to_state_dict(flax_params, net))
    return net


@functools.lru_cache(maxsize=None)
def _params():
    """A parameter tree of JAX's structure (``eval_shape`` of its init: no
    compile) filled from numpy: kernels at 1/sqrt(fan-in), LayerNorm
    scales near 1, PReLU slopes near 0.25, codes spread at 0.3, the rest
    small."""
    jcfg, _ = _configs()
    shapes = jax.eval_shape(lambda k: jdqn.init_params(jcfg, k),
                            jax.random.key(0))
    rng = np.random.default_rng(1)

    def fill(path, a):
        leaf = jax.tree_util.keystr(path[-1:])[2:-2]
        n = rng.standard_normal(a.shape)
        if leaf in ("kernel", "wq", "wk", "wv", "wo"):
            v = n / np.sqrt(np.prod(a.shape[:-1]))
        elif leaf == "codebook":
            v = 0.3 * n
        elif leaf.endswith("scale"):
            v = 1.0 + 0.02 * n
        elif leaf == "alpha":
            v = 0.25 + 0.02 * n
        else:
            v = 0.02 * n
        return jnp.asarray(v, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=None)
def _obs(key, n=BATCH):
    jcfg, _ = _configs()
    return jax.jit(lambda k: jenv.observe_batch(jcfg.env, jenv.reset_batch(
        jcfg.env, k, n)))(jax.random.key(key))


@pytest.mark.parametrize("link", [
    (), ("channel.fec=hamming74_soft",), ("channel.harq=true",)])
def test_qnetwork_vq_matches_jax_given_its_draws(link):
    """At 0 dB the camera link makes index errors (and HARQ sends again);
    Q and what the trunk returns beside it agree with JAX's."""
    jcfg, tcfg = _configs(link)
    params = _params()
    img, pts, mask = _obs(5)
    key = jax.random.key(6)
    snr = jnp.zeros((BATCH,), jnp.float32)
    want, col = jax.jit(lambda p: JQNetwork(jcfg).apply(
        {"params": p}, img, pts, mask, key, snr_db=snr,
        mutable=["intermediates"]))(params)
    sown = col["intermediates"]["perception"]
    aux = {}
    with torch.no_grad():
        got = _port_net(tcfg, params)(
            _t(img), _t(pts), _t(mask), snr_db=_t(snr),
            channel_noise=_jax_noise(jcfg, key, BATCH), aux=aux)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    names = {"vq_loss": "vq_loss", "index_error_rate": "index_error_rate"}
    if jcfg.channel.harq:
        names.update(harq_syms="harq_syms", harq_rounds="harq_rounds",
                     harq_resid="harq_resid")
        assert float(aux["harq_rounds"]) > 1.0
    assert float(aux["index_error_rate"]) > 0 or jcfg.channel.harq
    for mine, theirs in names.items():
        np.testing.assert_allclose(float(aux[mine]), float(sown[theirs][0]),
                                   atol=1e-6, rtol=1e-6, err_msg=mine)


def _batch(jcfg):
    rng = np.random.default_rng(0)
    (i0, p0, m0), (i1, p1, m1) = _obs(11), _obs(12)
    return jdqn.Transition(
        image=i0, points=p0, mask=m0,
        action=jnp.asarray(rng.integers(0, jcfg.rl.num_actions, BATCH),
                           jnp.int32),
        reward=jnp.asarray(rng.standard_normal(BATCH) * 2.0, jnp.float32),
        done=jnp.asarray(rng.uniform(size=BATCH) < 0.3),
        next_image=i1, next_points=p1, next_mask=m1)


RESEED = ("camera.vq_reseed=0.7", "rl.vq_loss_coef=2.0")


@functools.lru_cache(maxsize=None)
def _jax_td():
    jcfg, _ = _configs(RESEED)
    batch = _batch(jcfg)
    params = _params()
    target = _perturb(params, 2, 0.02)
    key = jax.random.key(21)
    (loss, rs), grads = jax.jit(jax.value_and_grad(
        lambda p: jdqn._td_loss(p, target, batch, key, jcfg),
        has_aux=True))(params)
    return params, target, batch, key, float(loss), rs, grads


def _draws(jcfg, key, coin=None):
    k1, k2, k3 = jax.random.split(key, 3)
    return tdqn.LearnDraws(
        indices=torch.arange(BATCH), snr_db=None,
        noise_online=_jax_noise(jcfg, k1, BATCH),
        noise_target=_jax_noise(jcfg, k2, BATCH),
        noise_double=_jax_noise(jcfg, k3, BATCH), coin=coin)


def test_td_loss_with_the_vq_term_matches_jax():
    """The Huber TD loss plus ``rl.vq_loss_coef`` x the online forward's VQ
    loss, its gradients (the codebook's from the VQ term alone) and the
    re-seeding inputs."""
    jcfg, tcfg = _configs(RESEED)
    params, target, batch, key, want_loss, rs, grads = _jax_td()
    online, target_net = _port_net(tcfg, params), _port_net(tcfg, target)
    aux = {}
    loss = tdqn._td_loss(tcfg, tdqn.learner_forward(tcfg), online,
                         target_net, tdqn.Transition(*(_t(x) for x in batch)),
                         _draws(jcfg, key), aux=aux)
    np.testing.assert_allclose(float(loss.detach()), want_loss, atol=1e-5,
                               rtol=1e-5)
    assert float(aux["vq_loss"]) > 0
    loss.backward()
    want = bridge.to_state_dict(grads, online)
    for name, p in online.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                   atol=1e-5, rtol=1e-3, err_msg=name)
    counts, cands = rs["cam"]
    np.testing.assert_array_equal(aux["vq_counts"].numpy(), np.asarray(counts))
    np.testing.assert_allclose(aux["vq_candidates"].numpy(),
                               np.asarray(cands), atol=1e-6, rtol=1e-5)
    assert int((aux["vq_counts"] == 0).sum()) > 0    # dead codes to re-seed


def test_learn_step_reseeds_dead_codes_after_the_step():
    """One learn step against optax and JAX's re-seeding (coin from
    ``fold_in(fold_in(key(0xD0D0), step), 1)``): the online network, the
    re-seeded codebook rows among it; target and EMA lerp the updated
    weights and keep their own codebooks' dead rows untouched."""
    from multimodal_sc_tpu.rl.perception import apply_codebook_reseed

    jcfg, tcfg = _configs(RESEED)
    params, target, batch, key, want_loss, rs, grads = _jax_td()
    tx = jdqn.make_optimizer(jcfg)
    # A non-trivial optimizer state: one earlier update on other gradients
    # (so Adam does not divide the attention key biases' rounding-level
    # gradients by their own size).
    update = jax.jit(tx.update)
    _, opt_state = update(_perturb(grads, 4, 1e-3), tx.init(params), params)
    updates, _ = update(grads, opt_state, params)
    j_params = optax.apply_updates(params, updates)
    step = 1
    rkey = jax.random.fold_in(jax.random.key(0xD0D0), step)
    j_params = apply_codebook_reseed(jcfg, j_params, rs, rkey)
    coin = _t(jax.random.uniform(jax.random.fold_in(rkey, 1), (16,)))
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
    before = state.params.perception.cam_vq.codebook.detach().clone()
    state, loss = tdqn.learn_step(
        tcfg, state, tdqn.Transition(*(_t(x) for x in batch)),
        _draws(jcfg, key, coin))
    np.testing.assert_allclose(float(loss), want_loss, atol=1e-5, rtol=1e-5)
    for net, tree, what in ((state.params, j_params, "online"),
                            (state.ema_params, j_ema, "ema")):
        want = bridge.to_state_dict(tree, net)
        for name, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       atol=1e-5, err_msg=f"{what} {name}")
    moved = (state.params.perception.cam_vq.codebook.detach()
             - before).abs().amax(dim=1)
    assert int((moved > 0.05).sum()) > 0         # some rows jumped


def test_make_iteration_learns_with_a_vq_camera():
    _, tcfg = _configs(["rl.batch_size=4", "camera.vq_reseed=0.5"])
    state = tdqn.init(tcfg, seed=0, num_envs=2, device="cpu")
    it = tdqn.make_iteration(tcfg, learn=True)
    for _ in range(4):
        state, m = it(state)
    assert state.step >= 1 and torch.isfinite(m["loss"])


def test_cold_start_seeds_the_codebook_from_rendered_observations():
    _, tcfg = _configs()
    net = tdqn.init_params(tcfg, 0, "cpu")
    fresh = net.perception.cam_vq.codebook.detach().clone()
    tws.seed_vq_codebook_params(tcfg, net)
    cb = net.perception.cam_vq.codebook.detach()
    g = torch.Generator().manual_seed(0xC0DE)   # train.seed 0
    img, _, _ = tenv.observe_batch(tcfg.env,
                                   tenv.reset_batch(tcfg.env, 64, g, "cpu"))
    with torch.no_grad():
        z = net.perception.cam_vq.encode_features(img).reshape(-1, 8)
    assert float(torch.cdist(cb, z).min(dim=1).values.max()) < 0.06
    assert not torch.equal(cb, fresh)
    # One iteration (the 2-step window is not full: nothing is learned):
    # the driver seeded the online codebook and the target and EMA copy it.
    state, out = ttrain.run(tcfg.override_str(["train.steps=1"]),
                            num_envs=4, device="cpu")
    seeded = state.params.perception.cam_vq.codebook
    assert not torch.equal(seeded, fresh)
    for other in (state.target_params, state.ema_params):
        assert torch.equal(other.perception.cam_vq.codebook, seeded)
    assert all(np.isfinite(v) for v in out.values()
               if isinstance(v, float))


def test_c1_vq_checkpoint_warm_starts_cam_vq_by_name(tmp_path):
    """The reconstruction codec's ``enc*``, ``to_code`` and ``codebook``
    land in the trunk's ``cam_vq`` by name (no seeding after it: the source
    brought a codebook); target and EMA restart from the warm weights."""
    _, tcfg = _configs()
    src = t_preset("c1").override_str(
        ["camera.arch=vq", "camera.features=8,16,32,32",
         "camera.vq_codes=16", "camera.vq_dim=8"])
    codec = tjscc.create_train_state(src, 3, "cpu")
    CheckpointManager(str(tmp_path)).save(1, codec)
    net = tdqn.init_params(tcfg, 0, "cpu")
    nets = (net, tdqn.init_params(tcfg, 1, "cpu"),
            tdqn.init_params(tcfg, 2, "cpu"))
    tws.warm_start(tcfg, nets, str(tmp_path))
    want = codec.params.state_dict()
    got = net.perception.cam_vq.state_dict()
    assert set(got) == {k for k in want if k.startswith(("enc", "to_code",
                                                         "codebook"))}
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
    for other in nets[1:]:
        for k, v in other.state_dict().items():
            assert torch.equal(v, net.state_dict()[k]), k


def test_policy_sweep_harq_accounting_matches_jax():
    """On a 4-env, 4-step rollout: the rows carry JAX's keys; at 25 dB no
    block fails, so both packages account 4 blocks x 36 symbols, one round
    and no residual failures, every step; at -4 dB the port sends more."""
    over = ("channel.harq=true", "env.max_steps=4")
    jcfg, tcfg = _configs(over)
    params = _params()
    net = _port_net(tcfg, params)
    kw = dict(kinds=("awgn",), num_envs=4)
    want = jsweep.policy_snr_sweep(jcfg, params, jax.random.key(0),
                                   snrs=(25.0,), **kw)["awgn"][0]
    got = tsweep.policy_snr_sweep(tcfg, net, 0, snrs=(25.0, -4.0),
                                  **kw)["awgn"]
    assert set(got[0]) == set(want)
    for k in ("link_syms_per_step", "harq_mean_rounds",
              "harq_residual_fail_rate"):
        np.testing.assert_allclose(got[0][k], want[k], atol=1e-6, err_msg=k)
    assert got[0]["link_syms_per_step"] == 4 * 36
    assert got[1]["link_syms_per_step"] > got[0]["link_syms_per_step"]
    assert got[1]["harq_mean_rounds"] > 1.0
