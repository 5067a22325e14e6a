"""``train.bf16`` on the RL paths over the VQ codecs and on c5's ViT
trunk, against the JAX package's bf16 run on the CPU:

* c4_digital's TD loss (the VQ camera and the pruned VQ LiDAR, both
  codebooks re-seeded, the online, target and double forwards) and c5
  digital's PPO loss, with their gradients, under ``close_grads`` with
  JAX's codes held (``_JaxCodes``, ``_HeldCodes``);
* c5's PPO loss and gradients on the ViT trunk (its attention plain).

The rules, the tolerances and the near-tie bound of a held code are
``test_torch_bf16_vq.py``'s; JAX runs its XLA route, its bf16 runs
compiled without excess precision.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from multimodal_sc_torch.rl import dqn as tdqn
from multimodal_sc_torch.rl import ppo as tppo
from multimodal_sc_torch.rl.perception import ActorCritic as TActorCritic
from multimodal_sc_torch.rl.perception import QNetwork as TQNetwork
from multimodal_sc_tpu.rl import dqn as jdqn
from multimodal_sc_tpu.rl import ppo as jppo
from test_torch_bf16 import close_grads
from test_torch_bf16_slice import RL_LOSS, _by_name, _noise, _port_grads
from test_torch_bf16_vq import (DIGITAL, _all_bf16, _exact_jit, _held_grads,
                                _load, _loss_close, _pair, _t)
from test_torch_c4_digital import (_batch, _jax_draws, _learn_draws, _obs,
                                   _perturb, flax_like)
from test_torch_c4_digital import _configs as _digital_configs
from test_torch_c4_digital import _params as _digital_params

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def test_c4_digital_td_loss_and_gradients_bf16_match_jax():
    """The Huber TD loss plus the summed VQ losses of the camera and LiDAR
    links of the online forward, over the online, target and double
    forwards (six nearest-code searches, all held)."""
    jcfg, tcfg = _digital_configs("c4", DIGITAL)
    jcfg32 = _digital_configs("c4", DIGITAL[:-1])[0]
    params = _digital_params("c4", DIGITAL)
    target = _perturb(params, 2, 0.02)
    batch = _batch(jcfg)
    key = jax.random.key(21)
    ((loss, _), grads), ((loss32, _), exact), held = _held_grads(
        lambda p: jdqn._td_loss(p, target, batch, key, jcfg),
        lambda p: jdqn._td_loss(p, target, batch, key, jcfg32), params)
    online = _load(TQNetwork(tcfg), params)
    target_net = _load(TQNetwork(tcfg), target)
    _all_bf16(online.perception)
    tloss = held.run(tdqn._td_loss, tcfg, tdqn.learner_forward(tcfg), online,
                     target_net, tdqn.Transition(*(_t(x) for x in batch)),
                     _learn_draws(jcfg, key))
    assert held.i == 6 and tloss.dtype == torch.float32
    _loss_close(tloss, loss, loss32, "loss")
    tloss.backward()
    close_grads(_port_grads(online), _by_name(online, grads),
                _by_name(online, exact), after_max=["perception.pfn."])


T, B = 2, 2


def _ppo_batch(jcfg, seed):
    img, pts, mask = _obs(3)
    rng = np.random.default_rng(seed)
    n, a = T * B, jcfg.rl.num_actions
    return {"image": img[:n], "points": pts[:n], "mask": mask[:n],
            "action": jnp.asarray(rng.integers(0, a, n), jnp.int32),
            "logp": jnp.asarray(np.log(1 / a) + 0.3 * rng.standard_normal(n),
                                jnp.float32),
            "adv": jnp.asarray(rng.standard_normal(n) * 3 + 1, jnp.float32),
            "ret": jnp.asarray(rng.standard_normal(n), jnp.float32),
            "snr": jnp.full((n,), jcfg.channel.snr_db, jnp.float32)}


def test_c5_digital_ppo_loss_and_gradients_bf16_match_jax():
    jcfg, tcfg = _digital_configs("c5", DIGITAL)
    jcfg32 = _digital_configs("c5", DIGITAL[:-1])[0]
    params = _digital_params("c5", DIGITAL)
    batch = _ppo_batch(jcfg, 32)
    key = jax.random.key(33)
    ent = float(jppo._entropy_coef(jcfg, jnp.int32(0)))
    ((loss, aux), grads), ((loss32, aux32), exact), held = _held_grads(
        lambda p: jppo._ppo_loss(p, batch, jcfg, key, ent),
        lambda p: jppo._ppo_loss(p, batch, jcfg32, key, ent), params)
    keep = _t(jax.random.uniform(jax.random.fold_in(key, 0x6EEA), (T * B,),
                                 minval=jcfg.lidar.vq_keep_min, maxval=1.0))
    net = _load(TActorCritic(tcfg), params)
    _all_bf16(net.perception)
    got, taux = held.run(
        tppo._ppo_loss, tcfg, tdqn.learner_forward(tcfg, TActorCritic), net,
        {k: _t(v) for k, v in batch.items()}, ent,
        channel_noise=_jax_draws(jcfg, key, T * B), keep=keep)
    assert held.i == 2
    _loss_close(got, loss, loss32, "loss")
    for k in ("pg_loss", "v_loss", "entropy"):
        _loss_close(taux[k], aux[k], aux32[k], k)
    got.backward()
    close_grads(_port_grads(net), _by_name(net, grads), _by_name(net, exact),
                after_max=["perception.pfn."])




# --- (e) c5 on the ViT trunk -------------------------------------------------

VIT_C5 = RL_LOSS + ["camera.arch=vit", "camera.depth=1", "camera.dim=32",
                    "camera.heads=2"]


def test_c5_vit_ppo_loss_and_gradients_bf16_match_jax():
    """The PPO loss over the ViT camera (its attention plain) in bf16."""
    jcfg, tcfg = _pair("c5", VIT_C5)
    params = flax_like(jax.eval_shape(lambda k: jppo.init_params(jcfg, k),
                                      jax.random.key(0)), 1)
    batch = _ppo_batch(jcfg, 60)
    key = jax.random.key(61)
    ent = float(jppo._entropy_coef(jcfg, jnp.int32(0)))

    def grad(cfg):
        return _exact_jit(jax.value_and_grad(
            lambda p: jppo._ppo_loss(p, batch, cfg, key, ent),
            has_aux=True))(params)

    (loss, aux), grads = grad(jcfg)
    (loss32, aux32), exact = grad(_pair("c5", VIT_C5, False)[0])
    net = _load(TActorCritic(tcfg), params)
    _all_bf16(net.perception)
    got, taux = tppo._ppo_loss(tcfg, tdqn.learner_forward(tcfg, TActorCritic),
                               net, {k: _t(v) for k, v in batch.items()}, ent,
                               channel_noise=_noise(jcfg, key, T * B))
    _loss_close(got, loss, loss32, "loss")
    for k in ("pg_loss", "v_loss", "entropy"):
        _loss_close(taux[k], aux[k], aux32[k], k)
    got.backward()
    close_grads(_port_grads(net), _by_name(net, grads), _by_name(net, exact),
                after_max=["perception.pfn."])
