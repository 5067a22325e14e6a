"""Three c5 PPO updates in a row against the JAX package on the CPU, held
after each one: GAE, 2 epochs x 2 minibatch steps (clip + Adam, given
permutations and JAX's noise) and the EMA lerp, the Adam state and the
entropy schedule carried from update to update, as ``_update_body``
composes them. The tiny c5 and the helpers are those of
``test_torch_ppo.py``; f32 everywhere, TF32 off. The parameters are held
to 5e-5 absolute (one update: 1e-5, ``test_torch_ppo.py``). Adam steps an
entry by up to lr = 3e-4 whatever its gradient's size, so an entry whose
gradient is no bigger than f32 rounding (a pillar feature that holds a
cell's max by a hair) moves by rounding; over 12 steps the largest such
gap seen is 2.0e-5 (``pfn.fc2.weight``, after the third update). The loss
is held to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

import test_torch_ppo as base
from multimodal_sc_torch import bridge
from multimodal_sc_torch.rl import dqn as tdqn
from multimodal_sc_torch.rl import ppo as tppo
from multimodal_sc_torch.rl.perception import ActorCritic as TActorCritic
from multimodal_sc_tpu.rl import gae as jgae
from multimodal_sc_tpu.rl import ppo as jppo

UPDATES = 3


def _params(jcfg, seed):
    """An ``ActorCritic`` tree of flax's shapes, drawn with numpy (cheaper
    than flax's init): kernels at 1/sqrt(fan_in), LayerNorm scales near 1,
    PReLU slopes near 0.25, the rest small."""
    shapes = jax.eval_shape(lambda: jppo.init_params(jcfg, jax.random.key(0)))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        n = rng.standard_normal(s.shape).astype(np.float32)
        name = jax.tree_util.keystr(path[-1:])
        if "scale" in name:
            return jnp.asarray(1.0 + 0.02 * n)
        if "alpha" in name:
            return jnp.asarray(0.25 + 0.02 * n)
        if len(s.shape) >= 2:
            return jnp.asarray(n / np.sqrt(np.prod(s.shape[:-1])))
        return jnp.asarray(0.02 * n)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def test_three_ppo_updates_follow_jax():
    extra = base.LOSS_CASES["annealed"][0]
    jcfg, tcfg = base._configs(extra + ("train.grad_clip=0.5",))
    r = jcfg.rl
    T, B, MB = base.T, base.B, base.MB
    params = _params(jcfg, 31)
    ema = base._perturb(params, 32, 0.01)
    tx = jppo.make_optimizer(jcfg)
    # A non-trivial Adam state, as the one-update test starts from: from
    # tx.init, the attention key biases (whose gradient is zero but for
    # rounding: softmax ignores a shift shared by every key) would take
    # lr-sized steps in directions set by that rounding.
    _, opt_state = tx.update(base._perturb(params, 34, 1e-3),
                             tx.init(params), params)
    apply = jax.jit(lambda g, o, p: (lambda u, o: (optax.apply_updates(p, u),
                                                   o))(*tx.update(g, o, p)))
    loss_grad = base._jax_loss_grad(extra)
    forward = tdqn.learner_forward(tcfg, TActorCritic)

    state = tppo.init(tcfg, seed=0, device="cpu")
    for net, tree in ((state.params, params), (state.ema_params, ema)):
        net.load_state_dict(bridge.to_state_dict(tree, net))
    adam = opt_state[1][0]
    bridge.load_adam_state(state.opt_state, state.params, int(adam.count),
                           adam.mu, adam.nu)
    rng = np.random.default_rng(33)
    obs = base._rollout(jcfg, seed=40)      # the observations, made once
    a = r.num_actions
    for u in range(UPDATES):
        ro = obs._replace(
            action=jnp.asarray(rng.integers(0, a, (T, B)), jnp.int32),
            logp=jnp.asarray(np.log(1 / a) + 0.3 * rng.standard_normal(
                (T, B)), jnp.float32),
            value=jnp.asarray(rng.standard_normal((T, B)), jnp.float32),
            reward=jnp.asarray(rng.standard_normal((T, B)), jnp.float32),
            done=jnp.asarray(rng.uniform(size=(T, B)) < 0.2))
        last_value = jnp.asarray(rng.standard_normal(B), jnp.float32)
        last_return = jnp.asarray(rng.standard_normal(B) * 5, jnp.float32)
        perms = [rng.permutation(T * B) for _ in range(r.ppo_epochs)]
        keys = [[jax.random.key(1000 * u + 10 * e + i)
                 for i in range(r.num_minibatches)]
                for e in range(r.ppo_epochs)]
        ent = jppo._entropy_coef(jcfg, jnp.int32(u))
        adv, ret = jgae.gae(ro.reward, ro.value, ro.done, last_value, r.gamma,
                            r.gae_lambda)
        flat = base._flat(ro, adv, ret)
        losses = []
        for e in range(r.ppo_epochs):
            for i in range(r.num_minibatches):
                idx = jnp.asarray(perms[e][i * MB:(i + 1) * MB])
                batch = {k: v[idx] for k, v in flat.items()}
                (loss, _), grads = loss_grad(params, batch, keys[e][i], ent)
                params, opt_state = apply(grads, opt_state, params)
                losses.append(float(loss))
        ema = jax.tree_util.tree_map(
            lambda m, p: (1.0 - r.ema_tau) * m + r.ema_tau * p, ema, params)

        state = state._replace(last_return=base._t(last_return))
        draws = tppo.UpdateDraws(
            perms=[torch.tensor(p) for p in perms],
            noise=[[base._jax_noise(jcfg, k, MB) for k in row]
                   for row in keys])
        state, metrics = tppo._update(
            tcfg, state, tppo.Rollout(*(base._t(x) for x in ro)),
            base._t(last_value), forward, draws)
        assert state.update == u + 1
        np.testing.assert_allclose(float(metrics["loss"]), np.mean(losses),
                                   atol=1e-5, rtol=1e-5,
                                   err_msg=f"update {u}")
        np.testing.assert_allclose(float(metrics["entropy_coef"]), float(ent),
                                   rtol=1e-6)
        for net, tree, what in ((state.params, params, "online"),
                                (state.ema_params, ema, "ema")):
            want = bridge.to_state_dict(tree, net)
            for name, p in net.named_parameters():
                np.testing.assert_allclose(
                    p.detach().numpy(), want[name].numpy(), atol=5e-5,
                    err_msg=f"update {u}: {what} {name}")
    adam = opt_state[1][0]
    for p in state.params.parameters():
        assert int(state.opt_state.state[p]["step"]) == int(adam.count) == (
            1 + UPDATES * r.ppo_epochs * r.num_minibatches)
