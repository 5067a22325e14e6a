"""The port's driving env against the JAX package on the CPU.

The port takes its random draws as arguments, so these tests build them
from the JAX package's own keys (mirroring its key splits) and hand them
over; states cross through ``multimodal_sc_torch.bridge``.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sc_torch import bridge
from multimodal_sc_torch.envs import driving as tenv
from multimodal_sc_tpu.config.configs import EnvConfig
from multimodal_sc_tpu.envs import driving as jenv

CFG = EnvConfig(num_npcs=3, image_hw=(16, 16), lidar_rays=16, max_steps=32)
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "env_golden.npz")


def _reset_draws(cfg, key):
    """The values ``jenv.reset(cfg, key)`` draws, as the port's ResetDraws."""
    k_road, k_lane, k_v, k_npc, _ = jax.random.split(key, 5)
    ks, kl, kv = jax.random.split(k_npc, 3)
    n, lanes = cfg.num_npcs, cfg.num_lanes
    vals = (jenv._sample_road(k_road)[None],
            jax.random.randint(k_lane, (1,), 0, lanes),
            jax.random.uniform(k_v, (1,), minval=3.0, maxval=8.0),
            jax.random.uniform(ks, (1, n), minval=jenv.SPAWN_AHEAD_MIN,
                               maxval=jenv.SPAWN_AHEAD_MAX),
            jax.random.randint(kl, (1, n), 0, lanes),
            jax.random.uniform(kv, (1, n), minval=jenv.NPC_V_MIN,
                               maxval=jenv.NPC_V_MAX))
    return tenv.ResetDraws(*(torch.tensor(np.array(v)) for v in vals))


def _step_draws(cfg, state_key):
    """The values ``jenv.step`` draws from ``state_key``, and the env key
    after the step (if not done, if done)."""
    key, k_npc, k_reset = jax.random.split(state_key, 3)
    k_chg, k_dir, k_sp = jax.random.split(k_npc, 3)
    ks_, kl_, kv_ = jax.random.split(k_sp, 3)
    n = cfg.num_npcs
    vals = (jax.random.uniform(k_chg, (1, n)),
            jax.random.uniform(k_dir, (1, n)),
            jax.random.uniform(ks_, (1, n), minval=jenv.SPAWN_AHEAD_MIN,
                               maxval=jenv.SPAWN_AHEAD_MAX),
            jax.random.randint(kl_, (1, n), 0, cfg.num_lanes),
            jax.random.uniform(kv_, (1, n), minval=jenv.NPC_V_MIN,
                               maxval=jenv.NPC_V_MAX))
    npc = tenv.NPCDraws(*(torch.tensor(np.array(v)) for v in vals))
    reset_key = jax.random.split(k_reset, 5)[4]
    return tenv.StepDraws(npc=npc, reset=_reset_draws(cfg, k_reset)), key, reset_key


def _bridged(state):
    return bridge.env_state_from_jax(state, device="cpu")


def test_reset_with_jax_draws_matches_jax():
    key = jax.random.key(9)
    want = jenv.reset(CFG, key)
    got = tenv.reset(CFG, _reset_draws(CFG, key))
    for name in ("ego", "npcs", "road", "t", "fog"):
        np.testing.assert_array_equal(getattr(got, name)[0].numpy(),
                                      np.asarray(getattr(want, name)), name)


@pytest.mark.parametrize("fog", [0.0, 20.0])
def test_observe_matches_jax(fog):
    cfg = EnvConfig(num_npcs=4, image_hw=(32, 32), lidar_rays=64,
                    fog_range=fog)
    states = jenv.reset_batch(cfg, jax.random.key(1), 8)
    # Move along the road so curves, NPC boxes and curbs are in view.
    for t in range(6):
        states, _ = jenv.step_batch(cfg, states, jnp.full((8,), 4 + t % 2))
    j_img, j_pts, j_mask = jenv.observe_batch(cfg, states)
    img, pts, mask = tenv.observe(cfg, _bridged(states))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    np.testing.assert_allclose(pts.numpy(), np.asarray(j_pts), atol=2e-5,
                               rtol=1e-5)
    # Transcendentals (sin/cos/sigmoid) may differ by an ulp between the
    # two CPU backends; a pixel on a hard edge (road, lane marking) could
    # then flip. Every pixel must agree to 1e-5, no exceptions here.
    np.testing.assert_allclose(img.numpy(), np.asarray(j_img), atol=1e-5)


def test_step_with_jax_draws_matches_jax():
    cfg = EnvConfig(num_npcs=4, image_hw=(16, 16), lidar_rays=32,
                    max_steps=5)   # short episodes: the auto-reset runs too
    js = jenv.reset(cfg, jax.random.key(4))
    ts_state = _bridged(js)
    saw_done = False
    for t in range(7):
        action = (3 * t + 1) % 9
        draws, _, _ = _step_draws(cfg, js.key)
        js, jts = jenv.step(cfg, js, jnp.int32(action))
        ts_state, tts = tenv.step(cfg, ts_state, torch.tensor([action]), draws)
        saw_done |= bool(jts.done)
        np.testing.assert_array_equal(tts.done.numpy()[0], np.asarray(jts.done))
        np.testing.assert_allclose(tts.reward.numpy()[0], np.asarray(jts.reward),
                                   atol=1e-5)
        for name in ("ego", "npcs", "road"):
            np.testing.assert_allclose(getattr(ts_state, name)[0].numpy(),
                                       np.asarray(getattr(js, name)),
                                       atol=1e-4, rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(tts.image.numpy()[0], np.asarray(jts.image),
                                   atol=1e-5)
        np.testing.assert_array_equal(tts.mask.numpy()[0], np.asarray(jts.mask))
    assert saw_done


def test_golden_episode():
    """The JAX package's golden episode (tests/data/env_golden.npz),
    reproduced from its seed by feeding the port the same draws."""
    key = jax.random.key(42)
    state = tenv.reset(CFG, _reset_draws(CFG, key))
    env_key = jax.random.split(key, 5)[4]
    rewards, egos, img_sums, pts_sums, hits = [], [], [], [], []
    for t in range(8):
        draws, key_live, key_reset = _step_draws(CFG, env_key)
        state, ts = tenv.step(CFG, state, torch.tensor([t % 9]), draws)
        env_key = key_reset if bool(ts.done[0]) else key_live
        rewards.append(float(ts.reward[0]))
        egos.append(state.ego[0].numpy())
        img_sums.append(float(ts.image.double().sum()))
        pts_sums.append(float(ts.points.double().sum()))
        hits.append(int(ts.mask.sum()))
    g = np.load(GOLDEN)
    np.testing.assert_allclose(rewards, g["rewards"], atol=1e-4)
    np.testing.assert_allclose(np.stack(egos), g["egos"], atol=1e-4)
    np.testing.assert_allclose(img_sums, g["img_sums"], rtol=1e-4)
    np.testing.assert_allclose(pts_sums, g["pts_sums"], rtol=1e-4)
    np.testing.assert_array_equal(hits, g["hit_counts"])


def test_unported_sensors_raise():
    """The front camera and the V2X scan, which raised until they were
    ported, now observe: the shapes JAX gives, finite, RSU rays after the
    ego rays."""
    for cfg in (EnvConfig(camera_mode="front"), EnvConfig(v2x_rays=8)):
        g = torch.Generator().manual_seed(0)
        states = tenv.reset_batch(cfg, 2, g, device="cpu")
        img, pts, mask = tenv.observe(cfg, states)
        assert img.shape == (2, 32, 32, 3)
        assert pts.shape == (2, cfg.lidar_rays + cfg.v2x_rays, 4)
        assert mask.shape == pts.shape[:2]
        assert torch.isfinite(img).all() and torch.isfinite(pts).all()


_MOVE_CFG = EnvConfig(num_npcs=4, image_hw=(8, 8), lidar_rays=8)


@functools.lru_cache(maxsize=None)
def _moved(seed):
    states = jenv.reset_batch(_MOVE_CFG, jax.random.key(seed), 8)
    for t in range(6):
        states, _ = jenv.step_batch(_MOVE_CFG, states,
                                    jnp.full((8,), 4 + t % 2))
    return states


def _moved_states(cfg, seed=1):
    """Eight envs moved along the road (curves, NPCs and curbs in view),
    stepped under one small config and given ``cfg``'s fog."""
    states = _moved(seed)
    return states._replace(fog=jnp.full((8,), cfg.fog_range, jnp.float32))


@pytest.mark.parametrize("fog", [0.0, 20.0])
@pytest.mark.parametrize("mode", ["front", "topdown"])
def test_observe_front_and_v2x_matches_jax(mode, fog):
    """``observe`` with the front camera or the top-down one and 32 RSU
    rays, with and without fog, from the same states: the tolerances of
    ``test_observe_matches_jax``."""
    cfg = EnvConfig(num_npcs=4, image_hw=(32, 32), lidar_rays=64,
                    camera_mode=mode, fog_range=fog, v2x_rays=32)
    states = _moved_states(cfg)
    j_img, j_pts, j_mask = jenv.observe_batch(cfg, states)
    img, pts, mask = tenv.observe(cfg, _bridged(states))
    assert pts.shape == (8, 64 + 32, 4)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    np.testing.assert_allclose(pts.numpy(), np.asarray(j_pts), atol=2e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(img.numpy(), np.asarray(j_img), atol=1e-5)


def test_v2x_scan_matches_jax_and_ignores_fog():
    cfg = EnvConfig(num_npcs=4, lidar_rays=64, v2x_rays=32, fog_range=5.0)
    states = _moved_states(cfg, seed=3)
    j_pts, j_mask = jax.vmap(lambda s: jenv.v2x_scan(cfg, s))(states)
    pts, mask = tenv.v2x_scan(cfg, _bridged(states))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    np.testing.assert_allclose(pts.numpy(), np.asarray(j_pts), atol=2e-5,
                               rtol=1e-5)
    # The RSU sees past the ego's 5 m of visibility.
    assert (pts[..., :2].norm(dim=-1)[mask] > 5.0).any()


def test_render_camera_front_matches_jax():
    cfg = EnvConfig(num_npcs=4, image_hw=(24, 40), camera_mode="front",
                    fog_range=30.0)
    states = _moved_states(cfg, seed=5)
    want = jax.vmap(lambda s: jenv.render_camera_front(cfg, s))(states)
    got = tenv.render_camera_front(cfg, _bridged(states))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
