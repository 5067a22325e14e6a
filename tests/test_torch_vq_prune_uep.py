"""Token pruning and semantic unequal power allocation (UEP) of the port's
digital codecs against the JAX package on the CPU.

* ``farthest_point_order`` (square and non-square grids) and ``topk_mask``
  on tied scores: equal;
* ``waterfill_power`` within 1e-5 of JAX's, with JAX's KKT properties (the
  budget exact, equal marginals on the active set);
* the camera's ``token_damage`` / ``token_drop_damage`` and the BEV
  codec's ``token_drop_damage`` given JAX's VJP probes: within 1e-4 of
  the largest entry; ``uep_weights`` (alpha, and water-filling under each
  FEC) within 1e-5;
* ``VQCameraJSCC`` pruned under each of the five selection rules and under
  UEP (alpha, water-filling), and ``LidarBEVVQCodec`` under each of its
  four rules with re-seeding on, FEC none and soft, all given JAX's draws:
  the codes exact, the reconstruction or logits and the aux within 1e-5.

Small shapes: 16x16 images (16 tokens), an 8x8 BEV from 64 points (64
tokens), 16 codes of dimension 8 (256 under FEC on the BEV), batch 2;
f32, TF32 off.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sc_torch import bridge
from multimodal_sc_torch.codec import lidar_bev as tlid
from multimodal_sc_torch.codec import semantic_vq as tvq
from multimodal_sc_torch.config import get_preset as t_preset
from multimodal_sc_torch.train import jscc as tjscc
from multimodal_sc_tpu.codec import lidar_bev as jlid
from multimodal_sc_tpu.codec import semantic_vq as jvq
from multimodal_sc_tpu.config import get_preset as j_preset
from multimodal_sc_tpu.train import jscc as jjscc

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

VQ = ["camera.arch=vq", "camera.image_hw=16,16", "camera.features=8,8,16,16",
      "camera.vq_codes=16", "camera.vq_dim=8", "train.batch_size=2"]
BATCH, N_TOK = 2, 16
KEEP = np.array([0.3, 0.8], np.float32)


def _t(x):
    return torch.tensor(np.array(x))


def _perturb(tree, seed, scale=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + scale * jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32)), tree)


def _close(got, want, what="", tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol, err_msg=what)


# --- the selection scores and the allocator ---------------------------------

@pytest.mark.parametrize("hw", [(8, 8), (4, 6), (1, 5)])
def test_farthest_point_order_equals_jax(hw):
    got = tvq.farthest_point_order(*hw)
    np.testing.assert_array_equal(got, jvq.farthest_point_order(*hw))
    assert tvq.farthest_point_order(*hw) is got and not got.flags.writeable


@pytest.mark.parametrize("m", [[0, 16], [5, 9], [11, 3]])
def test_topk_mask_equals_jax_on_ties(m):
    scores = np.random.default_rng(1).integers(0, 4, (2, 16)).astype(
        np.float32)
    want = jvq.topk_mask(jnp.asarray(scores), jnp.asarray(m))
    got = tvq.topk_mask(torch.from_numpy(scores), torch.tensor(m))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_waterfill_equals_jax_with_its_kkt_properties():
    d = np.exp(np.random.default_rng(2).standard_normal((4, 64)) * 1.5
               ).astype(np.float32)
    for snr in (-5.0, 0.0, 5.0, 25.0, np.array([-5.0, 0.0, 10.0, 25.0],
                                                np.float32)):
        want = jvq.VQCameraJSCC.waterfill_power(jnp.asarray(d), snr)
        got = tvq.waterfill_power(torch.from_numpy(d), torch.as_tensor(snr))
        _close(got, want, f"snr {snr}")
        _close(got.mean(1), np.ones(4), "budget")
        assert bool((got >= 0).all())
    s = 1.0                                     # 0 dB
    w2 = tvq.waterfill_power(torch.from_numpy(d), 0.0).numpy()
    marg = (s / 2.0) * d * np.exp(-s * w2 / 2.0)
    for b in range(4):
        active = w2[b] > 1e-4
        assert active.sum() >= 2
        assert marg[b][active].std() / marg[b][active].mean() < 1e-3


# --- the camera codec -------------------------------------------------------

def _cam_configs(extra=()):
    over = VQ + list(extra)
    return j_preset("c1").override_str(over), t_preset("c1").override_str(over)


@functools.lru_cache(maxsize=None)
def _cam_params():
    """A pruned model's parameters (the UEP models take them without
    ``mask_embed``)."""
    jcfg, _ = _cam_configs(["camera.vq_prune=true"])
    model = jjscc.build_model(jcfg)
    params = jax.jit(lambda k: model.init(
        k, jnp.zeros((BATCH, 16, 16, 3)), jnp.full((BATCH,), 10.0),
        jax.random.key(0))["params"])(jax.random.key(3))
    return _perturb(params, 4)


def _cam(extra):
    jcfg, tcfg = _cam_configs(extra)
    params = dict(_cam_params())
    if not jcfg.camera.vq_prune:
        params.pop("mask_embed")
    tm = tjscc.build_model(tcfg)
    tm.load_state_dict(bridge.to_state_dict(params, tm))
    return jcfg, jjscc.build_model(jcfg), params, tm


def _img(seed=5):
    return np.random.default_rng(seed).uniform(
        0, 1, (BATCH, 16, 16, 3)).astype(np.float32)


def _idx(model, params, img):
    return model.apply({"params": params}, jnp.asarray(img),
                       method="encode_tokens")[0]


def _probes(key, shape):
    return jax.random.normal(key, (2, BATCH) + shape, jnp.float32)


@pytest.mark.parametrize("method", ["token_damage", "token_drop_damage"])
def test_camera_damage_matches_jax_given_its_probes(method):
    jcfg, model, params, tm = _cam(["camera.vq_prune=true"])
    idx = _idx(model, params, _img())
    key = jax.random.key(6)
    want = model.apply({"params": params}, idx, key, method=method)
    got = getattr(tm, method)(_t(idx), _t(_probes(key, (16, 16, 3))))
    assert got.shape == (BATCH, N_TOK) and not got.requires_grad
    _close(got, want, method, tol=1e-4 * float(jnp.max(want)))
    assert all(p.grad is None for p in tm.parameters())


@pytest.mark.parametrize("mode,fec", [("alpha", "none"),
                                      ("waterfill", "none"),
                                      ("waterfill", "hamming74"),
                                      ("waterfill", "hamming74_soft")])
def test_uep_weights_match_jax(mode, fec):
    jcfg, model, params, tm = _cam([
        "channel.uep_alpha=" + ("0.25" if mode == "alpha" else "1"),
        f"channel.uep_mode={mode}", f"channel.fec={fec}"])
    idx = _idx(model, params, _img())
    key = jax.random.key(7)
    snr = jnp.asarray([0.0, 5.0], jnp.float32)
    want = model.apply({"params": params}, idx, snr, key,
                       method="uep_weights")
    got = tm.uep_weights(_t(idx), _t(snr), _t(_probes(key, (16, 16, 3))))
    _close(got, want, f"{mode} {fec}")
    _close(got.square().mean(1), np.ones(BATCH), "unit mean power")


def _jax_forward(model, params, img, snr, key, **kw):
    return jax.jit(lambda p, i, s, k: model.apply(
        {"params": p}, i, s, k, **kw))(params, jnp.asarray(img), snr, key)


@pytest.mark.parametrize("select", ["scatter", "random", "drop_damage",
                                    "drop_damage_scatter", "damage"])
def test_pruned_camera_forward_matches_jax(select):
    """Kept fractions 0.3 and 0.8 at 2 dB: the kept set, the reconstruction
    (dropped tokens decoded as ``mask_embed``) and the aux."""
    jcfg, model, params, tm = _cam(["camera.vq_prune=true"])
    img = _img(8)
    snr = jnp.full((BATCH,), 2.0, jnp.float32)
    key = jax.random.key(9)
    jrec, jaux = _jax_forward(model, params, img, snr, key,
                              keep=jnp.asarray(KEEP), select=select)
    k88 = jax.random.fold_in(key, 88)
    draws = (jax.random.uniform(k88, (BATCH, N_TOK)) if select == "random"
             else _probes(k88, (16, 16, 3)))
    rec, aux = tm(_t(img), _t(snr), noise=_t(jax.random.normal(
        key, (BATCH, N_TOK * 2, 2))), keep=_t(KEEP), select=select,
        select_draws=None if select == "scatter" else _t(draws))
    assert set(aux) == set(jaux)
    _close(rec.detach(), jrec, "recon")
    for k in jaux:
        _close(float(aux[k].detach()), float(jaux[k]), k)
    assert float(aux["token_keep_frac"]) == (5 + 13) / 32


@pytest.mark.parametrize("mode", ["alpha", "waterfill"])
def test_uep_camera_forward_matches_jax(mode):
    jcfg, model, params, tm = _cam([
        "channel.uep_alpha=" + ("0.25" if mode == "alpha" else "1"),
        f"channel.uep_mode={mode}"])
    img = _img(10)
    snr = jnp.asarray([0.0, 4.0], jnp.float32)
    key = jax.random.key(11)
    jrec, jaux = _jax_forward(model, params, img, snr, key)
    rec, aux = tm(_t(img), _t(snr), noise=_t(jax.random.normal(
        key, (BATCH, N_TOK * 2, 2))), uep_draws=_t(_probes(
            jax.random.fold_in(key, 77), (16, 16, 3))))
    assert set(aux) == set(jaux) and "uep_power_spread" in aux
    assert float(aux["index_error_rate"]) > 0
    _close(rec.detach(), jrec, "recon")
    for k in jaux:
        _close(float(aux[k].detach()), float(jaux[k]), k)


# --- the BEV codec ----------------------------------------------------------

LID = dict(pillar_dim=16, bev_hw=(8, 8), vq_codes=16, vq_dim=8,
           vq_usage_coef=0.25, vq_reseed=0.5, vq_prune=True, seg_classes=4)


def _points(seed=12, n=64):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-4, 52, (BATCH, n)),
                    rng.uniform(-14, 14, (BATCH, n)),
                    rng.uniform(0, 1.8, (BATCH, n)),
                    rng.uniform(0, 1, (BATCH, n))], -1).astype(np.float32)
    return pts, rng.uniform(0, 1, (BATCH, n)) < 0.9


@functools.lru_cache(maxsize=None)
def _bev(fec="none"):
    """The BEV codec under ``fec``; with FEC 256 codes (8 bits a token), as
    whole QPSK symbols a token need (7 coded bits are 3.5 symbols)."""
    jch = j_preset("c3").override_str([f"channel.fec={fec}"]).channel
    tch = t_preset("c3").override_str([f"channel.fec={fec}"]).channel
    lid = {**LID, "vq_codes": 16 if fec == "none" else 256}
    jm = jlid.LidarBEVVQCodec(channel_cfg=jch, **lid)
    pts, mask = _points()
    params = jax.jit(lambda k: jm.init(
        k, jnp.asarray(pts), jnp.asarray(mask), jnp.full((BATCH,), 10.0),
        jax.random.key(0))["params"])(jax.random.key(13))
    params = _perturb(params, 14, 0.05)
    tm = tlid.LidarBEVVQCodec(channel_cfg=tch, **lid)
    tm.load_state_dict(bridge.to_state_dict(params, tm))
    return jm, params, tm


def test_bev_codes_and_drop_damage_match_jax_given_its_probes():
    jm, params, tm = _bev()
    pts, mask = _points()
    idx = jm.apply({"params": params}, jnp.asarray(pts), jnp.asarray(mask),
                   method="encode_tokens")[0]
    np.testing.assert_array_equal(
        tm.encode_tokens(_t(pts), _t(mask))[0].numpy(), np.asarray(idx))
    key = jax.random.key(15)
    want = jm.apply({"params": params}, idx, key, method="token_drop_damage")
    got = tm.token_drop_damage(_t(idx), _t(_probes(key, (8, 8, 4))))
    _close(got, want, "drop damage", tol=1e-4 * float(jnp.max(want)))


@pytest.mark.parametrize("fec", ["none", "hamming74_soft"])
@pytest.mark.parametrize("select", ["scatter", "random", "drop_damage",
                                    "drop_damage_scatter"])
def test_bev_codec_forward_matches_jax(select, fec):
    """Kept fractions 0.3 and 0.8 at 1 dB with the re-seeding stats: the
    codes, the kept set, the logits and the aux; the full-rate forward
    (no keep) too."""
    jm, params, tm = _bev(fec)
    pts, mask = _points()
    snr = jnp.full((BATCH,), 1.0, jnp.float32)
    key = jax.random.key(16)
    n_sym = 64 * 4 // 2 if fec == "none" else 64 * 8 * 7 // 4 // 2
    noise = _t(jax.random.normal(key, (BATCH, n_sym, 2)))
    k88 = jax.random.fold_in(key, 88)
    draws = (jax.random.uniform(k88, (BATCH, 64)) if select == "random"
             else _probes(k88, (8, 8, 4)))
    for keep in (KEEP, None):
        kw = {} if keep is None else dict(keep=jnp.asarray(keep),
                                          select=select)
        jlog, jaux = jax.jit(lambda p: jm.apply(
            {"params": p}, jnp.asarray(pts), jnp.asarray(mask), snr, key,
            **kw))(params)
        tkw = {} if keep is None else dict(
            keep=_t(keep), select=select,
            select_draws=None if select == "scatter" else _t(draws))
        log, aux = tm(_t(pts), _t(mask), _t(snr), noise=noise, **tkw)
        assert set(aux) == set(jaux)
        assert float(jaux["index_error_rate"]) > 0
        _close(log.detach(), jlog, f"logits keep={keep}")
        np.testing.assert_array_equal(aux["vq_counts"].numpy(),
                                      np.asarray(jaux["vq_counts"]))
        for k in jaux:
            _close(np.asarray(aux[k].detach()), jaux[k], k)


def test_bev_codec_refuses_as_jax():
    jm, params, tm = _bev()
    pts, mask = _points()
    with pytest.raises(ValueError, match="unsupported BEV token_select"):
        tm(_t(pts), _t(mask), 10.0, keep=_t(KEEP), select="damage")
    with pytest.raises(ValueError, match="power of 4"):
        tlid.LidarBEVVQCodec(**{**LID, "vq_codes": 32})
    unpruned = tlid.LidarBEVVQCodec(channel_cfg=tm.channel_cfg,
                                    **{**LID, "vq_prune": False})
    assert not hasattr(unpruned, "mask_embed")
    with pytest.raises(ValueError, match="lidar.vq_prune"):
        unpruned(_t(pts), _t(mask), 10.0, keep=_t(KEEP))
