"""The c2 camera codec and its evaluators against the JAX package on the
CPU: ``ssim`` / ``ms_ssim``, the adaptive-rate ``CameraJSCC`` (``RateFiLM``
on both sides, the SNR FiLM, the seg head) from bridged weights through
``encode``, ``decode`` and ``decode_seg``, and ``sweep_camera`` /
``sweep_camera_rate`` over the ideal channel, where no draw matters, with
``format_table``'s text. Narrow widths (8, 16, 16, 16), 16x16 images; f32,
TF32 off, JAX at ``highest`` precision.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sc_torch import bridge
from multimodal_sc_torch.codec.camera_cnn import CameraJSCC
from multimodal_sc_torch.config import get_preset as t_preset
from multimodal_sc_torch.evaluation import metrics as tmet
from multimodal_sc_torch.evaluation import snr_sweep as tsweep
from multimodal_sc_torch.train import jscc as tjscc
from multimodal_sc_tpu.codec import camera_cnn as jcam
from multimodal_sc_tpu.config import get_preset as j_preset
from multimodal_sc_tpu.evaluation import metrics as jmet
from multimodal_sc_tpu.evaluation import snr_sweep as jsweep
from multimodal_sc_tpu.train import jscc as jjscc

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

FEATS, C_SYM, HW, SEG = (8, 16, 16, 16), 4, (16, 16), 4
BATCH = 3


def _t(x):
    return torch.tensor(np.array(x))


def _images(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("shape,kw", [
    ((2, 32, 32, 3), {}),
    ((2, 23, 19, 1), {"filter_size": 7, "filter_sigma": 1.0}),
])
def test_ssim_matches_jax(shape, kw):
    x = _images(1, shape)
    y = np.clip(x + np.random.default_rng(2).normal(0, 0.1, shape), 0,
                1).astype(np.float32)
    for per_example in (False, True):
        got = tmet.ssim(torch.from_numpy(x), torch.from_numpy(y),
                        per_example=per_example, **kw)
        want = jmet.ssim(jnp.asarray(x), jnp.asarray(y),
                         per_example=per_example, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    same = tmet.ssim(torch.from_numpy(x), torch.from_numpy(x))
    assert abs(float(same) - 1.0) < 1e-5


@pytest.mark.parametrize("shape,kw", [
    ((1, 176, 176, 3), {}),
    # Odd sides at every scale: the symmetric one-pixel padding.
    ((2, 45, 47, 3), {"weights": tmet.MS_SSIM_WEIGHTS[:3], "filter_size": 5}),
])
def test_ms_ssim_matches_jax(shape, kw):
    x = _images(3, shape)
    y = np.clip(x + np.random.default_rng(4).normal(0, 0.05, shape), 0,
                1).astype(np.float32)
    got = tmet.ms_ssim(torch.from_numpy(x), torch.from_numpy(y),
                       per_example=True, **kw)
    want = jmet.ms_ssim(jnp.asarray(x), jnp.asarray(y), per_example=True,
                        **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    with pytest.raises(ValueError, match="too small"):
        tmet.ms_ssim(torch.zeros(1, 32, 32, 3), torch.zeros(1, 32, 32, 3))


@functools.lru_cache(maxsize=None)
def _jax_codec(adaptive=True, seg=SEG, snr_cond=True):
    model = jcam.CameraJSCC(features=FEATS, c_sym=C_SYM, image_hw=HW,
                            seg_classes=seg, snr_conditioning=snr_cond,
                            adaptive_rate=adaptive)
    img = jnp.zeros((2, *HW, 3))
    snr = jnp.full((2,), 10.0)
    rate = jnp.ones((2,)) if adaptive else None
    params = model.init(jax.random.key(0), img, snr, rate)["params"]
    rng = np.random.default_rng(5)
    # Off the init (zero biases, zero FiLM output layers).
    params = jax.tree_util.tree_map(lambda a: a + 0.05 * jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)), params)
    return model, params


def _port_codec(params, adaptive=True, seg=SEG, snr_cond=True):
    tm = CameraJSCC(FEATS, C_SYM, HW, seg_classes=seg,
                    snr_conditioning=snr_cond, adaptive_rate=adaptive)
    tm.load_state_dict(bridge.to_state_dict(params, tm))
    return tm.eval()


def test_adaptive_codec_matches_jax():
    model, params = _jax_codec()
    tm = _port_codec(params)
    assert any(n.startswith("encoder.rate_film.fc1") for n, _ in
               tm.named_parameters())
    assert tm.encoder.rate_film.fc1.out_features == 32
    img = _images(6, (BATCH, *HW, 3))
    snr = np.array([-5.0, 7.5, 25.0], np.float32)
    rate = np.array([0.25, 0.5, 1.0], np.float32)
    v = {"params": params}
    z = model.apply(v, img, snr, rate, method="encode")
    recon, seg = model.apply(v, z, snr, rate, method="decode_seg")
    recon_only = model.apply(v, z, snr, rate, method="decode")
    with torch.no_grad():
        tz = tm.encode(_t(img), _t(snr), _t(rate))
        trecon, tseg = tm.decode_seg(tz, _t(snr), _t(rate))
        tonly = tm.decode(_t(z), _t(snr), _t(rate))
    assert tz.shape == (BATCH, tm.k, 2) and tseg.shape == (BATCH, *HW, SEG)
    for got, want in ((tz, z), (trecon, recon), (tseg, seg),
                      (tonly, recon_only)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
    with pytest.raises(ValueError, match="requires a rate"):
        tm.encode(_t(img), _t(snr))
    fixed = _port_codec(_jax_codec(False, 0, False)[1], False, 0, False)
    with pytest.raises(ValueError, match="seg_classes > 0"):
        fixed.decode_seg(torch.zeros(1, fixed.k, 2))


def test_c2_preset_bridges_snr_film_and_seg_head():
    """The c2 preset's codec (SNR FiLM, 4-class seg head) carries over from
    flax at its full widths: every parameter on both sides, every shape."""
    jcfg, tcfg = j_preset("c2"), t_preset("c2")
    model = jjscc.build_model(jcfg)
    h, w = jcfg.camera.image_hw
    params = jax.eval_shape(lambda: model.init(
        jax.random.key(0), jnp.zeros((2, h, w, 3)),
        jnp.full((2,), 10.0)))["params"]
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   params)
    tm = tjscc.build_model(tcfg)
    sd = bridge.to_state_dict(zeros, tm)
    assert {k for k in sd if "snr_film" in k} >= {
        "encoder.snr_film.fc1.weight", "decoder.snr_film.fc2.bias"}
    assert sd["decoder.seg_head.weight"].shape == (4, 32, 3, 3)
    tm.load_state_dict(sd)


def test_sweeps_over_the_ideal_channel_match_jax():
    model, params = _jax_codec()
    tm = _port_codec(params)
    img = _images(7, (BATCH, *HW, 3))
    seg = np.random.default_rng(8).integers(0, SEG, (BATCH, *HW)).astype(
        np.int32)
    snrs = (-5.0, 10.0, 25.0)
    want = jsweep.sweep_camera(model, params, jnp.asarray(img),
                               jax.random.key(0), snrs_db=snrs,
                               kinds=("ideal",), batches_per_point=2,
                               seg=jnp.asarray(seg))
    got = tsweep.sweep_camera(tm, _t(img), 0, snrs_db=snrs, kinds=("ideal",),
                              batches_per_point=2, seg=_t(seg))
    assert set(got) == {"ideal"} and len(got["ideal"]) == len(snrs)
    for g, w in zip(got["ideal"], want["ideal"]):
        assert set(g) == set(w) == {"snr_db", "psnr", "ssim", "miou"}
        assert g["snr_db"] == w["snr_db"]
        assert abs(g["psnr"] - w["psnr"]) < 1e-4
        assert abs(g["ssim"] - w["ssim"]) < 1e-5
        assert abs(g["miou"] - w["miou"]) < 1e-6
    for metric in ("psnr", "ssim", "miou"):
        assert tsweep.format_table(got, metric) == jsweep.format_table(
            want, metric)
    two = {"awgn": want["ideal"], "rayleigh": want["ideal"]}
    assert tsweep.format_table(two) == jsweep.format_table(two)

    want_r = jsweep.sweep_camera_rate(model, params, jnp.asarray(img),
                                      jax.random.key(1), kind="ideal",
                                      batches_per_point=2)
    got_r = tsweep.sweep_camera_rate(tm, _t(img), 1, kind="ideal",
                                     batches_per_point=2)
    assert [p["rate_sym"] for p in got_r] == list(range(1, C_SYM + 1))
    for g, w in zip(got_r, want_r):
        assert g["rate_sym"] == w["rate_sym"] and g["rate"] == w["rate"]
        assert abs(g["psnr"] - w["psnr"]) < 1e-4
        assert abs(g["ssim"] - w["ssim"]) < 1e-5
    with pytest.raises(ValueError, match="adaptive_rate"):
        tsweep.sweep_camera_rate(_port_codec(
            _jax_codec(False, 0, False)[1], False, 0, False), _t(img))
