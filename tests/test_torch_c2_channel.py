"""The port's channel layer and M-QAM modulation against the JAX package on
the CPU: Rayleigh, Rician and OFDM (pilots 0 and 2) given JAX's own draws
(split the key into the fading and noise keys, the CSI error from
``fold_in(key, 2)``), the masked power normalisation and the rate mask, the
whole ``channel()`` with masks, pilots and 16-QAM, and the QAM functions
exactly. The statistics of the port's own draws are checked apart, as the
JAX package's unit tests check its own.
"""

import ast
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_sc_torch
from multimodal_sc_torch.channel import layer as tch
from multimodal_sc_torch.channel import modulation as tmod
from multimodal_sc_tpu.channel import layer as jch
from multimodal_sc_tpu.channel import modulation as jmod

PKG = pathlib.Path(multimodal_sc_torch.__file__).parent
B, K = 4, 96


def _t(x):
    return torch.tensor(np.array(x))



def _symbols(seed, shape=(B, K, 2)):
    z = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.array(jch.power_normalize(jnp.asarray(z)))


def _close(got, want):
    """Deep fades make equalised entries of 1e3-1e6 (1 / |h_hat|^2): rtol
    1e-5 plus 1e-5 of the tensor's largest entry."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _block_draws(key, z_shape, pilots):
    """JAX's draws of ``rayleigh`` / ``rician`` from ``key``."""
    key_h, key_n = jax.random.split(key)
    h_shape = (z_shape[0],) + (1,) * (len(z_shape) - 2) + (2,)
    return tch.ChannelDraws(
        noise=_t(jax.random.normal(key_n, z_shape)),
        h=_t(jax.random.normal(key_h, (z_shape[0], 2))),
        csi=_t(jax.random.normal(jax.random.fold_in(key, 2), h_shape))
        if pilots else None)


def _ofdm_draws(key, z_shape, pilots, subcarriers, taps):
    key_h, key_n = jax.random.split(key)
    flat = (z_shape[0], int(np.prod(z_shape[1:-1])), 2)
    return tch.ChannelDraws(
        noise=_t(jax.random.normal(key_n, flat)),
        h=_t(jax.random.normal(key_h, (z_shape[0], taps, 2))),
        csi=_t(jax.random.normal(jax.random.fold_in(key, 2),
                                 (z_shape[0], subcarriers, 2)))
        if pilots else None)


SNRS = {"scalar": 7.0,
        "per_example": np.array([-5.0, 0.0, 12.5, 25.0], np.float32)}


@pytest.mark.parametrize("snr", list(SNRS))
@pytest.mark.parametrize("pilots", [0, 2])
@pytest.mark.parametrize("kind", ["rayleigh", "rician"])
def test_block_fading_matches_jax_given_its_draws(kind, pilots, snr):
    z = _symbols(1).copy()
    snr_db = SNRS[snr]
    key = jax.random.key(3 + pilots)
    jfn = jch.rayleigh if kind == "rayleigh" else jch.rician
    tfn = tch.rayleigh if kind == "rayleigh" else tch.rician
    want = jfn(jnp.asarray(z), jnp.asarray(snr_db), key, pilots=pilots)
    got = tfn(torch.from_numpy(z), torch.as_tensor(snr_db), pilots=pilots,
              draws=_block_draws(key, z.shape, pilots))
    _close(got.numpy(), want)


@pytest.mark.parametrize("pilots", [0, 2])
@pytest.mark.parametrize("geometry", [(64, 8), (16, 3)])
def test_ofdm_matches_jax_given_its_draws(pilots, geometry):
    subcarriers, taps = geometry
    # (B, h, w, c, 2): the flattening of the symbol grid onto subcarriers.
    z = _symbols(2, (B, 4, 4, 6, 2)).copy()
    snr = SNRS["per_example"]
    key = jax.random.key(5)
    want = jch.ofdm(jnp.asarray(z), jnp.asarray(snr), key, pilots=pilots,
                    subcarriers=subcarriers, taps=taps)
    got = tch.ofdm(torch.from_numpy(z), torch.from_numpy(snr), pilots=pilots,
                   subcarriers=subcarriers, taps=taps,
                   draws=_ofdm_draws(key, z.shape, pilots, subcarriers, taps))
    _close(got.numpy(), want)
    h = jax.random.normal(key, (B, taps, 2))
    np.testing.assert_allclose(
        tch.ofdm_freq_response(_t(h), subcarriers).numpy(),
        np.asarray(jch.ofdm_freq_response(h, subcarriers)), atol=1e-5)
    np.testing.assert_allclose(tch.exp_power_delay_profile(taps).numpy(),
                               np.asarray(jch.exp_power_delay_profile(taps)),
                               rtol=1e-6)


def test_masked_power_normalisation_and_rate_mask_match_jax():
    z = np.random.default_rng(6).standard_normal((B, K, 2)).astype(np.float32)
    m = np.array([1, 3, 8, 5], np.int32)
    jmask = jch.rate_mask(B, K, 8, jnp.asarray(m))
    tmask = tch.rate_mask(B, K, 8, torch.from_numpy(m))
    assert tmask.dtype == torch.float32 and tmask.shape == (B, K, 1)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    # Flat symbol i carries channel i % c_sym: the first m of every 8.
    assert tmask[1, :, 0].tolist()[:10] == [1, 1, 1, 0, 0, 0, 0, 0, 1, 1]
    np.testing.assert_allclose(
        tch.power_normalize_masked(torch.from_numpy(z), tmask).numpy(),
        np.asarray(jch.power_normalize_masked(jnp.asarray(z), jmask)),
        rtol=1e-6, atol=1e-6)
    full = torch.ones(B, K, 1)
    np.testing.assert_allclose(
        tch.power_normalize_masked(torch.from_numpy(z), full).numpy(),
        tch.power_normalize(torch.from_numpy(z)).numpy(), rtol=1e-6)


@pytest.mark.parametrize("kind,pilots,modulation,masked", [
    ("awgn", 0, 16, True), ("rayleigh", 2, 0, True), ("rician", 0, 16, False),
    ("ofdm", 2, 0, True), ("ideal", 0, 4, True)])
def test_channel_matches_jax(kind, pilots, modulation, masked):
    z = np.random.default_rng(7).standard_normal((B, K, 2)).astype(np.float32)
    snr = SNRS["per_example"]
    m = np.array([2, 8, 5, 1], np.int32)
    jmask = jch.rate_mask(B, K, 8, jnp.asarray(m)) if masked else None
    key = jax.random.key(8)
    want = jch.channel(jnp.asarray(z), jnp.asarray(snr), kind, key,
                       modulation=modulation, pilots=pilots, mask=jmask)
    if kind == "ofdm":
        draws = _ofdm_draws(key, z.shape, pilots, 64, 8)
    elif kind == "awgn":
        draws = tch.ChannelDraws(noise=_t(jax.random.normal(key, z.shape)))
    else:
        draws = _block_draws(key, z.shape, pilots)
    got = tch.channel(torch.from_numpy(z), torch.from_numpy(snr), kind,
                      modulation=modulation, pilots=pilots,
                      mask=_t(jmask) if masked else None, noise=draws)
    _close(got.numpy(), want)


def test_qam_matches_jax_exactly():
    rng = np.random.default_rng(9)
    for m in (4, 16, 64):
        np.testing.assert_array_equal(tmod.qam_levels(m).numpy(),
                                      np.asarray(jmod.qam_levels(m)))
        levels = np.asarray(jmod.qam_levels(m))
        # Away from the decision midpoints, where a tie could go either way.
        z = rng.uniform(-1.6, 1.6, (B, 64, 2)).astype(np.float32)
        mid = (levels[1:] + levels[:-1]) / 2
        near = np.abs(z[..., None] - mid).min(-1) < 1e-3
        z[near] += 2e-3
        for tfn, jfn in ((tmod.qam_modulate, jmod.qam_modulate),
                         (tmod.qam_demodulate_indices,
                          jmod.qam_demodulate_indices)):
            np.testing.assert_array_equal(
                tfn(torch.from_numpy(z), m).numpy(),
                np.asarray(jfn(jnp.asarray(z), m)))
        z_rx = z + rng.normal(0, 0.1, z.shape).astype(np.float32)
        assert float(tmod.symbol_error_rate(
            torch.from_numpy(z), torch.from_numpy(z_rx), m)) == float(
            jmod.symbol_error_rate(jnp.asarray(z), jnp.asarray(z_rx), m))
        for snr_db in (0.0, 10.0, 20.0):
            assert tmod.qam_ser_awgn_theory(m, snr_db) == \
                jmod.qam_ser_awgn_theory(m, snr_db)
    with pytest.raises(ValueError, match="square"):
        tmod.qam_levels(8)
    # Straight through: the gradient of the hard mapping is the identity.
    z = torch.randn(2, 8, 2, requires_grad=True)
    tmod.qam_modulate(z, 16).sum().backward()
    assert torch.equal(z.grad, torch.ones_like(z))


# --- the port's own draws: statistics ---------------------------------------

def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_fading_statistics_on_the_ports_generator():
    g = _gen(11)
    n = 20000
    z = tch.power_normalize(torch.randn(n, 8, 2, generator=g))
    # The gains: E|h|^2 = 1 for both kinds; Rician's mean sqrt(K / (K + 1))
    # on the real part; Rayleigh's mean 0.
    for fn, mean_re in ((tch.rayleigh, 0.0),
                        (tch.rician, math.sqrt(4.0 / 5.0))):
        h_std = torch.randn(n, 2, generator=g)
        # Equalisation at a very high SNR inverts the gain: y == z.
        y = fn(z, 200.0, draws=tch.ChannelDraws(h=h_std))
        torch.testing.assert_close(y, z, atol=1e-3, rtol=1e-3)
        scale = math.sqrt(0.5) if fn is tch.rayleigh else math.sqrt(0.1)
        h = h_std * scale + torch.tensor([mean_re, 0.0])
        assert abs(float(h.square().sum(-1).mean()) - 1.0) < 0.03
        assert abs(float(h[:, 0].mean()) - mean_re) < 0.02
        assert abs(float(h[:, 1].mean())) < 0.02


def test_awgn_and_ofdm_power_and_pilot_error_on_the_ports_generator():
    g = _gen(12)
    z = tch.power_normalize(torch.randn(512, 256, 2, generator=g))
    for snr_db in (0.0, 10.0):
        y = tch.channel(z, snr_db, "awgn", g)
        measured = 10 * torch.log10(z.square().mean() / (y - z).square().mean())
        assert abs(float(measured) - snr_db) < 0.3
    # E|H_k|^2 = 1 over subcarriers.
    taps = torch.randn(4096, 8, 2, generator=g) * torch.sqrt(
        tch.exp_power_delay_profile(8) / 2.0)[None, :, None]
    power = tch.ofdm_freq_response(taps, 64).square().sum(-1).mean()
    assert abs(float(power) - 1.0) < 0.03
    # More pilots, a better estimate: the median per-example error falls
    # (the mean is heavy-tailed: E[1 / |h|^2] is infinite under Rayleigh).
    err = [float((tch.ofdm(z, 10.0, _gen(13), pilots=p) - z).square().mean(
        dim=(1, 2)).median()) for p in (1, 16, 0)]
    assert err[0] > err[1] > err[2], err
    # The estimate's error: var(h_hat - h) = noise power / pilots.
    e = tch._estimate_csi(torch.zeros(200000, 2), torch.tensor(0.0), 4,
                          torch.randn(200000, 2, generator=g))
    assert abs(float(e.square().sum(-1).mean()) - 0.25) < 0.01
    # The mask zeros the untransmitted symbols on every kind.
    mask = tch.rate_mask(512, 256, 8, torch.randint(1, 9, (512,),
                                                    generator=g))
    for kind in ("awgn", "rayleigh", "rician", "ofdm"):
        y = tch.channel(z, 10.0, kind, g, mask=mask, pilots=2)
        assert torch.all(y[mask.expand_as(y) == 0] == 0)


def test_unknown_kind_and_bad_draws_raise():
    z = torch.zeros(2, 4, 2)
    with pytest.raises(ValueError, match="kind must be one of"):
        tch.channel(z, 10.0, "quantum")
    with pytest.raises(ValueError, match="draw of shape"):
        tch.rayleigh(z, 10.0, draws=tch.ChannelDraws(h=torch.zeros(3, 2)))


@pytest.mark.parametrize("module", [
    "channel/layer.py", "channel/modulation.py", "codec/camera_cnn.py",
    "evaluation/metrics.py", "evaluation/snr_sweep.py", "io/checkpoint.py",
    "runtime/prefetch.py", "train/jscc.py", "train/fusion_jscc.py",
    "envs/datasets.py", "kernels/conv_block.py", "envs/driving.py",
    "rl/perception.py", "rl/warmstart.py", "train/dqn.py", "train/ppo.py",
    "evaluation/policy_eval.py", "evaluation/policy_sweep.py",
    "obs/profiling.py", "codec/camera_vit.py"])
def test_c2_modules_import_no_jax(module):
    banned = ("jax", "flax", "optax", "orbax", "multimodal_sc_tpu")
    for node in ast.walk(ast.parse((PKG / module).read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in banned, (module, name)
