"""The port's channel and codec modules against the JAX package on the CPU.

Parameters are the JAX modules' own fresh initialisation, carried over
with ``multimodal_sc_torch.bridge``; inputs are made with numpy from a
seed and fed to both sides; the channel noise is JAX's own draw, handed to
the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sc_torch import bridge
from multimodal_sc_torch.channel import layer as tch
from multimodal_sc_torch.codec import camera_cnn as tcam
from multimodal_sc_torch.codec import camera_vit as tvit
from multimodal_sc_torch.codec import lidar_bev as tlid
from multimodal_sc_torch.fusion import transformer as tfus
from multimodal_sc_tpu.channel import layer as jch
from multimodal_sc_tpu.codec import camera_cnn as jcam
from multimodal_sc_tpu.codec import camera_vit as jvit
from multimodal_sc_tpu.codec import lidar_bev as jlid
from multimodal_sc_tpu.fusion import transformer as jfus


def _load(tmodule, params):
    tmodule.load_state_dict(bridge.to_state_dict(params, tmodule))
    return tmodule.eval()


def _np(x):
    return np.array(x)


@pytest.mark.parametrize("shape", [(3, 16, 2), (2, 4, 4, 2)])
def test_power_normalize_matches_jax(shape):
    z = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = jch.power_normalize(jnp.asarray(z))
    got = tch.power_normalize(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, _np(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("snr", [10.0, "per_example"])
def test_awgn_with_jax_noise_matches_jax(snr):
    z = np.random.default_rng(1).standard_normal((4, 32, 2)).astype(np.float32)
    snr_j = jnp.asarray([0.0, 5.0, 10.0, 20.0]) if snr == "per_example" else snr
    snr_t = torch.tensor([0.0, 5.0, 10.0, 20.0]) if snr == "per_example" else snr
    key = jax.random.key(3)
    want = jch.channel(jnp.asarray(z), snr_j, "awgn", key)
    # jch.awgn draws normal(key) after normalization; feed that same draw.
    noise = _np(jax.random.normal(key, z.shape, dtype=jnp.float32))
    got = tch.channel(torch.from_numpy(z), snr_t, "awgn",
                      noise=torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, _np(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("snr_db", [0.0, 10.0, 20.0])
def test_awgn_measured_snr_with_generator(snr_db):
    """The port's own draws: measured SNR within 0.3 dB of the request
    (the JAX package's channel test bound)."""
    g = torch.Generator().manual_seed(42)
    z = tch.power_normalize(torch.randn(64, 256, 2, generator=g))
    y = tch.awgn(z, snr_db, generator=g)
    measured = 10 * torch.log10(z.square().mean() / (y - z).square().mean())
    assert abs(float(measured) - snr_db) < 0.3


def test_channel_unported_kinds_raise():
    """Every kind of the JAX package is ported; an unknown kind and a QAM
    order that is no square still raise."""
    z = torch.zeros(2, 4, 2)
    for kind in tch.CHANNEL_KINDS:
        assert tch.channel(z, 10.0, kind).shape == z.shape
    with pytest.raises(ValueError):
        tch.channel(z, 10.0, "quantum")
    with pytest.raises(ValueError, match="square"):
        tch.channel(z, 10.0, "awgn", modulation=8)


@pytest.mark.parametrize("cond", [False, True])
def test_camera_encoder_matches_jax(cond):
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    snr = np.array([0.0, 15.0], np.float32)
    feats, c_sym = (8, 16, 16, 16), 4
    jm = jcam.CameraEncoderCNN(features=feats, c_sym=c_sym)
    args = (jnp.asarray(img), jnp.asarray(snr) if cond else None)
    params = jm.init(jax.random.key(0), *args)["params"]
    want = jm.apply({"params": params}, *args)
    tm = _load(tcam.CameraEncoderCNN(feats, c_sym, snr_conditioning=cond),
               params)
    with torch.no_grad():
        got = tm(torch.from_numpy(img),
                 torch.from_numpy(snr) if cond else None).numpy()
    np.testing.assert_allclose(got, _np(want), atol=1e-5, rtol=1e-5)


def test_camera_tokens_matches_jax():
    rng = np.random.default_rng(3)
    z = rng.standard_normal((2, 4 * 4 * 4, 2)).astype(np.float32)
    jm = jcam.CameraTokensCNN(dim=32, c_sym=4, image_hw=(16, 16))
    params = jm.init(jax.random.key(1), jnp.asarray(z))["params"]
    want = jm.apply({"params": params}, jnp.asarray(z))
    tm = _load(tcam.CameraTokensCNN(32, 4, (16, 16)), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, _np(want), atol=1e-5, rtol=1e-5)


def _points(rng, b=2, n=24):
    pts = np.stack([rng.uniform(-4, 52, (b, n)), rng.uniform(-14, 14, (b, n)),
                    rng.uniform(0, 1, (b, n)), rng.uniform(0, 1, (b, n))],
                   -1).astype(np.float32)
    mask = rng.uniform(0, 1, (b, n)) < 0.8
    return pts, mask


def test_voxelize_matches_jax():
    pts, mask = _points(np.random.default_rng(4))
    args = ((8, 8), (0.0, 48.0), (-12.0, 12.0))
    j_aug, j_cell = jlid.voxelize(jnp.asarray(pts), jnp.asarray(mask), *args)
    t_aug, t_cell = tlid.voxelize(torch.from_numpy(pts),
                                  torch.from_numpy(mask), *args)
    np.testing.assert_array_equal(t_cell.numpy(), _np(j_cell))
    assert t_cell.dtype == torch.int32
    np.testing.assert_allclose(t_aug.numpy(), _np(j_aug), atol=1e-6)


def test_pillar_net_and_backbone_match_jax():
    pts, mask = _points(np.random.default_rng(5))
    jp = jlid.PillarFeatureNet(pillar_dim=16, bev_hw=(8, 8))
    p_pfn = jp.init(jax.random.key(2), jnp.asarray(pts),
                    jnp.asarray(mask))["params"]
    j_bev = jp.apply({"params": p_pfn}, jnp.asarray(pts), jnp.asarray(mask))
    jb = jlid.BEVBackbone(features=(16, 16))
    p_bb = jb.init(jax.random.key(3), j_bev)["params"]
    want = jb.apply({"params": p_bb}, j_bev)

    tp = _load(tlid.PillarFeatureNet(4, 16, (8, 8)), p_pfn)
    tb = _load(tlid.BEVBackbone(16, (16, 16)), p_bb)
    with torch.no_grad():
        t_bev = tp(torch.from_numpy(pts), torch.from_numpy(mask))
        got = tb(t_bev)
    np.testing.assert_allclose(t_bev.numpy(), _np(j_bev), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)


# --- the unfused fusion layer: MHA on the packed attention ----------------

def _perturbed(params, seed):
    """Fresh flax params moved off their init (zero biases, unit LayerNorm
    scales), so a dropped bias or a swapped norm shows."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32)), params)


@pytest.mark.parametrize("dim,heads,lq,lk,use_pallas", [
    (128, 4, 9, 130, True),     # packed-eligible: the packed kernel's path
    (128, 4, 33, 33, False),
    (48, 3, 7, 12, True),       # ineligible: the generic attention dispatch
])
def test_mha_matches_jax(dim, heads, lq, lk, use_pallas):
    rng = np.random.default_rng(20)
    x_q = rng.standard_normal((2, lq, dim)).astype(np.float32)
    x_kv = rng.standard_normal((2, lk, dim)).astype(np.float32)
    # The JAX module takes its Pallas kernels only where they can run here:
    # the packed one in interpret mode. The flash kernel of the ineligible
    # shape is compared through its plain reference.
    jm = jvit.MHA(dim, heads,
                  use_pallas and jvit.packed_eligible(heads, dim // heads, lk))
    params = _perturbed(jm.init(jax.random.key(0), jnp.asarray(x_q),
                                jnp.asarray(x_kv))["params"], 21)
    want = jm.apply({"params": params}, jnp.asarray(x_q), jnp.asarray(x_kv))
    tm = _load(tvit.MHA(dim, heads, use_pallas), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x_q), torch.from_numpy(x_kv)).numpy()
    np.testing.assert_allclose(got, _np(want), atol=1e-4, rtol=1e-4)


def test_unported_vit_classes_raise():
    """The ViT classes are ported, and so is the digital LiDAR codec: of
    these codec modules only what the JAX package refuses still raises, a
    codebook that is no power of 4."""
    for name in ("TransformerBlock", "SNRToken", "ViTEncoderJSCC",
                 "ViTDecoderJSCC", "ViTTokensDecoder", "ViTJSCC"):
        assert issubclass(getattr(tvit, name), torch.nn.Module)
    assert isinstance(tlid.LidarBEVVQCodec(), torch.nn.Module)
    with pytest.raises(ValueError, match="power of 4"):
        tlid.LidarBEVVQCodec(vq_codes=32)
    with pytest.raises(AttributeError):
        tvit.no_such_name


def test_unfused_fusion_layer_matches_jax():
    rng = np.random.default_rng(22)
    cam = rng.standard_normal((2, 17, 128)).astype(np.float32)
    lid = rng.standard_normal((2, 36, 128)).astype(np.float32)
    jm = jfus.FusionLayer(128, 4, use_pallas=True, fused_block=False)
    params = _perturbed(jm.init(jax.random.key(1), jnp.asarray(cam),
                                jnp.asarray(lid))["params"], 23)
    want = jm.apply({"params": params}, jnp.asarray(cam), jnp.asarray(lid))
    tm = _load(tfus.FusionLayer(128, 4, use_pallas=True, fused_block=False),
               params)
    with torch.no_grad():
        got = tm(torch.from_numpy(cam), torch.from_numpy(lid))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("fused_block", [False, True])
def test_fusion_transformer_matches_jax(fused_block):
    rng = np.random.default_rng(24)
    cam = rng.standard_normal((2, 16, 24)).astype(np.float32)
    lid = rng.standard_normal((2, 36, 16)).astype(np.float32)
    kw = dict(dim=128, depth=2, heads=4, state_dim=32, use_pallas=True,
              fused_block=fused_block, block_kernel=False)
    jm = jfus.FusionTransformer(**kw)
    params = _perturbed(jm.init(jax.random.key(2), jnp.asarray(cam),
                                jnp.asarray(lid))["params"], 25)
    want = jm.apply({"params": params}, jnp.asarray(cam), jnp.asarray(lid))
    tm = _load(tfus.FusionTransformer(cam_in=24, lid_in=16, **kw), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(cam), torch.from_numpy(lid)).numpy()
    np.testing.assert_allclose(got, _np(want), atol=1e-4, rtol=1e-4)
