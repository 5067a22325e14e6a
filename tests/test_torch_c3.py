"""The modules of the c3 late-fusion JSCC slice of the port against the JAX
package on the CPU: the ViT camera codec (both branches of its attention
dispatch), the LiDAR BEV codec and its targets, the metrics and the
synthetic generators. The training step is in ``test_torch_c3_train.py``.

The JAX side runs its Pallas kernels in interpret mode; the port, on CPU
tensors, runs their plain versions. Both sides get the same parameters
(``multimodal_sc_torch.bridge``), the same inputs (made from a seed with
numpy) and JAX's own random draws. f32 everywhere, JAX at ``highest``
matmul precision.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sc_torch import bridge
from multimodal_sc_torch.codec import camera_vit as tvit
from multimodal_sc_torch.codec import lidar_bev as tlid
from multimodal_sc_torch.envs import datasets as tdata
from multimodal_sc_torch.evaluation import metrics as tmet
from multimodal_sc_tpu.codec import camera_vit as jvit
from multimodal_sc_tpu.codec import lidar_bev as jlid
from multimodal_sc_tpu.envs import datasets as jdata
from multimodal_sc_tpu.evaluation import metrics as jmet

BATCH = 2


def _np(x):
    return np.array(x)


def _t(x):
    return torch.tensor(np.array(x))


def _load(tmodule, params):
    tmodule.load_state_dict(bridge.to_state_dict(params, tmodule))
    return tmodule.eval()


def _perturb(tree, seed, scale=0.1):
    """Parameters moved off their init (zero biases, unit LayerNorm
    scales), so a dropped bias or a swapped norm shows."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + scale * jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32)), tree)


def _points(rng, b=BATCH, n=48):
    pts = np.stack([rng.uniform(-4, 52, (b, n)), rng.uniform(-14, 14, (b, n)),
                    rng.uniform(0, 1.8, (b, n)), rng.uniform(0, 1, (b, n))],
                   -1).astype(np.float32)
    mask = rng.uniform(0, 1, (b, n)) < 0.85
    cls = rng.integers(1, 4, (b, n)).astype(np.int32)
    return pts, mask, cls


# --- MHA: both branches of the kernel dispatch -----------------------------

@pytest.mark.parametrize("dim,heads,branch", [(192, 3, "attention"),
                                              (128, 4, "packed_attention")])
def test_mha_use_pallas_dispatch_matches_jax(monkeypatch, dim, heads, branch):
    calls = {"attention": 0, "packed_attention": 0}
    for name in calls:
        def counted(*a, _name=name, _fn=getattr(tvit, name), **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tvit, name, counted)
    rng = np.random.default_rng(30)
    x = rng.standard_normal((2, 20, dim)).astype(np.float32)
    jm = jvit.MHA(dim, heads, use_pallas=True)     # interpret mode on the CPU
    params = _perturb(jm.init(jax.random.key(0), jnp.asarray(x))["params"], 31)
    want = jm.apply({"params": params}, jnp.asarray(x))
    tm = _load(tvit.MHA(dim, heads, use_pallas=True), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert calls == {"attention": 0, "packed_attention": 0, branch: 1}
    # The packed JAX kernel rounds its matmul operands to bf16 only when
    # compiled for the TPU; interpreted it is f32 like the port's plain one.
    np.testing.assert_allclose(got, _np(want), atol=1e-4, rtol=1e-4)


# --- the ViT codec ---------------------------------------------------------

VIT_KW = dict(image_hw=(16, 16), patch=4, dim=32, depth=2, heads=4, c_sym=4)


def _vit_inputs(seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    z = rng.standard_normal((2, 16 * 4, 2)).astype(np.float32)
    return img, z, np.array([0.0, 15.0], np.float32)


@pytest.mark.parametrize("snr_token", [False, True])
def test_vit_encoder_matches_jax(snr_token):
    img, _, snr = _vit_inputs(40)
    args = (jnp.asarray(img), jnp.asarray(snr) if snr_token else None)
    jm = jvit.ViTEncoderJSCC(snr_conditioning=snr_token, **VIT_KW)
    params = _perturb(jm.init(jax.random.key(1), *args)["params"], 41)
    want = jm.apply({"params": params}, *args)
    tm = _load(tvit.ViTEncoderJSCC(snr_conditioning=snr_token, **VIT_KW),
               params)
    with torch.no_grad():
        got = tm(_t(img), _t(snr) if snr_token else None)
    assert got.shape == (2, 16 * 4, 2)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("snr_token", [False, True])
def test_vit_decoder_matches_jax(snr_token):
    _, z, snr = _vit_inputs(42)
    args = (jnp.asarray(z), jnp.asarray(snr) if snr_token else None)
    jm = jvit.ViTDecoderJSCC(snr_conditioning=snr_token, **VIT_KW)
    params = _perturb(jm.init(jax.random.key(2), *args)["params"], 43)
    want = jm.apply({"params": params}, *args)
    tm = _load(tvit.ViTDecoderJSCC(snr_conditioning=snr_token, **VIT_KW),
               params)
    with torch.no_grad():
        got = tm(_t(z), _t(snr) if snr_token else None)
    assert got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)


def test_vit_snr_token_is_skipped_without_an_snr():
    """A conditioned model given no SNR runs without the token (L = n)."""
    img, _, snr = _vit_inputs(44)
    jm = jvit.ViTEncoderJSCC(snr_conditioning=True, **VIT_KW)
    params = _perturb(jm.init(jax.random.key(3), jnp.asarray(img),
                              jnp.asarray(snr))["params"], 45)
    want = jm.apply({"params": params}, jnp.asarray(img), None)
    tm = _load(tvit.ViTEncoderJSCC(snr_conditioning=True, **VIT_KW), params)
    with torch.no_grad():
        got = tm(_t(img), None)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)


def test_vit_tokens_decoder_matches_jax():
    _, z, _ = _vit_inputs(46)
    jm = jvit.ViTTokensDecoder(**VIT_KW)
    params = _perturb(jm.init(jax.random.key(4), jnp.asarray(z))["params"], 47)
    want = jm.apply({"params": params}, jnp.asarray(z))
    tm = _load(tvit.ViTTokensDecoder(**VIT_KW), params)
    with torch.no_grad():
        got = tm(_t(z))
    assert got.shape == (2, 16, 32)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("snr_token", [False, True])
def test_vit_jscc_matches_jax(snr_token):
    img, _, snr = _vit_inputs(48)
    args = (jnp.asarray(img), jnp.asarray(snr) if snr_token else None)
    jm = jvit.ViTJSCC(snr_conditioning=snr_token, **VIT_KW)
    params = _perturb(jm.init(jax.random.key(5), *args)["params"], 49, 0.05)
    want = jm.apply({"params": params}, *args)
    want_z = jm.apply({"params": params}, *args, method="encode")
    tm = _load(tvit.ViTJSCC(snr_conditioning=snr_token, **VIT_KW), params)
    t_args = (_t(img), _t(snr) if snr_token else None)
    with torch.no_grad():
        got, got_z = tm(*t_args), tm.encode(*t_args)
    assert tm.k == jm.k == 16 * 4
    np.testing.assert_allclose(got_z.numpy(), _np(want_z), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)


# --- the LiDAR BEV codec and its targets -----------------------------------

@pytest.mark.parametrize("seg_classes", [1, 4])
def test_lidar_bev_codec_matches_jax(seg_classes):
    pts, mask, _ = _points(np.random.default_rng(50))
    kw = dict(pillar_dim=16, bev_hw=(8, 8), c_sym=4, seg_classes=seg_classes)
    jm = jlid.LidarBEVCodec(**kw)
    obs = (jnp.asarray(pts), jnp.asarray(mask))
    params = _perturb(jm.init(jax.random.key(6), obs)["params"], 51, 0.05)
    z = jm.apply({"params": params}, obs, method="encode")
    z_hat = z + 0.1 * jnp.asarray(np.random.default_rng(52).standard_normal(
        z.shape).astype(np.float32))
    want = {m: jm.apply({"params": params}, z_hat, method=m)
            for m in ("decode", "tokens")}
    want_all = jm.apply({"params": params}, obs)
    tm = _load(tlid.LidarBEVCodec(**kw), params)
    with torch.no_grad():
        got_z = tm.encode((_t(pts), _t(mask)))
        got = {"decode": tm.decode(_t(z_hat)), "tokens": tm.tokens(_t(z_hat))}
        got_all = tm((_t(pts), _t(mask)))
    assert tm.k == jm.k == 8 * 8 * 4
    assert got["decode"].shape == (BATCH, 8, 8, seg_classes)
    assert got["tokens"].shape == (BATCH, 64, 16)
    np.testing.assert_allclose(got_z.numpy(), _np(z), atol=1e-5, rtol=1e-5)
    for m in want:
        np.testing.assert_allclose(got[m].numpy(), _np(want[m]), atol=1e-5,
                                   rtol=1e-5, err_msg=m)
    np.testing.assert_allclose(got_all.numpy(), _np(want_all), atol=1e-5,
                               rtol=1e-5)


GRID = ((8, 8), (0.0, 48.0), (-12.0, 12.0))


@pytest.mark.parametrize("min_points", [1, 2])
def test_occupancy_target_matches_jax(min_points):
    pts, mask, _ = _points(np.random.default_rng(53), n=96)
    want = jlid.occupancy_target(jnp.asarray(pts), jnp.asarray(mask), *GRID,
                                 min_points=min_points)
    got = tlid.occupancy_target(_t(pts), _t(mask), *GRID,
                                min_points=min_points)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_semantic_bev_target_matches_jax():
    pts, mask, cls = _points(np.random.default_rng(54), n=200)
    want = jlid.semantic_bev_target(jnp.asarray(pts), jnp.asarray(mask),
                                    jnp.asarray(cls), *GRID, num_classes=4)
    got = tlid.semantic_bev_target(_t(pts), _t(mask), _t(cls), *GRID,
                                   num_classes=4)
    assert got.dtype == torch.int32 and got.shape == (BATCH, 8, 8)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert set(np.unique(got.numpy())) == {0, 1, 2, 3}


def test_semantic_bev_target_breaks_ties_toward_the_higher_class():
    # Cell (0, 0): one point of class 1 and one of class 3 -> 3. Cell
    # (1, 1): two of class 1, two of class 2, one of class 3 -> 2. Cell
    # (2, 2): a masked point only -> 0 (empty).
    xy = [(1, -11), (2, -10.5), (7, -8), (8, -8.5), (7.5, -7), (8.5, -7.5),
          (9, -8), (13, -5)]
    pts = np.array([[x, y, 0.5, 0.5] for x, y in xy], np.float32)[None]
    cls = np.array([[1, 3, 1, 1, 2, 2, 3, 2]], np.int32)
    mask = np.array([[True] * 7 + [False]])
    want = jlid.semantic_bev_target(jnp.asarray(pts), jnp.asarray(mask),
                                    jnp.asarray(cls), *GRID, num_classes=4)
    got = tlid.semantic_bev_target(_t(pts), _t(mask), _t(cls), *GRID,
                                   num_classes=4).numpy()
    np.testing.assert_array_equal(got, _np(want))
    assert (got[0, 0, 0], got[0, 1, 1], got[0, 2, 2]) == (3, 2, 0)
    assert got.sum() == 5


# --- metrics ---------------------------------------------------------------

@pytest.mark.parametrize("per_example", [False, True])
def test_mse_and_psnr_match_jax(per_example):
    rng = np.random.default_rng(55)
    x, y = (rng.uniform(0, 1, (3, 8, 8, 3)).astype(np.float32)
            for _ in range(2))
    for name in ("mse", "psnr"):
        want = getattr(jmet, name)(jnp.asarray(x), jnp.asarray(y),
                                   per_example=per_example)
        got = getattr(tmet, name)(_t(x), _t(y), per_example=per_example)
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5,
                                   rtol=1e-5, err_msg=name)
    # Identical inputs: the clamp at 1e-12 gives 120 dB on both sides.
    np.testing.assert_allclose(float(tmet.psnr(_t(x), _t(x))),
                               float(jmet.psnr(jnp.asarray(x), jnp.asarray(x))))


@pytest.mark.parametrize("num_classes,present", [(4, 4), (5, 3)])
def test_confusion_matrix_and_miou_match_jax(num_classes, present):
    rng = np.random.default_rng(56)
    pred, label = (rng.integers(0, present, (2, 8, 8)).astype(np.int32)
                   for _ in range(2))
    want_cm = jmet.confusion_matrix(jnp.asarray(pred), jnp.asarray(label),
                                    num_classes)
    got_cm = tmet.confusion_matrix(_t(pred), _t(label), num_classes)
    assert got_cm.dtype == torch.int32
    np.testing.assert_array_equal(got_cm.numpy(), _np(want_cm))
    want = jmet.miou(jnp.asarray(pred), jnp.asarray(label), num_classes)
    got = tmet.miou(_t(pred), _t(label), num_classes)
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)


# --- the synthetic generators ----------------------------------------------

def _jax_image_draws(key, batch, hw, channels=3):
    """The draws ``_synthetic_image_seg_batch`` makes from ``key``."""
    u = jax.random.uniform
    k1, k2 = jax.random.split(key, 2)
    per_object = {n: [] for n in ("cls", "cy", "cx", "half", "slope", "color")}
    for j in range(jdata.SEG_OBJECTS):
        kc, kp, ks, kcol, ka = jax.random.split(jax.random.fold_in(key, 10 + j), 5)
        per_object["cls"].append(jax.random.randint(kc, (batch,), 1,
                                                    jdata.SEG_CLASSES))
        per_object["cy"].append(u(kp, (batch,), minval=0.15, maxval=0.85))
        per_object["cx"].append(u(jax.random.fold_in(kp, 1), (batch,),
                                  minval=0.15, maxval=0.85))
        per_object["half"].append(u(ks, (batch,), minval=0.08, maxval=0.22))
        per_object["slope"].append(u(ka, (batch,), minval=-1.0, maxval=1.0))
        per_object["color"].append(u(kcol, (batch, channels)))
    return tdata.ImageDraws(
        gcoef=_t(u(k1, (batch, channels), minval=-1, maxval=1)),
        hcoef=_t(u(k2, (batch, channels), minval=-1, maxval=1)),
        noise=_t(jax.random.normal(jax.random.fold_in(key, 7),
                                   (batch, *hw, channels))),
        **{n: _t(jnp.stack(v, axis=1)) for n, v in per_object.items()})


def test_image_generator_with_jax_draws_matches_jax():
    key, hw = jax.random.key(60), (32, 32)
    want_img, want_seg = jdata._synthetic_image_seg_batch(key, 3, hw)
    img, seg = tdata.synthetic_image_seg_batch(_jax_image_draws(key, 3, hw), hw)
    assert img.dtype == torch.float32 and seg.dtype == torch.int32
    np.testing.assert_array_equal(seg.numpy(), _np(want_seg))
    np.testing.assert_allclose(img.numpy(), _np(want_img), atol=1e-6)
    assert len(np.unique(seg.numpy())) > 1


def _jax_pointcloud_draws(key, batch, n, x_range, y_range):
    """The draws ``synthetic_pointcloud_batch`` makes from ``key``."""
    u, fold = jax.random.uniform, jax.random.fold_in
    kp, kc, km, kz, kg, kn, kd = jax.random.split(key, 7)
    centers = jnp.stack([
        u(kc, (batch, 4), minval=x_range[0] + 5, maxval=x_range[1] - 5),
        u(fold(kc, 1), (batch, 4), minval=y_range[0] + 2,
          maxval=y_range[1] - 2)], axis=-1)
    uni_xy = jnp.stack([
        u(kg, (batch, n), minval=x_range[0], maxval=x_range[1]),
        u(fold(kg, 1), (batch, n), minval=y_range[0], maxval=y_range[1])],
        axis=-1)
    return tdata.PointcloudDraws(
        centers=_t(centers),
        assign=_t(jax.random.randint(km, (batch, n), 0, 4)),
        car_offs=_t(jax.random.normal(kp, (batch, n, 2))),
        car_z=_t(u(kz, (batch, n, 1), minval=0.2, maxval=1.6)[..., 0]),
        uni_xy=_t(uni_xy),
        ground_z=_t(u(fold(kz, 2), (batch, n, 1), maxval=0.15)[..., 0]),
        clutter_z=_t(u(fold(kz, 3), (batch, n, 1), maxval=1.8)[..., 0]),
        pop_u=_t(u(fold(km, 1), (batch, n))),
        jitter=_t(jax.random.normal(kn, (batch, n, 2))),
        intensity=_t(u(fold(kz, 1), (batch, n, 1))[..., 0]),
        keep_u=_t(u(kd, (batch, n))))


def test_pointcloud_generator_with_jax_draws_matches_jax():
    key, xr, yr = jax.random.key(61), (0.0, 48.0), (-12.0, 12.0)
    want = jdata.synthetic_pointcloud_batch(key, 3, 256, xr, yr,
                                            with_classes=True)
    got = tdata.synthetic_pointcloud_batch(
        _jax_pointcloud_draws(key, 3, 256, xr, yr), xr, yr, with_classes=True)
    np.testing.assert_allclose(got[0].numpy(), _np(want[0]), atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), _np(want[2]))
    assert got[2].dtype == torch.int32 and got[1].dtype == torch.bool
    assert len(tdata.synthetic_pointcloud_batch(
        _jax_pointcloud_draws(key, 3, 256, xr, yr), xr, yr)) == 2


def test_own_draws_give_the_documented_populations_and_ranges():
    g = torch.Generator().manual_seed(7)
    xr, yr = (0.0, 48.0), (-12.0, 12.0)
    d = tdata.draw_pointcloud(64, 1024, g, "cpu", xr, yr)
    pts, mask, cls = tdata.synthetic_pointcloud_batch(d, xr, yr,
                                                      with_classes=True)
    share = [(cls == c).float().mean().item() for c in (1, 2, 3)]
    np.testing.assert_allclose(share, [0.50, 0.35, 0.15], atol=0.01)
    assert pts.shape == (64, 1024, 4) and mask.shape == (64, 1024)
    # 5% dropout, and a few car / jittered returns outside the range.
    assert 0.85 < mask.float().mean().item() < 0.95
    inside = pts[mask]
    assert (inside[:, 0] >= xr[0]).all() and (inside[:, 0] < xr[1]).all()
    assert (inside[:, 1] >= yr[0]).all() and (inside[:, 1] < yr[1]).all()
    assert (pts[..., 2][cls == 1] < 0.15).all()
    assert (pts[..., 2][cls == 2] >= 0.2).all()
    assert (d.centers[..., 0] >= 5).all() and (d.centers[..., 0] < 43).all()
    assert (d.centers[..., 1] >= -10).all() and (d.centers[..., 1] < 10).all()
    i = tdata.draw_image(256, (32, 32), g, "cpu")
    assert set(i.cls.unique().tolist()) == {1, 2, 3}
    for t, lo, hi in ((i.cy, 0.15, 0.85), (i.half, 0.08, 0.22),
                      (i.slope, -1.0, 1.0), (i.gcoef, -1.0, 1.0)):
        assert t.min() >= lo and t.max() < hi
        assert t.min() < lo + 0.05 * (hi - lo) and t.max() > hi - 0.05 * (hi - lo)
    img, seg = tdata.synthetic_image_seg_batch(i, (32, 32))
    assert img.min() >= 0 and img.max() <= 1
    assert set(seg.unique().tolist()) == {0, 1, 2, 3}


def test_image_dataset_is_seeded_per_step_and_refuses_real_files(tmp_path):
    a = tdata.ImageDataset("synthetic_kitti", 2, seed=3, device="cpu")
    b = tdata.ImageDataset("synthetic_kitti", 2, seed=3, device="cpu")
    first, second = next(a), next(a)
    assert first.shape == (2, 64, 64, 3) and first.dtype == torch.float32
    assert not torch.equal(first, second)
    b._step = 1                                   # resume at step 1
    assert torch.equal(next(b), second)
    other = next(tdata.ImageDataset("synthetic_kitti", 2, seed=4, device="cpu"))
    assert not torch.equal(other, first)
    img, seg = next(tdata.ImageDataset("synthetic_cifar", 2, with_seg=True,
                                       device="cpu"))
    assert img.shape == (2, 32, 32, 3) and seg.shape == (2, 32, 32)
    assert tdata.ImageDataset.SHAPES == jdata.ImageDataset.SHAPES
    # Without their files the real datasets serve their synthetic twins,
    # as in the JAX package; an unknown name is refused.
    for name in ("cifar", "kitti"):
        real = tdata.ImageDataset(name, 2, seed=3, device="cpu",
                                  data_root=str(tmp_path))
        twin = tdata.ImageDataset(f"synthetic_{name}", 2, seed=3,
                                  device="cpu")
        assert real._real is None and torch.equal(next(real), next(twin))
    with pytest.raises(KeyError):
        tdata.ImageDataset("imagenet", 2, device="cpu")
