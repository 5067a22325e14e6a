"""``train.bf16`` activations: the port's modules against the JAX package's
bf16 run on the CPU.

* ``FusedConvPReLU`` at stride 1 and 2, with and without PReLU, against
  the JAX module on its Pallas kernel (interpret mode), and one case
  against its XLA route (``use_pallas=False``), which rounds three times;
  the gradients of its parameters and input;
* ``PReLU`` and the SNR and rate FiLMs on a bf16 map;
* ``CameraEncoderCNN``, ``CameraDecoderCNN`` (with the seg head) and
  ``CameraTokensCNN``;
* ``PillarFeatureNet``, ``BEVBackbone`` and ``LidarBEVCodec`` (encode,
  decode, tokens), the scatter on its Pallas kernel;
* ``FusedMHABlock`` (the JAX kernel in interpret mode) and
  ``FusionTransformer`` on fused blocks and in ``late_concat``;
* ``scatter_max`` on bf16 features, forward and backward, bit for bit
  against JAX's ``scatter_max_reference`` and its ``jax.vjp``, with forced
  ties; the plain versions of the three kernels on bf16.

The parameters are ``eval_shape`` of the flax init filled from numpy
(``flax_like``), the inputs numpy draws from a seed, both sides f32
parameters and bf16 activations; TF32 off.

Tolerance, unless a test says otherwise: each output tensor within 2 bf16
ulps of its largest entry, |got - want| <= 2 * 2^-8 * max|want|. Both
sides round the same operands to bf16 but sum in other orders and, where
the two frameworks' elementwise ops differ (PyTorch rounds a bf16 op's
f32 result once, XLA may keep a fused chain in f32), round in other
places: each such flip is one bf16 step of the value it rounds, and the
steps of the values a later op sums stay within two of the largest.

Gradients of parameters cannot be held to a step: a bf16 gradient
carries the roundings of every op between the parameter and the loss,
and JAX's own bf16 gradients lie up to tens of steps from its f32 ones.
So each tensor's gradient is held, in the L2 norm, against JAX's f32
gradient of the same loss on the same parameters and inputs: within 2
bf16 steps plus four times the distance of JAX's bf16 gradient from it
(that distance taken at least at the median over the network's tensors),
and within 3/4 of the tensor's norm, so that a zero or sign-flipped
gradient fails (``close_grads``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sc_torch import bridge
from multimodal_sc_torch.codec import camera_cnn as tcam
from multimodal_sc_torch.codec import lidar_bev as tlid
from multimodal_sc_torch.fusion import transformer as tfus
from multimodal_sc_torch.kernels import conv_block as tconv
from multimodal_sc_torch.kernels import mha_block as tmha
from multimodal_sc_torch.kernels import pillar_scatter as tscatter
from multimodal_sc_tpu.codec import camera_cnn as jcam
from multimodal_sc_tpu.codec import lidar_bev as jlid
from multimodal_sc_tpu.fusion import transformer as jfus
from multimodal_sc_tpu.kernels import conv_block as jconv
from multimodal_sc_tpu.kernels import pillar_scatter as jscatter
from test_torch_c4_digital import flax_like

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

BF16 = torch.bfloat16
ULP = 2.0 ** -8         # one bf16 step, relative


def _close(got, want, what, ulps=2):
    """|got - want| <= ulps bf16 steps of want's largest entry."""
    got = np.asarray(torch.as_tensor(got).float() if isinstance(
        got, torch.Tensor) else got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    tol = ulps * ULP * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=what)


NOISE = 2.0 ** -16   # an f32 gradient this far under the network's largest


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close_grads(got, want, exact, what="", after_max=()):
    """Per tensor (dicts by parameter name): the port's gradient ``got``
    with bf16 activations against ``exact``, JAX's f32 gradient, in the L2
    norm, within ``2 * ULP * |exact| + 4 * max(|want - exact|, rho *
    |exact|)`` and within ``3/4 * |exact|``. ``want`` is JAX's bf16
    gradient and ``rho`` the median of ``|want - exact| / |exact|`` over
    the tensors. The port's roundings are others than JAX's, so on one
    tensor its error may be the larger by a factor that varies from draw
    to draw: 4 leaves room for it. The floor keeps a tensor on which JAX's
    roundings happen to cancel from demanding the same luck of the port's;
    the cap makes a zero or sign-flipped gradient fail.

    ``after_max`` names the tensors (by prefix) that feed a scatter-max:
    there a rounding can move a cell's maximum to another point of a
    near-tie, which then takes the cell's whole gradient; such jumps are
    few and large, and their number varies from one bf16 run to another
    more than a sum of many small roundings does: those tensors are held
    at 8 times JAX's distance instead of 4.

    A tensor whose exact gradient lies under 2^-16 of the network's largest
    entry is rounding noise (zero in exact arithmetic, as a key bias's: the
    softmax ignores a shift of every key): it must stay within that floor
    of the exact one."""
    exact = {n: _np32(e) for n, e in exact.items()}
    floor = NOISE * max(float(np.abs(e).max()) for e in exact.values())
    real = [n for n, e in exact.items() if np.abs(e).max() >= floor]
    norm = {n: float(np.linalg.norm(exact[n])) for n in real}
    jax_err = {n: float(np.linalg.norm(_np32(want[n]) - exact[n]))
               for n in real}
    rho = float(np.median([jax_err[n] / norm[n] for n in real]))
    bad = {}
    for n, e in exact.items():
        g = _np32(got[n])
        if n not in norm:
            err, tol = float(np.abs(g - e).max()), floor
        else:
            k = 8 if n.startswith(tuple(after_max)) else 4
            tol = min(2 * ULP * norm[n] + k * max(jax_err[n], rho * norm[n]),
                      0.75 * norm[n])
            err = float(np.linalg.norm(g - e))
        if err > tol:
            bad[n] = (err, tol)
    assert not bad, f"{what}(|got - exact|, radius): {bad}"


def _j(x):
    return jnp.asarray(x)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x, np.float32))
    return t if dtype is None else t.to(dtype)


def _jbf(x):
    return jnp.asarray(x, jnp.bfloat16)


def _filled(jm, seed, *args, method=None, **kw):
    """``flax_like`` of the flax module's parameter shapes."""
    shapes = jax.eval_shape(functools.partial(jm.init, method=method, **kw),
                            jax.random.key(0), *args)["params"]
    return flax_like(shapes, seed)


def _load(tmodule, params):
    tmodule.load_state_dict(bridge.to_state_dict(params, tmodule))
    return tmodule


# --- FusedConvPReLU ----------------------------------------------------------

CONVS = {  # (H, W, Cin, Cout, stride, PReLU); the JAX route
    "3->16 s2 (banded)": ((16, 16, 3, 16, 2, True), True),
    "16->32 s1 (tensor cores)": ((8, 8, 16, 32, 1, True), True),
    "16->8 s2 no PReLU": ((9, 7, 16, 8, 2, False), True),
    "32->3 s1 no PReLU (banded)": ((8, 8, 32, 3, 1, False), True),
    # JAX's XLA route rounds the conv, then the bias, then the PReLU, each
    # to bf16; the port (as the Pallas kernel) once: up to a step and a
    # half of each value apart, so 4 steps of the largest.
    "16->32 s1 vs XLA route": ((8, 8, 16, 32, 1, True), False),
}


@pytest.mark.parametrize("name", sorted(CONVS))
def test_fused_conv_prelu_bf16_matches_jax(name):
    (h, w, cin, cout, s, prelu), pallas = CONVS[name]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, h, w, cin)).astype(np.float32)
    jm = jconv.FusedConvPReLU(cout, 5, stride=s, with_prelu=prelu,
                              use_pallas=pallas, dtype=jnp.bfloat16)
    params = _filled(jm, 2, _j(x))
    gy = rng.standard_normal((2, -(-h // s), -(-w // s), cout))

    def loss(m, p, xx):
        y = m.apply({"params": p}, xx)
        return jnp.sum(y.astype(jnp.float32) * _j(gy)), y

    grad = jax.value_and_grad(loss, argnums=(1, 2), has_aux=True)
    (_, want), (gp, gx) = jax.jit(functools.partial(grad, jm))(params,
                                                              _jbf(x))
    _, (exact, _) = jax.jit(functools.partial(
        grad, jm.clone(dtype=jnp.float32)))(params, _jbf(x).astype(
            jnp.float32))
    tm = _load(tconv.FusedConvPReLU(cin, cout, 5, stride=s, with_prelu=prelu,
                                    dtype=BF16), params)
    tx = _t(x, BF16).requires_grad_(True)
    got = tm(tx)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    ulps = 2 if pallas else 4
    _close(got.detach(), want, "y", ulps)
    (got.float() * _t(gy)).sum().backward()
    assert tx.grad.dtype == BF16
    _close(tx.grad, gx, "dx", ulps)
    for p in tm.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
    close_grads({n: p.grad for n, p in tm.named_parameters()}, gp, exact)


def test_conv_plain_version_rounds_once():
    """The plain version on bf16 operands is the f32 conv of the widened
    operands, bias and PReLU, rounded to bf16 once; the bf16 tensor-core
    rule asks both channel counts to be multiples of 8."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 8, 8, 16, generator=g).to(BF16)
    w = (torch.randn(5, 5, 16, 8, generator=g) / 20).to(BF16)
    b = (0.1 * torch.randn(8, generator=g)).to(BF16)
    a = torch.rand(8, generator=g).to(BF16)
    got = tconv.conv_prelu(x, w, b, a, 2)
    want = tconv.conv_prelu_reference(x.float(), w.float(), b.float(),
                                      a.float(), 2).to(BF16)
    assert got.dtype == BF16 and torch.equal(got, want)
    assert tconv.tensor_core_path(16, 8, BF16)
    assert not tconv.tensor_core_path(16, 12, BF16)
    assert tconv.tensor_core_path(16, 12)
    with pytest.raises(TypeError, match="one dtype"):
        tconv._conv_prelu_cuda(x, w.float(), b, a, 1)


# --- PReLU, FiLMs, the CNN camera codec ---------------------------------------

@pytest.mark.parametrize("what", ["prelu", "snr_film", "rate_film"])
def test_prelu_and_films_on_bf16(what):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 4, 4, 16)).astype(np.float32)
    cond = rng.uniform(0, 1, 3).astype(np.float32) * (
        20.0 if what == "snr_film" else 1.0)
    if what == "prelu":
        jm, tm, args = jcam.PReLU(), tcam.PReLU(16), ()
    elif what == "snr_film":
        jm, tm, args = jcam.SNRFiLM(16), tcam.SNRFiLM(16), (cond,)
    else:
        jm, tm, args = jcam.RateFiLM(16), tcam.RateFiLM(16), (cond,)
    params = _filled(jm, 5, _jbf(x), *map(_j, args))
    want = jm.apply({"params": params}, _jbf(x), *map(_j, args))
    _load(tm, params)
    with torch.no_grad():
        got = tm(_t(x, BF16), *map(_t, args))
    # flax's Dense without a dtype promotes the FiLM to f32; the PReLU
    # stays bf16.
    assert str(got.dtype)[6:] == str(want.dtype)
    _close(got, want, what)


def _img(seed, b=2, hw=16):
    return np.random.default_rng(seed).uniform(0, 1, (b, hw, hw, 3)).astype(
        np.float32)


def test_camera_encoder_bf16_matches_jax():
    img, snr = _img(6), np.array([0.0, 15.0], np.float32)
    feats, c_sym = (8, 16, 16, 16), 4
    jm = jcam.CameraEncoderCNN(features=feats, c_sym=c_sym, use_pallas=True,
                               dtype=jnp.bfloat16)
    params = _filled(jm, 7, _j(img), _j(snr))
    want = jm.apply({"params": params}, _j(img), _j(snr))
    tm = _load(tcam.CameraEncoderCNN(feats, c_sym, snr_conditioning=True,
                                     dtype=BF16), params)
    with torch.no_grad():
        got = tm(_t(img), _t(snr))
    assert got.dtype == torch.float32       # the channel stays f32
    _close(got, want, "symbols")


def test_camera_decoder_and_tokens_bf16_match_jax():
    rng = np.random.default_rng(8)
    z = rng.standard_normal((2, 4 * 4 * 4, 2)).astype(np.float32)
    snr = np.array([3.0, 12.0], np.float32)
    jd = jcam.CameraDecoderCNN(features=(16, 16, 16, 8), c_sym=4,
                               image_hw=(16, 16), seg_classes=4,
                               use_pallas=True, dtype=jnp.bfloat16)
    params = _filled(jd, 9, _j(z), _j(snr))
    recon, seg = jd.apply({"params": params}, _j(z), _j(snr))
    td = _load(tcam.CameraDecoderCNN((16, 16, 16, 8), 4, (16, 16),
                                     seg_classes=4, snr_conditioning=True,
                                     dtype=BF16), params)
    with torch.no_grad():
        t_recon, t_seg = td(_t(z), _t(snr))
    assert t_recon.dtype == t_seg.dtype == torch.float32
    _close(t_recon, recon, "recon")
    _close(t_seg, seg, "seg")

    jt = jcam.CameraTokensCNN(dim=32, c_sym=4, image_hw=(16, 16),
                              dtype=jnp.bfloat16)
    p_tok = _filled(jt, 10, _j(z), _j(snr))
    want = jt.apply({"params": p_tok}, _j(z), _j(snr))
    tt = _load(tcam.CameraTokensCNN(32, 4, (16, 16), snr_conditioning=True,
                                    dtype=BF16), p_tok)
    with torch.no_grad():
        got = tt(_t(z), _t(snr))
    assert got.dtype == torch.float32
    _close(got, want, "tokens")


# --- the analog LiDAR codec ---------------------------------------------------

def _points(seed, b=2, n=32):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-4, 52, (b, n)), rng.uniform(-14, 14, (b, n)),
                    rng.uniform(0, 1, (b, n)), rng.uniform(0, 1, (b, n))],
                   -1).astype(np.float32)
    return pts, rng.uniform(0, 1, (b, n)) < 0.8


def test_pillar_net_and_backbone_bf16_match_jax():
    pts, mask = _points(11)
    jp = jlid.PillarFeatureNet(pillar_dim=16, bev_hw=(8, 8), use_pallas=True,
                               dtype=jnp.bfloat16)
    p_pfn = _filled(jp, 12, _j(pts), _j(mask))
    j_bev = jp.apply({"params": p_pfn}, _j(pts), _j(mask))
    jb = jlid.BEVBackbone(features=(16, 16), dtype=jnp.bfloat16)
    p_bb = _filled(jb, 13, j_bev)
    want = jb.apply({"params": p_bb}, j_bev)
    tp = _load(tlid.PillarFeatureNet(4, 16, (8, 8), dtype=BF16), p_pfn)
    tb = _load(tlid.BEVBackbone(16, (16, 16), BF16), p_bb)
    with torch.no_grad():
        t_bev = tp(_t(pts), torch.from_numpy(mask))
        got = tb(t_bev)
    # The port scatters the bf16 features, JAX widens them first: the
    # same grid.
    assert t_bev.dtype == got.dtype == BF16
    _close(t_bev, j_bev, "bev")
    _close(got, want, "backbone")


def test_lidar_codec_bf16_matches_jax():
    pts, mask = _points(14)
    z = np.random.default_rng(15).standard_normal((2, 64 * 4, 2)).astype(
        np.float32)
    jm = jlid.LidarBEVCodec(pillar_dim=16, bev_hw=(8, 8), c_sym=4,
                            seg_classes=4, use_pallas=True,
                            dtype=jnp.bfloat16)
    params = _filled(jm, 16, (_j(pts), _j(mask)))
    tm = _load(tlid.LidarBEVCodec(16, (8, 8), 4, 4, dtype=BF16), params)
    for method, j_args, t_args in (
            ("encode", ((_j(pts), _j(mask)),),
             ((_t(pts), torch.from_numpy(mask)),)),
            ("decode", (_j(z),), (_t(z),)),
            ("tokens", (_j(z),), (_t(z),))):
        want = jm.apply({"params": params}, *j_args, method=method)
        with torch.no_grad():
            got = getattr(tm, method)(*t_args)
        assert got.dtype == torch.float32
        _close(got, want, method)


# --- the fused blocks and the fusion transformer --------------------------------

def _tokens(seed, b, l, d):
    return np.random.default_rng(seed).standard_normal((b, l, d)).astype(
        np.float32)


@pytest.mark.parametrize("self_attn", [False, True])
def test_fused_mha_block_bf16_matches_jax(self_attn):
    """JAX's kernel in interpret mode (its matmuls exact f32, the output
    rounded to bf16) against the port's plain version on bf16 activations
    and f32 parameters, values and gradients."""
    x_q = _tokens(17, 2, 17, 128)
    x_kv = x_q if self_attn else _tokens(18, 2, 36, 128)
    jm = jfus.FusedMHABlock(128, 4, self_attn=self_attn, use_kernel=True,
                            dtype=jnp.bfloat16)
    args = (_jbf(x_q),) if self_attn else (_jbf(x_q), _jbf(x_kv))
    params = _filled(jm, 19, *args)
    gy = np.random.default_rng(20).standard_normal(x_q.shape)

    def loss(m, p, *xs):
        y = m.apply({"params": p}, *xs)
        return jnp.sum(y.astype(jnp.float32) * _j(gy)), y

    grad = jax.value_and_grad(loss, argnums=1, has_aux=True)
    (_, want), grads = jax.jit(functools.partial(grad, jm))(params, *args)
    _, exact = jax.jit(functools.partial(grad, jm.clone(dtype=jnp.float32)))(
        params, *(a.astype(jnp.float32) for a in args))
    tm = _load(tfus.FusedMHABlock(128, 4, self_attn=self_attn), params)
    t_args = [_t(x, BF16) for x in ((x_q,) if self_attn else (x_q, x_kv))]
    got = tm(*t_args)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    _close(got.detach(), want, "out")
    (got.float() * _t(gy)).sum().backward()
    for p in tm.parameters():
        assert p.grad.dtype == torch.float32
    # The matmuls run in f32 on the widened activations (JAX's twin).
    close_grads({n: p.grad for n, p in tm.named_parameters()}, grads, exact)


@pytest.mark.parametrize("mode", ["cross_attention", "late_concat"])
def test_fusion_transformer_bf16_matches_jax(mode):
    cam, lid = _tokens(21, 2, 16, 24), _tokens(22, 2, 36, 16)
    kw = dict(dim=128, depth=2, heads=4, state_dim=32, mode=mode,
              fused_block=True)
    jm = jfus.FusionTransformer(block_kernel=True, dtype=jnp.bfloat16, **kw)
    params = _filled(jm, 23, _j(cam), _j(lid))
    want = jm.apply({"params": params}, _j(cam), _j(lid))
    tm = _load(tfus.FusionTransformer(cam_in=24, lid_in=16, dtype=BF16, **kw),
               params)
    with torch.no_grad():
        got = tm(_t(cam), _t(lid))
    assert got.dtype == torch.float32
    _close(got, want, "state")


def test_mha_block_plain_versions_take_bf16():
    """Both plain versions keep bf16 activations bf16 beside f32
    parameters; the wrapper refuses mixed activations and head dims no
    kernel takes (the f32 mode on bf16 activations has an instance of its
    own: ``tests/test_torch_f32mode_bf16.py``)."""
    g = torch.Generator().manual_seed(24)
    p = {k: (torch.randn(128, 128, generator=g) / 12 if k.startswith("w")
             else 0.1 * torch.randn(128, generator=g))
         for k in tmha.PARAM_KEYS}
    x_q = torch.randn(2, 9, 128, generator=g).to(BF16)
    x_kv = torch.randn(2, 20, 128, generator=g).to(BF16)
    for fn in (tmha.mha_block_reference, tmha.mha_block_reference_bf16):
        out = fn(x_q, x_kv, p, 4)
        assert out.dtype == BF16 and out.shape == x_q.shape
    want = tmha.mha_block_reference(x_q.float(), x_kv.float(), p, 4)
    assert torch.equal(tmha.mha_block(x_q, x_kv, p, 4), want.to(BF16))
    flat = tuple(p[k] for k in tmha.PARAM_KEYS)
    with pytest.raises(TypeError, match="both float32 or both bfloat16"):
        tmha._mha_block_cuda(x_q, x_kv.float(), flat, 4, 0.18, True)
    with pytest.raises(ValueError, match="head dims 8-64"):
        tmha._mha_block_cuda(x_q, x_kv, flat, 1, 0.18, False)


# --- scatter_max on bf16 ------------------------------------------------------

def _scatter_inputs(seed, b=3, n=96, d=8, cells=16):
    """bf16 features with forced ties: rows copied onto the next in every
    feature and in half of them, and cells whose max three, five and seven
    points share (counts that are no power of two); trash points; an env
    with all points in the trash."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, n, d)).astype(np.float32)
    cell = rng.integers(0, cells + 1, (b, n)).astype(np.int32)
    for first, width in ((0, d), (4, d // 2)):
        src = np.arange(first, n - 1, 8)
        cell[:, src + 1] = cell[:, src]
        feats[:, src + 1, :width] = feats[:, src, :width]
    for c, (lo, k) in enumerate(((40, 3), (50, 5), (60, 7))):
        cell[0, lo:lo + k] = c
        feats[0, lo:lo + k] = 6.0 + c
    cell[-1] = cells
    feats = np.asarray(jnp.asarray(feats, jnp.bfloat16).astype(jnp.float32))
    g = rng.standard_normal((b, cells, d)).astype(np.float32)
    return feats, cell, g, cells


@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_max_bf16_is_bit_equal_to_jax(seed):
    feats, cell, g, cells = _scatter_inputs(seed)

    def fwd(x):
        # As JAX's PillarFeatureNet scatters its bf16 features: widened to
        # f32 (its gradient then rounds XLA's f32 share to bf16).
        return jax.vmap(lambda f, c: jscatter.scatter_max_reference(
            f.astype(jnp.float32), c, cells))(x, _j(cell))

    want, vjp = jax.vjp(fwd, _jbf(feats))
    (want_g,) = vjp(_jbf(g).astype(jnp.float32))
    assert want_g.dtype == jnp.bfloat16
    x = _t(feats, BF16).requires_grad_(True)
    got = tscatter.scatter_max(x, torch.from_numpy(cell), cells)
    assert got.dtype == BF16
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    (got_g,) = torch.autograd.grad(got, x, _t(g, BF16))
    # XLA's bits: the cotangent times 1 / count in f32, rounded to bf16.
    np.testing.assert_array_equal(got_g.float().numpy(),
                                  np.asarray(want_g.astype(jnp.float32)))
    ref = tscatter.scatter_max_backward_reference(
        x.detach(), torch.from_numpy(cell), got.detach(), _t(g, BF16), cells)
    assert torch.equal(ref, got_g)
    # Ties of 3, 5 and 7 points share their cell's gradient.
    share = got_g[0, 40:43].float()
    assert torch.all(share == share[0]) and share.abs().sum() > 0
    # The Pallas kernel's forward too (interpret mode): the same grid.
    pallas = jax.vmap(lambda f, c: jscatter.scatter_max_pallas(
        f, c, cells, block_n=32))(_jbf(feats), _j(cell))
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(pallas.astype(jnp.float32)))
