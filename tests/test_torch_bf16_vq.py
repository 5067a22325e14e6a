"""``train.bf16`` on the VQ codecs (c1_vq, c3_vq, c4_vq, c4_digital, c5
digital), against the JAX package's bf16 run on the CPU, and the
observability gaps; the RL losses are in ``test_torch_bf16_vq_rl.py``.

* (a) The modules: ``VQEncoderTokens.encode_features``, ``VQTokensCamera``,
  ``VQCameraJSCC.codes_to_image`` and ``LidarBEVVQCodec.encode_features`` /
  ``codes_to_logits`` in bf16, with JAX's ``use_pallas`` on and off;
* (b) the losses and gradients of a bf16 c1_vq and c3_vq train step under
  ``close_grads``, with JAX's codes held;
* (c) the drop-damage and single-bit damage estimates and the UEP weights
  of a bf16 c1_vq decoder, given JAX's probes, and the kept set they rank;
* (d) the codebook seeding's features of a bf16 digital trunk;
* (f) ``replay.add``, ``annotate`` and the ``obs`` re-exports.

Parameters are ``eval_shape`` of the flax init filled from numpy
(``flax_like``), inputs numpy draws from a seed, the channels' draws JAX's.
The module gates: each output within one bf16 step of its largest entry
against JAX's kernel route (``use_pallas=True``, one rounding a conv, as
the port's), two against its XLA route, which rounds the conv, the bias
and the PReLU apart (four for a lone conv in ``test_torch_bf16.py``); a
feature or token that JAX returns as a widened bf16 value is one in the
port too. The steps and losses run JAX's XLA route, its f32 run the exact
one (``close_grads``: each gradient in the L2 norm within 2 bf16 steps
plus 4x JAX's own bf16 distance from f32, capped at 3/4 of the norm; a
loss the same way). JAX's bf16 runs are compiled without XLA's excess
precision (``_exact_jit``), so that they round wherever their modules
declare bf16, as the port does.

Holding codes. JAX and the port sum a conv in other orders, so a bf16
code feature can round one step apart, and a code at a near-tie flips;
one flipped code moves everything after it. So JAX's bf16 run records the
indices its nearest-code searches pick (``_JaxCodes``), its f32 run
quantises to them too, and the port's searches are held to them
(``_HeldCodes``). A code of the port's own that differs must be a
near-tie: its distance gap under ``TIE`` of the distances' scale |z|^2 +
|c|^2. The bound: features that differ by d in the L2 norm move the gap
between codes h and o by at most 2 |d| |o - h|; at d within 4 bf16 steps
of |z| that is under 2^-5 of the scale. At most 1/32 of the tokens may be
held. The port's features reach the search bf16-valued, as JAX's.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

# JAX's digital modules build module-level constants: import them before a
# trace reaches their lazy imports.
import multimodal_sc_tpu.channel.harq  # noqa: F401
import multimodal_sc_tpu.codec.semantic_vq  # noqa: F401
from multimodal_sc_torch import obs as tobs
from multimodal_sc_torch.codec import lidar_bev as tlid
from multimodal_sc_torch.codec import semantic_vq as tvq
from multimodal_sc_torch.config import get_preset as t_preset
from multimodal_sc_torch.envs import driving as tenv
from multimodal_sc_torch.rl import dqn as tdqn
from multimodal_sc_torch.rl import replay as treplay
from multimodal_sc_torch.rl import warmstart as twarm
from multimodal_sc_torch.rl.perception import QNetwork as TQNetwork
from multimodal_sc_torch.train import fusion_jscc as tfj
from multimodal_sc_torch.train import jscc as tjscc
from multimodal_sc_tpu import obs as jobs
from multimodal_sc_tpu.codec import lidar_bev as jlid
from multimodal_sc_tpu.codec import semantic_vq as jvq
from multimodal_sc_tpu.config import get_preset as j_preset
from multimodal_sc_tpu.envs import driving as jenv
from multimodal_sc_tpu.rl import dqn as jdqn
from multimodal_sc_tpu.rl import replay as jreplay
from multimodal_sc_tpu.rl import warmstart as jwarm
from multimodal_sc_tpu.train import fusion_jscc as jfj
from multimodal_sc_tpu.train import jscc as jjscc
from test_torch_bf16 import ULP, _filled, _j, _load, close_grads
from test_torch_bf16_slice import _by_name, _port_grads
from test_torch_c4_digital import PRUNE, RESEED, flax_like
from test_torch_c4_digital import _configs as _digital_configs
from test_torch_c4_digital import _params as _digital_params

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

BF16 = torch.bfloat16
TIE = 2.0 ** -5         # a held code's distance gap, of |z|^2 + |c|^2
HELD_SHARE = 1 / 32     # at most this share of the tokens held


def _close(got, want, what, ulps=1):
    """|got - want| <= ulps bf16 steps of want's largest entry."""
    got = torch.as_tensor(got).detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    tol = ulps * ULP * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=what)


def _exact_jit(fn):
    """``jax.jit(fn)`` compiled without XLA's excess precision, which on the
    CPU keeps a fused chain's bf16 results in f32: JAX's bf16 run then
    rounds wherever its modules declare bf16, as the port does."""
    def call(*args):
        return jax.jit(fn).lower(*args).compile(
            {"xla_allow_excess_precision": False})(*args)
    return call


def _loss_close(got, want, exact, what):
    """A loss as ``close_grads`` holds a gradient: within 2 bf16 steps of
    JAX's f32 value ``exact`` plus 4x the distance of JAX's bf16 value
    ``want`` from it."""
    got, want, exact = (float(v) for v in (got, want, exact))
    tol = 2 * ULP * abs(exact) + 4 * abs(want - exact)
    assert abs(got - exact) <= tol, (what, got, want, exact)


def _bf16_valued(x, what):
    """Widened bf16 values, as flax's bf16 layers return them."""
    x = (x.detach() if isinstance(x, torch.Tensor)
         else torch.from_numpy(np.array(x, np.float32)))
    assert x.dtype == torch.float32, what
    assert torch.equal(x, x.to(BF16).float()), f"{what}: not bf16 values"


def _all_bf16(net):
    """Every module that takes an activation dtype was built in bf16."""
    dtypes = {getattr(m, a) for m in net.modules()
              for a in ("dtype", "act_dtype") if hasattr(m, a)}
    assert dtypes == {BF16}, dtypes


def _t(x):
    return torch.from_numpy(np.array(x))


# --- holding the codes -------------------------------------------------------

class _JaxCodes:
    """A stand-in for JAX's ``vector_quantize``. Recording (the bf16 run):
    its own search, the indices of each call kept by the call's place in
    the trace. Forcing (the f32 run): the same loss terms on the recorded
    indices (the usage term does not depend on the pick)."""

    def __init__(self):
        self.orig = jvq.vector_quantize
        self.codes, self.n, self.force = {}, 0, False

    def _keep(self, i, idx):
        self.codes[i] = np.asarray(idx)

    def __call__(self, z_e, codebook, beta=0.25, usage_coef=0.0,
                 usage_temp=0.5, with_stats=False):
        i, self.n = self.n, self.n + 1
        out = self.orig(z_e, codebook, beta, usage_coef=usage_coef,
                        usage_temp=usage_temp, with_stats=with_stats)
        if not self.force:
            jax.debug.callback(functools.partial(self._keep, i), out[1])
            return out
        sg = jax.lax.stop_gradient
        idx = jnp.asarray(self.codes[i])
        z_q = codebook[idx.reshape(-1)].reshape(z_e.shape)
        loss = (jnp.mean(jnp.square(sg(z_e) - z_q))
                + beta * jnp.mean(jnp.square(z_e - sg(z_q))))
        if usage_coef > 0:
            flat = z_e.reshape(-1, codebook.shape[1])
            d2 = (jnp.sum(flat * flat, axis=1, keepdims=True)
                  - 2.0 * flat @ codebook.T
                  + jnp.sum(codebook * codebook, axis=1)[None, :])
            loss = loss + usage_coef * jvq.vq_usage_loss(d2, usage_temp)
        return (z_e + sg(z_q - z_e), idx, loss) + tuple(out[3:])

    def run(self, fn, *args, force=False):
        """``fn(*args)`` with this in place of JAX's ``vector_quantize``."""
        self.n, self.force = 0, force
        with mock.patch.object(jvq, "vector_quantize", self):
            out = fn(*args)
            jax.block_until_ready(out)
        return out


class _HeldCodes:
    """A stand-in for the port's ``vector_quantize`` that quantises to
    ``codes`` (JAX's, in call order). Its own pick may differ only at a
    near-tie (``TIE``); ``held`` counts those, ``total`` the tokens. Its
    features must be bf16 values widened."""

    def __init__(self, codes):
        self.codes = [torch.from_numpy(codes[i]).long()
                      for i in range(len(codes))]
        self.i = self.held = self.total = 0

    def __call__(self, z_e, codebook, beta=0.25, usage_coef=0.0,
                 usage_temp=0.5, with_stats=False, mesh=None):
        # One data shard: there is nothing to pool over.
        assert mesh is None or mesh.data == 1
        _bf16_valued(z_e, "code features")
        want = self.codes[self.i].reshape(-1)
        self.i += 1
        flat = z_e.reshape(-1, codebook.shape[1])
        d2 = ((flat * flat).sum(1, keepdim=True) - 2.0 * flat @ codebook.T
              + (codebook * codebook).sum(1)[None, :])
        with torch.no_grad():
            own = d2.argmin(dim=1)
            rows = (own != want).nonzero()[:, 0]
            gap = d2[rows, want[rows]] - d2[rows, own[rows]]
            scale = flat[rows].square().sum(1) + codebook[want[rows]].square(
                ).sum(1)
            assert bool((gap <= TIE * scale).all()), (
                f"a held code is no near-tie: gap "
                f"{(gap / scale).max().item():.3e} of the scale")
        self.held += rows.numel()
        self.total += want.numel()
        z_q = tvq.code_rows(codebook, want).reshape(z_e.shape)
        loss = ((z_e.detach() - z_q).square().mean()
                + beta * (z_e - z_q.detach()).square().mean())
        if usage_coef > 0:
            loss = loss + usage_coef * tvq.vq_usage_loss(d2, usage_temp)
        out = (z_e + (z_q - z_e).detach(),
               want.reshape(z_e.shape[:-1]).to(torch.int32), loss)
        if not with_stats:
            return out
        k = codebook.shape[0]
        with torch.no_grad():
            err = d2.gather(1, want[:, None])[:, 0]
            cand = flat[err.topk(min(k, flat.shape[0])).indices]
            cand = cand.repeat(-(-k // cand.shape[0]), 1)[:k]
        return out + ({"counts": torch.bincount(want, minlength=k).to(
            torch.int32), "candidates": cand.detach()},)

    def run(self, fn, *args, **kw):
        """``fn(*args, **kw)`` held; every code of ``codes`` consumed."""
        with mock.patch.object(tvq, "vector_quantize", self):
            out = fn(*args, **kw)
        assert self.i == len(self.codes)
        assert self.held <= HELD_SHARE * self.total, (self.held, self.total)
        return out


def _held_grads(jfn, jfn32, params):
    """JAX's bf16 ``((loss, aux), grads)`` of ``jfn`` recording its codes,
    JAX's f32 ones of ``jfn32`` on them, and the port's holder of them."""
    codes = _JaxCodes()
    bf16 = codes.run(_exact_jit(jax.value_and_grad(jfn, has_aux=True)),
                     params)
    f32 = codes.run(jax.jit(jax.value_and_grad(jfn32, has_aux=True)),
                    params, force=True)
    assert codes.codes, "no nearest-code search ran"
    return bf16, f32, _HeldCodes(codes.codes)


# --- (a) the modules ---------------------------------------------------------

FEATS, VQ_DIM, CODES = (8, 16, 16, 16), 8, 16
ROUTES = {"kernel route": True, "XLA route": False}


def _img(seed, b=2, hw=16):
    return np.random.default_rng(seed).uniform(0, 1, (b, hw, hw, 3)).astype(
        np.float32)


def _codes_in(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_vq_camera_modules_bf16_match_jax(route):
    pallas, ulps = ROUTES[route], 1 if ROUTES[route] else 2
    img = _img(1)
    je = jvq.VQEncoderTokens(features=FEATS, vq_dim=VQ_DIM, vq_codes=CODES,
                             use_pallas=pallas, dtype=jnp.bfloat16)
    p_enc = _filled(je, 2, _j(img))
    want = je.apply({"params": p_enc}, _j(img), method="encode_features")
    te = _load(tvq.VQEncoderTokens(FEATS, VQ_DIM, CODES, dtype=BF16), p_enc)
    with torch.no_grad():
        got = te.encode_features(_t(img))
    _bf16_valued(want, "JAX's features")
    _bf16_valued(got, "features")
    _close(got, want, "encode_features", ulps)
    # The decoder: from_code, dec0, dec1, the transposed convs, conv_out,
    # the sigmoid in f32.
    over = ["camera.arch=vq", "camera.image_hw=16,16",
            "camera.features=8,16,16,16", f"camera.vq_codes={CODES}",
            f"camera.vq_dim={VQ_DIM}", f"use_pallas={str(pallas).lower()}"]
    jm = jvq.VQCameraJSCC(cfg=j_preset("c1").override_str(over),
                          dtype=jnp.bfloat16)
    z = _codes_in(3, (2, 16, VQ_DIM))
    params = _filled(jm, 4, _j(img), jnp.full((2,), 10.0), jax.random.key(0))
    want = jm.apply({"params": params}, _j(z), method="codes_to_image")
    tm = _load(tvq.VQCameraJSCC(t_preset("c1").override_str(over), BF16),
               params)
    with torch.no_grad():
        got = tm.codes_to_image(_t(z))
    assert got.dtype == torch.float32
    # The sigmoid is taken in f32, after the widening, as JAX's.
    for x in (got, _t(want)):
        assert not torch.equal(x, x.to(BF16).float())
    _close(got, want, "codes_to_image", ulps)


def test_vq_tokens_camera_bf16_matches_jax():
    z = _codes_in(5, (2, 16, VQ_DIM))
    jt = jvq.VQTokensCamera(dim=32, vq_dim=VQ_DIM, image_hw=(16, 16),
                            dtype=jnp.bfloat16)
    params = _filled(jt, 6, _j(z))
    want = jt.apply({"params": params}, _j(z))
    tt = _load(tvq.VQTokensCamera(32, VQ_DIM, (16, 16), BF16), params)
    with torch.no_grad():
        got = tt(_t(z))
    _bf16_valued(want, "JAX's tokens")
    _bf16_valued(got, "tokens")
    _close(got, want, "tokens")


def _points(seed, b=2, n=32):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-4, 52, (b, n)), rng.uniform(-14, 14, (b, n)),
                    rng.uniform(0, 1, (b, n)), rng.uniform(0, 1, (b, n))],
                   -1).astype(np.float32)
    return pts, rng.uniform(0, 1, (b, n)) < 0.8


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_lidar_vq_codec_bf16_matches_jax(route):
    pallas, ulps = ROUTES[route], 1 if ROUTES[route] else 2
    pts, mask = _points(7)
    z = _codes_in(8, (2, 64, VQ_DIM))
    jm = jlid.LidarBEVVQCodec(pillar_dim=16, bev_hw=(8, 8), vq_codes=CODES,
                              vq_dim=VQ_DIM, seg_classes=4,
                              use_pallas=pallas, dtype=jnp.bfloat16)
    enc = jax.eval_shape(functools.partial(jm.init, method="encode_features"),
                         jax.random.key(0), _j(pts), _j(mask))["params"]
    dec = jax.eval_shape(functools.partial(jm.init, method="codes_to_logits"),
                         jax.random.key(0), _j(z))["params"]
    params = flax_like({**enc, **dec}, 9)
    tm = _load(tlid.LidarBEVVQCodec(16, (8, 8), CODES, VQ_DIM, seg_classes=4,
                                    dtype=BF16), params)
    want = jm.apply({"params": params}, _j(pts), _j(mask),
                    method="encode_features")
    with torch.no_grad():
        got = tm.encode_features(_t(pts), _t(mask))
        logits = tm.codes_to_logits(_t(z))
    _bf16_valued(want, "JAX's features")
    _bf16_valued(got, "features")
    _close(got, want, "encode_features", ulps)
    want = jm.apply({"params": params}, _j(z), method="codes_to_logits")
    assert logits.dtype == torch.float32
    _close(logits, want, "codes_to_logits", ulps)


# --- (b) the steps -----------------------------------------------------------

C1_VQ = ["camera.arch=vq", "camera.image_hw=16,16",
         "camera.features=8,16,16,16", f"camera.vq_codes={CODES}",
         f"camera.vq_dim={VQ_DIM}", "camera.vq_reseed=0.5",
         "train.batch_size=4", "train.bf16=true"]


def _pair(preset, over, bf16=True):
    over = [o for o in over if bf16 or o != "train.bf16=true"]
    return j_preset(preset).override_str(over), \
        t_preset(preset).override_str(over)


def test_c1_vq_step_loss_and_gradients_bf16_match_jax():
    """MSE + VQ loss over the link at 1 dB (index errors), the codebook's
    gradient through the VQ loss alone; then one train step of the port on
    the same draws: its loss, parameters and moments f32."""
    jcfg, tcfg = _pair("c1", C1_VQ)
    img = _img(10, b=4)
    snr = jnp.full((4,), 1.0, jnp.float32)
    key = jax.random.key(11)
    model = jjscc.build_model(jcfg)
    params = _filled(model, 12, _j(img), snr, key)

    def loss_fn(m):
        def fn(p):
            recon, aux = m.apply({"params": p}, img, snr, key)
            return jnp.mean(jnp.square(recon - img)) + aux["vq_loss"], aux
        return fn

    ((loss, aux), grads), ((loss32, aux32), exact), held = _held_grads(
        loss_fn(model), loss_fn(jjscc.build_model(_pair("c1", C1_VQ,
                                                        False)[0])), params)
    assert float(aux["index_error_rate"]) > 0
    state = tjscc.create_train_state(tcfg, 0, "cpu")
    net = state.params
    net.load_state_dict(_by_name(net, params))
    draws = tjscc.StepDraws(snr_db=_t(snr), channel=_t(jax.random.normal(
        key, (4, 16 * 4 // 2, 2))))
    tloss, (_, taux) = held.run(tjscc.vq_loss_fn, net, _t(img), draws)
    _loss_close(tloss, loss, loss32, "loss")
    _loss_close(taux["vq_loss"], aux["vq_loss"], aux32["vq_loss"], "vq_loss")
    tloss.backward()
    close_grads(_port_grads(net), _by_name(net, grads), _by_name(net, exact))
    net.zero_grad(set_to_none=True)
    held.i = 0
    state, m = held.run(tjscc.make_train_step(tcfg), state, _t(img),
                        draws._replace(coin=torch.ones(CODES)))
    _loss_close(m["loss"], loss, loss32, "step loss")
    assert all(p.dtype == torch.float32 for p in net.parameters())
    for st in state.opt_state.state.values():
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32


C3_VQ = ["camera.image_hw=16,16", "camera.depth=1", "camera.dim=32",
         "camera.heads=2", "camera.c_sym=4", "lidar.pillar_dim=16",
         "lidar.max_points=48", "lidar.bev_hw=8,8", "lidar.arch=vq",
         f"lidar.vq_codes={CODES}", f"lidar.vq_dim={VQ_DIM}",
         "lidar.vq_usage_coef=0.25", "lidar.vq_reseed=0.5",
         "train.batch_size=2", "train.bf16=true"]


def test_c3_vq_step_loss_and_gradients_bf16_match_jax():
    """JAX's train step's ``loss_fn`` (camera MSE + 0.5 x the BEV cross
    entropy + the LiDAR VQ loss with its usage term) on the same channel
    draws; the pillar net's tensors at 8x JAX's distance (the scatter-max
    sends a near-tie's whole gradient to one point)."""
    jcfg, tcfg = _pair("c3", C3_VQ)
    rng = np.random.default_rng(13)
    img = _img(14)
    pts, mask = _points(15, n=48)
    cls = rng.integers(1, 4, (2, 48)).astype(np.int32)
    snr = jnp.full((2,), 1.0, jnp.float32)
    params = flax_like(jax.eval_shape(
        jfj.LateFusionJSCC(jcfg).init, jax.random.key(0), img, pts, mask,
        snr, jax.random.key(1))["params"], 16)
    kch = jax.random.key(17)
    lid = jcfg.lidar
    target = jlid.semantic_bev_target(pts, mask, cls, lid.bev_hw, lid.x_range,
                                      lid.y_range, num_classes=lid.seg_classes)

    def loss_fn(cfg):
        m = jfj.LateFusionJSCC(cfg)

        def fn(p):
            recon, logits, aux = m.apply({"params": p}, img, pts, mask, snr,
                                         kch)
            ce = jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
                logits, target))
            return (jnp.mean(jnp.square(recon - img)) + 0.5 * ce
                    + aux["vq_loss"]), aux
        return fn

    ((loss, aux), grads), ((loss32, aux32), exact), held = _held_grads(
        loss_fn(jcfg), loss_fn(_pair("c3", C3_VQ, False)[0]), params)
    state = tfj.create_train_state(tcfg, 0, "cpu")
    net = state.params
    net.load_state_dict(_by_name(net, params))
    k_cam, k_lid = jax.random.split(kch)
    noise = (_t(jax.random.normal(k_cam, (2, 4 * 4 * 4, 2))),
             _t(jax.random.normal(k_lid, (2, 64 * 2, 2))))
    t_in = [_t(a) for a in (img, pts, mask, cls)]
    tloss, out = held.run(tfj.loss_fn, tcfg, net, *t_in[:3],
                          tfj.bev_target(tcfg, *t_in[1:]), _t(snr),
                          channel_noise=noise)
    assert float(out[4]["index_error_rate"]) > 0
    _loss_close(tloss, loss, loss32, "loss")
    _loss_close(out[4]["vq_loss"], aux["vq_loss"], aux32["vq_loss"],
                "vq_loss")
    tloss.backward()
    close_grads(_port_grads(net), _by_name(net, grads), _by_name(net, exact),
                after_max=["lidar.pfn."])
    assert all(p.dtype == torch.float32 for p in net.parameters())


# --- (c) the damage probes ---------------------------------------------------

PROBES = ["channel.uep_probes=3"]
PRUNED = C1_VQ + PROBES + ["camera.vq_prune=true"]
UEP = C1_VQ + PROBES + ["channel.uep_alpha=0.25"]


def test_drop_damage_and_uep_weights_bf16_match_jax():
    """Through the bf16 decoder, given JAX's probes: the drop-damage and
    single-bit damage estimates and the UEP weights under ``close_grads``'s
    rule (JAX's f32 estimate the exact one); the half of the tokens the
    drop damage ranks first agrees but at near-ties of JAX's damage."""
    img = _img(40, b=4)
    snr = jnp.full((4,), 2.0, jnp.float32)
    idx = jnp.asarray(np.random.default_rng(42).integers(0, CODES, (4, 16)),
                      jnp.int32)
    key = jax.random.key(43)
    probes = _t(jax.random.normal(key, (3, 4, 16, 16, 3)))
    want, exact, got = {}, {}, {}
    params = None
    for over, calls in ((PRUNED, {"token_drop_damage": (idx, key)}),
                        (UEP, {"token_damage": (idx, key),
                               "uep_weights": (idx, snr, key)})):
        jcfg, tcfg = _pair("c1", over)
        jm = jjscc.build_model(jcfg)
        j32 = jjscc.build_model(_pair("c1", over, False)[0])
        if params is None:      # the pruned tree: its mask_embed on top
            params = _filled(jm, 41, _j(img), snr, jax.random.key(0))
        tree = {k: v for k, v in params.items()
                if k != "mask_embed" or jcfg.camera.vq_prune}
        tm = _load(tjscc.build_model(tcfg), tree)
        for name, args in calls.items():
            for m, out in ((jm, want), (j32, exact)):
                out[name] = _exact_jit(functools.partial(
                    m.apply, method=name))({"params": tree}, *args)
            got[name] = getattr(tm, name)(*(_t(a) for a in args[:-1]),
                                          probes=probes)
    for v in got.values():
        assert v.dtype == torch.float32 and not v.requires_grad
    close_grads(got, want, exact)
    m_keep = torch.full((4,), 8)
    dmg = np.asarray(want["token_drop_damage"])
    kept_t = tvq.topk_mask(got["token_drop_damage"], m_keep).numpy()
    kept_j = tvq.topk_mask(_t(dmg), m_keep).numpy()
    tol = 4 * float(np.abs(dmg - np.asarray(
        exact["token_drop_damage"])).max())
    for row in range(4):
        edge = np.sort(dmg[row])[::-1][7:9].mean()
        swapped = kept_t[row] != kept_j[row]
        assert np.all(np.abs(dmg[row][swapped] - edge) <= tol), row


# --- (d) the codebook seeding ------------------------------------------------

# c4_digital at the small widths of ``test_torch_c4_digital.py``: the VQ
# camera and the pruned VQ LiDAR, both codebooks re-seeded, the usage term
# on the LiDAR's, no V2X link (the chip's c4_digital); bf16 activations.
DIGITAL = ("camera.arch=vq", *PRUNE, *RESEED, "env.v2x_rays=0",
           "train.bf16=true")

def test_seeding_features_bf16_match_jax():
    """``seed_vq_codebook_params`` of a bf16 c4_digital trunk: the camera's
    and the ego LiDAR's code features on the same 64 observations, bf16
    values widened as JAX's (JAX's XLA route: two steps)."""
    over = DIGITAL
    jcfg, tcfg = _digital_configs("c4", over)
    params = _digital_params("c4", over)
    obs = jax.jit(lambda k: jenv.observe_batch(jcfg.env, jenv.reset_batch(
        jcfg.env, k, 64)))(jax.random.key(50))
    seen = {"jax": [], "port": []}

    def capture(side, ret):
        def fn(tree, z, *a, **kw):
            if side == "jax":
                jax.debug.callback(lambda v: seen["jax"].append(
                    np.asarray(v)), z)
            else:
                seen["port"].append(z.clone())
            return ret(tree, z, *a, **kw)
        return fn

    with mock.patch.object(jenv, "observe_batch", lambda cfg, s: obs), \
            mock.patch.object(jvq, "seed_codebook",
                              capture("jax", jvq.seed_codebook)):
        jax.block_until_ready(_exact_jit(
            lambda p: jwarm.seed_vq_codebook_params(
                jcfg, p, jax.random.key(51)))(params))
    net = _load(TQNetwork(tcfg), params)
    with mock.patch.object(tenv, "reset_batch", lambda *a: None), \
            mock.patch.object(tenv, "observe_batch",
                              lambda cfg, s: tuple(_t(x) for x in obs)), \
            mock.patch.object(twarm, "seed_codebook",
                              capture("port", twarm.seed_codebook)):
        twarm.seed_vq_codebook_params(tcfg, net)
    assert len(seen["jax"]) == len(seen["port"]) == 2     # camera, LiDAR
    for what, got, want in zip(("camera", "LiDAR"), seen["port"],
                               seen["jax"]):
        _bf16_valued(want, f"JAX's {what} features")
        _bf16_valued(got, f"{what} features")
        _close(got, want, what, 2)


# --- (f) the observability gaps and replay.add -------------------------------

def test_replay_add_matches_jax_over_a_wraparound():
    example = jdqn.Transition(
        image=np.zeros((4, 4, 3), np.uint8), points=np.zeros((5, 4),
                                                             np.float32),
        mask=np.zeros(5, bool), action=np.int32(0), reward=np.float32(0),
        done=False, next_image=np.zeros((4, 4, 3), np.uint8),
        next_points=np.zeros((5, 4), np.float32), next_mask=np.zeros(5, bool))
    jbuf = jreplay.create(example, 3)
    tbuf = treplay.create(tdqn.Transition(*(_t(x) for x in example)), 3,
                          "cpu")
    rng = np.random.default_rng(70)
    for i in range(5):
        tr = jdqn.Transition(*(np.asarray(
            rng.integers(0, 200, np.shape(x)) if np.asarray(x).dtype != bool
            else rng.uniform(size=np.shape(x)) < 0.5).astype(
                np.asarray(x).dtype) for x in example))
        jbuf = jreplay.add(jbuf, tr)
        tbuf = treplay.add(tbuf, tdqn.Transition(*(_t(x) for x in tr)))
        assert (tbuf.cursor, tbuf.size) == (int(jbuf.cursor),
                                            int(jbuf.size)) == (
            (i + 1) % 3, min(i + 1, 3))
    for got, want in zip(tbuf.data, jbuf.data):
        assert got.dtype == _t(np.asarray(want)).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_annotate_is_a_named_scope_on_the_cpu():
    x = torch.arange(6.0)
    with tobs.annotate("vq_step"):
        y = x * 2
    assert torch.equal(y, 2 * x)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tobs.annotate("vq_step"):
            (x + 1).sum()
    assert "vq_step" in {e.key for e in prof.key_averages()}

    @tobs.annotate("decorated")
    def f(v):
        return v + 1

    assert torch.equal(f(x), x + 1)


def test_obs_exports_the_jax_names():
    names = {n for n in dir(jobs) if not n.startswith("_")} - {
        "metrics_writer", "profiling"}
    assert names == {"MetricsWriter", "Timer", "steps_per_sec_per_chip",
                     "NaNWatchdog", "annotate", "corrupt_symbols",
                     "maybe_trace"}
    for n in names:
        assert callable(getattr(tobs, n)), n
