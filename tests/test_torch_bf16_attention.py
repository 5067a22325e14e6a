"""``train.bf16`` on the attention paths: the ViT camera, the unfused fusion
MHA and the packed and flash attention, against the JAX package's bf16 run
on the CPU.

* (a) The twins round the softmax probabilities to V's dtype before P V,
  as JAX's do: on bf16 inputs within one bf16 step of JAX's (the formula
  before the repair lies hundreds of steps away), on f32 inputs bit for bit
  what they gave before;
* (b) the kernels' plain versions, which the CPU paths run on bf16
  tensors, against JAX's Pallas kernels in interpret mode, forward and
  ``jax.vjp``: the packed ones (``mxu_bf16`` False and True) at Lq = 200,
  two 128-query blocks, whose dK and dV JAX sums per block in bf16 (a
  version that rounds them once fails the same gate), and the flash ones;
* (c) ``ViTJSCC`` (its attention plain, packed and flash) and the unfused
  ``FusionTransformer`` in bf16, with ``use_pallas`` on and off;
* (d) a bf16 c3 train step's loss and gradients (the ViT camera on the
  packed attention) and a bf16 c4 ViT-trunk TD loss with its gradients,
  under ``close_grads``;
* (e) ``activation_dtype`` takes the ViT, ``pallas_attention`` and the
  unfused MHA and still refuses the VQ codecs.

Inputs are numpy draws from a seed rounded to bf16 on both sides;
parameters are ``eval_shape`` of the flax init filled from numpy
(``flax_like``). Gates on a kernel's bf16 outputs (``_bf16_gate``): at most
1% of the entries differ in their bits, and each lies within 2 bf16 steps
of the tensor's largest entry. Both sides round the same values at the
same places; the f32 sums before a rounding run in other orders, so now
and then one rounding flips by a step, and a flipped probability or dS
moves an output by a step of its own size. A module's outputs carry such
flips through every later layer, so there only the 2 steps hold, as in
``test_torch_bf16.py``, which states the module and gradient tolerances.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_sc_torch.act_dtype import activation_dtype
from multimodal_sc_torch.codec import camera_vit as tvit
from multimodal_sc_torch.config import get_preset as t_preset
from multimodal_sc_torch.fusion import transformer as tfus
from multimodal_sc_torch.kernels import attention as tattn
from multimodal_sc_torch.kernels import attention_packed as tpacked
from multimodal_sc_torch.rl import dqn as tdqn
from multimodal_sc_torch.rl.perception import QNetwork as TQNetwork
from multimodal_sc_torch.train import fusion_jscc as tfj
from multimodal_sc_tpu.codec import camera_vit as jvit
from multimodal_sc_tpu.codec import lidar_bev as jlid
from multimodal_sc_tpu.fusion import transformer as jfus
from multimodal_sc_tpu.kernels import attention_packed as jpacked
from multimodal_sc_tpu.rl import dqn as jdqn
from multimodal_sc_tpu.train import fusion_jscc as jfj
from test_torch_bf16 import ULP, _filled, _load, close_grads
from test_torch_bf16_slice import (PFN, RL_LOSS, _batch, _by_name,
                                   _configs, _f32, _learn_draws, _perturb,
                                   _port, _port_grads, _rel, _scatter_vjp,
                                   _t)
from test_torch_c4_digital import flax_like

jattn = importlib.import_module("multimodal_sc_tpu.kernels.attention")

torch.backends.cuda.matmul.allow_tf32 = False

BF16 = torch.bfloat16


def _draws(seed, *shapes):
    """bf16 draws, as (JAX, torch) pairs of the same values."""
    rng = np.random.default_rng(seed)
    out = []
    for s in shapes:
        j = jnp.asarray(rng.standard_normal(s).astype(np.float32),
                        jnp.bfloat16)
        out.append((j, torch.from_numpy(np.asarray(j.astype(jnp.float32)))
                    .to(BF16)))
    return out


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _steps(got, want):
    """|got - want| in bf16 steps of the larger of the two, entry by
    entry."""
    g, w = _f(got), _f(want)
    _, e = np.frexp(np.maximum(np.maximum(np.abs(g), np.abs(w)), 1e-30))
    return np.abs(g - w) / np.ldexp(1.0, e - 8)


def _bf16_gate(got, want, what, share=1e-2, ulps=2):
    """At most ``share`` of the entries differ, each within ``ulps`` bf16
    steps of the tensor's largest entry."""
    g, w = _f(got), _f(want)
    differ = float(np.mean(g != w))
    assert differ <= share, f"{what}: {100 * differ:.2f}% of entries differ"
    np.testing.assert_allclose(g, w, atol=ulps * ULP * np.abs(w).max(),
                               rtol=0, err_msg=what)


# --- (a) fault 1: the twins round P to V's dtype -------------------------------

def _twins(heads):
    """Each twin as (port function, JAX function, split of a packed (B, L,
    H*d) input into its layout)."""
    def split(t):
        if isinstance(t, torch.Tensor):
            return tpacked._split(t, heads)
        b, l, dm = t.shape
        return t.reshape(b, l, heads, dm // heads).transpose(0, 2, 1, 3)

    return {"packed": (lambda q, k, v: tpacked.packed_attention_reference(
                           q, k, v, heads),
                       lambda q, k, v: jpacked.packed_attention_reference(
                           q, k, v, heads), lambda t: t),
            "flash": (tattn.attention_reference, jattn.attention_reference,
                      split)}


@pytest.mark.parametrize("twin", ["packed", "flash"])
def test_twins_round_probabilities_like_jax(twin):
    heads = 4
    port, jax_twin, layout = _twins(heads)[twin]
    (jq, tq), (jk, tk), (jv, tv) = _draws(
        1, (2, 33, 128), (2, 70, 128), (2, 70, 128))
    want = jax_twin(*(layout(t) for t in (jq, jk, jv)))
    got = port(*(layout(t) for t in (tq, tk, tv)))
    assert got.dtype == BF16
    assert _steps(got, want).max() <= 1.0
    # The formula before the repair (f32 probabilities into P V).
    qh, kh, vh = (tpacked._split(t.float(), heads) for t in (tq, tk, tv))
    unrounded = torch.softmax(qh @ kh.transpose(-1, -2) * 32 ** -0.5,
                              dim=-1) @ vh
    unrounded = layout(tpacked._merge(unrounded).to(BF16))
    assert _steps(unrounded, want).max() > 8.0
    # f32 inputs: the same bits as the formula before the repair.
    f32 = [t.float() for t in (tq, tk, tv)]
    before = tpacked._merge(torch.softmax(
        qh @ kh.transpose(-1, -2) * 32 ** -0.5, dim=-1) @ vh)
    assert torch.equal(port(*(layout(t) for t in f32)), layout(before))


# --- (b) the kernels' plain versions against JAX's kernels in interpret mode ---

def _once_rounded(q, k, v, out, dout, heads, mxu):
    """dK and dV summed over every query in f32 and rounded once: what the
    per-block rounding replaces."""
    grads = tpacked.packed_attention_bwd_reference(
        *(t.float() for t in (q, k, v, out, dout)), heads, bf16=mxu)
    return [g.to(BF16) for g in grads]


@pytest.mark.parametrize("mxu", [False, True])
def test_packed_plain_versions_match_jax_kernels_bf16(mxu):
    heads, lq, lk = 4, 200, 48
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _draws(
        2, (2, lq, 128), (2, lk, 128), (2, lk, 128), (2, lq, 128))
    want, vjp = jax.vjp(functools.partial(
        jpacked.packed_attention, heads=heads, interpret=True, mxu_bf16=mxu),
        jq, jk, jv)
    want_g = vjp(jdo)
    ins = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    before = (tpacked.launches_fwd_bf16, tpacked.launches_bwd_bf16)
    out = tpacked.packed_attention(*ins, heads, mxu_bf16=mxu)
    got = torch.autograd.grad(out, ins, tdo)
    assert (tpacked.launches_fwd_bf16, tpacked.launches_bwd_bf16) == before
    assert out.dtype == BF16 and all(g.dtype == BF16 for g in got)
    _bf16_gate(out, want, "out")
    for name, g, w in zip("qkv", got, want_g):
        _bf16_gate(g, w, f"d{name}")
    # Lq = 200 is two of JAX's 128-query blocks: dK and dV rounded once
    # over all queries fail the gate the per-block sums pass.
    once = _once_rounded(tq, tk, tv, out, tdo, heads, mxu)
    for name, g, w in zip("kv", once[1:], want_g[1:]):
        with pytest.raises(AssertionError):
            _bf16_gate(g, w, f"d{name} rounded once")


def test_packed_plain_version_blocks_by_128_queries():
    """One block up to Lq = 128: there the block sums are the once-rounded
    sums, bit for bit."""
    heads = 4
    (_, q), (_, k), (_, v), (_, do) = _draws(
        3, (2, 128, 128), (2, 40, 128), (2, 40, 128), (2, 128, 128))
    out, lse = tpacked.packed_attention_fwd_reference(q, k, v, heads)
    got = tpacked.packed_attention_bwd_reference(q, k, v, out, do, heads,
                                                 lse=lse)
    f32 = tpacked.packed_attention_bwd_reference(
        *(t.float() for t in (q, k, v, out, do)), heads, lse=lse)
    for g, w in zip(got, f32):
        assert torch.equal(g, w.to(BF16))


def test_flash_plain_versions_match_jax_kernels_bf16():
    b, h, lq, lk, d = 2, 3, 200, 70, 64
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _draws(
        4, (b, h, lq, d), (b, h, lk, d), (b, h, lk, d), (b, h, lq, d))
    want, vjp = jax.vjp(functools.partial(jattn.flash_attention,
                                          interpret=True), jq, jk, jv)
    want_g = vjp(jdo)
    ins = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    before = (tattn.launches_fwd_bf16, tattn.launches_bwd_dq_bf16,
              tattn.launches_bwd_dkv_bf16)
    out = tattn.attention(*ins, use_pallas=True)
    got = torch.autograd.grad(out, ins, tdo)
    assert (tattn.launches_fwd_bf16, tattn.launches_bwd_dq_bf16,
            tattn.launches_bwd_dkv_bf16) == before
    assert out.dtype == BF16 and all(g.dtype == BF16 for g in got)
    _bf16_gate(out, want, "out")
    for name, g, w in zip("qkv", got, want_g):
        _bf16_gate(g, w, f"d{name}")


def test_packed_kernel_refuses_bf16_in_its_f32_mode():
    """The f32 mode no longer refuses bf16 tensors: with ``mxu_bf16=False``
    they take its bf16-I/O instance (the flash kernels with T = bf16, dK
    and dV rounded per 128-query block); here the rule that decides each
    launcher mode."""
    z = torch.zeros(1, 8, 128, dtype=BF16)
    assert tpacked._mode(z, False) == tpacked._MODE_F32_BF16_IO
    assert tpacked._mode(z, True) == tpacked._MODE_BF16_IO
    assert tpacked._mode(z.float(), True) == tpacked._MODE_BF16
    assert tpacked._mode(z.float(), False) == tpacked._MODE_F32


# --- (c) the modules ---------------------------------------------------------

VITS = {"plain attention": (128, 4, False),
        "packed attention": (128, 4, True),
        "flash attention": (192, 3, True)}


@pytest.mark.parametrize("name", sorted(VITS))
def test_vit_jscc_bf16_matches_jax(name):
    dim, heads, pallas = VITS[name]
    kw = dict(image_hw=(16, 16), patch=4, dim=dim, depth=1, heads=heads,
              c_sym=4, use_pallas=pallas)
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    snr = np.array([3.0, 12.0], np.float32)
    jm = jvit.ViTJSCC(dtype=jnp.bfloat16, **kw)
    params = _filled(jm, 6, jnp.asarray(img), jnp.asarray(snr))
    z = jm.apply({"params": params}, jnp.asarray(img), jnp.asarray(snr),
                 method="encode")
    recon = jm.apply({"params": params}, z, jnp.asarray(snr),
                     method="decode")
    tm = _load(tvit.ViTJSCC(dtype=BF16, **kw), params)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    with torch.no_grad():
        tz = tm.encode(torch.from_numpy(img), torch.from_numpy(snr))
        trecon = tm.decode(torch.from_numpy(_f(z)), torch.from_numpy(snr))
    assert tz.dtype == trecon.dtype == torch.float32
    _bf16_gate(tz, z, "symbols", share=1.0)
    _bf16_gate(trecon, recon, "image", share=1.0)


@pytest.mark.parametrize("pallas", [False, True])
def test_unfused_fusion_transformer_bf16_matches_jax(pallas):
    rng = np.random.default_rng(7)
    cam = rng.standard_normal((2, 16, 24)).astype(np.float32)
    lid = rng.standard_normal((2, 36, 16)).astype(np.float32)
    kw = dict(dim=128, depth=1, heads=4, state_dim=32,
              mode="cross_attention", use_pallas=pallas, fused_block=False)
    jm = jfus.FusionTransformer(dtype=jnp.bfloat16, **kw)
    params = _filled(jm, 8, jnp.asarray(cam), jnp.asarray(lid))
    want = jm.apply({"params": params}, jnp.asarray(cam), jnp.asarray(lid))
    tm = _load(tfus.FusionTransformer(cam_in=24, lid_in=16, dtype=BF16, **kw),
               params)
    with torch.no_grad():
        got = tm(torch.from_numpy(cam), torch.from_numpy(lid))
    assert got.dtype == torch.float32
    _bf16_gate(got, want, "state", share=1.0)


# --- (d) the training steps ----------------------------------------------------

C3 = ["camera.image_hw=16,16", "camera.depth=1", "camera.c_sym=4",
      "lidar.pillar_dim=16", "lidar.max_points=48", "lidar.bev_hw=8,8",
      "train.batch_size=2", "pallas_attention=true", "train.bf16=true",
      "use_pallas=true"]


def test_c3_vit_step_loss_and_gradients_bf16_match_jax():
    """The c3 loss (the ViT camera on the packed attention, the analog
    LiDAR) and its gradients against JAX's train step's ``loss_fn`` on the
    same channel draws; JAX's f32 run is the exact one."""
    jcfg, tcfg = _configs("c3", C3)
    rng = np.random.default_rng(40)
    img = rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    pts = np.stack([rng.uniform(-4, 52, (2, 48)), rng.uniform(-14, 14, (2, 48)),
                    rng.uniform(0, 1.8, (2, 48)), rng.uniform(0, 1, (2, 48))],
                   -1).astype(np.float32)
    mask = rng.uniform(0, 1, (2, 48)) < 0.85
    cls = rng.integers(1, 4, (2, 48)).astype(np.int32)
    snr = jnp.full((2,), jcfg.channel.snr_db, jnp.float32)
    params = flax_like(jax.eval_shape(
        jfj.LateFusionJSCC(jcfg).init, jax.random.key(0), img, pts, mask,
        snr, jax.random.key(1))["params"], 41)
    kch = jax.random.split(jax.random.key(42))[1]
    lid = jcfg.lidar
    target = jlid.semantic_bev_target(pts, mask, cls, lid.bev_hw, lid.x_range,
                                      lid.y_range, num_classes=lid.seg_classes)

    def grad(cfg):
        m = jfj.LateFusionJSCC(cfg)

        def loss_fn(p):
            # JAX's train step's loss_fn (train/fusion_jscc.py), unpruned.
            recon, logits, _ = m.apply({"params": p}, img, pts, mask, snr, kch)
            return jnp.mean(jnp.square(recon - img)) + 0.5 * jnp.mean(
                optax.softmax_cross_entropy_with_integer_labels(logits,
                                                                target))

        return jax.jit(jax.value_and_grad(loss_fn))(params)

    with _scatter_vjp():
        loss, grads = grad(jcfg)
        _, exact = grad(_configs("c3", _f32(C3))[0])
    state = tfj.create_train_state(tcfg, 0, "cpu")
    net = state.params
    net.load_state_dict(_by_name(net, params))
    k_cam, k_lid = jax.random.split(kch)
    noise = (_t(jax.random.normal(k_cam, (2, 4 * 4 * 4, 2))),
             _t(jax.random.normal(k_lid, (2, 64 * lid.c_sym, 2))))
    t_in = [torch.from_numpy(a) for a in (img, pts, mask, cls)]
    tloss, _ = tfj.loss_fn(tcfg, net, *t_in[:3], tfj.bev_target(
        tcfg, *t_in[1:]), _t(snr), channel_noise=noise)
    _rel(tloss.detach(), loss, "loss")
    tloss.backward()
    close_grads(_port_grads(net), _by_name(net, grads), _by_name(net, exact),
                after_max=["lidar.pfn."])
    assert all(p.dtype == torch.float32 for p in net.parameters())


VIT_RL = RL_LOSS + ["camera.arch=vit", "camera.depth=2",
                    "pallas_attention=true"]


def test_c4_vit_trunk_td_loss_and_gradients_bf16_match_jax():
    jcfg, tcfg = _configs("c4", VIT_RL)
    params = flax_like(jax.eval_shape(lambda k: jdqn.init_params(jcfg, k),
                                      jax.random.key(0)), 1)
    target = _perturb(params, 2, 0.02)
    batch = _batch(jcfg)
    key = jax.random.key(21)

    def grad(cfg):
        return jax.jit(jax.value_and_grad(
            lambda p: jdqn._td_loss(p, target, batch, key, cfg),
            has_aux=True))(params)

    (loss, _), grads = grad(jcfg)
    _, exact = grad(_configs("c4", _f32(VIT_RL))[0])
    online, target_net = (_port(TQNetwork, tcfg, params),
                          _port(TQNetwork, tcfg, target))
    tloss = tdqn._td_loss(tcfg, tdqn.learner_forward(tcfg), online,
                          target_net,
                          tdqn.Transition(*(_t(x) for x in batch)),
                          _learn_draws(jcfg, key))
    assert tloss.dtype == torch.float32
    _rel(tloss.detach(), loss, "loss")
    tloss.backward()
    close_grads(_port_grads(online), _by_name(online, grads),
                _by_name(online, exact), after_max=PFN)


# --- (e) activation_dtype ------------------------------------------------------

ACCEPTED = {
    "c3 preset (ViT, packed attention)": ("c3", ["pallas_attention=true"]),
    "c3 arm F (flash attention)": ("c3", ["pallas_attention=true",
                                          "camera.dim=192",
                                          "camera.heads=3"]),
    "c4 ViT trunk": ("c4", ["camera.arch=vit", "pallas_attention=true"]),
    "c4 arm B (unfused MHA)": ("c4", ["pallas_mha_block=false",
                                      "pallas_attention=true"]),
    "c1 ViT": ("c1", ["camera.arch=vit"]),
}
VQ_CODECS = {"camera vq": ("c4", ["camera.arch=vq"]),
             "lidar vq": ("c3", ["lidar.arch=vq"]),
             "both vq": ("c4", ["camera.arch=vq", "lidar.arch=vq"])}


@pytest.mark.parametrize("name", sorted(ACCEPTED))
def test_activation_dtype_takes_the_attention_paths(name):
    preset, over = ACCEPTED[name]
    cfg = t_preset(preset).override_str(["train.bf16=true", *over])
    assert activation_dtype(cfg) == BF16
    assert activation_dtype(t_preset(preset).override_str(over)) == \
        torch.float32


@pytest.mark.parametrize("name", sorted(VQ_CODECS))
def test_activation_dtype_takes_the_vq_codecs(name):
    """The VQ codecs build in bf16 on f32 parameters (their slice:
    ``test_torch_bf16_vq.py``)."""
    preset, over = VQ_CODECS[name]
    cfg = t_preset(preset).override_str(["train.bf16=true", *over])
    assert activation_dtype(cfg) == BF16
    if preset == "c3":
        net = tfj.build_lidar_codec(cfg)
        to_code = [net.to_code]
    else:
        with torch.device("meta"):
            net = TQNetwork(cfg)
        per = net.perception
        to_code = [m.to_code if m is per.cam_vq else m for m in (
            getattr(per, "cam_vq", None), getattr(per, "lid_to_code", None))
            if m is not None]
    assert len(to_code) == len([o for o in over if o.endswith("=vq")])
    assert all(m.act_dtype == BF16 for m in to_code)
    assert all(p.dtype == torch.float32 for p in net.parameters())
