"""The port's kernel modules against the JAX package on the CPU.

On a CPU tensor each port wrapper runs its plain PyTorch version; the JAX
side runs its Pallas kernel in interpret mode and its XLA reference. The
same inputs, made with numpy from a seed, go to both. The CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sc_torch import bridge
from multimodal_sc_torch.fusion.transformer import FusedMHABlock as TFusedMHABlock
from multimodal_sc_torch.kernels import attention as tattn
from multimodal_sc_torch.kernels import attention_packed as tpacked
from multimodal_sc_torch.kernels import conv_block as tconv
from multimodal_sc_torch.kernels import mha_block as tmha
from multimodal_sc_torch.kernels import pillar_scatter as tscatter
from multimodal_sc_tpu.fusion.transformer import FusedMHABlock as JFusedMHABlock
from multimodal_sc_tpu.kernels import attention_packed as jpacked
from multimodal_sc_tpu.kernels import conv_block as jconv
from multimodal_sc_tpu.kernels import mha_block as jmha
from multimodal_sc_tpu.kernels import pillar_scatter as jscatter
from multimodal_sc_tpu.kernels.attention import (
    attention_reference as j_attention_reference)


def _mha_params(rng, dim):
    p = {}
    for k in jmha.PARAM_KEYS:
        if k.startswith("w"):
            p[k] = rng.standard_normal((dim, dim)) * dim ** -0.5
        elif "scale" in k:
            p[k] = 1.0 + 0.1 * rng.standard_normal(dim)
        else:
            p[k] = 0.1 * rng.standard_normal(dim)
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("lq,lk,heads", [(65, 256, 4), (256, 65, 4),
                                         (7, 100, 8)])
def test_mha_block_plain_matches_jax(lq, lk, heads):
    rng = np.random.default_rng(lq * 1000 + lk)
    dim = 128
    p = _mha_params(rng, dim)
    x_q = rng.standard_normal((2, lq, dim)).astype(np.float32)
    x_kv = rng.standard_normal((2, lk, dim)).astype(np.float32)
    assert tmha.block_eligible(heads, dim, lk)
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    j_kernel = jmha.mha_block(jnp.asarray(x_q), jnp.asarray(x_kv), pj, heads,
                              interpret=True, mxu_bf16=False)
    j_ref = jmha.mha_block_reference(jnp.asarray(x_q), jnp.asarray(x_kv), pj,
                                     heads)
    before = tmha.launches
    out = tmha.mha_block(torch.from_numpy(x_q), torch.from_numpy(x_kv),
                         {k: torch.from_numpy(v) for k, v in p.items()},
                         heads).numpy()
    assert tmha.launches == before        # CPU tensors: no kernel launch
    # f32 on both sides, summed in another order: the JAX kernel test's gate.
    np.testing.assert_allclose(out, np.asarray(j_kernel), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out, np.asarray(j_ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("lq,lk,heads", [(65, 256, 4), (256, 65, 4),
                                         (7, 100, 8)])
def test_mha_block_bf16_plain_matches_jax_bf16(lq, lk, heads):
    """The plain version of the kernel's bf16 mode (the card's check of that
    mode holds the kernel against it) against the JAX kernel's bf16 mode."""
    rng = np.random.default_rng(lq * 1000 + lk)
    dim = 128
    p = _mha_params(rng, dim)
    x_q = rng.standard_normal((2, lq, dim)).astype(np.float32)
    x_kv = rng.standard_normal((2, lk, dim)).astype(np.float32)
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    j_bf16 = np.asarray(jmha.mha_block(jnp.asarray(x_q), jnp.asarray(x_kv),
                                       pj, heads, interpret=True,
                                       mxu_bf16=True))
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    args = (torch.from_numpy(x_q), torch.from_numpy(x_kv), pt, heads)
    got = tmha.mha_block_reference_bf16(*args).numpy()
    f32 = tmha.mha_block_reference(*args).numpy()
    # The same operands are rounded to bf16 on both sides, but the JAX
    # kernel rounds the normalised probabilities and the port's the
    # unnormalised ones of each 32-key tile: each probability may differ by
    # one bf16 step (2^-8 relative), which moves the O(1) outputs by a few
    # 1e-3. The f32 result differs from both by about as much.
    np.testing.assert_allclose(got, j_bf16, atol=1e-2, rtol=1e-2)
    assert np.abs(got - f32).max() > 1e-4      # the rounding really happens


def test_kernel_eligible_takes_only_built_head_dims():
    # The JAX rule accepts every head dim that divides 128; the CUDA kernel
    # is built for 8-64, and FusedMHABlock runs the plain version otherwise.
    for heads in (1, 32, 64, 128):
        assert tmha.block_eligible(heads, 128, 65)
        assert not tmha.kernel_eligible(heads, 128, 65)
    for heads in (2, 4, 8, 16):
        assert tmha.kernel_eligible(heads, 128, 65)
    assert not tmha.kernel_eligible(4, 128, 2049)


@pytest.mark.parametrize("self_attn,lq,lk", [(False, 9, 130), (True, 33, 33)])
def test_fused_mha_module_matches_jax(self_attn, lq, lk):
    rng = np.random.default_rng(7)
    x_q = rng.standard_normal((2, lq, 128)).astype(np.float32)
    x_kv = rng.standard_normal((2, lk, 128)).astype(np.float32)
    jm = JFusedMHABlock(dim=128, heads=4, self_attn=self_attn,
                        use_kernel=False)
    args = (jnp.asarray(x_q),) if self_attn else (jnp.asarray(x_q),
                                                  jnp.asarray(x_kv))
    params = jm.init(jax.random.key(3), *args)["params"]
    # Perturb the LayerNorm params so a wrongly shared or swapped norm shows.
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32)), params)
    want = jm.apply({"params": params}, *args)
    tm = TFusedMHABlock(128, 4, self_attn=self_attn)
    tm.load_state_dict(bridge.to_state_dict(params, tm))
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    with torch.no_grad():
        got = tm(*targs).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("hw,stride,prelu", [
    ((8, 8), 1, True), ((8, 8), 2, True), ((7, 9), 1, False),
    ((7, 9), 2, True), ((8, 8), 2, False)])
def test_conv_prelu_plain_matches_jax(hw, stride, prelu):
    rng = np.random.default_rng(hw[1] * 10 + stride)
    cin, cout = 3, 8
    x = rng.standard_normal((2, *hw, cin)).astype(np.float32)
    w = (0.2 * rng.standard_normal((5, 5, cin, cout))).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    a = rng.uniform(0, 1, cout).astype(np.float32) if prelu else None
    ja = jnp.asarray(a) if prelu else None
    j_kernel = jconv.conv_prelu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                ja, stride=stride, use_pallas=True,
                                interpret=True)
    j_ref = jconv.conv_prelu_reference(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b), ja, stride)
    before = tconv.launches
    out = tconv.conv_prelu(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b),
                           torch.from_numpy(a) if prelu else None,
                           stride).numpy()
    assert tconv.launches == before
    assert out.shape == j_ref.shape
    np.testing.assert_allclose(out, np.asarray(j_kernel), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out, np.asarray(j_ref), atol=1e-5, rtol=1e-5)


def test_conv_prelu_same_pads_match_xla():
    # Stride 2 on an even input pads 1 before and 2 after; odd sizes and
    # stride 1 pad symmetrically.
    assert tconv.same_pads(32, 5, 2) == (1, 2)
    assert tconv.same_pads(16, 5, 2) == (1, 2)
    assert tconv.same_pads(8, 5, 1) == (2, 2)
    assert tconv.same_pads(7, 5, 2) == (2, 2)


def test_scatter_max_plain_matches_jax():
    rng = np.random.default_rng(5)
    b, n, d, cells = 3, 40, 16, 12
    feats = rng.standard_normal((b, n, d)).astype(np.float32)
    cell = rng.integers(0, cells + 1, (b, n)).astype(np.int32)
    cell[0, :10] = cells                    # trash-cell points
    cell[1, :] = np.where(cell[1] == 4, 5, cell[1])   # cell 4 empty in env 1
    cell[2, :3] = 7                         # an all-negative cell
    cell[2, 3:] = np.where(cell[2, 3:] == 7, 8, cell[2, 3:])
    feats[2, :3] = -np.abs(feats[2, :3]) - 0.5
    want = np.stack([np.asarray(jscatter.scatter_max_reference(
        jnp.asarray(feats[i]), jnp.asarray(cell[i]), cells)) for i in range(b)])
    want_pallas = np.stack([np.asarray(jscatter.scatter_max_pallas(
        jnp.asarray(feats[i]), jnp.asarray(cell[i]), cells, interpret=True))
        for i in range(b)])
    before = tscatter.launches
    got = tscatter.scatter_max(torch.from_numpy(feats),
                               torch.from_numpy(cell), cells).numpy()
    assert tscatter.launches == before
    # Max is exact: the same values, bit for bit.
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, want_pallas)
    assert (got[1, 4] == 0).all() and (got[2, 7] < 0).all()


def test_wrappers_backward_through_plain_version():
    """Gradients of the CPU path equal autograd of the plain versions (the
    CUDA forward's backward recomputes through them)."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 3)).astype(np.float32))
    w = torch.from_numpy((0.2 * rng.standard_normal((5, 5, 3, 8))).astype(
        np.float32)).requires_grad_(True)
    b = torch.zeros(8, requires_grad=True)
    y = tconv.conv_prelu(x, w, b, None, 2)
    y.square().sum().backward()
    assert w.grad is not None and torch.isfinite(w.grad).all()


# --- packed attention: plain versions against the JAX kernel --------------

def _qkv(seed, b, lq, lk, dm):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, lq, dm), (b, lk, dm), (b, lk, dm)))


@pytest.mark.parametrize("heads,lq,lk,dm", [
    (4, 65, 256, 128), (4, 256, 65, 128), (4, 33, 70, 128), (8, 64, 64, 256),
    (2, 17, 100, 128), (1, 40, 40, 128)])
def test_packed_attention_plain_matches_jax(heads, lq, lk, dm):
    q, k, v = _qkv(lq * 1000 + lk, 2, lq, lk, dm)
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    j_kernel = jpacked.packed_attention(jq, jk, jv, heads, interpret=True)
    j_ref = jpacked.packed_attention_reference(jq, jk, jv, heads)
    before = (tpacked.launches_fwd, tpacked.launches_bwd)
    out = tpacked.packed_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                                   heads).numpy()
    # CPU tensors: no kernel launch.
    assert (tpacked.launches_fwd, tpacked.launches_bwd) == before
    # f32 on both sides, summed in another order: the JAX kernel test's gate.
    np.testing.assert_allclose(out, np.asarray(j_kernel), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out, np.asarray(j_ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("heads,lq,lk,dm", [
    (4, 33, 70, 128), (8, 40, 24, 256), (4, 200, 48, 128)])
def test_packed_attention_gradients_match_jax(heads, lq, lk, dm):
    """Autograd of the CPU path, and the explicit backward formulas the CUDA
    backward kernels evaluate, against the JAX backward kernel."""
    q, k, v = _qkv(lq + lk, 1, lq, lk, dm)

    def loss(q, k, v):
        return jnp.sum(jpacked.packed_attention(q, k, v, heads,
                                                interpret=True) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(t)
                                               for t in (q, k, v)))
    ins = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out = tpacked.packed_attention(*ins, heads)
    got = torch.autograd.grad(out.square().sum(), ins)
    with torch.no_grad():
        explicit = tpacked.packed_attention_bwd_reference(
            *ins, out, 2.0 * out, heads)
    for a, e, w in zip(got, explicit, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(e.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


def test_packed_attention_bf16_plain_matches_jax_bf16():
    """The plain versions of the kernels' bf16 mode against the JAX kernels'
    bf16 mode, forward and backward."""
    heads = 4
    q, k, v = _qkv(9, 2, 65, 256, 128)
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))

    def fwd(q, k, v):
        return jpacked.packed_attention(q, k, v, heads, interpret=True,
                                        mxu_bf16=True)

    j_out, vjp = jax.vjp(fwd, jq, jk, jv)
    do = np.random.default_rng(10).standard_normal(q.shape).astype(np.float32)
    j_grads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    got = tpacked.packed_attention_reference_bf16(tq, tk, tv, heads)
    f32 = tpacked.packed_attention_reference(tq, tk, tv, heads)
    # Both round q, k, v and the NORMALISED probabilities to bf16 and sum in
    # f32: the roundings coincide, so the gate is far tighter than the 3e-2
    # against exact f32 (a rare flip of one probability's rounding, a step
    # of 2^-8 relative, is what 2e-3 leaves room for).
    np.testing.assert_allclose(got.numpy(), np.asarray(j_out), atol=2e-3,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), f32.numpy(), atol=3e-2, rtol=3e-2)
    assert (got - f32).abs().max() > 1e-4      # the rounding really happens
    t_grads = tpacked.packed_attention_bwd_reference(
        tq, tk, tv, torch.from_numpy(np.array(j_out)), torch.from_numpy(do),
        heads, bf16=True)
    for a, w in zip(t_grads, j_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=5e-3, rtol=0)


def test_packed_eligible_matches_jax_rule():
    for args in ((4, 32, 256), (1, 128, 64), (3, 32, 64), (4, 48, 64),
                 (4, 32, 100_000), (8, 32, 4096), (8, 32, 4097)):
        assert tpacked.packed_eligible(*args) == jpacked.packed_eligible(*args)
    assert tpacked.packed_eligible(4, 32, 256)
    assert not tpacked.packed_eligible(3, 32, 64)
    with pytest.raises(ValueError):
        z = torch.zeros(1, 8, 96)
        tpacked.packed_attention(z, z, z, heads=3)


def test_attention_dispatch_matches_jax_reference():
    rng = np.random.default_rng(12)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 3, 7, 24), (2, 3, 11, 24), (2, 3, 11, 24)))
    want = j_attention_reference(*(jnp.asarray(t) for t in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    for use_pallas in (False, True):      # a CPU tensor: the plain version
        got = tattn.attention(tq, tk, tv, use_pallas=use_pallas)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=2e-5)
