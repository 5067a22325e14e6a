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
from multimodal_sc_torch.kernels import conv_block as tconv
from multimodal_sc_torch.kernels import mha_block as tmha
from multimodal_sc_torch.kernels import pillar_scatter as tscatter
from multimodal_sc_tpu.fusion.transformer import FusedMHABlock as JFusedMHABlock
from multimodal_sc_tpu.kernels import conv_block as jconv
from multimodal_sc_tpu.kernels import mha_block as jmha
from multimodal_sc_tpu.kernels import pillar_scatter as jscatter


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
