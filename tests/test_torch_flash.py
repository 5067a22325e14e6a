"""The port's flash attention module against the JAX package on the CPU.

The JAX side runs its three Pallas kernels (forward, dQ, dK/dV) in
interpret mode; the port, on CPU tensors, runs the plain versions that sit
beside its CUDA kernels: ``flash_attention_fwd_reference`` (out and
logsumexp), ``flash_attention_bwd_reference`` (the backward kernels'
formulas on the saved residuals) and autograd through the ``attention``
dispatch. Inputs are made with numpy from a seed and fed to both sides.
The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sc_torch.kernels import attention as tattn

# ``multimodal_sc_tpu.kernels`` exports a function named ``attention`` over
# the submodule of that name: ask for the module itself.
jattn = importlib.import_module("multimodal_sc_tpu.kernels.attention")

# (q shape, k/v shape): the shapes of the JAX package's own kernel tests.
SHAPES = {
    "self": ((2, 4, 64, 32), (2, 4, 64, 32)),
    "ragged": ((1, 2, 100, 32), (1, 2, 70, 32)),
    "tiny_ragged_d64": ((2, 2, 17, 64), (2, 2, 17, 64)),
    "cross": ((2, 4, 33, 32), (2, 4, 70, 32)),
    "d48": ((2, 4, 64, 48), (2, 4, 64, 48)),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    """Inputs from a seed, and the JAX kernels' output, saved logsumexp and
    gradients of ``vdot(out, g)`` (one interpret-mode run per shape)."""
    shape_q, shape_k = SHAPES[name]
    rng = np.random.default_rng(sorted(SHAPES).index(name))
    q, g = (rng.standard_normal(shape_q).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal(shape_k).astype(np.float32) for _ in range(2))
    jq, jk, jv, jg = (jnp.asarray(t) for t in (q, k, v, g))
    out, vjp = jax.vjp(
        lambda a, b, c: jattn.flash_attention(a, b, c, interpret=True),
        jq, jk, jv)
    grads = vjp(jg)
    lq, lk = shape_q[2], shape_k[2]
    _, lse = jattn._flash_attention_fwd_impl(
        jq, jk, jv, shape_q[-1] ** -0.5, min(128, jattn._round_up(lq, 128)),
        min(128, jattn._round_up(lk, 128)), True)
    # The residual is (B*H, 1, Lq padded to the block): cut and reshape.
    lse = np.asarray(lse)[:, 0, :lq].reshape(shape_q[:3])
    return (q, k, v, g, np.asarray(out), lse,
            tuple(np.asarray(t) for t in grads))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_flash_forward_and_lse_match_jax_kernel(name):
    q, k, v, _, want, want_lse, _ = _case(name)
    out, lse = tattn.flash_attention_fwd_reference(*_t(q, k, v))
    # f32 on both sides, sums in another order: the JAX kernel test's gate.
    np.testing.assert_allclose(out.numpy(), want, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=2e-5, rtol=2e-5)
    assert lse.shape == q.shape[:3] and lse.dtype == torch.float32
    got = tattn.flash_attention(*_t(q, k, v))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_flash_backward_matches_jax_kernels(name):
    q, k, v, g, _, _, want = _case(name)
    tq, tk, tv, tg = _t(q, k, v, g)
    out, lse = tattn.flash_attention_fwd_reference(tq, tk, tv)
    explicit = tattn.flash_attention_bwd_reference(tq, tk, tv, out, lse, tg)
    ins = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    auto = torch.autograd.grad(tattn.attention(*ins, use_pallas=True), ins, tg)
    # The JAX backward kernel test's gate.
    for e, a, w in zip(explicit, auto, want):
        np.testing.assert_allclose(e.numpy(), w, atol=2e-4, rtol=2e-4)
        np.testing.assert_allclose(a.numpy(), w, atol=2e-4, rtol=2e-4)


def test_backward_reference_is_its_two_kernels_and_takes_a_scale():
    q, k, v, g, _, _, _ = _case("cross")
    tq, tk, tv, tg = _t(q, k, v, g)
    scale = 0.3
    out, lse = tattn.flash_attention_fwd_reference(tq, tk, tv, scale)
    dq, delta = tattn.flash_attention_dq_reference(tq, tk, tv, out, lse, tg,
                                                   scale)
    dk, dv = tattn.flash_attention_dkv_reference(tq, tk, tv, lse, delta, tg,
                                                 scale)
    assert delta.shape == lse.shape
    ins = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    want = torch.autograd.grad(tattn.attention_reference(*ins, scale), ins, tg)
    for got, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, w, atol=2e-5, rtol=2e-5)
    want_j = jattn.attention_reference(*(jnp.asarray(t) for t in (q, k, v)),
                                       scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_j), atol=2e-5,
                               rtol=2e-5)


def test_use_pallas_on_cpu_runs_the_plain_version_and_launches_nothing():
    q, k, v, _, want, _, _ = _case("self")
    before = (tattn.launches_fwd, tattn.launches_bwd_dq,
              tattn.launches_bwd_dkv)
    got = tattn.attention(*_t(q, k, v), use_pallas=True)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    assert (tattn.launches_fwd, tattn.launches_bwd_dq,
            tattn.launches_bwd_dkv) == before == (0, 0, 0)


@pytest.mark.parametrize("what", ["odd_head_dim", "wide_head_dim", "bf16",
                                  "kv_mismatch", "grad_shape"])
def test_kernel_wrapper_validation(what):
    """What the CUDA wrappers refuse, checked before any launch."""
    q = torch.zeros(2, 3, 5, 16)
    k = torch.zeros(2, 3, 7, 16)
    if what == "odd_head_dim":
        bad = torch.zeros(2, 3, 5, 6)
        with pytest.raises(ValueError, match="head dim.*got 6"):
            tattn._check_cuda(bad, bad, bad)
    elif what == "wide_head_dim":
        bad = torch.zeros(1, 1, 4, 132)
        with pytest.raises(ValueError, match="head dim.*got 132"):
            tattn._check_cuda(bad, bad, bad)
    elif what == "bf16":
        # bf16 tensors are taken (the kernels' bf16-I/O instances), mixed
        # or other float types are not.
        assert tattn._check_cuda(q.bfloat16(), k.bfloat16(),
                                 k.bfloat16()) == (2, 3, 5, 7, 16)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            tattn._check_cuda(q.bfloat16(), k, k)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            tattn._check_cuda(q.half(), k.half(), k.half())
    elif what == "kv_mismatch":
        with pytest.raises(ValueError, match="disagree"):
            tattn._check_cuda(q, k, torch.zeros(2, 3, 8, 16))
    else:
        with pytest.raises(ValueError, match="expected shape"):
            tattn._check_cuda(q, k, k, torch.zeros(2, 3, 6, 16))
    assert tattn._check_cuda(q, k, k, q) == (2, 3, 5, 7, 16)


def test_kernels_read_head_views_in_place():
    """The transposed views an attention module hands in are read through
    their strides (no copy); what the kernels cannot read is copied."""
    x = torch.randn(2, 9, 3, 16)                  # a (B, L, H, D) projection
    view = x.transpose(1, 2)
    assert tattn._readable(view) is view
    assert list(tattn._strides(view)) == [9 * 48, 16, 48]
    odd = torch.randn(2, 3, 9, 17)[..., :16]      # row stride 17: no float4
    fixed = tattn._readable(odd)
    assert fixed is not odd and fixed.is_contiguous()
    torch.testing.assert_close(fixed, odd)
    out = tattn._heads_inner(2, 3, 9, 16, x)
    assert out.shape == (2, 3, 9, 16)
    assert out.transpose(1, 2).reshape(2, 9, 48).data_ptr() == out.data_ptr()
