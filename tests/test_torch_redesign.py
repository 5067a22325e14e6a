"""What the tensor-core kernels of the port rest on, checked on the CPU.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
them against their plain versions there). What surrounds their arithmetic
is stated in PyTorch and checked here against the JAX package:

* the packed attention forward's second result, the logsumexp it hands its
  backward, and the backward formulas evaluated from a handed-in logsumexp,
  in f32 and in the bf16-rounding mode;
* the 3xTF32 split of ``conv_prelu``'s tensor-core path: its rounding, and
  the error of ``lo*hi + hi*lo + hi*hi`` against exact f32;
* the implicit GEMM's gather (output pixel, tap -> input pixel or padding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sc_torch.kernels import attention_packed as tpacked
from multimodal_sc_torch.kernels import conv_block as tconv
from multimodal_sc_tpu.kernels import attention_packed as jpacked
from multimodal_sc_tpu.kernels import conv_block as jconv

# (H, W, Cin, Cout, stride, PReLU) of the c4 camera encoder.
C4_CONVS = ((32, 32, 3, 32, 2, True), (16, 16, 32, 64, 2, True),
            (8, 8, 64, 128, 1, True), (8, 8, 128, 128, 1, True),
            (8, 8, 128, 16, 1, False))


def _qkv(seed, b, lq, lk, dm):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, lq, dm), (b, lk, dm), (b, lk, dm)))


def _conv_inputs(seed, b, h, w, cin, cout, prelu):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((5, 5, cin, cout)) / np.sqrt(25 * cin)).astype(
        np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    alpha = rng.uniform(0, 1, cout).astype(np.float32) if prelu else None
    return x, wt, bias, alpha


def _t(a):
    return None if a is None else torch.from_numpy(a)


# The tensor-core path of ``csrc/conv_prelu.cu`` stated in PyTorch: its index
# map, its split and the two put together.

def _igemm_gather_index(n: int, h: int, w: int, k: int,
                       stride: int) -> torch.Tensor:
    """The implicit GEMM's gather, as the kernel computes it: for output
    pixel ``m`` (flat over image, row, column) and tap ``ky * k + kx``, the
    flat index of the input pixel (over image, row, column) that the tap
    reads, or -1 where it falls into the SAME padding. Shape (M, k*k)."""
    oh, ow = -(-h // stride), -(-w // stride)
    pad_h, pad_w = tconv.same_pads(h, k, stride)[0], tconv.same_pads(w, k, stride)[0]
    m = torch.arange(n * oh * ow)
    img, rem = m // (oh * ow), m % (oh * ow)
    iy0 = (rem // ow) * stride - pad_h
    ix0 = (rem % ow) * stride - pad_w
    tap = torch.arange(k * k)
    iy = iy0[:, None] + (tap // k)[None, :]
    ix = ix0[:, None] + (tap % k)[None, :]
    inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    flat = (img[:, None] * h + iy) * w + ix
    return torch.where(inside, flat, torch.full_like(flat, -1))


def _split_tf32(x: torch.Tensor):
    """``x = hi + lo`` as the kernel splits it, by integer arithmetic on the
    float's bits: ``hi`` is ``x`` rounded to TF32 (10 mantissa bits) to
    nearest, ties away from zero (what ``cvt.rna.tf32.f32`` gives), ``lo``
    the rest ``x - hi`` as the tensor cores read an f32 register: its low 13
    bits dropped. ``lo`` is at most half a TF32 step of ``x``, so what is
    dropped is below 2^-21 of ``x``."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)
    return hi, lo


def _conv_prelu_igemm_model(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           alpha: torch.Tensor, stride: int = 1,
                           split: bool = True) -> torch.Tensor:
    """Plain model of the tensor-core path: the gather of
    ``_igemm_gather_index``, then (M, K*K*Cin) x (K*K*Cin, Cout) with every
    product as ``lo*hi + hi*lo + hi*hi`` of the TF32 halves (or exact with
    ``split=False``), bias, PReLU."""
    n, h, wd, cin = x.shape
    k, cout = w.shape[0], w.shape[3]
    idx = _igemm_gather_index(n, h, wd, k, stride)
    pixels = torch.cat([x.reshape(-1, cin), x.new_zeros(1, cin)])
    a = pixels[idx].reshape(idx.shape[0], k * k * cin)   # -1: the zero row
    wm = w.reshape(k * k * cin, cout)
    if split:
        (ah, al), (wh, wl) = _split_tf32(a), _split_tf32(wm)
        y = al @ wh + ah @ wl + ah @ wh
    else:
        y = a @ wm
    y = (y + b).reshape(n, -(-h // stride), -(-wd // stride), cout)
    if alpha is not None:
        y = torch.where(y >= 0, y, y * alpha)
    return y


# --- packed attention: the logsumexp handed from forward to backward -------

@pytest.mark.parametrize("heads,lq,lk,dm", [
    (4, 65, 256, 128), (4, 256, 65, 128), (16, 33, 70, 128), (2, 17, 100, 128)])
def test_packed_fwd_reference_out_and_lse_match_jax(heads, lq, lk, dm):
    q, k, v = _qkv(lq * 1000 + lk, 2, lq, lk, dm)
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    j_kernel = jpacked.packed_attention(jq, jk, jv, heads, interpret=True)
    # The JAX reference's scores: heads split out, q k^T scale.
    d = dm // heads
    qh, kh = (np.asarray(t).reshape(2, -1, heads, d).transpose(0, 2, 1, 3)
              for t in (q, k))
    scores = torch.from_numpy(np.einsum("bhqd,bhkd->bhqk", qh, kh) * d ** -0.5)
    out, lse = tpacked.packed_attention_fwd_reference(
        *(torch.from_numpy(t) for t in (q, k, v)), heads)
    assert lse.shape == (2, heads, lq)
    # f32 on both sides, summed in another order: the JAX kernel test's gate.
    np.testing.assert_allclose(out.numpy(), np.asarray(j_kernel), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(),
                               torch.logsumexp(scores, -1).numpy(),
                               atol=2e-5, rtol=2e-5)
    # And it is the plain forward, bit for bit up to the softmax's form.
    plain = tpacked.packed_attention_reference(
        *(torch.from_numpy(t) for t in (q, k, v)), heads)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=2e-6, rtol=0)


@pytest.mark.parametrize("heads", [16, 4, 2])          # d = 8, 32, 64
def test_packed_bwd_reference_from_lse_matches_jax_grad(heads):
    """The backward formulas from a handed-in logsumexp (what the kernels
    evaluate) give the gradients of the recomputed softmax and of the JAX
    function, at a ragged shape."""
    lq, lk, dm = 65, 256, 128
    q, k, v = _qkv(heads, 1, lq, lk, dm)
    do = np.random.default_rng(heads + 50).standard_normal(
        (1, lq, dm)).astype(np.float32)

    def fwd(q, k, v):
        return jpacked.packed_attention(q, k, v, heads, interpret=True)

    _, vjp = jax.vjp(fwd, *(jnp.asarray(t) for t in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(t) for t in (q, k, v, do))
    out, lse = tpacked.packed_attention_fwd_reference(tq, tk, tv, heads)
    from_lse = tpacked.packed_attention_bwd_reference(tq, tk, tv, out, tdo,
                                                      heads, lse=lse)
    recomputed = tpacked.packed_attention_bwd_reference(tq, tk, tv, out, tdo,
                                                        heads)
    for a, r, w in zip(from_lse, recomputed, want):
        # Exact f32 everywhere; exp(s - lse) against exp(s - max) / sum.
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("heads", [16, 4, 2])          # d = 8, 32, 64
def test_packed_bwd_reference_from_lse_bf16_mode(heads):
    """The same in the bf16-rounding mode: the logsumexp is of the rounded q
    and k, as the forward kernel's is, and the result is the JAX kernel's
    bf16-mode gradient up to rare flips of one rounding."""
    lq, lk, dm = 65, 256, 128
    q, k, v = _qkv(heads + 7, 1, lq, lk, dm)
    do = np.random.default_rng(heads + 57).standard_normal(
        (1, lq, dm)).astype(np.float32)

    def fwd(q, k, v):
        return jpacked.packed_attention(q, k, v, heads, interpret=True,
                                        mxu_bf16=True)

    _, vjp = jax.vjp(fwd, *(jnp.asarray(t) for t in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(t) for t in (q, k, v, do))
    out, lse = tpacked.packed_attention_fwd_reference(tq, tk, tv, heads,
                                                      bf16=True)
    twin = tpacked.packed_attention_reference_bf16(tq, tk, tv, heads)
    np.testing.assert_allclose(out.numpy(), twin.numpy(), atol=2e-3, rtol=0)
    from_lse = tpacked.packed_attention_bwd_reference(
        tq, tk, tv, out, tdo, heads, bf16=True, lse=lse)
    recomputed = tpacked.packed_attention_bwd_reference(
        tq, tk, tv, out, tdo, heads, bf16=True)
    exact = tpacked.packed_attention_bwd_reference(tq, tk, tv, out, tdo, heads)
    for a, r, w, e in zip(from_lse, recomputed, want, exact):
        # One flipped bf16 rounding of a probability or a dS entry moves an
        # output by up to 2^-8 of it times an O(1) operand: 5e-3, the gate
        # of the bf16 comparison with the JAX kernel; flips are rare, so the
        # mean stays far below.
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=5e-3, rtol=0)
        assert (a - r).abs().mean() < 1e-5
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=5e-3, rtol=0)
        assert (a - e).abs().max() > 1e-4      # the rounding really happens


def test_packed_bwd_reference_rejects_nothing_it_took_before():
    """Without ``lse`` the backward reference is what it was: autograd of
    the plain forward."""
    q, k, v = (torch.from_numpy(t).requires_grad_(True)
               for t in _qkv(3, 2, 33, 70, 128))
    do = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 33, 128)).astype(np.float32))
    out = tpacked.packed_attention_reference(q, k, v, 4)
    want = torch.autograd.grad(out, (q, k, v), do)
    with torch.no_grad():
        got = tpacked.packed_attention_bwd_reference(q, k, v, out, do, 4)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=1e-5, rtol=1e-5)


# --- conv_prelu: the 3xTF32 split -----------------------------------------

def test_split_tf32_rounds_to_nearest_on_the_bits():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.concatenate([
        rng.standard_normal(4096).astype(np.float32) * 3.0,
        np.float32([0.0, -0.0, 1.0, -1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12,
                    1.0 + 3 * 2.0 ** -12, 2.0 ** -20, -(1.0 + 2.0 ** -11)])]))
    hi, lo = _split_tf32(x)
    # TF32 keeps 10 mantissa bits: the 13 low bits of hi are clear.
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    # To nearest: at most half a TF32 step (2^-11 relative) away; a tie goes
    # away from zero, as cvt.rna does.
    assert ((hi - x).abs() <= x.abs() * 2.0 ** -11).all()
    assert hi[-5].item() == 1.0 + 2.0 ** -10        # 1 + 2^-11: tie, up
    assert hi[-1].item() == -(1.0 + 2.0 ** -10)
    assert hi[-4].item() == 1.0                     # 1 + 2^-12: down
    assert hi[-3].item() == 1.0 + 2.0 ** -10        # 1 + 3 * 2^-12: up
    # lo is a TF32 number too, and hi + lo restores x to ~2^-21 relative.
    assert (lo.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((hi + lo - x).abs() <= x.abs() * 2.0 ** -20).all()


@pytest.mark.parametrize("h,w,cin,cout,stride,prelu", C4_CONVS)
def test_conv_3xtf32_model_holds_plain_version(h, w, cin, cout, stride, prelu):
    """The scheme's error, known before chip time is spent: every product
    as lo*hi + hi*lo + hi*hi of the TF32 halves stays within 1e-5 of the
    exact-f32 convolution at the five c4 shapes; one TF32 product does not."""
    x, wt, bias, alpha = (_t(a) for a in _conv_inputs(
        h + cin, 2, h, w, cin, cout, prelu))
    ref = tconv.conv_prelu_reference(x, wt, bias, alpha, stride)
    model = _conv_prelu_igemm_model(x, wt, bias, alpha, stride)
    assert model.shape == ref.shape
    np.testing.assert_allclose(model.numpy(), ref.numpy(), atol=1e-5,
                               rtol=1e-5)
    single = tconv.conv_prelu_reference(_split_tf32(x)[0],
                                        _split_tf32(wt)[0], bias, alpha,
                                        stride)
    assert (single - ref).abs().max() > 1e-4


# --- conv_prelu: the implicit GEMM's gather --------------------------------

@pytest.mark.parametrize("hw,stride", [((8, 8), 1), ((8, 8), 2), ((7, 9), 1),
                                       ((7, 9), 2), ((16, 16), 2),
                                       ((5, 3), 2)])
def test_igemm_index_map_reproduces_conv(hw, stride):
    """Output pixel x tap -> input pixel or padding, then one matrix
    product: the plain version and the JAX kernel in interpret mode."""
    cin, cout = 4, 8
    assert tconv.tensor_core_path(cin, cout)
    x, wt, bias, alpha = _conv_inputs(hw[0] * 10 + stride, 2, *hw, cin, cout,
                                      True)
    j_kernel = jconv.conv_prelu(jnp.asarray(x), jnp.asarray(wt),
                                jnp.asarray(bias), jnp.asarray(alpha),
                                stride=stride, use_pallas=True, interpret=True)
    tx, tw, tb, ta = (_t(a) for a in (x, wt, bias, alpha))
    ref = tconv.conv_prelu_reference(tx, tw, tb, ta, stride)
    got = _conv_prelu_igemm_model(tx, tw, tb, ta, stride, split=False)
    assert got.shape == ref.shape == j_kernel.shape
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_kernel), atol=1e-5,
                               rtol=1e-5)


def test_igemm_index_map_padding_is_xla_same():
    # Stride 2 on an even input pads (1, 2): output row 0 reads input rows
    # -1 .. 3, so its first tap row is padding and its last is row 3.
    idx = _igemm_gather_index(1, 8, 8, 5, 2)
    assert idx.shape == (16, 25)
    assert (idx[0, :5] == -1).all() and idx[0, 6].item() == 0
    assert idx[0, 24].item() == 3 * 8 + 3
    # The last output pixel (3, 3) reads rows 5 .. 9: two rows of padding
    # after the image.
    assert (idx[15, 15:] == -1).all() and idx[15, 0].item() == 5 * 8 + 5
    # Stride 1 pads (2, 2); the second image's indices continue the first's.
    idx = _igemm_gather_index(2, 7, 9, 5, 1)
    assert idx[0, 12].item() == 0 and idx[63, 12].item() == 63
    assert (idx[0, :10] == -1).all()


def test_tensor_core_path_rule():
    # 16-byte copies: both channel counts multiples of 4; the first c4 layer
    # (Cin = 3) keeps the per-image path.
    taken = [tconv.tensor_core_path(cin, cout)
             for _, _, cin, cout, _, _ in C4_CONVS]
    assert taken == [False, True, True, True, True]
    assert tconv.tensor_core_path(16, 12)
    assert not tconv.tensor_core_path(16, 10)
