"""The bf16 wgmma conv and packed attention forward kernels, modelled on the
CPU.

The CUDA kernels (``conv_wgmma_bf16_kernel`` in ``csrc/conv_prelu.cu``,
``fwd_wgmma_bf16_kernel`` in ``csrc/packed_fwd_bf16.cuh``) run only on the
card (``chip_smoke.py`` holds them against their plain versions there).
What their arithmetic does is stated here in PyTorch, in the order the
kernels do it, and held against the JAX package's Pallas kernels in
interpret mode, handed bf16 arrays, and the port's plain versions:

* the conv: the gathered pixels times the HWIO weights read as a
  (K*K*Cin, Cout) matrix; a pipeline step is 64 consecutive values of the
  flattened (ky, kx, c), its products summed in f32 from zero and joined to
  its block's running sum in order; a split tile's blocks (a run of whole
  steps each, in order) added in rank order; bias and PReLU in f32; one
  rounding to bf16;
* the packed forward, while Lk <= 256: S = q K^T in f32 (bf16 values),
  the row max and sum of 2^(s c - m c), c = scale log2(e), lse = m scale
  + log(sum), P = exp(s scale - lse) rounded to bf16, P V in f32, one
  rounding. Past 256 keys: the max and sum over 256-key chunks first (the
  sum rescaled from chunk to chunk), then P per chunk.

Inputs are made with numpy from a seed and fed to both sides. Tolerance:
one bf16 step of each output (the larger of the two values' steps; conv
outputs below 2^-14 of the largest at that floor's step, where two f32 sums
of the same products in other orders lie apart by more than the value's own
step), the share of outputs whose bits differ bounded as stated at each
assert. An attention output also moves by what its row's probabilities
whose bf16 rounding flipped move it: against the plain version that is
accounted flip by flip, against the JAX kernel (whose P is not observable)
the card's bf16-I/O gate holds.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sc_torch.kernels import attention_packed as tpacked
from multimodal_sc_torch.kernels import conv_block as tconv

jconv = importlib.import_module("multimodal_sc_tpu.kernels.conv_block")
jpacked = importlib.import_module("multimodal_sc_tpu.kernels.attention_packed")

BF16 = torch.bfloat16
STEP_K = 64           # K of one conv pipeline step
CHUNK_KEYS = 256      # keys the packed forward holds at once
LOG2E = 1.4426950408889634
FLOOR = 2.0 ** -14


def _bf16_step(x: torch.Tensor) -> torch.Tensor:
    _, e = torch.frexp(x.abs().clamp(min=2.0 ** -126))
    return torch.ldexp(torch.ones_like(x), e - 8)


def _steps_apart(got: torch.Tensor, want: torch.Tensor):
    """(largest distance in bf16 steps, share of outputs whose bits
    differ), the step the larger of the two values' at the floor."""
    g, w = got.float(), want.float()
    floor = FLOOR * w.abs().max()
    step = torch.maximum(_bf16_step(torch.maximum(w.abs(), floor)),
                         _bf16_step(torch.maximum(g.abs(), floor)))
    return ((g - w).abs() / step).max().item(), (got != want).float().mean(
    ).item()


def _torch(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jnp.asarray(x, jnp.float32))).to(BF16)


# --- the conv ------------------------------------------------------------------

def _im2col(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """(N*OH*OW, K*K*Cin) of f32 values, columns in (ky, kx, c) order, zeros
    where a tap falls outside the image (XLA's SAME padding)."""
    n, h, w, cin = x.shape
    (plo, phi), (qlo, qhi) = (tconv.same_pads(h, k, stride),
                              tconv.same_pads(w, k, stride))
    xp = torch.nn.functional.pad(x.float(), (0, 0, qlo, qhi, plo, phi))
    oh, ow = -(-h // stride), -(-w // stride)
    cols = [xp[:, ky:ky + stride * (oh - 1) + 1:stride,
               kx:kx + stride * (ow - 1) + 1:stride, :]
            for ky in range(k) for kx in range(k)]
    return torch.cat(cols, dim=-1).reshape(n * oh * ow, k * k * cin)


def _steps(k: int, cin: int):
    """The kernel's pipeline steps as (first, last) columns of K: 64
    consecutive values of the flattened (ky, kx, c) each, the last one
    short."""
    ktot = k * k * cin
    return [(k0, min(k0 + STEP_K, ktot)) for k0 in range(0, ktot, STEP_K)]


def _conv_model(x, w, b, alpha, stride, splits):
    """``conv_wgmma_bf16_kernel`` on bf16 (NHWC, HWIO) inputs with the taps
    of each output tile split over ``splits`` blocks."""
    n, h, wd, cin = x.shape
    k, cout = w.shape[0], w.shape[-1]
    a = _im2col(x, k, stride)
    wm = w.float().reshape(k * k * cin, cout)
    steps = _steps(k, cin)
    total = None
    for rank in range(splits):
        part = torch.zeros(a.shape[0], cout)
        for k0, k1 in steps[len(steps) * rank // splits:
                            len(steps) * (rank + 1) // splits]:
            part = part + a[:, k0:k1] @ wm[k0:k1]     # a chain from zero
        total = part if total is None else total + part
    y = total + b.float()
    if alpha is not None:
        y = torch.where(y >= 0, y, y * alpha.float())
    oh, ow = -(-h // stride), -(-wd // stride)
    return y.reshape(n, oh, ow, cout).to(BF16)


CONVS = {  # (B, H, W, Cin, Cout, stride, PReLU)
    "cin32_s1": (2, 8, 8, 32, 16, 1, True),
    "cin16_s2_no_prelu": (2, 9, 7, 16, 24, 2, False),
    "cin3_s2_flat": (2, 16, 16, 3, 32, 2, True),
    "cin3_s1_flat_ragged": (1, 7, 9, 3, 8, 1, True),
    "cin72_steps_across_taps": (1, 8, 8, 72, 8, 1, True),
}


@pytest.mark.parametrize("name", sorted(CONVS))
def test_bf16_wgmma_conv_model_matches_jax_and_plain_version(name):
    bsz, h, wd, cin, cout, s, prelu = CONVS[name]
    rng = np.random.default_rng(sorted(CONVS).index(name))
    x = rng.standard_normal((bsz, h, wd, cin)).astype(np.float32)
    w = (rng.standard_normal((5, 5, cin, cout))
         / math.sqrt(25 * cin)).astype(np.float32)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    al = rng.uniform(0, 1, cout).astype(np.float32) if prelu else None
    jx, jw, jb = (jnp.asarray(t, jnp.bfloat16) for t in (x, w, b))
    ja = None if al is None else jnp.asarray(al, jnp.bfloat16)
    tx, tw, tb = (_torch(t) for t in (jx, jw, jb))
    ta = None if ja is None else _torch(ja)
    want = _torch(jconv.conv_prelu(jx, jw, jb, ja, s, use_pallas=True,
                                   interpret=True))
    plain = tconv.conv_prelu_reference(tx, tw, tb, ta, s)
    assert tconv.tensor_core_path(cin, cout, BF16)
    for splits in (1, 2, 8):
        got = _conv_model(tx, tw, tb, ta, s, splits)
        assert got.dtype == BF16 and got.shape == want.shape
        # The Pallas kernel sums each tap's dot and joins them in tap order
        # (stride 2 through its space-to-depth taps): other orders of the
        # same f32 products. At most 3% of the outputs' bits differ (a
        # rounding of a sum that lies near a bf16 midpoint).
        for ref in (want, plain):
            steps, share = _steps_apart(got, ref)
            assert steps <= 1.0 and share <= 0.03, (splits, steps, share)


def test_bf16_conv_path_takes_every_cin_and_cout_a_multiple_of_8():
    """The bf16 implicit GEMM takes Cout a multiple of 8 whatever Cin (the
    first layer's 3 included); the decoder's Cout = 3 stays banded."""
    assert tconv.tensor_core_path(3, 32, BF16)
    assert tconv.tensor_core_path(12, 8, BF16)
    assert not tconv.tensor_core_path(32, 3, BF16)
    assert not tconv.tensor_core_path(3, 32)          # f32: both by 4
    assert _steps(5, 3) == [(0, 64), (64, 75)]
    steps = _steps(5, 128)       # half a tap a step
    assert len(steps) == 50 and all(b - a == 64 for a, b in steps)
    assert len(_steps(5, 32)) == 13   # two taps a step, the last one alone


# --- the packed forward ----------------------------------------------------------

def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, l, dm = t.shape
    return t.float().reshape(b, l, heads, dm // heads).transpose(1, 2)


def _packed_fwd_model(q, k, v, heads, scale):
    """``(out f32 before its rounding, lse, P)`` as ``fwd_wgmma_bf16_kernel``
    computes them from bf16 (B, L, H*d) inputs; P (B, H, Lq, Lk) the bf16
    probabilities, as f32."""
    qh, kh, vh = (_split_heads(t, heads) for t in (q, k, v))
    c2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    lk = k.shape[1]
    if lk <= CHUNK_KEYS:
        s = qh @ kh.transpose(-1, -2)
        m = s.amax(-1, keepdim=True)
        l = torch.exp2(s * c2 - m * c2).sum(-1, keepdim=True)
        lse = m * scale + torch.log(l)
        p = torch.exp(s * scale - lse).bfloat16().float()
        o = p @ vh
    else:
        m = torch.full(qh.shape[:3] + (1,), -1e30)
        l = torch.zeros_like(m)
        for c0 in range(0, lk, CHUNK_KEYS):
            s = qh @ kh[..., c0:c0 + CHUNK_KEYS, :].transpose(-1, -2)
            mn = torch.maximum(m, s.amax(-1, keepdim=True))
            l = l * torch.exp2((m - mn) * c2) + torch.exp2(
                s * c2 - mn * c2).sum(-1, keepdim=True)
            m = mn
        lse = m * scale + torch.log(l)
        o = torch.zeros_like(qh[..., :vh.shape[-1]])
        ps = []
        for c0 in range(0, lk, CHUNK_KEYS):
            s = qh @ kh[..., c0:c0 + CHUNK_KEYS, :].transpose(-1, -2)
            ps.append(torch.exp(s * scale - lse).bfloat16().float())
            o = o + ps[-1] @ vh[..., c0:c0 + CHUNK_KEYS, :]
        p = torch.cat(ps, dim=-1)
    b, h, lq, d = o.shape
    return o.transpose(1, 2).reshape(b, lq, h * d), lse.squeeze(-1), p


def _bf16_io_gate(got, want):
    """``chip_smoke.py``'s gate of a bf16-I/O attention output against a
    value rounded elsewhere: within 1e-2 plus one bf16 step (a flipped
    probability rounding moves an output by 2^-8 p times a v entry), the
    mean error under 1e-5."""
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= 1e-2 + _bf16_step(want.float())).all())
    assert diff.mean().item() < 1e-5


PACKED = {  # (B, Lq, Lk, dm, heads)
    "d32_65_65": (2, 65, 65, 128, 4),
    "d8_65_65": (2, 65, 65, 128, 16),
    "d32_65_300": (1, 65, 300, 128, 4),
    "d8_300_65": (1, 300, 65, 128, 16),
}


@pytest.mark.parametrize("name", sorted(PACKED))
def test_bf16_wgmma_packed_forward_model_matches_jax_and_plain_version(name):
    bsz, lq, lk, dm, heads = PACKED[name]
    rng = np.random.default_rng(100 + sorted(PACKED).index(name))
    arrays = [jnp.asarray(rng.standard_normal(shape).astype(np.float32),
                          jnp.bfloat16)
              for shape in ((bsz, lq, dm), (bsz, lk, dm), (bsz, lk, dm))]
    tq, tk, tv = (_torch(t) for t in arrays)
    d = dm // heads
    scale = d ** -0.5
    out, lse, p = _packed_fwd_model(tq, tk, tv, heads, scale)
    got = out.to(BF16)
    want = _torch(jpacked._fwd_impl(*arrays, d, scale, 128, True, True))
    plain, plain_lse = tpacked.packed_attention_fwd_reference(
        tq, tk, tv, heads, scale, bf16=True)
    assert got.shape == want.shape == plain.shape and plain.dtype == BF16
    # Against the plain version, whose P = exp(s scale - lse) rounded is
    # observable: the kernel's P (the same form, lse of its own sums) agrees
    # but where a probability lies at a bf16 rounding's midpoint (at most 1
    # in 1000 here), and every
    # output lies within one bf16 step of the plain version's plus what its
    # row's flipped probabilities move it (|P - P'| |v|, summed).
    qh, kh, vh = (_split_heads(t, heads) for t in (tq, tk, tv))
    sc = qh @ kh.transpose(-1, -2) * scale
    p_plain = torch.exp(sc - sc.logsumexp(-1, keepdim=True)).bfloat16().float()
    flips = (p - p_plain).abs()
    assert (flips > 0).float().mean().item() <= 1e-3
    moved = (flips @ vh.abs()).transpose(1, 2).reshape(out.shape)
    gap = (got.float() - plain.float()).abs()
    step = torch.maximum(_bf16_step(got.float()), _bf16_step(plain.float()))
    assert bool((gap <= step + 1.001 * moved).all())
    _, share = _steps_apart(got, plain)
    assert share <= 0.03, share
    # Against the JAX kernel (its P = e / sum, inside the kernel): the
    # card's bf16-I/O gate, at most 3% of the outputs' bits differing.
    _bf16_io_gate(got, want)
    assert (got != want).float().mean().item() <= 0.03
    # lse: the f32 logsumexp of the same scores, the plain version's gate on
    # the card (2e-5).
    torch.testing.assert_close(lse, plain_lse, atol=2e-5, rtol=2e-5)


def test_packed_forward_wrapper_refuses_what_no_kernel_takes():
    """The forward's launcher takes one dtype for q, k and v, and bf16
    tensors only in the bf16 mode (the bf16 wgmma kernel); the wrapper
    refuses anything else before it reaches the card."""
    q = torch.zeros(1, 8, 128)
    with pytest.raises(TypeError, match="one dtype"):
        tpacked._fwd_cuda(q, q.to(BF16), q, 4, 0.25, True)
    with pytest.raises(NotImplementedError, match="bf16"):
        tpacked._fwd_cuda(q.to(BF16), q.to(BF16), q.to(BF16), 4, 0.25,
                          False)