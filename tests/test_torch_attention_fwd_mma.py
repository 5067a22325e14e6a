"""The tensor-core forward kernels of the attention port, modelled on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them against
their plain versions there). What their arithmetic does is stated here in
PyTorch, in the order the kernels do it, and held against the JAX package
(its Pallas kernels in interpret mode) and the port's plain versions:

* the packed forward's bf16 mode (``fwd_mma_kernel`` of
  ``csrc/attention_packed.cu``): operands rounded to bf16, scores per 16-key
  tile summed in f32, the logsumexp from a first pass over all keys, the
  NORMALISED probabilities rounded to bf16 in a second pass and multiplied
  into V tile by tile;
* the flash forward (``flash_fwd_kernel`` of ``csrc/flash_kernels.cuh``):
  every product as ``lo*hi + hi*lo + hi*hi`` of the TF32 halves (3xTF32),
  an online softmax over 32-key tiles (16 at head dims above 64), each
  tile's P V joined to the rescaled running output;
* the packed layout read as (B, H, L, D) strides, the route the packed
  forward's f32 mode now takes through the flash forward.

Inputs are made with numpy from a seed and fed to both sides.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sc_torch.kernels import attention as tattn
from multimodal_sc_torch.kernels import attention_packed as tpacked
from multimodal_sc_tpu.kernels import attention_packed as jpacked

# ``multimodal_sc_tpu.kernels`` exports a function named ``attention`` over
# the submodule of that name: ask for the module itself.
jattn = importlib.import_module("multimodal_sc_tpu.kernels.attention")

NEG = -1e30     # the kernels' first running max and masked score


def _rng_arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in shapes)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, l, dm = x.shape
    return x.reshape(b, l, heads, dm // heads).transpose(1, 2)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.bfloat16().float()


def _packed_fwd_mma_model(q, k, v, heads, scale=None, kc=256):
    """The packed forward's bf16 mode as ``fwd_mma_kernel`` computes it:
    ``(out, lse)``. K and V are staged ``kc`` keys at a time; scores come
    16 keys at a time, each an f32 sum of bf16 products."""
    d = q.shape[-1] // heads
    if scale is None:
        scale = d ** -0.5
    qh, kh, vh = (_heads(_bf16(t.float()), heads) for t in (q, k, v))
    lk = kh.shape[2]
    tiles = [(c0 + ks, min(c0 + ks + 16, lk))
             for c0 in range(0, lk, kc)
             for ks in range(0, min(kc, lk - c0), 16)]
    # Pass 1: running max and sum over every key.
    m = torch.full(qh.shape[:3], NEG)
    l = torch.zeros(qh.shape[:3])
    for a, b in tiles:
        s = qh @ kh[:, :, a:b].transpose(-1, -2) * scale
        mx = torch.maximum(m, s.amax(-1))
        l = l * torch.exp(m - mx) + torch.exp(s - mx[..., None]).sum(-1)
        m = mx
    lse = m + torch.log(l)
    # Pass 2: the normalised probabilities, rounded, times V.
    o = torch.zeros(qh.shape)
    for a, b in tiles:
        s = qh @ kh[:, :, a:b].transpose(-1, -2) * scale
        p = _bf16(torch.exp(s - lse[..., None]))
        o = o + p @ vh[:, :, a:b]
    return tpacked._merge(o), lse


def _split_tf32(x: torch.Tensor):
    """``x = hi + lo`` as the kernels split it, on the float's bits: ``hi``
    is ``x`` rounded to TF32 to nearest (ties away from zero), ``lo`` the
    rest as the tensor cores read an f32 register (low 13 bits dropped)."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    lo = ((x - hi).contiguous().view(torch.int32) & ~0x1FFF).view(
        torch.float32)
    return hi, lo


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An f32-grade product from three TF32 ones, small terms first."""
    (ah, al), (bh, bl) = _split_tf32(a), _split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh


def _flash_fwd_3xtf32_model(q, k, v, scale=None):
    """The flash forward as ``flash_fwd_kernel`` computes it: ``(out, lse)``
    of (B, H, L, D) inputs, strided or not, over key tiles of 32 (16 for a
    head dim above 64, compiled at width 128)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    tk = 16 if q.shape[-1] > 64 else 32
    qs = q.float() * scale
    lk = k.shape[2]
    m = torch.full(q.shape[:3], NEG)
    l = torch.zeros(q.shape[:3])
    o = torch.zeros(q.shape)
    for k0 in range(0, lk, tk):
        kt, vt = k[:, :, k0:k0 + tk].float(), v[:, :, k0:k0 + tk].float()
        s = _mm3(qs, kt.transpose(-1, -2))
        mx = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - mx)
        p = torch.exp(s - mx[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + _mm3(p, vt)
        m = mx
    lc = l.clamp_min(1e-30)
    return o / lc[..., None], m + torch.log(lc)


# --- (a) the packed forward's bf16 mode ------------------------------------

PACKED = {          # (B, Lq, Lk, dm, heads)
    "d8_ragged": (2, 33, 70, 128, 16),
    "d16_ragged": (2, 33, 70, 128, 8),
    "d32_ragged": (2, 33, 70, 128, 4),
    "d64_ragged": (2, 33, 70, 128, 2),
    "d32_lk300": (1, 40, 300, 128, 4),   # two staged key chunks (kc = 256)
    "d64_two_groups": (1, 70, 130, 256, 4),
}


@pytest.mark.parametrize("name", sorted(PACKED))
def test_packed_bf16_forward_model_matches_jax_and_plain_version(name):
    b, lq, lk, dm, heads = PACKED[name]
    q, k, v = _rng_arrays(sorted(PACKED).index(name), (b, lq, dm),
                          (b, lk, dm), (b, lk, dm))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    out, lse = _packed_fwd_mma_model(tq, tk, tv, heads)
    assert out.shape == (b, lq, dm) and lse.shape == (b, heads, lq)
    # Against the JAX kernel's own bf16 mode: the loose gate of its tests
    # (tests/kernels/test_attention_packed.py), both sides bf16 operands
    # with f32 sums rounded at other places.
    j_out = jpacked.packed_attention(*(jnp.asarray(t) for t in (q, k, v)),
                                     heads, interpret=True, mxu_bf16=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=3e-2,
                               rtol=3e-2)
    # Against the plain version that rounds the same operands: only the
    # order of the f32 sums differs, which now and then flips one
    # probability's bf16 rounding (2^-8 p times a v entry): max 1e-2, and
    # flips are rare, so the mean error stays under 1e-5 (chip_smoke.py's
    # gates for the kernel).
    want = tpacked.packed_attention_reference_bf16(tq, tk, tv, heads)
    diff = (out - want).abs()
    assert diff.max().item() <= 1e-2
    assert diff.mean().item() <= 1e-5
    # The logsumexp of the rounded q and k, summed tile by tile: 2e-5.
    _, want_lse = tpacked.packed_attention_fwd_reference(tq, tk, tv, heads,
                                                         bf16=True)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=2e-5)


# --- (b) the flash forward on 3xTF32 ---------------------------------------

FLASH = {           # q shape (B, H, Lq, D), Lk
    8: ((2, 3, 40, 8), 70),
    32: ((2, 2, 33, 32), 70),
    48: ((1, 2, 64, 48), 64),
    64: ((2, 2, 17, 64), 100),
    96: ((1, 2, 40, 96), 24),
    128: ((1, 2, 33, 128), 130),
}


@pytest.mark.parametrize("d", sorted(FLASH))
def test_flash_3xtf32_forward_model_matches_jax_and_plain_version(d):
    shape_q, lk = FLASH[d]
    shape_k = shape_q[:2] + (lk, d)
    q, k, v = _rng_arrays(d, shape_q, shape_k, shape_k)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    out, lse = _flash_fwd_3xtf32_model(tq, tk, tv)
    # 3xTF32 drops only the lo*lo term (~2^-22 of a product): the exact-f32
    # gate of the JAX kernel tests, 2e-5, for out and lse.
    j_out = jattn.flash_attention(*(jnp.asarray(t) for t in (q, k, v)),
                                  interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=2e-5,
                               rtol=2e-5)
    want, want_lse = tattn.flash_attention_fwd_reference(tq, tk, tv)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=2e-5)


# --- (c) the packed layout through the flash forward (f32 mode) ------------

@pytest.mark.parametrize("heads", [16, 8, 4, 2])          # d = 8, 16, 32, 64
def test_packed_layout_as_strides_is_the_packed_forward(heads):
    b, lq, lk, dm = 2, 33, 70, 128
    q, k, v = _rng_arrays(heads, (b, lq, dm), (b, lk, dm), (b, lk, dm))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    d = dm // heads

    def as_heads(t):
        # (B, L, heads*d) read in place as (B, heads, L, d): the batch, head
        # and row strides the f32 mode hands the flash forward.
        l = t.shape[1]
        return t.as_strided((b, heads, l, d), (l * dm, d, dm, 1))

    views = [as_heads(t) for t in (tq, tk, tv)]
    want, want_lse = tpacked.packed_attention_fwd_reference(tq, tk, tv,
                                                            heads)
    # Exact f32 on both sides, the same sums batched differently.
    out, lse = tattn.flash_attention_fwd_reference(*views)
    torch.testing.assert_close(tpacked._merge(out), want, atol=2e-6, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=2e-6, rtol=0)
    # The kernel's arithmetic on those views: the f32 mode's gates (1e-4 for
    # the output, 2e-5 for the logsumexp) are met with room to spare.
    out3, lse3 = _flash_fwd_3xtf32_model(*views)
    torch.testing.assert_close(tpacked._merge(out3), want, atol=2e-5,
                               rtol=2e-5)
    torch.testing.assert_close(lse3, want_lse, atol=2e-5, rtol=2e-5)
