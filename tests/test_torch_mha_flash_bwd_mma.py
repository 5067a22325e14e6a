"""Two tensor-core kernels of the port, modelled on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them against
their plain versions there). What their arithmetic does is stated here in
PyTorch, in the order the kernels do it, and held against the JAX package
(its Pallas kernels in interpret mode) and the port's plain versions:

* ``mha_block``'s bf16 mode (``mha_mma_kernel`` of ``csrc/mha_block.cu``):
  the LayerNorms correctly rounded to f32, then to bf16; the Q, K, V and
  output projections on bf16 operands, one 16-term k-step at a time joined
  by f32 adds; per head the scores of 16 keys at a time, the logsumexp from
  a first pass (base 2), the NORMALISED probabilities rounded
  to bf16 in a second pass and multiplied into V 16 keys at a time, each
  product joined by an f32 add; the head outputs rounded before ``Wo``;
* the flash backward (``flash_bwd_dq_tc_kernel`` and
  ``flash_bwd_dkv_tc_kernel`` of ``csrc/flash_kernels.cuh``): every product
  as ``lo*hi + hi*lo + hi*hi`` of the TF32 halves (3xTF32), S and dP (or
  their transposes) one chain over the head dim per tile of 32 rows, the
  products over a tile's rows joined to dQ, dK and dV by f32 adds, in the
  kernels' tile order.

Inputs are made with numpy from a seed and fed to both sides.
"""

import functools
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sc_torch.kernels import attention as tattn
from multimodal_sc_torch.kernels import mha_block as tmha
from multimodal_sc_tpu.kernels import mha_block as jmha

# ``multimodal_sc_tpu.kernels`` exports a function named ``attention`` over
# the submodule of that name: ask for the module itself.
jattn = importlib.import_module("multimodal_sc_tpu.kernels.attention")

NEG = -1e30     # the kernels' first running max


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.bfloat16().float()


# --- (a) mha_block, bf16 mode --------------------------------------------

def _mm_ksteps(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (..., 128) . w (128, n) as the projections sum it: 16-term
    products, one k-step at a time, joined by f32 adds."""
    out = a[..., :16] @ w[:16]
    for k0 in range(16, a.shape[-1], 16):
        out = out + a[..., k0:k0 + 16] @ w[k0:k0 + 16]
    return out


def _mha_mma_model(x_q, x_kv, p, heads, layer_norm=tmha._layer_norm_f64):
    """``mha_mma_kernel``'s arithmetic on f32 CPU tensors."""
    b, lq, dm = x_q.shape
    lk, d = x_kv.shape[1], dm // heads
    scale2 = np.float32(d ** -0.5) * np.float32(math.log2(math.e))
    xq = _bf16(layer_norm(x_q, p["ln_q_scale"], p["ln_q_bias"]))
    xkv = _bf16(layer_norm(x_kv, p["ln_kv_scale"], p["ln_kv_bias"]))
    q = _bf16(_mm_ksteps(xq, _bf16(p["wq"])) + p["bq"])
    k = _bf16(_mm_ksteps(xkv, _bf16(p["wk"])) + p["bk"])
    v = _bf16(_mm_ksteps(xkv, _bf16(p["wv"])) + p["bv"])

    def split(x, n):
        return x.reshape(b, n, heads, d).transpose(1, 2)

    qh, kh, vh = split(q, lq), split(k, lk), split(v, lk)
    # Pass 1 in base 2, 16 keys a step: running max and sum.
    m = torch.full((b, heads, lq), NEG)
    l = torch.zeros((b, heads, lq))
    for k0 in range(0, lk, 16):
        x = (qh @ kh[:, :, k0:k0 + 16].transpose(-1, -2)) * scale2
        mx = torch.maximum(m, x.amax(-1))
        l = l * torch.exp2(m - mx) + torch.exp2(x - mx[..., None]).sum(-1)
        m = mx
    lse2 = m + torch.log2(l)
    # Pass 2: the normalised probabilities, rounded, times V, 16 keys each.
    o = torch.zeros(qh.shape)
    for k0 in range(0, lk, 16):
        x = (qh @ kh[:, :, k0:k0 + 16].transpose(-1, -2)) * scale2
        o = o + _bf16(torch.exp2(x - lse2[..., None])) @ vh[:, :, k0:k0 + 16]
    att = _bf16(o.transpose(1, 2).reshape(b, lq, dm))
    return (x_q + _mm_ksteps(att, _bf16(p["wo"]))) + p["bo"]


def _mha_params(rng, dim):
    p = {}
    for key in jmha.PARAM_KEYS:
        if key.startswith("w"):
            p[key] = rng.standard_normal((dim, dim)) * dim ** -0.5
        elif "scale" in key:
            p[key] = 1.0 + 0.1 * rng.standard_normal(dim)
        else:
            p[key] = 0.1 * rng.standard_normal(dim)
    return {key: val.astype(np.float32) for key, val in p.items()}


MHA = {                 # (B, Lq, Lk, heads)
    "c4_65_256": (2, 65, 256, 4),
    "c4_256_65": (2, 256, 65, 4),
    "d64_ragged": (3, 20, 70, 2),
    "d8_ragged": (2, 17, 33, 16),
}


@pytest.mark.parametrize("name", sorted(MHA))
def test_mha_bf16_kernel_model_matches_jax_and_plain_version(name):
    b, lq, lk, heads = MHA[name]
    rng = np.random.default_rng(sorted(MHA).index(name))
    p = _mha_params(rng, 128)
    x_q = rng.standard_normal((b, lq, 128)).astype(np.float32)
    x_kv = rng.standard_normal((b, lk, 128)).astype(np.float32)
    pt = {key: torch.from_numpy(val) for key, val in p.items()}
    tq, tkv = torch.from_numpy(x_q), torch.from_numpy(x_kv)
    got = _mha_mma_model(tq, tkv, pt, heads)
    # Against the plain version that rounds the same operands: only the
    # order of the f32 sums differs, which now and then flips one bf16
    # rounding: chip_smoke.py's gates for the kernel, max 5e-3 and mean
    # 1e-5, absolute.
    diff = (got - tmha.mha_block_reference_bf16(tq, tkv, pt, heads)).abs()
    assert diff.max().item() <= 5e-3
    assert diff.mean().item() <= 1e-5
    # Against the JAX kernel's bf16 mode in interpret mode, both sides on
    # XLA's LayerNorm (see test_torch_kernels.py: its last bits differ from
    # the correctly rounded one): the packed forward's gates, max 1e-2 and
    # mean 1e-5.
    pj = {key: jnp.asarray(val) for key, val in p.items()}
    want = np.asarray(jmha.mha_block(jnp.asarray(x_q), jnp.asarray(x_kv), pj,
                                     heads, interpret=True, mxu_bf16=True))
    jln = jax.jit(jmha._layer_norm)

    def xla_layer_norm(x, s, bias):
        return torch.from_numpy(np.array(jln(*(jnp.asarray(t.numpy())
                                              for t in (x, s, bias)))))

    got_j = _mha_mma_model(tq, tkv, pt, heads, xla_layer_norm).numpy()
    assert np.abs(got_j - want).max() <= 1e-2
    assert np.abs(got_j - want).mean() <= 1e-5


# --- (b) the flash backward on 3xTF32 --------------------------------------

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


def _flash_bwd_3xtf32_model(q, k, v, out, lse, g, scale=None, tile=32):
    """``(dq, dk, dv)`` as the two tensor-core backward kernels compute
    them from the forward's output and logsumexp, (B, H, L, D) tensors."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    lq, lk = q.shape[2], k.shape[2]
    delta = (g * out).sum(-1)
    # dQ kernel: q scale and dO of the block's rows, key tiles.
    qs = q * scale
    dq = torch.zeros(q.shape)
    for k0 in range(0, lk, tile):
        kt, vt = k[:, :, k0:k0 + tile], v[:, :, k0:k0 + tile]
        s = _mm3(qs, kt.transpose(-1, -2))
        dp = _mm3(g, vt.transpose(-1, -2))
        ds = torch.exp(s - lse[..., None]) * (dp - delta[..., None])
        dq = dq + _mm3(ds, kt)
    # dK/dV kernel: k scale and v of the block's rows, query tiles.
    ks = k * scale
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    for q0 in range(0, lq, tile):
        qt, gt = q[:, :, q0:q0 + tile], g[:, :, q0:q0 + tile]
        st = _mm3(ks, qt.transpose(-1, -2))
        dpt = _mm3(v, gt.transpose(-1, -2))
        pt = torch.exp(st - lse[:, :, None, q0:q0 + tile])
        dst = pt * (dpt - delta[:, :, None, q0:q0 + tile])
        dv = dv + _mm3(pt, gt)
        dk = dk + _mm3(dst, qt)
    return dq * scale, dk * scale, dv


FLASH_BWD = {           # q shape (B, H, Lq, D), Lk
    "arm_f_d64": ((1, 2, 96, 64), 96),
    "ragged_d32": ((2, 2, 33, 32), 70),
    "d48_cross": ((1, 2, 40, 48), 100),
    "d8": ((2, 2, 17, 8), 40),
}


@functools.lru_cache(maxsize=None)
def _jax_grads(name):
    shape_q, lk = FLASH_BWD[name]
    shape_k = shape_q[:2] + (lk, shape_q[3])
    rng = np.random.default_rng(sorted(FLASH_BWD).index(name))
    q, g = (rng.standard_normal(shape_q).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal(shape_k).astype(np.float32) for _ in range(2))
    _, vjp = jax.vjp(
        lambda a, b, c: jattn.flash_attention(a, b, c, interpret=True),
        *(jnp.asarray(t) for t in (q, k, v)))
    grads = vjp(jnp.asarray(g))
    return (q, k, v, g), tuple(np.asarray(t) for t in grads)


@pytest.mark.parametrize("name", sorted(FLASH_BWD))
def test_flash_3xtf32_backward_model_matches_jax_and_plain_version(name):
    (q, k, v, g), want = _jax_grads(name)
    tq, tk, tv, tg = (torch.from_numpy(t) for t in (q, k, v, g))
    out, lse = tattn.flash_attention_fwd_reference(tq, tk, tv)
    got = _flash_bwd_3xtf32_model(tq, tk, tv, out, lse, tg)
    plain = tattn.flash_attention_bwd_reference(tq, tk, tv, out, lse, tg)
    for a, w, pl in zip(got, want, plain):
        # 3xTF32 drops only the lo*lo term (~2^-22 of a product): the JAX
        # backward kernel test's gate, 2e-4; the model stays within a few
        # 1e-6 of the JAX kernels, asserted at 5e-6.
        np.testing.assert_allclose(a.numpy(), w, atol=2e-4, rtol=2e-4)
        assert np.abs(a.numpy() - w).max() <= 5e-6
        torch.testing.assert_close(a, pl, atol=2e-5, rtol=2e-5)
