"""``mha_block``'s bf16-I/O kernel on bf16 wgmma, modelled on the CPU.

The CUDA kernel (``mha_wgmma_bf16_kernel`` in ``csrc/mha_bf16.cuh``) runs
only on the card (``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold
it against its plain version there). What its arithmetic does is stated
here in PyTorch, in the kernel's order, and held against the JAX package's
Pallas kernel in interpret mode handed bf16 arrays and against the port's
plain version, ``mha_block_reference_bf16``:

* each LayerNorm correctly rounded to f32 (f64 statistics and value), then
  rounded to bf16; the weights rounded to bf16 once;
* the four projections 8 k-steps of 16 terms, run two at a time (32
  terms) in the tensor-core accumulator from zero and joined to the f32
  sum by adds in order; bias added in f32, q, k, v rounded to bf16;
* per (64 queries, head) S once, all keys at once (one chain over the head
  dim); the row max m, the sum of 2^(s c - m c), c = scale log2(e) (f32,
  ``fma``), lse2 = m c + log2(sum); P = 2^(s c - lse2), normalised in f32
  and rounded to bf16; P V one chain over all keys; the head outputs
  rounded to bf16;
* (x_q + att Wo) + bo in f32, one rounding to bf16;
* a batch element's 64-row query tiles split over blocks (small batches),
  each block projecting K and V itself: the same bits as unsplit.

A chain in the tensor-core accumulator is modelled as the exact sum rounded
once to f32 (the card truncates inside a chain; the plain version's sums
run in other orders): the model is the kernel's order, not its bits.
Inputs are made with numpy from a seed and fed to all sides. Tolerance: the
card's gates for this kernel (``chip_smoke.py``): every output within one
bf16 step of its own plus 5e-3 (the reach of one flipped intermediate
rounding), at most 1% of the outputs differing at all.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sc_torch.kernels import mha_block as tmha
from multimodal_sc_tpu.kernels import mha_block as jmha

BF16 = torch.bfloat16
ROWS = 64           # query rows of a warpgroup's tile
PROJ_TERMS = 32     # terms of a projection's chain (PROJ_CHAIN k-steps)
GATE_ABS = 5e-3     # chip_smoke.BF16_MHA_ABS
GATE_SHARE = 1e-2   # chip_smoke.BF16_MHA_SHARE


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.bfloat16().float()


def _chain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as one tensor-core chain: bf16 values, their products summed
    exactly (f64 holds every such sum here) and rounded once to f32."""
    return (a.double() @ b.double()).float()


def _project(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (..., 128) @ w as the projections sum it: chains of PROJ_TERMS
    terms, each from zero, joined by f32 adds in order."""
    out = _chain(a[..., :PROJ_TERMS], w[:PROJ_TERMS])
    for k0 in range(PROJ_TERMS, a.shape[-1], PROJ_TERMS):
        out = out + _chain(a[..., k0:k0 + PROJ_TERMS], w[k0:k0 + PROJ_TERMS])
    return out


def _fma(x: torch.Tensor, y: float, z: torch.Tensor) -> torch.Tensor:
    """fmaf(x, y, z) on f32 tensors: one rounding of x y + z."""
    return (x.double() * y + z.double()).float()


def _wgmma_model(x_q, x_kv, p, heads, qsplit=1,
                 layer_norm=tmha._layer_norm_f64):
    """``mha_wgmma_bf16_kernel``'s arithmetic on bf16 inputs; the query
    tiles split over ``qsplit`` runs, each with its own K and V."""
    b, lq, dm = x_q.shape
    lk, d = x_kv.shape[1], dm // heads
    scale2 = float(np.float32(d ** -0.5) * np.float32(math.log2(math.e)))
    xq32, xkv32 = x_q.float(), x_kv.float()
    w = {k: _bf16(p[k]) for k in ("wq", "wk", "wv", "wo")}
    ntiles = -(-lq // ROWS)
    out = []
    for part in range(qsplit):
        t0, t1 = ntiles * part // qsplit, ntiles * (part + 1) // qsplit
        if t0 == t1:
            continue
        rows = slice(t0 * ROWS, min(t1 * ROWS, lq))
        xkv = _bf16(layer_norm(xkv32, p["ln_kv_scale"], p["ln_kv_bias"]))
        k = _bf16(_project(xkv, w["wk"]) + p["bk"])
        v = _bf16(_project(xkv, w["wv"]) + p["bv"])
        xq = _bf16(layer_norm(xq32[:, rows], p["ln_q_scale"],
                              p["ln_q_bias"]))
        q = _bf16(_project(xq, w["wq"]) + p["bq"])
        n = q.shape[1]
        qh = q.reshape(b, n, heads, d).transpose(1, 2)
        kh = k.reshape(b, lk, heads, d).transpose(1, 2)
        vh = v.reshape(b, lk, heads, d).transpose(1, 2)
        s = _chain(qh, kh.transpose(-1, -2))
        m2 = (s.amax(-1, keepdim=True) * np.float32(scale2)).float()
        total = torch.exp2(_fma(s, scale2, -m2)).sum(-1, keepdim=True)
        lse2 = m2 + torch.log2(total)
        probs = _bf16(torch.exp2(_fma(s, scale2, -lse2)))
        att = _bf16(_chain(probs, vh).transpose(1, 2).reshape(b, n, dm))
        out.append(((xq32[:, rows] + _project(att, w["wo"])) + p["bo"]))
    return torch.cat(out, 1).to(BF16)


def _bf16_step(x: torch.Tensor) -> torch.Tensor:
    _, e = torch.frexp(x.float().abs().clamp(min=2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def _within_gates(got: torch.Tensor, want: torch.Tensor):
    """(every output within one bf16 step of its own plus GATE_ABS, the
    share of outputs whose bits differ)."""
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= _bf16_step(got) + GATE_ABS).all())
    return ok, (got != want).float().mean().item()


def _inputs(seed, b, lq, lk):
    rng = np.random.default_rng(seed)
    p = {}
    for key in jmha.PARAM_KEYS:
        if key.startswith("w"):
            p[key] = rng.standard_normal((128, 128)) * 128 ** -0.5
        elif "scale" in key:
            p[key] = 1.0 + 0.1 * rng.standard_normal(128)
        else:
            p[key] = 0.1 * rng.standard_normal(128)
    p = {key: val.astype(np.float32) for key, val in p.items()}
    # bf16 activations, made in f32 and rounded once.
    x_q = torch.from_numpy(rng.standard_normal((b, lq, 128)).astype(
        np.float32)).to(BF16)
    x_kv = torch.from_numpy(rng.standard_normal((b, lk, 128)).astype(
        np.float32)).to(BF16)
    return p, x_q, x_kv


CASES = {               # (B, Lq, Lk, heads)
    "lq17_lk70_h4": (2, 17, 70, 4),
    "lq65_lk65_h2": (2, 65, 65, 2),
    "lq33_lk256_h4": (2, 33, 256, 4),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_wgmma_model_matches_plain_version_and_jax(name):
    b, lq, lk, heads = CASES[name]
    p, x_q, x_kv = _inputs(sorted(CASES).index(name), b, lq, lk)
    pt = {key: torch.from_numpy(val) for key, val in p.items()}
    got = _wgmma_model(x_q, x_kv, pt, heads)
    assert got.dtype == BF16 and got.shape == x_q.shape
    # Against the plain version, which rounds the same operands where the
    # kernel does: sums in other orders and P's exponentials taken another
    # way flip a rounding now and then.
    ok, share = _within_gates(got, tmha.mha_block_reference_bf16(
        x_q, x_kv, pt, heads))
    assert ok and share <= GATE_SHARE
    # Against the JAX kernel in interpret mode on bf16 arrays, both on
    # XLA's f32 LayerNorm (its last bits differ from the correctly rounded
    # one); JAX's P is e / sum, the kernel's 2^(s c - lse2).
    pj = {key: jnp.asarray(val) for key, val in p.items()}

    def jarr(t):
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)

    want = np.array(jmha.mha_block(jarr(x_q), jarr(x_kv), pj, heads,
                                   interpret=True, mxu_bf16=True)
                    .astype(jnp.float32))
    jln = jax.jit(jmha._layer_norm)

    def xla_layer_norm(x, s, bias):
        return torch.from_numpy(np.array(jln(*(jnp.asarray(t.numpy())
                                              for t in (x, s, bias)))))

    got_j = _wgmma_model(x_q, x_kv, pt, heads, layer_norm=xla_layer_norm)
    ok, share = _within_gates(got_j, torch.from_numpy(want).to(BF16))
    assert ok and share <= GATE_SHARE


@pytest.mark.parametrize("lq,lk,heads,qsplit", [(65, 65, 2, 2),
                                                (130, 256, 4, 3)])
def test_query_split_gives_the_unsplit_bits(lq, lk, heads, qsplit):
    """Small batches split a batch element's query tiles over blocks, each
    projecting K and V itself: every row's arithmetic is the one of the
    unsplit kernel."""
    p, x_q, x_kv = _inputs(7, 2, lq, lk)
    pt = {key: torch.from_numpy(val) for key, val in p.items()}
    assert torch.equal(_wgmma_model(x_q, x_kv, pt, heads, qsplit=qsplit),
                       _wgmma_model(x_q, x_kv, pt, heads))


def test_route_takes_bf16_io_up_to_256_keys():
    """bf16 activations in the bf16 mode with at most 256 keys run the wgmma
    kernel; f32 activations, the f32 mode and longer key sets keep
    ``mha_mma_kernel``; naming the wgmma kernel for any of those raises
    before a launch."""
    assert tmha.wgmma_route(True, True, 256)
    assert not tmha.wgmma_route(True, True, 257)
    assert not tmha.wgmma_route(False, True, 65)
    assert not tmha.wgmma_route(True, False, 65)
    p, x_q, x_kv = _inputs(3, 1, 8, 300)
    flat = [torch.from_numpy(p[k]) for k in tmha.PARAM_KEYS]
    with pytest.raises(ValueError, match="at most 256 keys"):
        tmha._mha_block_cuda(x_q, x_kv, flat, 4, 32 ** -0.5, True,
                             kernel="wgmma")
    with pytest.raises(ValueError, match="at most 256 keys"):
        tmha._mha_block_cuda(x_q.float(), x_kv[:, :65].float(), flat, 4,
                             32 ** -0.5, True, kernel="wgmma")
    with pytest.raises(ValueError, match="no mha_block kernel"):
        tmha._mha_block_cuda(x_q, x_kv[:, :65], flat, 4, 32 ** -0.5, True,
                             kernel="flash")
