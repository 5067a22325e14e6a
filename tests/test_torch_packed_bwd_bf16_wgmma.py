"""The packed attention backward's bf16-I/O kernel on bf16 wgmma, modelled
on the CPU.

The CUDA kernel (``bwd_wgmma_bf16_kernel`` in ``csrc/packed_bwd_bf16.cuh``)
runs only on the card (``chip_smoke.py`` and ``tests/test_torch_cuda.py``
hold it against its plain version there). What its arithmetic does is
stated here in PyTorch, in the kernel's order, and held against the JAX
package's Pallas kernel under ``jax.vjp`` in interpret mode on bf16 arrays
(``mxu_bf16=True``) and against the port's plain version,
``packed_attention_bwd_reference(..., bf16=True, lse=lse)``:

* keys as the products' M: per (batch element, head) and 64-key tile,
  S^T = K Q^T and dP^T = V dO^T, each one chain over the head dim;
* P^T = exp(s scale - lse), the product rounded to f32 before the
  difference; delta = sum_d dO O in f32 of the bf16 values; dS^T =
  P^T (dP^T - delta) scale; P and dS rounded to bf16 as operands;
* dV = P^T dO and dK = dS^T Q one chain per 128-query block
  (``BLOCK_Q``), each block's sum rounded to bf16 and added to the running
  bf16 sum, which is rounded again;
* dQ = dS K one chain per 64-key tile, the tiles' sums joined by f32 adds
  in key order, rounded once.

A chain in the tensor-core accumulator is modelled as the exact sum rounded
once to f32 (the card truncates inside a chain; the plain version's sums
run in other orders): the model is the kernel's order, not its bits.
Inputs are made with numpy from a seed and fed to all sides; each tensor
compared holds at least 30,000 outputs, so a share of differing ones is
more than noise. Tolerance against the plain version, which rounds the
same values at the same places: one bf16 step for each rounding between
the f32 sums and an output (the larger of the two values' steps, at 2^-14
of the tensor's largest entry at least: ``chip_smoke.BF16_FLOOR``): dQ
one, dK and dV one per 128-query block and one per join of a block to the
running sum; plus ``REACH``, what one flipped intermediate rounding (of dS
or P, whose sums run in other orders) moves an output by at these
magnitudes (3.05e-5 at most here); at most 0.1% of the outputs differing.
Against JAX's kernel,
whose P is e / sum (a flipped rounding of P or dS moves an output by a
step of its own size): ``_bf16_gate`` of ``test_torch_bf16_attention.py``,
every output within 2 bf16 steps of the tensor's largest entry, at most 1%
differing.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sc_torch.kernels import attention_packed as tpacked
from multimodal_sc_tpu.kernels import attention_packed as jpacked

BF16 = torch.bfloat16
KEYS = 64           # keys of a warpgroup: one dQ chain each
BLOCK = tpacked.BLOCK_Q   # dK, dV: one chain per 128-query block
FLOOR = 2.0 ** -14  # chip_smoke.BF16_FLOOR
SHARE = {"plain": 1e-3, "jax": 1e-2}
JAX_STEPS = 2       # bf16 steps of the tensor's largest entry, against JAX
REACH = 1e-4        # a flipped intermediate rounding's reach, against plain


def _chain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as one tensor-core chain: bf16 values, their products summed
    exactly (f64 holds every such sum here) and rounded once to f32."""
    return (a.double() @ b.double()).float()


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, dm = x.shape
    return x.float().reshape(b, n, heads, dm // heads).transpose(1, 2)


def _packed(x: torch.Tensor) -> torch.Tensor:
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def _wgmma_model(q, k, v, out, dout, lse, heads, scale):
    """``bwd_wgmma_bf16_kernel``'s arithmetic on bf16 inputs: (dq, dk, dv)
    in bf16."""
    lq, lk = q.shape[1], k.shape[1]
    qh, kh, vh, oh, doh = (_heads(t, heads) for t in (q, k, v, out, dout))
    delta = (doh.double() * oh.double()).sum(-1).float()        # (b, h, lq)
    st = _chain(kh, qh.transpose(-1, -2))                     # keys x queries
    pt = torch.exp(st * scale - lse.unsqueeze(-2))
    dpt = _chain(vh, doh.transpose(-1, -2))
    dst = ((pt * (dpt - delta.unsqueeze(-2))) * scale).to(BF16).float()
    pt = pt.to(BF16).float()
    dk = dv = None
    for q0 in range(0, lq, BLOCK):
        rows = slice(q0, q0 + BLOCK)
        part_v = _chain(pt[..., rows], doh[..., rows, :]).to(BF16)
        part_k = _chain(dst[..., rows], qh[..., rows, :]).to(BF16)
        dv = part_v if dv is None else (dv.float() + part_v.float()).to(BF16)
        dk = part_k if dk is None else (dk.float() + part_k.float()).to(BF16)
    dq = None
    for k0 in range(0, lk, KEYS):
        keys = slice(k0, k0 + KEYS)
        part = _chain(dst[..., keys, :].transpose(-1, -2), kh[..., keys, :])
        dq = part if dq is None else dq + part
    return _packed(dq).to(BF16), _packed(dk), _packed(dv)


def _bf16_step(x: torch.Tensor) -> torch.Tensor:
    _, e = torch.frexp(x.float().abs().clamp(min=2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def _readings(got: torch.Tensor, want: torch.Tensor, reach: float = 0.0):
    """(the largest distance in bf16 steps, less ``reach``, the share of
    outputs whose bits differ)."""
    g, w = got.float(), want.float()
    floor = FLOOR * w.abs().max()
    step = torch.maximum(_bf16_step(torch.maximum(w.abs(), floor)),
                         _bf16_step(torch.maximum(g.abs(), floor)))
    far = ((g - w).abs() - reach).clamp(min=0.0)
    return (far / step).max().item(), (got != want).float().mean().item()


def _draws(seed, b, lq, lk):
    """bf16 q, k, v, dO from a numpy seed, as numpy f32 arrays of bf16
    values."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (lq, lk, lk, lq):
        x = rng.standard_normal((b, n, 128)).astype(np.float32)
        out.append(torch.from_numpy(x).to(BF16).float().numpy())
    return out


CASES = {               # (B, Lq, Lk, heads): outputs per tensor >= 30,000
    "lq65_lk65_h4": (4, 65, 65, 4),
    "lq65_lk256_h4": (4, 65, 256, 4),
    "lq200_lk48_h4": (5, 200, 48, 4),
    "lq130_lk100_h2": (2, 130, 120, 2),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_wgmma_model_matches_plain_version_and_jax(name):
    b, lq, lk, heads = CASES[name]
    scale = (128 // heads) ** -0.5
    qn, kn, vn, don = _draws(sorted(CASES).index(name), b, lq, lk)
    q, k, v, do = (torch.from_numpy(x).to(BF16) for x in (qn, kn, vn, don))
    # JAX's forward and backward: the model runs on JAX's output.
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (qn, kn, vn, don))
    jout, vjp = jax.vjp(functools.partial(
        jpacked.packed_attention, heads=heads, interpret=True, mxu_bf16=True),
        jq, jk, jv)
    jgrads = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(BF16)
              for x in vjp(jdo)]
    out = torch.from_numpy(np.array(jout.astype(jnp.float32))).to(BF16)
    _, lse = tpacked.packed_attention_fwd_reference(q, k, v, heads, scale,
                                                    bf16=True)
    got = _wgmma_model(q, k, v, out, do, lse, heads, scale)
    plain = tpacked.packed_attention_bwd_reference(q, k, v, out, do, heads,
                                                   scale, bf16=True, lse=lse)
    blocks = -(-lq // BLOCK)
    for i, (g, w) in enumerate(zip(got, plain)):
        assert g.dtype == w.dtype == BF16 and g.shape == w.shape
        steps, share = _readings(g, w, REACH)
        assert steps <= (1 if i == 0 else 2 * blocks - 1), ("qkv"[i], steps)
        assert share <= SHARE["plain"], ("qkv"[i], share)
    for i, (g, w) in enumerate(zip(got, jgrads)):
        assert g.shape == w.shape
        top = _bf16_step(w.float().abs().max())
        assert (g.float() - w.float()).abs().max() <= JAX_STEPS * top, i
        assert (g != w).float().mean().item() <= SHARE["jax"], i


def test_model_flushes_dk_dv_per_128_queries():
    """Lq 200 is two blocks: the model's dK and dV are the plain version's
    per-block sums, and a single 200-query chain rounded once lies past the
    model's own reach from them on some output."""
    b, lq, lk, heads = 2, 200, 48, 4
    scale = (128 // heads) ** -0.5
    q, k, v, do = (torch.from_numpy(x).to(BF16)
                   for x in _draws(11, b, lq, lk))
    out, lse = tpacked.packed_attention_fwd_reference(q, k, v, heads, scale,
                                                      bf16=True)
    got = _wgmma_model(q, k, v, out, do, lse, heads, scale)
    plain = tpacked.packed_attention_bwd_reference(q, k, v, out, do, heads,
                                                   scale, bf16=True, lse=lse)
    once = tpacked.packed_attention_bwd_reference(
        *(t.float() for t in (q, k, v, out, do)), heads, scale, bf16=True,
        lse=lse)
    for i in (1, 2):
        _, share = _readings(got[i], plain[i])
        _, share_once = _readings(once[i].to(BF16), plain[i])
        assert share <= SHARE["plain"] < share_once


def test_route_takes_bf16_io_up_to_256_keys():
    """bf16 tensors in the bf16 mode with at most 256 keys run the wgmma
    kernel; f32 tensors, the f32 mode and longer key sets keep
    ``bwd_mma_kernel`` (or the f32 mode's flash kernels); naming a kernel
    for a shape it does not take raises before a launch."""
    assert tpacked.bwd_wgmma_route(True, True, 256)
    assert not tpacked.bwd_wgmma_route(True, True, 257)
    assert not tpacked.bwd_wgmma_route(False, True, 65)
    assert not tpacked.bwd_wgmma_route(True, False, 65)
    q, k, v, do = (torch.from_numpy(x).to(BF16) for x in _draws(3, 1, 8, 300))
    lse = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="at most 256 keys"):
        tpacked._bwd_cuda(q, k, v, q, lse, do, 4, 32 ** -0.5, True,
                          kernel="wgmma")
    with pytest.raises(ValueError, match="no packed attention backward"):
        tpacked._bwd_cuda(q, k[:, :65], v[:, :65], q, lse, do, 4,
                          32 ** -0.5, True, kernel="flash")
    f32 = [t.float() for t in (q, k[:, :65], v[:, :65], q, do)]
    with pytest.raises(ValueError, match="bf16 mode"):
        tpacked._bwd_cuda(*f32[:4], lse, f32[4], 4, 32 ** -0.5, False,
                          kernel="mma")
