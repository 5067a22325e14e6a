"""The flash attention kernels on bf16 tensors (``csrc/flash_bf16.cuh``),
modelled on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them against
their plain versions there). What their arithmetic does is stated here in
PyTorch, in the order the kernels do it, and held against the JAX package's
kernels (``_flash_attention_fwd_impl`` / ``_flash_attention_bwd_impl`` in
interpret mode, handed bf16 arrays) and the port's plain versions:

* every value widened to f32; the forward's q scale in f32, the backward's
  scale applied after q K^T; softmax, P and dS in f32;
* a product of two bf16 values as one bf16 pass (exact products, f32 sums):
  q K^T, dO V^T, and (q scale) K^T where the scale is a power of two;
* a product with an f32 operand (P, dS, q scale otherwise) as three passes,
  that operand split into bf16 hi, mid and lo, the small pieces first;
* the forward over 64-key tiles with the online softmax (its exponentials
  as powers of two); the backward over 64-row tiles (32 at head dims above
  64); each result rounded to bf16 once.

Inputs are made with numpy from a seed and fed to both sides.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from multimodal_sc_torch.kernels import attention as tattn

# ``multimodal_sc_tpu.kernels`` exports a function named ``attention`` over
# the submodule of that name: ask for the module itself.
jattn = importlib.import_module("multimodal_sc_tpu.kernels.attention")

NEG = -1e30       # the kernels' first running max and masked score
FWD_KEYS = 64     # keys of a forward tile
LOG2E = 1.4426950408889634


def _bwd_rows(d):
    """Rows of a backward tile at head dim d (compiled width above 64: 32)."""
    return 32 if d > 64 else 64


def _split3(x: torch.Tensor):
    """``x = hi + mid + lo`` as ``bw::split3`` splits an f32: each piece the
    bf16 rounding (to nearest even) of what the ones before left."""
    hi = x.bfloat16().float()
    r = x - hi
    mid = r.bfloat16().float()
    return hi, mid, (r - mid).bfloat16().float()


def _mm_split(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (f32) . b (bf16 values) in three bf16 passes of a's pieces, small
    first, as the kernels issue them."""
    hi, mid, lo = _split3(a)
    return lo @ b + mid @ b + hi @ b


def _fwd_model(q, k, v, scale):
    """``(out f32 before its rounding, lse)`` as ``flash_fwd_bf16_kernel``
    computes them from bf16 (B, H, L, D) inputs."""
    qf, kf, vf = (t.float() for t in (q, k, v))
    qs = qf * scale
    one_pass = math.frexp(scale)[0] == 0.5
    if one_pass:
        # A power-of-two scale keeps q scale a bf16 value: one piece.
        assert torch.equal(qs.bfloat16().float(), qs)
    m = torch.full(q.shape[:3], NEG)
    l = torch.zeros(q.shape[:3])
    o = torch.zeros(q.shape)
    for k0 in range(0, k.shape[2], FWD_KEYS):
        kt, vt = kf[:, :, k0:k0 + FWD_KEYS], vf[:, :, k0:k0 + FWD_KEYS]
        s = qs @ kt.transpose(-1, -2) if one_pass else _mm_split(
            qs, kt.transpose(-1, -2))
        mx = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - mx)
        # exp(s - m) as the kernel takes it: 2^(s log2 e - m log2 e).
        p = torch.exp2(s * LOG2E - (mx * LOG2E)[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + _mm_split(p, vt)
        m = mx
    lc = l.clamp_min(1e-30)
    return o / lc[..., None], m + torch.log(lc)


def _bwd_model(q, k, v, out, lse, g, scale):
    """``(dq, dk, dv, delta)`` as ``flash_bwd_dq_bf16_kernel`` and
    ``flash_bwd_dkv_bf16_kernel`` compute them: dQ over key tiles, dK and
    dV over query tiles, each summed in f32 and rounded once."""
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    bt = _bwd_rows(q.shape[-1])
    delta = (gf * out.float()).sum(-1)
    acc = torch.zeros(qf.shape)
    for k0 in range(0, kf.shape[2], bt):
        kt, vt = kf[:, :, k0:k0 + bt], vf[:, :, k0:k0 + bt]
        p = torch.exp(qf @ kt.transpose(-1, -2) * scale - lse[..., None])
        ds = p * (gf @ vt.transpose(-1, -2) - delta[..., None])
        acc = acc + _mm_split(ds, kt)
    dka, dva = torch.zeros(kf.shape), torch.zeros(vf.shape)
    for q0 in range(0, qf.shape[2], bt):
        qt, gt = qf[:, :, q0:q0 + bt], gf[:, :, q0:q0 + bt]
        lt, dt = lse[:, :, q0:q0 + bt], delta[:, :, q0:q0 + bt]
        pt = torch.exp(kf @ qt.transpose(-1, -2) * scale - lt[:, :, None])
        dst = pt * (vf @ gt.transpose(-1, -2) - dt[:, :, None])
        dva = dva + _mm_split(pt, gt)
        dka = dka + _mm_split(dst, qt)
    return ((acc * scale).to(q.dtype), (dka * scale).to(k.dtype),
            dva.to(v.dtype), delta)


def _bf16_step(x: torch.Tensor) -> torch.Tensor:
    """One bf16 step at each |x| (8 significant bits)."""
    _, e = torch.frexp(x.float().abs().clamp(min=2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def _gate_bf16_io(got, want):
    """The bf16-I/O attention gate of ``chip_smoke.py``: within 1e-2 plus
    one bf16 step of the value that rounds where the kernel does (two sums
    in another order can flip the final rounding), mean error under 1e-5."""
    assert got.dtype == want.dtype == torch.bfloat16
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= 1e-2 + _bf16_step(want)).all()), diff.max().item()
    assert diff.mean().item() < 1e-5


def _inputs(seed, b, h, lq, lk, d):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .bfloat16() for s in ((b, h, lq, d), (b, h, lk, d),
                                       (b, h, lk, d), (b, h, lq, d)))


def _jnp(t: torch.Tensor):
    """A bf16 tensor as a JAX bf16 array (exact through f32)."""
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _jnp_lse(lse: torch.Tensor, lq: int):
    """(B, H, Lq) lse as JAX's backward takes it: (B*H, 1, Lq padded)."""
    b, h, _ = lse.shape
    pad = -(-lq // 128) * 128 - lq
    x = torch.nn.functional.pad(lse.reshape(b * h, 1, lq), (0, pad))
    return jnp.asarray(x.numpy())


def _torch(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


# (B, H, Lq, Lk, D): a power-of-two scale (D 64: q scale in one piece), and
# two that are not (D 32; D 96, compiled at width 128 with 32-row backward
# tiles), each over ragged tiles (Lk 100: a full and a ragged 64-key tile).
CASES = {64: (1, 2, 70, 100, 64), 32: (2, 2, 33, 100, 32),
         96: (1, 2, 40, 70, 96)}


@pytest.mark.parametrize("d", sorted(CASES))
def test_bf16_wgmma_model_matches_jax_and_plain_version(d):
    b, h, lq, lk, _ = CASES[d]
    q, k, v, g = _inputs(d, b, h, lq, lk, d)
    scale = d ** -0.5
    out32, lse = _fwd_model(q, k, v, scale)
    out = out32.bfloat16()

    # The plain versions, bf16 in and out (what the card's gate holds the
    # kernels to): the output under the bf16-I/O gate, lse within 2e-5.
    want, want_lse = tattn.flash_attention_fwd_reference(q, k, v, scale)
    _gate_bf16_io(out, want)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=2e-5)
    # Every product is exact up to its f32 sums: the output before its
    # rounding is within f32 summation noise of the f64 attention.
    s64 = q.double() @ k.double().transpose(-1, -2) * scale
    exact = torch.softmax(s64, -1) @ v.double()
    torch.testing.assert_close(out32.double(), exact, atol=2e-6, rtol=0)

    # JAX's kernels in interpret mode on the same bf16 arrays.
    block_q = min(128, -(-lq // 128) * 128)
    block_k = min(128, -(-lk // 128) * 128)
    jq, jk, jv, jg = (_jnp(t) for t in (q, k, v, g))
    j_out, j_lse = jattn._flash_attention_fwd_impl(jq, jk, jv, scale,
                                                   block_q, block_k, True)
    assert j_out.dtype == jnp.bfloat16
    _gate_bf16_io(out, _torch(j_out).bfloat16())
    j_lse = _torch(j_lse).reshape(b, h, -1)[:, :, :lq]
    torch.testing.assert_close(lse, j_lse, atol=2e-5, rtol=2e-5)

    # The backward on JAX's output and lse, as its custom VJP hands them.
    got = _bwd_model(q, k, v, _torch(j_out).bfloat16(), j_lse, g, scale)
    j_grads = jattn._flash_attention_bwd_impl(jq, jk, jv, j_out, _jnp_lse(
        j_lse, lq), jg, scale, block_q, block_k, True)
    for a, w in zip(got[:3], j_grads):
        _gate_bf16_io(a, _torch(w).bfloat16())
    want_g = tattn.flash_attention_bwd_reference(
        q, k, v, _torch(j_out).bfloat16(), j_lse, g, scale)
    for a, w in zip(got[:3], want_g):
        _gate_bf16_io(a, w)
    _, want_delta = tattn.flash_attention_dq_reference(
        q, k, v, _torch(j_out).bfloat16(), j_lse, g, scale)
    torch.testing.assert_close(got[3], want_delta, atol=1e-5, rtol=1e-5)


# P lies in [0, 1] and dS within a few hundred; below 2^-110 the last piece
# would pass bf16's smallest subnormal, and such terms are 2^-110 of a sum.
_range = st.floats(min_value=2.0 ** -110, max_value=2.0 ** 20, width=32)


@settings(max_examples=300, deadline=None)
@given(st.lists(st.one_of(st.just(0.0), _range, _range.map(lambda x: -x)),
                min_size=1, max_size=64))
def test_three_bf16_pieces_hold_an_f32_exactly(values):
    x = torch.tensor(values, dtype=torch.float32)
    hi, mid, lo = _split3(x)
    for piece in (hi, mid, lo):
        assert torch.equal(piece.bfloat16().float(), piece)
    # The sum in f64 (exact for three such pieces) is x itself.
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    # And each remainder is exact in f32, as the kernel subtracts it.
    assert torch.equal((x - hi) - mid, lo)


def test_the_wrappers_pick_a_kernel_by_dtype_or_refuse():
    """The C entry's mode from the tensors' dtype and the asked output
    dtype: f32 to f32 (the f32 kernels), bf16 to bf16, bf16 to f32 (the bf16
    kernels' sums before their rounding); nothing else."""
    f32, bf16 = torch.float32, torch.bfloat16
    q32, q16 = torch.zeros(1, 1, 1, 4), torch.zeros(1, 1, 1, 4, dtype=bf16)
    assert tattn._mode(q32, None) == (0, f32)
    assert tattn._mode(q16, None) == (1, bf16)
    assert tattn._mode(q16, f32) == (2, f32)
    with pytest.raises(TypeError):
        tattn._mode(q32, bf16)
    with pytest.raises(TypeError):
        tattn._mode(q16, torch.float16)
