"""The f32 modes' bf16-I/O instances (``mxu_bf16=False`` on bf16 tensors),
modelled on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold them against their plain versions
there). What their arithmetic does is stated here in PyTorch, in the
kernels' order, and held against the JAX package's Pallas kernels in
interpret mode with ``mxu_bf16=False`` on bf16 arrays, and against the
port's plain versions:

* the packed attention's f32 mode (the flash kernels of
  ``csrc/flash_kernels.cuh`` with T = bf16): every value widened exactly;
  the forward's online softmax over tiles of 32 keys, the output rounded
  once; the dQ kernel over the same key tiles, dQ rounded once; the dK/dV
  kernel over tiles of 32 queries, whose f32 sums are flushed every 4
  tiles (128 queries from query 0, JAX's block) into running bf16 sums:
  the first block's sum rounded, each later one rounded and added to the
  running sum, which is rounded again. Lq 65, 200 and 300: one, two and
  three blocks, the last partial;
* ``mha_block``'s f32 mode (``kv_proj_kernel<bf16>``, ``attn_kernel<D,
  bf16>``): x_q and x_kv widened, the LayerNorms, projections, online
  softmax over 32-key tiles, biases and residual in f32, the output rounded
  once. 65, 256 and 512 keys.

A chain of tensor-core (3xTF32) or FMA products is modelled as the exact
sum rounded once to f32: the model is the kernels' order, not their bits.
Inputs are made with numpy from a seed and fed to all sides.

Tolerance: each output within one bf16 step for every bf16 rounding
between the f32 sums and it (the output and dQ one; dK and dV one per block
and one per join to the running sum), a step of the largest value that
rounding takes (for dK and dV the largest of the block sums and the
running sums: a block sum's flipped rounding moves a running sum that
cancels to a small value by a step of the block sum) and of no less than
2^-14 of the tensor's largest entry (sums in other orders may differ by
more than a tiny value's own step); and at most ``SHARE`` of
the outputs differing in their bits: only the order of f32 sums differs,
so a flip needs an f32 sum within its rounding error of a bf16 tie. JAX's
P is e / sum and its sums run in other orders, so the same gate holds
against it. A version that rounds dK and dV once over all queries
differs in far more outputs past one block (it fails the share gate).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sc_torch.kernels import attention_packed as tpacked
from multimodal_sc_torch.kernels import mha_block as tmha
from multimodal_sc_tpu.kernels import attention_packed as jpacked
from multimodal_sc_tpu.kernels import mha_block as jmha

torch.backends.cuda.matmul.allow_tf32 = False

BF16 = torch.bfloat16
TILE = 32             # flash kernels' key (forward, dQ) and query (dK/dV) tile
BLOCK = tpacked.BLOCK_Q   # dK and dV rounded into their running sum per block
MHA_TILE = 32         # attn_kernel's key tile (RT)
FLOOR = 2.0 ** -14    # chip_smoke.BF16_FLOOR
SHARE = 2e-3


def _draws(seed, *shapes):
    """bf16 draws, as (JAX, torch) pairs of the same values."""
    rng = np.random.default_rng(seed)
    out = []
    for s in shapes:
        j = jnp.asarray(rng.standard_normal(s).astype(np.float32),
                        jnp.bfloat16)
        out.append((j, torch.from_numpy(_f(j)).to(BF16)))
    return out


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _share_and_steps(got, want, mag=None):
    """(share of entries whose bits differ, the largest distance in bf16
    steps of ``mag`` (default the reference value), floored at ``FLOOR`` of
    the reference's largest entry)."""
    g, w = _f(got), _f(want)
    m = np.abs(w) if mag is None else np.maximum(np.abs(w), _f(mag))
    _, e = np.frexp(np.maximum(m, FLOOR * np.abs(w).max()))
    steps = np.abs(g - w) / np.ldexp(1.0, e - 8)
    return float(np.mean(g != w)), float(steps.max())


def _gate(got, want, what, roundings=1, mag=None):
    assert got.shape == want.shape, what
    share, steps = _share_and_steps(got, want, mag)
    assert share <= SHARE, f"{what}: {100 * share:.3f}% of entries differ"
    assert steps <= roundings, f"{what}: {steps:.2f} bf16 steps apart"


def _chain(a, b):
    """a @ b as one f32-grade chain: the exact sum rounded once to f32."""
    return (a.double() @ b.double()).float()


def _heads(x, heads):
    b, n, dm = x.shape
    return x.float().reshape(b, n, heads, dm // heads).transpose(1, 2)


def _packed(x):
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def _fwd_model(q, k, v, heads, scale):
    """``flash_fwd_kernel<DT, bf16>``: (out bf16, lse f32)."""
    qh, kh, vh = (_heads(t, heads) for t in (q, k, v))
    qs = qh * scale
    b, h, lq, d = qh.shape
    m = torch.full((b, h, lq, 1), -1e30)
    l = torch.zeros(b, h, lq, 1)
    o = torch.zeros(b, h, lq, d)
    for k0 in range(0, kh.shape[2], TILE):
        s = _chain(qs, kh[:, :, k0:k0 + TILE].transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _chain(p, vh[:, :, k0:k0 + TILE])
        m = m_new
    out = _packed(o * (1.0 / l)).to(BF16)
    return out, (m + torch.log(l))[..., 0]


def _bwd_model(q, k, v, out, dout, lse, heads, scale, blocked=True):
    """``flash_bwd_dq_tc_kernel<DT, bf16>`` and
    ``flash_bwd_dkv_tc_kernel<DT, bf16>``: (dq, dk, dv) in bf16, and the
    largest magnitude each dK and dV rounding took (its block sums and
    running sums). Without ``blocked`` dK and dV are summed over every
    query and rounded once."""
    qh, kh, vh, oh, doh = (_heads(t, heads) for t in (q, k, v, out, dout))
    delta = (doh * oh).sum(-1, keepdim=True)
    lse = lse[..., None]
    acc = torch.zeros_like(qh)
    for k0 in range(0, kh.shape[2], TILE):
        kt, vt = kh[:, :, k0:k0 + TILE], vh[:, :, k0:k0 + TILE]
        p = torch.exp(_chain(qh * scale, kt.transpose(-1, -2)) - lse)
        ds = p * (_chain(doh, vt.transpose(-1, -2)) - delta)
        acc = acc + _chain(ds, kt)
    dq = _packed(acc * scale).to(BF16)
    lq = qh.shape[2]
    ak = torch.zeros_like(kh)
    av = torch.zeros_like(vh)
    run_k = run_v = None
    mag_k, mag_v = torch.zeros_like(kh), torch.zeros_like(vh)
    for j, q0 in enumerate(range(0, lq, TILE)):
        rows = slice(q0, q0 + TILE)
        st = _chain(kh * scale, qh[:, :, rows].transpose(-1, -2))
        pt = torch.exp(st - lse[:, :, rows, 0][:, :, None, :])
        dst = pt * (_chain(vh, doh[:, :, rows].transpose(-1, -2))
                    - delta[:, :, rows, 0][:, :, None, :])
        av = av + _chain(pt, doh[:, :, rows])
        ak = ak + _chain(dst, qh[:, :, rows])
        last = q0 + TILE >= lq
        if blocked and ((j + 1) % (BLOCK // TILE) == 0 or last):
            pk, pv = (ak * scale).to(BF16), av.to(BF16)
            run_k = pk if run_k is None else run_k + pk
            run_v = pv if run_v is None else run_v + pv
            mag_k = torch.maximum(mag_k, torch.maximum(
                (ak * scale).abs(), run_k.float().abs()))
            mag_v = torch.maximum(mag_v, torch.maximum(
                av.abs(), run_v.float().abs()))
            ak, av = torch.zeros_like(ak), torch.zeros_like(av)
    if not blocked:
        run_k, run_v = (ak * scale).to(BF16), av.to(BF16)
    return (dq, _packed(run_k), _packed(run_v)), (None, _packed(mag_k),
                                                  _packed(mag_v))


@pytest.mark.parametrize("lq", [65, 200, 300])
def test_packed_f32_mode_model_matches_jax_on_bf16(lq):
    heads, lk = 4, 96
    scale = 32 ** -0.5
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _draws(
        lq, (2, lq, 128), (2, lk, 128), (2, lk, 128), (2, lq, 128))
    want, vjp = jax.vjp(functools.partial(
        jpacked.packed_attention, heads=heads, interpret=True,
        mxu_bf16=False), jq, jk, jv)
    want_g = vjp(jdo)
    out, lse = _fwd_model(tq, tk, tv, heads, scale)
    _gate(out, want, "out")
    # The backward takes JAX's forward output, as its own backward does:
    # a flipped output entry moves its row's delta and every dQ of the row.
    out = torch.from_numpy(_f(want)).to(BF16)
    got, mags = _bwd_model(tq, tk, tv, out, tdo, lse, heads, scale)
    blocks = -(-lq // BLOCK)
    for name, g, w, m in zip("qkv", got, want_g, mags):
        _gate(g, w, f"d{name}", 1 if name == "q" else 2 * blocks - 1, m)
    # The plain version the card's check holds the kernels to rounds where
    # the model does.
    plain, plain_lse = tpacked.packed_attention_fwd_reference(tq, tk, tv,
                                                             heads, scale)
    _gate(_fwd_model(tq, tk, tv, heads, scale)[0], plain,
          "out against the plain version")
    torch.testing.assert_close(lse, plain_lse, atol=2e-6, rtol=2e-6)
    plain_g = tpacked.packed_attention_bwd_reference(tq, tk, tv, out, tdo,
                                                     heads, scale, lse=lse)
    for name, g, w, m in zip("qkv", got, plain_g, mags):
        _gate(g, w, f"d{name} against the plain version",
              1 if name == "q" else 2 * blocks - 1, m)
    if lq > BLOCK:
        # dK and dV rounded once over all queries: many more flips.
        once, _ = _bwd_model(tq, tk, tv, out, tdo, lse, heads, scale,
                             blocked=False)
        for name, g, o, w in zip("kv", got[1:], once[1:], want_g[1:]):
            blocked_share, _ = _share_and_steps(g, w)
            once_share, _ = _share_and_steps(o, w)
            assert once_share > max(10 * blocked_share, SHARE), (
                name, once_share, blocked_share)


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


def _ln_model(x, s, b):
    """``ln_tile``: mean, then the mean square of the centred row, in f32."""
    mu = x.sum(-1, keepdim=True) * (1.0 / x.shape[-1])
    d = x - mu
    var = (d * d).sum(-1, keepdim=True) * (1.0 / x.shape[-1])
    return d * torch.rsqrt(var + 1e-6) * s + b


def _mha_model(x_q, x_kv, p, heads):
    """``kv_proj_kernel<bf16>`` then ``attn_kernel<D, bf16>``: the output
    in bf16."""
    xq, xkv = x_q.float(), x_kv.float()
    dm = xq.shape[-1]
    d = dm // heads
    scale = d ** -0.5
    lnkv = _ln_model(xkv, p["ln_kv_scale"], p["ln_kv_bias"])
    k = _chain(lnkv, p["wk"]) + p["bk"]
    v = _chain(lnkv, p["wv"]) + p["bv"]
    q = _chain(_ln_model(xq, p["ln_q_scale"], p["ln_q_bias"]), p["wq"]) \
        + p["bq"]
    qh, kh, vh = (_heads(t, heads) for t in (q, k, v))
    b, h, lq, _ = qh.shape
    m = torch.full((b, h, lq, 1), -float("inf"))
    l = torch.zeros(b, h, lq, 1)
    o = torch.zeros(b, h, lq, d)
    for k0 in range(0, kh.shape[2], MHA_TILE):
        s = _chain(qh, kh[:, :, k0:k0 + MHA_TILE].transpose(-1, -2)) * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p_ = torch.exp(s - m_new)
        l = l * corr + p_.sum(-1, keepdim=True)
        o = o * corr + _chain(p_, vh[:, :, k0:k0 + MHA_TILE])
        m = m_new
    att = _packed(o * (1.0 / l))
    return ((xq + _chain(att, p["wo"])) + p["bo"]).to(BF16)


@pytest.mark.parametrize("lk", [65, 256, 512])
def test_mha_f32_mode_model_matches_jax_on_bf16(lk):
    rng = np.random.default_rng(lk)
    heads, lq, dim = 4, 65, 128
    p = _mha_params(rng, dim)
    (jq, tq), (jkv, tkv) = _draws(lk + 1, (2, lq, dim), (2, lk, dim))
    want = jmha.mha_block(jq, jkv, {k: jnp.asarray(v) for k, v in p.items()},
                          heads, interpret=True, mxu_bf16=False)
    assert want.dtype == jnp.bfloat16
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = _mha_model(tq, tkv, tp, heads)
    _gate(got, want, "out")
    plain = tmha.mha_block_reference(tq, tkv, tp, heads)
    assert plain.dtype == BF16
    _gate(got, plain, "out against the plain version")
    # The port's CPU route is that plain version, whatever the flag.
    before = (tmha.launches_bf16, tmha.launches_f32io_bf16)
    assert torch.equal(tmha.mha_block(tq, tkv, tp, heads, mxu_bf16=False),
                       plain)
    assert (tmha.launches_bf16, tmha.launches_f32io_bf16) == before


def test_f32_mode_routes_bf16_tensors_to_its_bf16_io_instances():
    """The launchers' modes: bf16 tensors with ``mxu_bf16=False`` take the
    f32 mode's bf16-I/O instance, counted apart; the CPU route runs the
    plain version and counts nothing."""
    z = torch.zeros(1, 8, 128, dtype=BF16)
    assert tpacked._mode(z, False) == tpacked._MODE_F32_BF16_IO
    for mode, suffix in ((tpacked._MODE_F32, ""), (tpacked._MODE_BF16, ""),
                         (tpacked._MODE_BF16_IO, "_bf16"),
                         (tpacked._MODE_F32_BF16_IO, "_f32io_bf16")):
        for which in ("fwd", "bwd"):
            name = f"launches_{which}{suffix}"
            before = getattr(tpacked, name)
            tpacked._count(mode, which)
            assert getattr(tpacked, name) == before + 1
            setattr(tpacked, name, before)
    (_, q), (_, k), (_, v) = _draws(9, (1, 40, 128), (1, 24, 128),
                                    (1, 24, 128))
    before = (tpacked.launches_fwd_f32io_bf16, tpacked.launches_bwd_f32io_bf16)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tpacked.packed_attention(*ins, 4, mxu_bf16=False)
    torch.autograd.grad(out, ins, torch.ones_like(out))
    assert (tpacked.launches_fwd_f32io_bf16,
            tpacked.launches_bwd_f32io_bf16) == before
    assert torch.equal(out, tpacked.packed_attention_fwd_reference(
        q, k, v, 4)[0])
