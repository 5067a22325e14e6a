"""The bf16 scatter kernels of ``csrc/scatter_bf16.cuh``, modelled on the CPU.

The CUDA kernels run only on the card, where ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold them against their plain versions. Here a
model of ``scatter_max_bf16_kernel`` and ``scatter_max_bwd_bf16_kernel`` in
numpy, step for step as the source runs them (the items a block takes in
turn and their buffers, the copies of an item's cells and feature slice,
the lists linked by shared-memory atomics in any order, the forward's
integer-key max a 16-byte piece, the backward's two 16-bit tie counts to a
word, its shares and its two passes), is checked for:

* its work partition at c4's and c3's N, D and cells with a small B: every
  output piece written once, every point's features copied once (and read
  by its cell's walk as the design says), every 16-byte access aligned;
* its arithmetic, bit for bit, against JAX's ``scatter_max_reference`` on
  the widened features and its ``jax.vjp`` (the bits of the JAX pillar
  net), and against the port's plain versions: forced ties (one of more
  than 256 points), an all-negative cell, an all-trash env, D 64 and D 40;
* the wrapper's route by dtype and D, its plan, and its refusals.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sc_torch.kernels import pillar_scatter as tscatter
from multimodal_sc_tpu.kernels import pillar_scatter as jscatter


# --- the kernels' arithmetic on 32-bit words of two bf16 -------------------

def _words(bits):
    """(..., 8) uint16 -> (..., 4) uint32, the low half the first feature."""
    b = bits.astype(np.uint32)
    return b[..., 0::2] | (b[..., 1::2] << 16)


def _halves(words):
    out = np.empty(words.shape[:-1] + (2 * words.shape[-1],), np.uint16)
    out[..., 0::2] = words & 0xffff
    out[..., 1::2] = words >> 16
    return out


def _key2(w):
    """``key2``: each half's low 15 bits flipped where its sign is set."""
    w = np.asarray(w, np.uint32)
    return w ^ (((w >> 15) & np.uint32(0x00010001)) * np.uint32(0x7fff))


def _vmaxs2(a, b):
    """``__vmaxs2``: the signed max of each 16-bit half."""
    ha, hb = _halves(a).view(np.int16), _halves(b).view(np.int16)
    return _words(np.maximum(ha, hb).view(np.uint16))


def _widen(words):
    """``widen8``: the 8 features of each piece as f32."""
    out = np.empty(words.shape[:-1] + (2 * words.shape[-1],), np.uint32)
    out[..., 0::2] = words << 16
    out[..., 1::2] = words & np.uint32(0xffff0000)
    return out.view(np.float32)


def _share_bits(g, n):
    """``share_bits``: bf16(g * (1 / n)), the product and the reciprocal
    (rounded to nearest, as ``__frcp_rn``) in f32."""
    with np.errstate(divide="ignore", invalid="ignore"):
        x = g * (np.float32(1.0) / n.astype(np.float32))
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def test_integer_keys_order_like_the_old_kernels_atomics():
    """The 16-bit keys order every bf16 as the f32 integer atomics of
    ``pillar_scatter.cu`` order its widened value (NaN aside): so the
    forward's max has the old kernel's bits, -0 below +0 included."""
    bits = np.arange(1 << 16, dtype=np.uint32)
    bits = bits[(bits & 0x7f80) != 0x7f80]           # no inf or NaN
    keys = _halves(_key2(bits[:, None])).view(np.int16)[:, 0]
    f32 = (bits << 16).view(np.float32)
    # The old order: the value, and -0 below +0.
    old = np.lexsort((np.signbit(f32) == 0, f32))
    assert np.array_equal(np.sort(keys), keys[old])
    assert np.array_equal(_key2(_key2(bits)), bits)   # its own inverse
    # Two features a word: each half on its own.
    rng = np.random.default_rng(0)
    a, b = rng.integers(0, 1 << 32, (2, 1000), dtype=np.uint64).astype(
        np.uint32)
    lo = _vmaxs2(_key2(a & 0xffff), _key2(b & 0xffff)) & 0xffff
    assert np.array_equal(_vmaxs2(_key2(a), _key2(b)) & 0xffff, lo)


# --- the launch and the work partition -------------------------------------

class _Log:
    """Element counts of each access, and whether each was aligned."""

    def __init__(self, **sizes):
        self.n = {k: np.zeros(v, np.int64) for k, v in sizes.items()}
        self.aligned = True

    def touch(self, name, first, elems=8, esz=2):
        first = np.atleast_1d(first)
        self.aligned &= bool((first * esz % 16 == 0).all())
        idx = (first[:, None] + np.arange(elems)[None, :]).ravel()
        np.add.at(self.n[name], idx, 1)


def _units(count, lanes, threads):
    """A block's pieces as its threads take them: thread t keeps lane t %
    lanes and takes rows t // lanes, + threads // lanes, ... (the forward's
    cells, the backward's points); the last threads % lanes threads none.
    Returns (thread, row, lane), each (row, lane) once."""
    rows = threads // lanes
    t = np.arange(rows * lanes)
    row = (t // lanes)[:, None] + rows * np.arange(-(-count // rows))[None, :]
    keep = row < count
    out = (np.broadcast_to(t[:, None], row.shape)[keep], row[keep],
           np.broadcast_to((t % lanes)[:, None], row.shape)[keep])
    key = out[1] * lanes + out[2]
    assert np.array_equal(np.sort(key), np.arange(count * lanes))
    return out


def _run(feats_bits, cell, cells, width, seed, g_bits=None, out_bits=None):
    """Both kernels as ``csrc/scatter_bf16.cuh`` runs them, one block an
    item (env, slice), its threads as ``bf16_threads`` plans them. Forward
    (no ``g_bits``): the (B, cells, D) bf16 bits; backward: the (B, N, D)
    bits of the gradient. Returns the result and the access log."""
    b_, n, d = feats_bits.shape
    bwd = g_bits is not None
    threads = tscatter.bf16_threads(b_, n, d, cells, width, bwd)
    rng = np.random.default_rng(seed)
    n_slices = -(-d // width)
    log = _Log(copies=b_ * n * d, out=b_ * cells * d, gather_out=b_ * cells * d,
               gather_g=b_ * cells * d, gf=b_ * n * d,
               smem_reads=b_ * n * d)
    res = np.full((b_, n if bwd else cells, d), 0xdead, np.uint16)
    for block in range(b_ * n_slices):
        b, s = divmod(block, n_slices)
        f0 = s * width
        lanes = min(width, d - f0) // 8
        # The copies: the cells, then the feature slice's 16-byte pieces.
        _, p, l = _units(n, lanes, threads)
        log.touch("copies", (b * n + p) * d + f0 + 8 * l)
        fs = _words(feats_bits[b, :, f0:f0 + 8 * lanes].reshape(n, lanes, 8))
        real = (cell[b] >= 0) & (cell[b] < cells)
        if not bwd:
            # The lists: one atomicExch a point in a real cell, any order.
            heads = np.full(cells, -1)
            nxt = np.full(n, -1)
            for q in rng.permutation(n):
                if real[q]:
                    nxt[q], heads[cell[b, q]] = heads[cell[b, q]], q
            _, c, l = _units(cells, lanes, threads)
            empty = heads[c] < 0
            log.touch("out", (b * cells + c[empty]) * d + f0 + 8 * l[empty])
            res[b, c[empty][:, None], (f0 + 8 * l[empty])[:, None]
                + np.arange(8)] = 0
            for c_, l_ in zip(c[~empty], l[~empty]):
                q = heads[c_]
                acc = _key2(fs[q, l_])
                while q >= 0:
                    acc = _vmaxs2(acc, _key2(fs[q, l_]))
                    log.touch("smem_reads", (b * n + q) * d + f0 + 8 * l_)
                    q = nxt[q]
                log.touch("out", (b * cells + c_) * d + f0 + 8 * l_)
                res[b, c_, f0 + 8 * l_:f0 + 8 * l_ + 8] = _halves(_key2(acc))
            continue
        # Backward, pass 1: each real piece against `out` at its cell; the
        # hits kept as a byte, the ties counted two 16-bit counts a word.
        cnt = np.zeros((cells, 4 * lanes), np.uint32)
        u, p, l = _units(n, lanes, threads)
        live = real[p]
        c = cell[b, p]
        log.touch("gather_out", (b * cells + c[live]) * d + f0 + 8 * l[live])
        m = _words(out_bits[b, c[live]].reshape(-1, d // 8, 8)[
            np.arange(live.sum()), (f0 // 8) + l[live]])
        eq = _widen(fs[p[live], l[live]]) == _widen(m)
        log.touch("smem_reads", (b * n + p[live]) * d + f0 + 8 * l[live])
        mask = np.zeros(len(u), np.uint32)
        mask[live] = (eq * (1 << np.arange(8))).sum(1)
        inc = ((mask[live, None] >> (2 * np.arange(4))) & 1) | (
            ((mask[live, None] >> (2 * np.arange(4) + 1)) & 1) << 16)
        words = c[live, None] * 0 + 4 * l[live, None] + np.arange(4)
        order = rng.permutation(live.sum())          # atomics in any order
        np.add.at(cnt, (c[live][order, None], words[order]),
                  inc[order].astype(np.uint32))
        # `g` copied at each real piece's cell (before pass 1); pass 2: a
        # hit's share, every piece stored.
        log.touch("gather_g", (b * cells + c[live]) * d + f0 + 8 * l[live])
        hit = mask != 0
        gg = _widen(_words(g_bits[b, c[hit]].reshape(-1, d // 8, 8)[
            np.arange(hit.sum()), (f0 // 8) + l[hit]]))
        nw = cnt[c[hit, None], 4 * l[hit, None] + np.arange(4)]
        n8 = np.empty((hit.sum(), 8), np.uint32)
        n8[:, 0::2], n8[:, 1::2] = nw & 0xffff, nw >> 16
        bits8 = (mask[hit, None] >> np.arange(8)) & 1
        piece = np.zeros((len(u), 8), np.uint16)
        piece[hit] = np.where(bits8 == 1, _share_bits(gg, n8), 0)
        log.touch("gf", (b * n + p) * d + f0 + 8 * l)
        res[b, p[:, None], (f0 + 8 * l)[:, None] + np.arange(8)] = piece
    return res, log


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32).__rshift__(16).astype(
        np.uint16)


def _inputs(seed, b, n, d, cells, big_tie=False):
    """bf16 features (their bits) and cells: forced ties (rows copied onto
    the next in every feature and in half of them; a cell whose max 3
    points share); env 1 an all-negative cell; the last env all trash; with
    ``big_tie`` 300 points of env 0 in one cell, tied at its max in feature
    0."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((b, n, d)).astype(np.float32)
    cell = rng.integers(0, cells + 1, (b, n)).astype(np.int32)
    for first, width in ((0, d), (4, d // 2)):
        src = np.arange(first, n - 1, 8)
        cell[:, src + 1] = cell[:, src]
        f[:, src + 1, :width] = f[:, src, :width]
    cell[0, 10:13] = 2
    f[0, 10:13] = 6.0
    if b > 2:
        cell[1, 20:23] = 7
        cell[1, 23:] = np.where(cell[1, 23:] == 7, 8, cell[1, 23:])
        f[1, 20:23] = -np.abs(f[1, 20:23]) - 0.5
    if big_tie:
        cell[0, 30:330] = 5
        f[0, 30:330, 0] = 7.0
        cell[0, 330:] = np.where(cell[0, 330:] == 5, 6, cell[0, 330:])
    cell[-1] = cells
    bits = _bits(f)
    g = _bits(rng.standard_normal((b, cells, d)).astype(np.float32))
    return bits, cell, g


def _f32(bits):
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _t(bits):
    return torch.from_numpy(bits.astype(np.int16)).view(torch.bfloat16)


# (B, N, D, cells, the batch the widths are planned for, or a width): c4's
# act and learn shapes and c3's with a small B; D 40 as planned (slices of
# 8) and in one slice of 40 (5 lanes: the last thread of a block idle).
PARTITION = [(3, 64, 64, 256, 1024), (3, 64, 64, 256, 128),
             (2, 1024, 64, 1024, 64), (3, 64, 40, 256, 128),
             (3, 64, 40, 256, "40")]


@pytest.mark.parametrize("b,n,d,cells,batch", PARTITION)
def test_every_piece_written_once_and_every_point_read_once(b, n, d, cells,
                                                             batch):
    """At the widths the wrapper plans for the main path's batch."""
    if isinstance(batch, str):
        width = bwidth = int(batch)
    else:
        width = tscatter.bf16_plan(batch, n, d, cells)
        bwidth = tscatter.bf16_plan(batch, n, d, cells, bwd=True)
    assert width in tscatter.bf16_widths(d)
    bits, cell, g = _inputs(b + n + d, b, n, d, cells)
    out, log = _run(bits, cell, cells, width, seed=1)
    assert log.aligned
    assert (log.n["copies"] == 1).all()     # each feature read once
    assert (log.n["out"] == 1).all()        # each output element once
    # Each in-range point's features read once, by its cell's walk.
    real = ((cell >= 0) & (cell < cells))[:, :, None].repeat(d, 2).ravel()
    assert (log.n["smem_reads"] == real).all()
    gf, blog = _run(bits, cell, cells, bwidth, seed=2, g_bits=g,
                    out_bits=out)
    assert blog.aligned and (blog.n["copies"] == 1).all()
    assert (blog.n["gf"] == 1).all()        # each gradient element once
    assert (blog.n["smem_reads"] == real).all()
    # `out` and `g` gathered once by each in-range point's pieces: only at
    # reached cells.
    touched = np.zeros((b, cells, d), np.int64)
    for e in range(b):
        ok = (cell[e] >= 0) & (cell[e] < cells)
        np.add.at(touched[e], cell[e][ok], 1)
    assert (blog.n["gather_out"] == touched.ravel()).all()
    assert (blog.n["gather_g"] == touched.ravel()).all()


def _jax_bits(bits, cell, g, cells):
    """JAX's forward on the widened features and its vjp (the bits of the
    JAX pillar net: XLA's f32 share rounded to bf16)."""
    x = jnp.asarray(_f32(bits)).astype(jnp.bfloat16)

    def fwd(x):
        return jax.vmap(lambda f, c: jscatter.scatter_max_reference(
            f.astype(jnp.float32), c, cells))(x, jnp.asarray(cell))

    out, vjp = jax.vjp(fwd, x)
    (gx,) = vjp(jnp.asarray(_f32(g)))
    return (np.asarray(out, np.float32),
            np.asarray(gx.astype(jnp.float32), np.float32))


def _same(got_bits, want_f32):
    """Bit for bit, but for the sign of a zero (a max of +0 and -0 is +0
    here, either elsewhere)."""
    got = _f32(got_bits)
    np.testing.assert_array_equal(got, want_f32)
    nz = want_f32 != 0
    assert np.array_equal(got_bits[nz], _bits(want_f32)[nz])


# (B, N, D, cells, big tie): D 64 and D 40 at c4's N and cells, and a tie
# of 300 points in one cell.
ARITH = [(4, 64, 64, 256, False), (4, 64, 40, 256, False),
         (3, 400, 16, 64, True)]


@pytest.mark.parametrize("b,n,d,cells,big", ARITH)
def test_kernels_are_bit_equal_to_jax_and_the_plain_versions(b, n, d, cells,
                                                             big):
    bits, cell, g = _inputs(7 * b + d, b, n, d, cells, big_tie=big)
    out, _ = _run(bits, cell, cells, tscatter.bf16_plan(b, n, d, cells),
                  seed=3)
    gf, _ = _run(bits, cell, cells,
                 tscatter.bf16_plan(b, n, d, cells, bwd=True), seed=4,
                 g_bits=g, out_bits=out)
    want_out, want_gf = _jax_bits(bits, cell, g, cells)
    _same(out, want_out)
    _same(gf, want_gf)
    # The plain versions the card holds the kernels to.
    ref = tscatter.scatter_max_reference(_t(bits), torch.from_numpy(cell),
                                         cells)
    _same(out, ref.float().numpy())
    ref_g = tscatter.scatter_max_backward_reference(
        _t(bits), torch.from_numpy(cell), ref, _t(g), cells)
    _same(gf, ref_g.float().numpy())
    # The cases are there: ties shared, the all-negative cell's negative
    # max passed back, the all-trash env zero.
    assert (_f32(gf)[0, 10:13] == _f32(gf)[0, 10]).all()
    assert (_f32(out)[-1] == 0).all() and (_f32(gf)[-1] == 0).all()
    if b > 2:
        assert (_f32(out)[1, 7] < 0).all()
        assert (np.abs(_f32(gf)[1, 20:23]).sum(0) > 0).all()
    if big:
        share = _f32(gf)[0, 30:330, 0]
        assert (share == share[0]).all() and share[0] != 0
        assert share[0] == _f32(_share_bits(
            _f32(g)[0, 5, :1], np.array([300], np.uint32)))[0]


# --- the wrapper ------------------------------------------------------------

class _Lib:
    """Stands in for the built library: records which entry ran."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.mark.parametrize("dtype,d,kernel,entry", [
    (torch.bfloat16, 64, None, "bf16"),
    (torch.bfloat16, 40, None, "bf16"),
    (torch.bfloat16, 30, None, "old"),
    (torch.bfloat16, 7, None, "old"),
    (torch.bfloat16, 64, "atomics", "old"),
    (torch.float32, 64, None, "old")])
def test_route_by_dtype_and_dim(dtype, d, kernel, entry):
    lib = _Lib()
    feats = torch.zeros(4, 64, d, dtype=dtype)
    cell = torch.zeros(4, 64, dtype=torch.int32)
    out = torch.zeros(4, 256, d, dtype=dtype)
    counts = ("launches_bf16", "launches_bwd_bf16") if dtype == \
        torch.bfloat16 else ("launches", "launches_bwd")
    before = [getattr(tscatter, c) for c in counts]
    with mock.patch.object(tscatter._build, "load", lambda *a: lib), \
            mock.patch.object(tscatter._build, "stream_ptr", lambda d: None):
        tscatter._scatter_max_cuda(feats, cell, 256, kernel=kernel)
        tscatter._scatter_max_bwd_cuda(feats, cell, out, out, 256,
                                       kernel=kernel)
    names = [c[0] for c in lib.calls]
    if entry == "bf16":
        assert names == ["scatter_max_bf16_launch",
                         "scatter_max_bwd_bf16_launch"]
        assert lib.calls[0][1][7] == tscatter.bf16_plan(4, 64, d, 256)
    else:
        assert names == ["scatter_max_launch", "scatter_max_bwd_launch"]
        assert lib.calls[0][1][-2] == int(dtype == torch.bfloat16)
    assert [getattr(tscatter, c) for c in counts] == [x + 1 for x in before]


def test_refusals():
    bf = torch.bfloat16
    lib = _Lib()
    with mock.patch.object(tscatter._build, "load", lambda *a: lib):
        with pytest.raises(ValueError, match="D a multiple of 8"):
            tscatter._scatter_max_cuda(torch.zeros(2, 8, 30, dtype=bf),
                                       torch.zeros(2, 8, dtype=torch.int32),
                                       16, kernel="lists")
        with pytest.raises(ValueError, match="D a multiple of 8"):
            tscatter._scatter_max_cuda(torch.zeros(2, 8, 64),
                                       torch.zeros(2, 8, dtype=torch.int32),
                                       16, kernel="lists")
        with pytest.raises(ValueError, match="no scatter_max kernel"):
            tscatter._scatter_max_cuda(torch.zeros(2, 8, 64, dtype=bf),
                                       torch.zeros(2, 8, dtype=torch.int32),
                                       16, kernel="grid")
        with pytest.raises(ValueError, match="slice width 12"):
            tscatter._scatter_max_cuda(torch.zeros(2, 8, 64, dtype=bf),
                                       torch.zeros(2, 8, dtype=torch.int32),
                                       16, width=12)
        n = tscatter.BF16_MAX_POINTS + 1
        feats = torch.zeros(1, n, 8, dtype=bf)
        cell = torch.zeros(1, n, dtype=torch.int32)
        g = torch.zeros(1, 4, 8, dtype=bf)
        with pytest.raises(ValueError, match="at most 65535"):
            tscatter._scatter_max_bwd_cuda(feats, cell, g, g, 4)
        with pytest.raises(ValueError, match="at most 65535"):
            tscatter._scatter_max_cuda(feats, cell, 4)
    assert lib.calls == []


def test_plan_at_main_path_shapes():
    plan = tscatter.bf16_plan
    assert plan(1024, 64, 64, 256) == 64      # c4 act, fog + V2X ego
    assert plan(1024, 32, 64, 256) == 64      # the RSU's 32 rays
    assert plan(512, 64, 64, 256) == 64       # c5 loss minibatch
    assert plan(128, 64, 64, 256) == 32       # c4 learn
    assert plan(64, 1024, 64, 1024) == 16     # c3
    assert plan(64, 1024, 64, 1024, bwd=True) == 16
    # Forward: the slice, the cells, the list heads and links.
    assert tscatter.bf16_smem_bytes(64, 64, 256) == (
        64 * 128 + 64 * 4 + 256 * 4 + 64 * 4)
    # Backward: the slices of the features and of `g`, the cells, the hit
    # bytes, 16-bit tie counts.
    assert tscatter.bf16_smem_bytes(1024, 16, 1024, bwd=True) == (
        2 * 1024 * 32 + 1024 * 4 + 1024 * 2 + 1024 * 16 * 2)
    # 512 threads where the grid has fewer blocks than two an SM and a block
    # 1024 pieces or more (c3; the c4 learn forward), else 256.
    threads = tscatter.bf16_threads
    assert threads(64, 1024, 64, 1024, 16) == 512
    assert threads(64, 1024, 64, 1024, 16, bwd=True) == 512
    assert threads(1024, 64, 64, 256, 64) == 256
    assert threads(128, 64, 64, 256, 32) == 512
    assert threads(128, 64, 64, 256, 32, bwd=True) == 256
    assert threads(512, 64, 64, 256, 64, bwd=True) == 256
    assert tscatter.bf16_widths(64) == [64, 32, 16, 8]
    assert tscatter.bf16_widths(40) == [40, 8]
    with pytest.raises(ValueError, match="not one they take"):
        plan(2, 20000, 64, 256)
