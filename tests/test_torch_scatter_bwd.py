"""The scatter-max gradient and the shape of its kernels, on the CPU.

The CUDA kernels of ``csrc/pillar_scatter.cu`` run only on the card, where
``chip_smoke.py`` holds them against their plain versions. Here:

* the backward's plain version against ``jax.grad`` of the JAX package's
  ``scatter_max_reference`` (XLA's ``segment_max`` gradient) and against
  torch autograd of the port's plain forward, with ties, trash points, an
  empty cell, an all-negative cell and an env with no point in range;
* the kernels' float max through integer atomics, in any order;
* their block and thread index map, at the main path's shapes and at
  widths that do not divide D;
* ``slice_plan``, and the ``autograd.Function`` wired to the kernels'
  entries (on CPU tensors, with the plain versions standing in).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sc_torch.kernels import pillar_scatter as tscatter
from multimodal_sc_tpu.kernels import pillar_scatter as jscatter

# (B, N, D, cells)
SMALL = [(4, 64, 16, 16), (4, 48, 8, 12), (2, 37, 12, 9)]


def _inputs(seed, b, n, d, cells):
    """Points with every case the gradient has to get right: env 0 has trash
    points, three duplicated rows that are their cell's max (a tie in every
    feature) and two rows that tie in their first features only; env 1 an
    empty cell; env 2 (if any) an all-negative cell; the last env only
    trash points."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, n, d)).astype(np.float32)
    cell = rng.integers(0, cells + 1, (b, n)).astype(np.int32)
    cell[0, :6] = cells
    cell[0, 10:13] = 2
    feats[0, 10:13] = 4.0 + rng.random(d).astype(np.float32)
    cell[0, 20:22] = 3
    feats[0, 20:22] = 5.0 + rng.random((2, d)).astype(np.float32)
    feats[0, 21, :d // 2] = feats[0, 20, :d // 2]
    cell[1] = np.where(cell[1] == 4, 5, cell[1])
    if b > 3:
        cell[2, :3] = 7
        cell[2, 3:] = np.where(cell[2, 3:] == 7, 8, cell[2, 3:])
        feats[2, :3] = -np.abs(feats[2, :3]) - 0.5
    cell[-1] = cells
    g = rng.standard_normal((b, cells, d)).astype(np.float32)
    return feats, cell, g


def _port_backward(feats, cell, g, cells):
    f, c = torch.from_numpy(feats), torch.from_numpy(cell)
    out = tscatter.scatter_max_reference(f, c, cells)
    return tscatter.scatter_max_backward_reference(
        f, c, out, torch.from_numpy(g), cells).numpy()


@pytest.mark.parametrize("b,n,d,cells", SMALL)
def test_backward_reference_matches_jax_grad(b, n, d, cells):
    feats, cell, g = _inputs(b * n + d, b, n, d, cells)

    def loss(x):
        out = jax.vmap(lambda f, c: jscatter.scatter_max_reference(
            f, c, cells))(x, jnp.asarray(cell))
        return jnp.sum(out * jnp.asarray(g))

    want = np.asarray(jax.grad(loss)(jnp.asarray(feats)))
    got = _port_backward(feats, cell, g, cells)
    # XLA multiplies the cell's gradient by 1/count, the port divides by
    # count (as torch autograd does): the two round differently when the
    # count is not a power of two, by at most one unit in the last place.
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    # Ties split evenly: three tied rows get a third each, the partial tie
    # half in its tied features and all of it in the rest.
    np.testing.assert_array_max_ulp(got[0, 10:13], np.broadcast_to(
        g[0, 2] / np.float32(3), (3, d)), maxulp=1)
    half = d // 2
    np.testing.assert_array_equal(got[0, 20:22, :half],
                                  np.broadcast_to(g[0, 3, :half] / 2, (2, half)))
    # In the other features one of the two rows is the max and gets it all.
    np.testing.assert_array_equal(got[0, 20:22, half:].sum(0), g[0, 3, half:])
    assert ((got[0, 20:22, half:] == 0).sum(0) == 1).all()
    assert (got[0, :6] == 0).all() and (got[-1] == 0).all()
    if b > 3:   # the all-negative cell passes its gradient to its maxima
        hit = feats[2, :3] == feats[2, :3].max(axis=0)
        np.testing.assert_array_equal(got[2, :3][hit], np.broadcast_to(
            g[2, 7], (3, d))[hit])


@pytest.mark.parametrize("b,n,d,cells", SMALL)
def test_backward_reference_matches_torch_autograd(b, n, d, cells):
    feats, cell, g = _inputs(7 * b + n, b, n, d, cells)
    f = torch.from_numpy(feats).requires_grad_(True)
    out = tscatter.scatter_max(f, torch.from_numpy(cell), cells)
    (want,) = torch.autograd.grad(out, f, torch.from_numpy(g))
    got = _port_backward(feats, cell, g, cells)
    # Both divide the cell's gradient by the same count: bit for bit.
    np.testing.assert_array_equal(got, want.numpy())


def test_cpu_path_launches_nothing():
    feats, cell, g = _inputs(3, *SMALL[0])
    before = (tscatter.launches, tscatter.launches_bwd)
    f = torch.from_numpy(feats).requires_grad_(True)
    out = tscatter.scatter_max(f, torch.from_numpy(cell), SMALL[0][3])
    out.backward(torch.from_numpy(g))
    assert (tscatter.launches, tscatter.launches_bwd) == before
    assert f.grad is not None


def test_function_backward_runs_the_backward_entry():
    """``_ScatterMax`` saves the forward's result and hands it, with the
    incoming gradient, to the backward kernel's entry; the plain forward is
    not what its backward runs. On CPU tensors, with the plain versions
    standing in for the two CUDA entries."""
    b, n, d, cells = SMALL[0]
    feats, cell, g = _inputs(5, b, n, d, cells)
    f, c = torch.from_numpy(feats), torch.from_numpy(cell)
    fwd = tscatter.scatter_max_reference(f, c, cells)
    calls = []

    def bwd(feats_, cell_, out_, g_, cells_):
        calls.append(out_)
        return tscatter.scatter_max_backward_reference(feats_, cell_, out_,
                                                       g_, cells_)

    def no_plain(*args):
        raise AssertionError("the backward ran the plain forward")

    x = f.clone().requires_grad_(True)
    with mock.patch.object(tscatter, "_scatter_max_cuda",
                           lambda *a: fwd.clone()), \
            mock.patch.object(tscatter, "_scatter_max_bwd_cuda", bwd):
        out = tscatter._ScatterMax.apply(x, c, cells)
        with mock.patch.object(tscatter, "scatter_max_reference", no_plain):
            (got,) = torch.autograd.grad(out, x, torch.from_numpy(g))
    assert len(calls) == 1 and torch.equal(calls[0], fwd)
    y = f.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(tscatter.scatter_max_reference(y, c, cells),
                                  y, torch.from_numpy(g))
    torch.testing.assert_close(got, want, atol=0, rtol=0)


# --- the float max through integer atomics --------------------------------

def _atomic_max_bits(word, v):
    """One ``smem_max``: atomicMax on the int view for v >= 0, atomicMin on
    the unsigned view for v < 0, both on the same 32 bits."""
    vb = np.float32(v).view(np.uint32)
    if np.float32(v).view(np.int32) >= 0:
        return np.uint32(max(np.int32(word.view(np.int32)),
                             np.float32(v).view(np.int32))).view(np.uint32)
    return np.uint32(min(word, vb))


@pytest.mark.parametrize("seed", range(4))
def test_integer_atomic_max_is_order_free(seed):
    rng = np.random.default_rng(seed)
    vals = np.concatenate([rng.standard_normal(40).astype(np.float32) * 10,
                           np.float32([0.0, -0.0, 1e-38, -1e-38, 3e38,
                                       -3e38])])
    sentinel = np.float32(-1e30).view(np.uint32)
    for _ in range(5):
        word = sentinel
        for v in rng.permutation(vals):
            word = _atomic_max_bits(word, v)
        assert word.view(np.float32) == vals.max()
    # All negative: the negative max, the sentinel only when nothing lands.
    word = sentinel
    for v in rng.permutation(-np.abs(vals) - 1):
        word = _atomic_max_bits(word, v)
    assert word.view(np.float32) == (-np.abs(vals) - 1).max()


# --- the kernels' index map ------------------------------------------------

def _slot(thread, dim, width, vec, s):
    """``slot`` of csrc/pillar_scatter.cu for slice ``s`` (any env)."""
    f0 = s * width
    w = min(width, dim - f0)
    lanes = width // vec
    rows = tscatter.THREADS // lanes
    lane, row = thread % lanes, thread // lanes
    active = (row < rows) & (lane * vec < w)
    return f0, w, lanes, rows, lane, row, active


def _grid_writes(dim, cells, width, vec):
    """How often each (cell, feature) of one env's output is written by the
    env's blocks (the kernel's last loop), and whether every vector store is
    aligned to its width."""
    n_slices = -(-dim // width)
    hits = torch.zeros(cells * dim, dtype=torch.int64)
    aligned = True
    for s in range(n_slices):
        f0, w, lanes, _, _, _, _ = _slot(torch.zeros(1, dtype=torch.long),
                                         dim, width, vec, s)
        i = torch.arange(cells * lanes)
        c, ff = i // lanes, (i % lanes) * vec
        keep = ff < w
        c, ff = c[keep], ff[keep]
        base = c * dim + f0 + ff
        aligned &= bool((base % vec == 0).all())
        for k in range(vec):
            hits += torch.bincount(base + k, minlength=cells * dim)
    return hits, aligned


def _point_reads(n_points, dim, width, vec):
    """How often each (point, feature) of one env is read by the env's
    blocks in one pass over the points (every thread's strided loop)."""
    n_slices = -(-dim // width)
    reads = torch.zeros(n_points * dim, dtype=torch.int64)
    t = torch.arange(tscatter.THREADS)
    for s in range(n_slices):
        f0, w, lanes, rows, lane, row, active = _slot(t, dim, width, vec, s)
        row, lane = row[active], lane[active]
        p = row[:, None] + rows * torch.arange(-(-n_points // rows))[None, :]
        keep = p < n_points
        base = (p * dim + f0 + (lane * vec)[:, None])[keep]
        for k in range(vec):
            reads += torch.bincount(base + k, minlength=n_points * dim)
    return reads


# Main-path shapes (B, N, D, cells): c4 act, c4 learn, c3; then widths that
# do not divide D (a last slice narrower than the others) and D that is not
# a multiple of 4.
PLANNED = [(1024, 64, 64, 256), (128, 64, 64, 256), (64, 1024, 64, 1024)]
FORCED = [(8, 37, 20, 16, 16, 4), (8, 37, 7, 9, 4, 1), (8, 50, 7, 9, 8, 1),
          (8, 33, 64, 1024, 24, 4)]


@pytest.mark.parametrize("b,n,d,cells,width,vec", [
    (b, n, d, cells, *tscatter.slice_plan(b, d, cells))
    for b, n, d, cells in PLANNED] + FORCED)
def test_every_output_written_once_and_every_point_read_once(
        b, n, d, cells, width, vec):
    n_slices = -(-d // width)
    # Blocks -> (env, slice): each pair exactly once.
    blk = torch.arange(b * n_slices)
    pairs = (blk // n_slices) * n_slices + blk % n_slices
    assert torch.equal(torch.sort(pairs).values, blk)
    assert cells * width * 4 <= tscatter.SMEM_BYTES
    hits, aligned = _grid_writes(d, cells, width, vec)
    assert aligned and bool((hits == 1).all())
    reads = _point_reads(n, d, width, vec)
    assert bool((reads == 1).all())


def test_slice_plan_at_main_path_shapes():
    # c4 act and learn: 16 features of the 256-cell grid (16 KB) a block;
    # c3: 8 features of the 1024-cell grid (32 KB), 512 blocks at B 64.
    assert tscatter.slice_plan(1024, 64, 256) == (16, 4)
    assert tscatter.slice_plan(128, 64, 256) == (16, 4)
    assert tscatter.slice_plan(64, 64, 1024) == (8, 4)
    # Few envs: slices as narrow as the float4 rows, for the block count.
    assert tscatter.slice_plan(8, 64, 256) == (4, 4)
    assert tscatter.slice_plan(4096, 7, 16)[1] == 1
    # A grid whose 4-feature slice does not fit reads one feature at a time;
    # one that does not fit even so is refused.
    assert tscatter.slice_plan(2, 64, 20000)[1] == 1
    with pytest.raises(ValueError, match="does not fit in shared memory"):
        tscatter.slice_plan(2, 64, 60000)
    with pytest.raises(ValueError, match="slice width"):
        tscatter._check_width(6, 4, 256)
