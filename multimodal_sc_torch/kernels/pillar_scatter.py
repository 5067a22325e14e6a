"""Pillar scatter: per-point features -> BEV grid by max pooling.

Counterpart of ``multimodal_sc_tpu/kernels/pillar_scatter.py``. The JAX
package vmapped a per-env scatter over the batch; here the batch dimension
is written out, so one call is one kernel launch for every env.

Points routed to the trash cell ``num_cells`` (masked or out of range, see
``codec/lidar_bev.py:voxelize``) are dropped; empty cells come out 0; a
cell whose points are all negative keeps its negative max.

The gradient is ``segment_max``'s, as XLA differentiates it in the JAX
package: a cell's gradient splits evenly among the points that tie at its
max, per feature; trash points get 0 (``scatter_max_backward_reference``).

``scatter_max`` launches the CUDA kernels (``csrc/pillar_scatter.cu``) on a
CUDA tensor: one forward launch per call, one backward launch per gradient.
On a CPU tensor it runs ``scatter_max_reference`` under autograd.

Under ``train.bf16`` the features are bf16 and the kernels read and write
bf16 themselves (their own counts, ``launches_bf16`` and
``launches_bwd_bf16``). Where D is a multiple of 8 (every bf16 path's D
64) they are the kernels of ``csrc/scatter_bf16.cuh`` (``lists_route``;
``bf16_plan`` picks their feature slice); for other D the f32 kernels'
instances on bf16 rows. The forward is exact in either dtype. The JAX
package's pillar net widens its bf16 features to f32 before the scatter,
so a tied max's gradient in bf16 is XLA's f32 share rounded to bf16,
``bf16(g * (1 / count))``, the product and the reciprocal in f32; in f32
it is ``g / count`` (torch autograd's), within one unit in the last place
of XLA's ``g * (1 / count)``.
"""

from __future__ import annotations

import ctypes

import torch

from multimodal_sc_torch.kernels import _build

_NEG = -1e30

# Shared memory one block may hold on an H100 (227 KB); the grid slice a
# block prefers to hold (32 KB: seven blocks of 256 threads share a
# multiprocessor) and its widest slice; the block count below which the
# card's 132 multiprocessors are not each given two blocks. Chosen from the
# widths' times at the main path's shapes (``chip_smoke.py`` prints them).
SMEM_BYTES = 232448
SLICE_BYTES = 32 * 1024
MAX_WIDTH = 16
MIN_BLOCKS = 2 * 132
THREADS = 256       # csrc/pillar_scatter.cu kThreads

# Launches of the CUDA kernels: one per scatter_max call on the card, one
# per backward; f32 and bf16 features apart.
launches = 0
launches_bwd = 0
launches_bf16 = 0
launches_bwd_bf16 = 0

# The bf16 kernels of csrc/scatter_bf16.cuh (kernel "lists") and the f32
# kernels' bf16 instances (kernel "atomics"). A block of the former takes an
# env and a slice of features; the slice it prefers leaves two blocks room
# on a multiprocessor (BF16_SLICE_BYTES of shared memory each) and the card
# at least BF16_MIN_ITEMS blocks. Chosen from the widths' times at the main
# path's shapes (``chip_smoke.py`` prints them).
KERNELS = ("lists", "atomics")
BF16_SLICE_BYTES = 113 * 1024
BF16_MIN_ITEMS = 132
BF16_FEW_BLOCKS = 2 * 132     # below it, 512-thread blocks (bf16_threads)
BF16_MAX_POINTS = 65535       # the backward's tie counts are 16 bits

_C = (ctypes.c_int,) * 7 + (ctypes.c_void_p,)
_C_BF16 = (ctypes.c_int,) * 6 + (ctypes.c_void_p,)
_SIG = {"scatter_max_launch": (ctypes.c_void_p,) * 3 + _C,
        "scatter_max_bwd_launch": (ctypes.c_void_p,) * 5 + _C,
        "scatter_max_bf16_launch": (ctypes.c_void_p,) * 3 + _C_BF16,
        "scatter_max_bwd_bf16_launch": (ctypes.c_void_p,) * 5 + _C_BF16}


def scatter_max_reference(feats: torch.Tensor, cell_idx: torch.Tensor,
                          num_cells: int) -> torch.Tensor:
    """feats (B, N, D), cell_idx (B, N) int in [0, num_cells] -> (B, num_cells, D)."""
    b, n, d = feats.shape
    out = torch.full((b, num_cells + 1, d), float("-inf"), dtype=feats.dtype,
                     device=feats.device)
    idx = cell_idx.long().unsqueeze(-1).expand(b, n, d)
    out = out.scatter_reduce(1, idx, feats, reduce="amax", include_self=True)
    out = out[:, :num_cells]
    return torch.where(torch.isfinite(out) & (out > _NEG / 2), out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def scatter_max_backward_reference(feats: torch.Tensor, cell_idx: torch.Tensor,
                                   out: torch.Tensor, g: torch.Tensor,
                                   num_cells: int) -> torch.Tensor:
    """The gradient of ``scatter_max`` with respect to ``feats`` (B, N, D).

    ``out`` is the forward's result and ``g`` the gradient arriving at it,
    both (B, num_cells, D). A point in a real cell whose feature equals the
    cell's max gets ``g / count``, ``count`` the points of that cell equal to
    the max in that feature; every other entry is 0."""
    b, n, d = feats.shape
    pad = torch.zeros((b, 1, d), dtype=out.dtype, device=out.device)
    idx = cell_idx.long().unsqueeze(-1).expand(b, n, d)
    real = ((cell_idx >= 0) & (cell_idx < num_cells)).unsqueeze(-1)
    hit = real & (feats == torch.cat([out, pad], 1).gather(1, idx))
    # Counts in f32 (exact integers; a bf16 count would round past 256).
    count = torch.zeros((b, num_cells + 1, d), dtype=torch.float32,
                        device=feats.device).scatter_add_(1, idx, hit.float())
    g = torch.cat([g, pad], 1)
    if feats.dtype == torch.bfloat16:
        # XLA's f32 share, rounded to bf16.
        share = (g.float() * (1.0 / count)).bfloat16()
    else:
        share = g / count.to(feats.dtype)
    return torch.where(hit, share.gather(1, idx),
                       torch.zeros((), dtype=feats.dtype, device=feats.device))


def slice_plan(batch: int, dim: int, num_cells: int) -> tuple:
    """``(width, vec)`` of the kernels' blocks: one block per env and slice
    of ``width`` features, holding ``num_cells * width`` 4-byte words in
    shared memory; rows read as ``vec`` floats (4 where D allows).

    The widest power-of-two slice up to ``MAX_WIDTH`` (or D) whose grid
    slice takes at most ``SLICE_BYTES`` and that gives the card at least
    ``MIN_BLOCKS`` blocks, else the narrowest (``vec``). Raises when not even
    a slice of ``vec`` features fits in shared memory."""
    vec = 4 if dim % 4 == 0 and num_cells * 16 <= SMEM_BYTES else 1
    if num_cells * vec * 4 > SMEM_BYTES:
        raise ValueError(
            f"scatter_max: a grid of {num_cells} cells does not fit in shared "
            f"memory even one feature at a time ({num_cells * 4} bytes, at "
            f"most {SMEM_BYTES})")
    width = vec
    while width < min(dim, MAX_WIDTH):
        width *= 2
    while width > vec and (num_cells * width * 4 > SLICE_BYTES
                           or batch * -(-dim // width) < MIN_BLOCKS):
        width //= 2
    return width, vec


def _check_width(width: int, vec: int, num_cells: int) -> None:
    if (width % vec or not vec <= width <= THREADS * vec
            or num_cells * width * 4 > SMEM_BYTES):
        raise ValueError(f"scatter_max: slice width {width} (vec {vec}) for "
                         f"{num_cells} cells is not one the kernels take")


def lists_route(feats: torch.Tensor) -> bool:
    """Whether a call on the card runs the kernels of
    ``csrc/scatter_bf16.cuh``: bf16 features whose D is a multiple of 8
    (rows of whole 16-byte pieces)."""
    return feats.dtype == torch.bfloat16 and feats.shape[-1] % 8 == 0


def bf16_smem_bytes(n_points: int, width: int, num_cells: int,
                    bwd: bool = False) -> int:
    """Shared memory of a block of the bf16 kernels: the env's feature slice
    and cells, and the forward's list heads and links or the backward's
    slice of ``g`` at each point's cell, tie counts (two 16-bit counts a
    word) and hit masks (a byte a 16-byte piece)."""
    if bwd:
        return (n_points * (4 * width + 4 + width // 8)
                + 2 * width * num_cells)
    return n_points * (2 * width + 8) + 4 * num_cells


def bf16_widths(dim: int) -> list:
    """The feature slices the bf16 kernels are planned with, widest first:
    D halved while it stays a multiple of 8, and 8."""
    out, w = [], dim
    while w % 8 == 0 and w >= 8:
        out.append(w)
        w //= 2
    return out if out[-1] == 8 else out + [8]


def bf16_plan(batch: int, n_points: int, dim: int, num_cells: int,
              bwd: bool = False) -> int:
    """The feature slice of a bf16 kernel's blocks (the forward's, or with
    ``bwd`` the backward's): the widest of ``bf16_widths`` whose block takes
    at most ``BF16_SLICE_BYTES`` and that gives at least ``BF16_MIN_ITEMS``
    blocks, else the narrowest. Raises when not even that fits in shared
    memory."""
    widths = bf16_widths(dim)
    for w in widths:
        if (bf16_smem_bytes(n_points, w, num_cells, bwd) <= BF16_SLICE_BYTES
                and batch * -(-dim // w) >= BF16_MIN_ITEMS):
            return w
    _check_lists(n_points, dim, num_cells, widths[-1], bwd)
    return widths[-1]


def bf16_threads(batch: int, n_points: int, dim: int, num_cells: int,
                 width: int, bwd: bool = False) -> int:
    """Threads of a bf16 kernel's block: 512 where the grid has fewer than
    ``BF16_FEW_BLOCKS`` blocks and a block at least 1024 16-byte pieces to
    take (the forward's cells, the backward's points, times width / 8),
    else 256."""
    pieces = (n_points if bwd else num_cells) * (width // 8)
    blocks = batch * -(-dim // width)
    return 512 if blocks < BF16_FEW_BLOCKS and pieces >= 1024 else 256


def _check_lists(n_points: int, dim: int, num_cells: int, width: int,
                 bwd: bool = False) -> None:
    if n_points > BF16_MAX_POINTS:
        raise ValueError(
            f"scatter_max bf16 kernels: {n_points} points an env, at most "
            f"{BF16_MAX_POINTS} (the backward counts ties in 16 bits)")
    smem = bf16_smem_bytes(n_points, width, num_cells, bwd)
    if (dim % 8 or width % 8 or not 8 <= width <= dim
            or smem > SMEM_BYTES):
        raise ValueError(
            f"scatter_max bf16 kernels: slice width {width} of D {dim} for "
            f"{n_points} points and {num_cells} cells is not one they take "
            f"(multiples of 8, {smem} bytes of shared memory, at most "
            f"{SMEM_BYTES})")


def _lists(feats: torch.Tensor, kernel) -> bool:
    """Whether ``kernel`` (None: ``lists_route``) names the bf16 kernels;
    raises on a name it does not know or on features "lists" does not
    take."""
    if kernel is None:
        return lists_route(feats)
    if kernel not in KERNELS:
        raise ValueError(f"no scatter_max kernel {kernel!r}; {KERNELS}")
    if kernel == "lists" and not lists_route(feats):
        raise ValueError("the scatter_max bf16 kernels take bf16 features "
                         "with D a multiple of 8, got "
                         f"{feats.dtype} D {feats.shape[-1]}")
    return kernel == "lists"


def _check(feats, cell_idx):
    if (feats.dtype not in (torch.float32, torch.bfloat16)
            or cell_idx.dtype != torch.int32):
        raise TypeError("scatter_max kernel takes float32 or bfloat16 feats "
                        f"and int32 cells, got {feats.dtype} / "
                        f"{cell_idx.dtype}")
    if feats.dim() != 3 or cell_idx.shape != feats.shape[:2]:
        raise ValueError(f"feats (B, N, D) and cell_idx (B, N) expected, got "
                         f"{tuple(feats.shape)} / {tuple(cell_idx.shape)}")
    if cell_idx.device != feats.device:
        raise ValueError("feats and cell_idx must be on one device")


def _scatter_max_cuda(feats: torch.Tensor, cell_idx: torch.Tensor,
                      num_cells: int, width=None, kernel=None) -> torch.Tensor:
    """The forward kernel. ``kernel`` names the bf16 kernels ("lists") or
    the f32 kernel's instance ("atomics", bf16 features of any D too); by
    default ``lists_route`` picks. ``width`` overrides the slice of
    ``bf16_plan`` or ``slice_plan``."""
    global launches, launches_bf16
    _check(feats, cell_idx)
    b, n, d = feats.shape
    lists = _lists(feats, kernel)
    if lists:
        width = bf16_plan(b, n, d, num_cells) if width is None else width
        _check_lists(n, d, num_cells, width)
    out = torch.empty((b, num_cells, d), dtype=feats.dtype,
                      device=feats.device)
    if out.numel() == 0:
        return out
    if lists:
        feats = _build.aligned(feats)
        cell_idx = cell_idx.contiguous()
        lib = _build.load("pillar_scatter", _SIG)
        err = lib.scatter_max_bf16_launch(
            _build.ptr(feats), _build.ptr(cell_idx), _build.ptr(out), b, n,
            d, num_cells, width, bf16_threads(b, n, d, num_cells, width),
            _build.stream_ptr(feats.device))
        _build.check(err, "scatter_max")
        launches_bf16 += 1
        return out
    plan_width, vec = slice_plan(b, d, num_cells)
    width = plan_width if width is None else width
    _check_width(width, vec, num_cells)
    feats = _build.aligned(feats)
    cell_idx = cell_idx.contiguous()
    lib = _build.load("pillar_scatter", _SIG)
    bf16 = feats.dtype == torch.bfloat16
    err = lib.scatter_max_launch(
        _build.ptr(feats), _build.ptr(cell_idx), _build.ptr(out), b, n, d,
        num_cells, width, vec, int(bf16), _build.stream_ptr(feats.device))
    _build.check(err, "scatter_max")
    if bf16:
        launches_bf16 += 1
    else:
        launches += 1
    return out


def _scatter_max_bwd_cuda(feats: torch.Tensor, cell_idx: torch.Tensor,
                          out: torch.Tensor, g: torch.Tensor, num_cells: int,
                          width=None, kernel=None) -> torch.Tensor:
    """The backward kernel: ``scatter_max_backward_reference`` on the card.
    ``kernel`` and ``width`` as ``_scatter_max_cuda``'s."""
    global launches_bwd, launches_bwd_bf16
    _check(feats, cell_idx)
    b, n, d = feats.shape
    lists = _lists(feats, kernel)
    if lists:
        width = (bf16_plan(b, n, d, num_cells, bwd=True) if width is None
                 else width)
        _check_lists(n, d, num_cells, width, bwd=True)
    for name, t in (("out", out), ("g", g)):
        if t.shape != (b, num_cells, d) or t.dtype != feats.dtype \
                or t.device != feats.device:
            raise ValueError(f"scatter_max backward: {name} must be "
                             f"{feats.dtype} {(b, num_cells, d)} on "
                             f"{feats.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    gf = torch.empty((b, n, d), dtype=feats.dtype, device=feats.device)
    if gf.numel() == 0:
        return gf
    if lists:
        feats, out, g = (_build.aligned(t) for t in (feats, out, g))
        cell_idx = cell_idx.contiguous()
        lib = _build.load("pillar_scatter", _SIG)
        err = lib.scatter_max_bwd_bf16_launch(
            _build.ptr(feats), _build.ptr(cell_idx), _build.ptr(out),
            _build.ptr(g), _build.ptr(gf), b, n, d, num_cells, width,
            bf16_threads(b, n, d, num_cells, width, bwd=True),
            _build.stream_ptr(feats.device))
        _build.check(err, "scatter_max backward")
        launches_bwd_bf16 += 1
        return gf
    plan_width, vec = slice_plan(b, d, num_cells)
    width = plan_width if width is None else width
    _check_width(width, vec, num_cells)
    feats, out, g = (_build.aligned(t) for t in (feats, out, g))
    cell_idx = cell_idx.contiguous()
    lib = _build.load("pillar_scatter", _SIG)
    bf16 = feats.dtype == torch.bfloat16
    err = lib.scatter_max_bwd_launch(
        _build.ptr(feats), _build.ptr(cell_idx), _build.ptr(out),
        _build.ptr(g), _build.ptr(gf), b, n, d, num_cells, width, vec,
        int(bf16), _build.stream_ptr(feats.device))
    _build.check(err, "scatter_max backward")
    if bf16:
        launches_bwd_bf16 += 1
    else:
        launches_bwd += 1
    return gf


class _ScatterMax(torch.autograd.Function):
    """Kernel forward, kernel backward; or (``plain``) the plain versions of
    both, which is how bf16 features on the CPU get the kernel's gradient
    (torch autograd of ``scatter_reduce`` divides in bf16)."""

    @staticmethod
    def forward(ctx, feats, cell_idx, num_cells, plain=False):
        fwd = scatter_max_reference if plain else _scatter_max_cuda
        out = fwd(feats, cell_idx, num_cells)
        ctx.save_for_backward(feats, cell_idx, out)
        ctx.num_cells, ctx.plain = num_cells, plain
        return out

    @staticmethod
    def backward(ctx, g):
        feats, cell_idx, out = ctx.saved_tensors
        bwd = (scatter_max_backward_reference if ctx.plain
               else _scatter_max_bwd_cuda)
        gf = bwd(feats, cell_idx, out, g, ctx.num_cells)
        return gf, None, None, None


def scatter_max(feats: torch.Tensor, cell_idx: torch.Tensor,
                num_cells: int) -> torch.Tensor:
    """Batched scatter-max; the kernels on the card, the plain version on the CPU."""
    if feats.is_cuda:
        return _ScatterMax.apply(feats, cell_idx, num_cells)
    return scatter_max_plain(feats, cell_idx, num_cells)


def scatter_max_plain(feats: torch.Tensor, cell_idx: torch.Tensor,
                      num_cells: int) -> torch.Tensor:
    """What ``scatter_max`` runs on a CPU tensor: the plain version, whose
    gradient on bf16 features is ``scatter_max_backward_reference``'s, as
    the kernel's."""
    if (feats.dtype == torch.bfloat16 and torch.is_grad_enabled()
            and feats.requires_grad):
        return _ScatterMax.apply(feats, cell_idx, num_cells, True)
    return scatter_max_reference(feats, cell_idx, num_cells)
