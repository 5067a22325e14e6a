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
``launches_bwd_bf16``). The forward is exact in either dtype. The JAX
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

_C = (ctypes.c_int,) * 7 + (ctypes.c_void_p,)
_SIG = {"scatter_max_launch": (ctypes.c_void_p,) * 3 + _C,
        "scatter_max_bwd_launch": (ctypes.c_void_p,) * 5 + _C}


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
                      num_cells: int, width=None) -> torch.Tensor:
    """The forward kernel; ``width`` overrides ``slice_plan``'s slice."""
    global launches, launches_bf16
    _check(feats, cell_idx)
    b, n, d = feats.shape
    out = torch.empty((b, num_cells, d), dtype=feats.dtype,
                      device=feats.device)
    if out.numel() == 0:
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
                          width=None) -> torch.Tensor:
    """The backward kernel: ``scatter_max_backward_reference`` on the card."""
    global launches_bwd, launches_bwd_bf16
    _check(feats, cell_idx)
    b, n, d = feats.shape
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
