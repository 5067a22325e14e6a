"""Pillar scatter: per-point features -> BEV grid by max pooling.

Counterpart of ``multimodal_sc_tpu/kernels/pillar_scatter.py``. The JAX
package vmapped a per-env scatter over the batch; here the batch dimension
is written out, so one call (one kernel launch) serves every env.

Points routed to the trash cell ``num_cells`` (masked or out of range, see
``codec/lidar_bev.py:voxelize``) are dropped; empty cells come out 0; a
cell whose points are all negative keeps its negative max.

``scatter_max`` launches the CUDA kernel (``csrc/pillar_scatter.cu``) on a
CUDA tensor and runs ``scatter_max_reference`` on a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from multimodal_sc_torch.kernels import _build

_NEG = -1e30

# Launches of the CUDA kernel (one per scatter_max call on the card).
launches = 0

_SIG = {"scatter_max_launch": (ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_void_p)}


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


def _scatter_max_cuda(feats: torch.Tensor, cell_idx: torch.Tensor,
                      num_cells: int) -> torch.Tensor:
    global launches
    if feats.dtype != torch.float32 or cell_idx.dtype != torch.int32:
        raise TypeError("scatter_max kernel takes float32 feats and int32 "
                        f"cells, got {feats.dtype} / {cell_idx.dtype}")
    if feats.dim() != 3 or cell_idx.shape != feats.shape[:2]:
        raise ValueError(f"feats (B, N, D) and cell_idx (B, N) expected, got "
                         f"{tuple(feats.shape)} / {tuple(cell_idx.shape)}")
    if cell_idx.device != feats.device:
        raise ValueError("feats and cell_idx must be on one device")
    feats = feats.contiguous()
    cell_idx = cell_idx.contiguous()
    b, n, d = feats.shape
    out = torch.empty((b, num_cells, d), dtype=feats.dtype,
                      device=feats.device)
    lib = _build.load("pillar_scatter", _SIG)
    err = lib.scatter_max_launch(
        _build.ptr(feats), _build.ptr(cell_idx), _build.ptr(out), b, n, d,
        num_cells, _build.stream_ptr(feats.device))
    _build.check(err, "scatter_max")
    launches += 1
    return out


class _ScatterMax(torch.autograd.Function):
    """Kernel forward; the backward recomputes through the plain version."""

    @staticmethod
    def forward(ctx, feats, cell_idx, num_cells):
        ctx.save_for_backward(feats, cell_idx)
        ctx.num_cells = num_cells
        return _scatter_max_cuda(feats, cell_idx, num_cells)

    @staticmethod
    def backward(ctx, g):
        feats, cell_idx = ctx.saved_tensors
        with torch.enable_grad():
            f = feats.detach().requires_grad_(True)
            y = scatter_max_reference(f, cell_idx, ctx.num_cells)
            (gf,) = torch.autograd.grad(y, f, g)
        return gf, None, None


def scatter_max(feats: torch.Tensor, cell_idx: torch.Tensor,
                num_cells: int) -> torch.Tensor:
    """Batched scatter-max; the kernel on the card, the plain version on the CPU."""
    if feats.is_cuda:
        return _ScatterMax.apply(feats, cell_idx, num_cells)
    return scatter_max_reference(feats, cell_idx, num_cells)
