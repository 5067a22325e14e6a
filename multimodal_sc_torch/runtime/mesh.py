"""The process mesh: data and model axes over ``torch.distributed``.

Counterpart of ``multimodal_sc_tpu/runtime/mesh.py``. One process drives
one card; the processes of a job (``torchrun``, or ``init_distributed``
given an address) form a ``(data, model)`` grid, laid out row-major as the
JAX package's ``grid.reshape(data, model)``: the ranks that share a data
index form one model group, the ranks that share a model index one data
group. ``data`` carries the batch (envs, replay shards, rows of a global
batch) and the one gradient mean; ``model`` the tensor parallelism of the
transformer blocks (``runtime/tp.py``).

The process group's backend follows the device: ``nccl`` for ``cuda``,
``gloo`` for ``cpu``; another is used only where a caller names it. A job
of one process needs no process group: its mesh is ``1 x 1`` and every
collective here is skipped, so the single-card path runs unchanged.
"""

from __future__ import annotations

import atexit
import datetime
import os
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.utils._pytree import tree_map

DATA_AXIS = "data"
MODEL_AXIS = "model"


def backend_for(device) -> str:
    """The process group backend of ``device``: nccl on the card, gloo on
    the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(device="cuda") -> int:
    """Join the job's process group; returns the world size.

    The job is read from ``torchrun``'s environment (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``); a job of one process
    joins nothing. On the card each process takes the card of its
    ``LOCAL_RANK``. A failed rendezvous raises."""
    if dist.is_initialized():
        return dist.get_world_size()
    world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return 1
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend=backend_for(dev), init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=600))
    # The group is the process's: left at its exit, as NCCL asks.
    atexit.register(dist.destroy_process_group)
    return world_size


@dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` grid of processes, as seen from one of them.

    ``shape`` maps each axis name to its size, as JAX's ``Mesh.shape``;
    ``data_index`` / ``model_index`` are this process's coordinates;
    ``data_group`` / ``model_group`` its process groups along each axis
    (None where the axis has one rank: nothing is sent), ``data_ranks``
    the global ranks of its data group in data-index order."""

    shape: dict
    axis_names: Tuple[str, str]
    rank: int
    data_index: int
    model_index: int
    data_group: Any = None
    model_group: Any = None
    data_ranks: Tuple[int, ...] = (0,)

    @property
    def data(self) -> int:
        return self.shape[self.axis_names[0]]

    @property
    def model(self) -> int:
        return self.shape[self.axis_names[1]]

    @property
    def size(self) -> int:
        return self.data * self.model


def make_mesh(data: int = -1, model: int = 1,
              axis_names: Sequence[str] = (DATA_AXIS, MODEL_AXIS)) -> Mesh:
    """Build a (data, model) mesh over the job's processes; data=-1 means
    'all remaining processes'. Every process of the job must call it (the
    groups are made collectively)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if model < 1:
        model = 1
    if data == -1:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data*model} devices, have {n}")
    if rank >= data * model:
        raise ValueError(f"process {rank} lies outside the {data}x{model} "
                         "mesh: run as many processes as the mesh holds")
    names = tuple(axis_names)
    d_idx, m_idx = divmod(rank, model)
    data_ranks = tuple(i * model + m_idx for i in range(data))
    data_group = model_group = None
    if n > 1:
        # new_group is collective: every process makes every group, in the
        # same order, and keeps its own.
        for j in range(model):
            g = dist.new_group([i * model + j for i in range(data)])
            if j == m_idx:
                data_group = g
        for i in range(data):
            g = dist.new_group([i * model + j for j in range(model)])
            if i == d_idx:
                model_group = g
    return Mesh(shape={names[0]: data, names[1]: model}, axis_names=names,
                rank=rank, data_index=d_idx, model_index=m_idx,
                data_group=data_group if data > 1 else None,
                model_group=model_group if model > 1 else None,
                data_ranks=data_ranks)


def shard_seed(seed: int, data_index: int) -> int:
    """The generator seed of data shard ``data_index``: ``seed`` itself
    for the first, so a world of one draws as a single process does."""
    return (seed + data_index * 0x9E3779B1) % (1 << 63)


def mesh_from_config(mesh_cfg) -> Mesh:
    """``make_mesh`` at a ``MeshConfig``'s axes."""
    return make_mesh(data=mesh_cfg.data_axis, model=mesh_cfg.model_axis,
                     axis_names=mesh_cfg.axis_names)


def batch_sharding(mesh: Mesh, ndim: int) -> Tuple[Optional[str], ...]:
    """The layout ``shard_batch`` gives an ``ndim``-axis tensor, as the
    JAX package's ``PartitionSpec``: the leading axis over ``data``, the
    rest whole."""
    return (mesh.axis_names[0],) + (None,) * (ndim - 1)


def replicated(mesh: Mesh) -> Tuple[Optional[str], ...]:
    """The layout ``replicate`` gives a tensor: whole on every process."""
    return ()


def local_batch_size(mesh: Mesh, global_batch: int) -> int:
    n = mesh.shape[mesh.axis_names[0]]
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by data={n}")
    return global_batch // n


def _local_rows(mesh: Mesh, x):
    if not isinstance(x, torch.Tensor) or x.dim() == 0:
        return x
    b = local_batch_size(mesh, x.shape[0])
    return x[mesh.data_index * b:(mesh.data_index + 1) * b]


def shard_batch(mesh: Mesh, tree):
    """This process's rows of the leading (batch) axis of every tensor of
    ``tree`` (nested tuples, lists, dicts, named tuples); scalars pass."""
    if mesh.data == 1:
        return tree
    return tree_map(lambda x: _local_rows(mesh, x), tree)


def _tensors(tree):
    if isinstance(tree, nn.Module):
        return list(tree.state_dict(keep_vars=True).values())
    if isinstance(tree, torch.optim.Optimizer):
        # The moments; Adam's step count is a host scalar, the same on
        # every process by construction.
        return [v for s in tree.state.values() for v in s.values()
                if isinstance(v, torch.Tensor) and v.dim() > 0]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return []


@torch.no_grad()
def replicate(mesh: Mesh, tree):
    """Make ``tree`` (modules, optimizers, tensors and containers of them)
    the same on every process of the mesh: each tensor is broadcast IN
    PLACE from the mesh's first rank. Returns ``tree``."""
    if mesh.size == 1:
        return tree
    for t in _tensors(tree):
        dist.broadcast(t.data if isinstance(t, nn.Parameter) else t, src=0)
    return tree


def all_reduce_mean_(tensors: Sequence[torch.Tensor], mesh: Mesh,
                     extra: Optional[Sequence[torch.Tensor]] = None):
    """Mean ``tensors`` IN PLACE over the data group: one flattened bucket
    summed, then divided by the group's size (the JAX package's ``pmean``).
    ``extra`` scalars ride the same bucket; their means are returned."""
    extra = list(extra or ())
    if mesh.data == 1:
        return extra
    flat = torch.cat([t.reshape(-1).float() if t.dtype != torch.float32
                      else t.reshape(-1) for t in tensors]
                     + [e.reshape(1).float() for e in extra])
    dist.all_reduce(flat, group=mesh.data_group)
    flat /= mesh.data
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n
    return [flat[off + i] for i in range(len(extra))]


class _MeanOverData(torch.autograd.Function):
    """The mean over the data group forward; identity backward. Inside a
    loss whose gradients are then meaned over the group, a term of this
    global mean gets the global batch's gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        y = x.detach().clone()
        dist.all_reduce(y, group=mesh.data_group)
        return y / mesh.data

    @staticmethod
    def backward(ctx, g):
        return g, None


def mean_over_data(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``x`` meaned over the data group (identity on one rank); see
    ``_MeanOverData`` for its gradient."""
    if not data_parallel(mesh):
        return x
    return _MeanOverData.apply(x, mesh)


def data_parallel(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` splits a batch: a data axis of more than one rank."""
    return mesh is not None and mesh.data > 1


def from_first_shard(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` as the data group's first rank holds it (a copy broadcast from
    there; ``x`` itself on a data axis of one rank): draws that must be the
    same on every shard, such as a re-seeding coin."""
    if mesh.data == 1:
        return x
    x = x.contiguous().clone()
    dist.broadcast(x, src=mesh.data_ranks[0], group=mesh.data_group)
    return x


def all_gather_rows(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """The data group's ``x`` joined along ``dim`` in data-index order (the
    inverse of ``shard_batch`` along that axis)."""
    if mesh.data == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.data)]
    dist.all_gather(parts, x.contiguous(), group=mesh.data_group)
    return torch.cat(parts, dim=dim)
