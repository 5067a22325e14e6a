"""Tensor parallelism over the mesh's ``model`` axis.

Counterpart of ``multimodal_sc_tpu/runtime/tp.py``. The JAX package names
a ``PartitionSpec`` for each parameter from its flax path and lets GSPMD
insert the collectives. Here the same rule (``_spec_for``) reads each port
parameter's flax path (``bridge.flax_leaf``, the inverse of the bridge's
name map), and ``apply_tp`` keeps this model rank's slice of every
model-sharded weight and puts the collectives in by hand, Megatron-style:

* a column-parallel layer (q/k/v, an MLP's up projection) keeps its rows
  of the output features; its input passes ``copy_to_model`` (identity
  forward, all-reduce of the gradient backward);
* a row-parallel layer (the out-projection, an MLP's down projection)
  keeps its columns of the input features and its partial products pass
  ``reduce_from_model`` (all-reduce forward, identity backward), its bias
  added once after.

Where only elementwise work sits between the two (an MLP's GELU, the
attention of each head) the activations stay split; an attention module
then runs on its H/m local heads, and ``packed_eligible`` judges the
local shape: at c4 / c5 widths (dm 128, 4 heads) model 2 leaves dm 64,
not whole 128-lane groups, so the flash kernels run there. Elsewhere
(the pillar net's LayerNorm between ``fc1`` and ``fc2``) the column
layer's output is gathered and the row layer reads its slice.
Biases are replicated, as the JAX rule has them: a column layer reads its
slice of the bias through ``copy_to_model``, so every model rank gets the
whole bias gradient.

The fused blocks' packed ``wq`` ... ``wo`` match no rule: they stay
replicated and ``mha_block`` runs whole on every model rank.

A checkpoint holds the single-card layout, as orbax writes the JAX
package's global arrays: ``whole_state_dict`` and ``whole_optimizer_state``
gather each model-sharded tensor (a parameter, its EMA, its Adam moments)
along the dimension it was sliced on. A run restores into the whole
network before ``apply_tp`` keeps its slice, so a checkpoint restores at
any model-axis size, and on one card.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from multimodal_sc_torch.runtime.mesh import MODEL_AXIS, Mesh

Spec = Tuple[Optional[str], ...]


def _spec_for(path: str, ndim: int) -> Spec:
    """PartitionSpec (as a tuple) for one param, keyed by its flax path.

    Megatron-style pairing: column-parallel into the block (QKV / MLP up),
    row-parallel out of it (attention output / MLP down), so each
    transformer block needs exactly one reduction.
    """
    if path.endswith("/bias") or ndim < 2:
        return ()
    # Attention projections (DenseGeneral): q/k/v kernels (in, heads, hd)
    # shard heads; output kernel (heads, hd, out) shards heads (row-par).
    if any(f"/{n}/kernel" in path for n in ("q", "k", "v")) and ndim == 3:
        return (None, MODEL_AXIS, None)
    if "/o/kernel" in path and ndim == 3:
        return (MODEL_AXIS, None, None)
    # Transformer MLP: up column-parallel, down row-parallel.
    if any(s in path for s in ("mlp1/kernel", "cam_mlp1/kernel",
                               "lid_mlp1/kernel", "fc1/kernel")):
        return (None, MODEL_AXIS)
    if any(s in path for s in ("mlp2/kernel", "cam_mlp2/kernel",
                               "lid_mlp2/kernel", "fc2/kernel")):
        return (MODEL_AXIS, None)
    return ()


def tp_param_shardings(module: nn.Module) -> Dict[str, Spec]:
    """The JAX package's spec of each parameter of ``module`` (before
    ``apply_tp``), by port parameter name."""
    from multimodal_sc_torch.bridge import flax_leaf

    return {name: _spec_for(*flax_leaf(module, name))
            for name, _ in module.named_parameters()}


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward over the model group; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather_last(x: torch.Tensor, group, m: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(m)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


class _GatherFromModel(torch.autograd.Function):
    """The model ranks' slices of the last axis joined; the gradient's own
    slice back."""

    @staticmethod
    def forward(ctx, x, group, m, j):
        ctx.n, ctx.j = x.shape[-1], j
        return _gather_last(x, group, m)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.j * ctx.n:(ctx.j + 1) * ctx.n].contiguous(), \
            None, None, None


class _SplitToModel(torch.autograd.Function):
    """This model rank's slice of the last axis; the gradient gathered."""

    @staticmethod
    def forward(ctx, x, group, m, j):
        ctx.group, ctx.m = group, m
        n = x.shape[-1] // m
        return x[..., j * n:(j + 1) * n].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g, ctx.group, ctx.m), None, None, None


def _linear(x, w, b, dtype):
    """``act_dtype.Dense``'s arithmetic on given weights."""
    if dtype == torch.float32:
        return F.linear(x, w, b)
    y = F.linear(x.to(dtype), w.to(dtype))
    return y if b is None else y + b.to(dtype)


def _slice_(p: nn.Parameter, dim: int, sl: slice, group,
            optimizer: Optional[torch.optim.Optimizer]) -> None:
    """Keep ``p``'s slice along ``dim`` IN PLACE (the same Parameter, so
    an optimizer's references hold), and its Adam moments' with it; the
    parameter records the model group its slices span (``tp_group``) and
    the dimension (``tp_dim``: the torch layout's axis of the sharded one
    in ``tp_param_shardings``' spec)."""
    idx = (slice(None),) * dim + (sl,)
    state = optimizer.state.get(p, {}) if optimizer is not None else {}
    for k, v in state.items():
        if isinstance(v, torch.Tensor) and v.shape == p.shape:
            state[k] = v[idx].clone()
    p.data = p.data[idx].clone()
    p.tp_group, p.tp_dim = group, dim


def gather_whole(t: torch.Tensor, p: nn.Parameter) -> torch.Tensor:
    """``t`` (``p`` itself, or a tensor of its shape such as an Adam
    moment) whole: the model ranks' slices joined in rank order along the
    dimension ``p`` was sliced on; ``t`` as it is for a replicated
    parameter. Every rank of the model group calls it."""
    group = getattr(p, "tp_group", None)
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.detach().contiguous(), group=group)
    return torch.cat(parts, dim=p.tp_dim)


def whole_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` in the single-card layout: each
    model-sharded parameter gathered whole (``gather_whole``)."""
    params = dict(module.named_parameters())
    return {k: gather_whole(v, params[k]) if k in params else v
            for k, v in module.state_dict().items()}


def whole_optimizer_state(optimizer: torch.optim.Optimizer) -> dict:
    """``optimizer.state_dict()`` in the single-card layout: the moments
    of each model-sharded parameter gathered whole; the live state is
    left as it is."""
    sd = optimizer.state_dict()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    state = {i: {k: (gather_whole(v, params[i])
                     if isinstance(v, torch.Tensor)
                     and v.shape == params[i].shape else v)
                 for k, v in st.items()}
             for i, st in sd["state"].items()}
    return {**sd, "state": state}


def global_norm(norms, params) -> torch.Tensor:
    """The L2 norm of a whole network's gradients from each tensor's norm
    (``norms``, one per entry of ``params``): the sliced ones' squares
    summed over their model group, the replicated ones' counted once."""
    sliced = [n for n, p in zip(norms, params)
              if getattr(p, "tp_group", None) is not None]
    whole = [n for n, p in zip(norms, params)
             if getattr(p, "tp_group", None) is None]
    group = next(p.tp_group for p in params
                 if getattr(p, "tp_group", None) is not None)
    sq = torch.stack(sliced).square().sum()
    dist.all_reduce(sq, group=group)
    if whole:
        sq = sq + torch.stack(whole).square().sum()
    return sq.sqrt()


class ColumnParallelDense(nn.Module):
    """A ``Dense`` keeping this model rank's rows of its output features;
    with ``gather_output`` the ranks' outputs are joined."""

    def __init__(self, dense: nn.Linear, mesh: Mesh, gather_output: bool,
                 optimizer=None):
        super().__init__()
        m, j = mesh.model, mesh.model_index
        n = dense.out_features // m
        self.sl = slice(j * n, (j + 1) * n)
        self.group, self.m, self.j = mesh.model_group, m, j
        self.gather_output = gather_output
        self.act_dtype = getattr(dense, "act_dtype", torch.float32)
        _slice_(dense.weight, 0, self.sl, mesh.model_group, optimizer)
        self.weight, self.bias = dense.weight, dense.bias

    def forward(self, x):
        x = _CopyToModel.apply(x, self.group)
        b = _CopyToModel.apply(self.bias, self.group)[self.sl]
        y = _linear(x, self.weight, b, self.act_dtype)
        if self.gather_output:
            y = _GatherFromModel.apply(y, self.group, self.m, self.j)
        return y


class RowParallelDense(nn.Module):
    """A ``Dense`` keeping this model rank's columns of its input features;
    the partial products are summed over the model group, the bias added
    once. Without ``input_is_parallel`` it reads its slice of a whole
    input."""

    def __init__(self, dense: nn.Linear, mesh: Mesh, input_is_parallel: bool,
                 optimizer=None):
        super().__init__()
        m, j = mesh.model, mesh.model_index
        n = dense.in_features // m
        self.group, self.m, self.j = mesh.model_group, m, j
        self.input_is_parallel = input_is_parallel
        self.act_dtype = getattr(dense, "act_dtype", torch.float32)
        _slice_(dense.weight, 1, slice(j * n, (j + 1) * n),
                mesh.model_group, optimizer)
        self.weight, self.bias = dense.weight, dense.bias

    def forward(self, x):
        if not self.input_is_parallel:
            x = _SplitToModel.apply(x, self.group, self.m, self.j)
        y = _linear(x, self.weight, None, self.act_dtype)
        y = _ReduceFromModel.apply(y, self.group)
        return y + (self.bias if self.act_dtype == torch.float32
                    else self.bias.to(self.act_dtype))


def _paired_parents():
    """Module types whose column/row pairs hold only elementwise work
    between them: their activations stay split."""
    from multimodal_sc_torch.codec.camera_vit import MHA, TransformerBlock
    from multimodal_sc_torch.fusion.transformer import (FusionLayer,
                                                        FusionTransformer)

    return (MHA, TransformerBlock, FusionLayer, FusionTransformer)


def apply_tp(module: nn.Module, mesh: Mesh,
             optimizer: Optional[torch.optim.Optimizer] = None) -> nn.Module:
    """Keep this model rank's slice of ``module``'s model-sharded weights
    IN PLACE (and of ``optimizer``'s moments for them), wrapping each
    sharded ``Dense`` as a column- or row-parallel layer. Returns
    ``module``, which records the mesh as ``tp_mesh``. A no-op on a model
    axis of one rank."""
    if mesh.model == 1 or getattr(module, "tp_mesh", None) is not None:
        return module
    from multimodal_sc_torch.codec.camera_vit import MHA

    m = mesh.model
    specs = tp_param_shardings(module)
    paired = _paired_parents()
    for name, sub in list(module.named_modules()):
        if isinstance(sub, MHA) and specs.get(f"{name}.q.weight" if name
                                              else "q.weight"):
            if sub.heads % m:
                raise ValueError(f"{name}: heads {sub.heads} not divisible "
                                 f"by model={m}")
            sub.heads //= m
            sub.dim //= m
    for name, sub in list(module.named_modules()):
        if not isinstance(sub, nn.Linear):
            continue
        spec = specs.get(f"{name}.weight")
        if not spec:
            continue
        parent_name, _, attr = name.rpartition(".")
        parent = (module.get_submodule(parent_name) if parent_name
                  else module)
        split = isinstance(parent, paired)
        if spec[0] is None:          # flax (in, out): out sharded
            if sub.out_features % m:
                raise ValueError(f"{name}: {sub.out_features} features not "
                                 f"divisible by model={m}")
            new = ColumnParallelDense(sub, mesh, not split, optimizer)
        else:
            if sub.in_features % m:
                raise ValueError(f"{name}: {sub.in_features} features not "
                                 f"divisible by model={m}")
            new = RowParallelDense(sub, mesh, split, optimizer)
        setattr(parent, attr, new)
    module.tp_mesh = mesh
    return module

