"""Ring and Ulysses attention: sequence-parallel attention over the mesh.

Counterpart of ``multimodal_sc_tpu/kernels/ring_attention.py``. Each
process holds its block of the sequence (dim 2 of ``(B, H, L, D)``,
``shard_sequence``). ``ring_attention`` keeps its queries and passes the
K/V blocks around the ring of the data group (``batch_isend_irecv`` to
the next rank, from the previous), merging each block's flash accumulator
``(acc, max, denominator)``; after ``n`` steps every query block has seen
every key block. ``ulysses_attention`` instead moves to a head-sharded
layout with one ``all_to_all_single`` (H/n heads of the whole sequence),
attends locally and moves back.

The collectives carry no gradient of their own: each is an
``autograd.Function`` whose backward sends the gradient the other way (the
ring's backward rotates the K/V gradients backwards, an all-to-all's
backward is the inverse all-to-all), so both functions differentiate as
the JAX package's do under ``jax.grad``. A ring of one rank sends nothing.
The block products are plain PyTorch, as they are plain XLA einsums in the
JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from multimodal_sc_torch.runtime.mesh import Mesh, shard_batch

_NEG = -1e30


def _block_attention_stats(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, scale: float):
    """Partial attention of q against one K/V block.

    q: (B,H,Lq,D), k/v: (B,H,Lb,D). Returns (acc, m, l): un-normalized
    output sum, per-row running max, per-row denominator — the flash
    accumulator triple.
    """
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)                           # (B,H,Lq,1)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = p.to(v.dtype).float() @ v.float()
    return acc, m, l


def _merge(carry, update):
    """Combine two flash accumulators (acc, m, l) -> one."""
    acc0, m0, l0 = carry
    acc1, m1, l1 = update
    m = torch.maximum(m0, m1)
    a0 = torch.exp(m0 - m)
    a1 = torch.exp(m1 - m)
    return acc0 * a0 + acc1 * a1, m, l0 * a0 + l1 * a1


def _ring_ranks(mesh: Mesh):
    """(group, next rank, previous rank) of this process in the data ring,
    as global ranks."""
    ranks, i = mesh.data_ranks, mesh.data_index
    n = len(ranks)
    return mesh.data_group, ranks[(i + 1) % n], ranks[(i - 1) % n]


def _send_recv(x: torch.Tensor, to: int, frm: int, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, to, group),
           dist.P2POp(dist.irecv, out, frm, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Rotate(torch.autograd.Function):
    """One step around the ring: send to the next rank, receive from the
    previous; the gradient goes the other way."""

    @staticmethod
    def forward(ctx, x, mesh):
        group, nxt, prv = _ring_ranks(mesh)
        ctx.args = (prv, nxt, group)
        return _send_recv(x, nxt, prv, group)

    @staticmethod
    def backward(ctx, g):
        return _send_recv(g, *ctx.args), None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Mesh, scale: Optional[float] = None) -> torch.Tensor:
    """Sequence-parallel attention: q/k/v are this process's blocks of the
    sequence (dim 2, ``shard_sequence``) over the data group. Returns this
    block's (B, H, L/n, D) output."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n = mesh.data
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full(q.shape[:-1] + (1,), _NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros(q.shape[:-1] + (1,), dtype=torch.float32,
                    device=q.device)
    k_blk, v_blk = k, v
    for i in range(n):
        upd = _block_attention_stats(q, k_blk, v_blk, scale)
        acc, m, l = _merge((acc, m, l), upd)
        if i + 1 < n:
            # Rotate K/V to the next neighbor around the ring (the last
            # rotation, which JAX makes and discards, is skipped).
            k_blk = _Rotate.apply(k_blk, mesh)
            v_blk = _Rotate.apply(v_blk, mesh)
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def _all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int,
                mesh: Mesh) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)`` over the data group: split
    ``split_axis`` into n chunks, chunk j to rank j, the received chunks
    joined along ``concat_axis`` in rank order."""
    n = mesh.data
    chunks = x.movedim(split_axis, 0)
    chunks = chunks.reshape(n, chunks.shape[0] // n, *chunks.shape[1:])
    send = chunks.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.data_group)
    # recv[j] is rank j's chunk for this rank: join them along concat_axis.
    recv = recv.movedim(1, split_axis + 1)        # (n, ...x with split)
    parts = list(recv.unbind(0))
    return torch.cat(parts, dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_axis, concat_axis, mesh):
        ctx.args = (concat_axis, split_axis, mesh)
        return _all_to_all(x, split_axis, concat_axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g.contiguous(), *ctx.args), None, None, None


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh: Mesh,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Ulysses-style SP: all-to-all reshard sequence->heads, attend locally.

    With q/k/v sequence-sharded on dim 2, one all-to-all moves to the
    head-sharded layout where each process holds H/n full-sequence heads,
    runs ordinary attention, and a second all-to-all reshards back.
    Requires H divisible by the axis size.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n = mesh.data
    if q.shape[1] % n != 0:
        raise ValueError(f"heads {q.shape[1]} not divisible by axis size {n}")

    def to_heads(x):
        return x if n == 1 else _AllToAll.apply(x, 1, 2, mesh)

    def to_seq(x):
        return x if n == 1 else _AllToAll.apply(x, 2, 1, mesh)

    qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)
    s = (qh.float() @ kh.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    o = (p.to(vh.dtype).float() @ vh.float()).to(q.dtype)
    return to_seq(o)


def shard_sequence(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This process's block of the sequence (dim 2) of a (B, H, L, D)
    tensor."""
    return shard_batch(mesh, x.transpose(0, 2)).transpose(0, 2)
