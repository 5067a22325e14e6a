"""On-device circular replay buffer.

Counterpart of ``multimodal_sc_tpu/rl/replay.py``: a struct of
preallocated tensors with a write cursor. Unlike the JAX package's
functional updates, ``add_batch`` writes the rows IN PLACE into the stores
(no second copy of a buffer of hundreds of MB) and returns the buffer with
the advanced cursor. Cursor and size are Python ints: they depend only on
how many rows were added, so keeping them on the host costs no device sync.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch


def quantize_frame(img: torch.Tensor) -> torch.Tensor:
    """uint8-quantize a [0,1] frame for storage (identity for uint8)."""
    if img.dtype == torch.uint8:
        return img
    return torch.round(torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)


def dequantize_frame(img: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_frame` (identity for float frames)."""
    if img.dtype == torch.uint8:
        return img.float() * (1.0 / 255.0)
    return img


class ReplayBuffer(NamedTuple):
    data: Any          # NamedTuple of stores, each (capacity, ...)
    cursor: int        # next write slot
    size: int          # number of valid entries
    capacity: int


def create(example: Any, capacity: int, device) -> ReplayBuffer:
    """Allocate from one example transition (NamedTuple, no batch dim)."""
    data = type(example)(*(
        torch.zeros((capacity,) + tuple(torch.as_tensor(x).shape),
                    dtype=torch.as_tensor(x).dtype, device=device)
        for x in example))
    return ReplayBuffer(data=data, cursor=0, size=0, capacity=capacity)


def add_batch(buf: ReplayBuffer, transitions: Any) -> ReplayBuffer:
    """Write a batch (leading dim B) at the cursor, wrapping around."""
    b = transitions[0].shape[0]
    if b > buf.capacity:
        # Duplicate slots would leave the surviving write undefined and
        # size would over-count.
        raise ValueError(
            f"add_batch of {b} transitions exceeds capacity {buf.capacity}")
    dev = buf.data[0].device
    idx = (buf.cursor + torch.arange(b, device=dev)) % buf.capacity
    for store, x in zip(buf.data, transitions):
        store[idx] = x.to(store.dtype)
    return buf._replace(cursor=(buf.cursor + b) % buf.capacity,
                        size=min(buf.size + b, buf.capacity))


def sample(buf: ReplayBuffer, generator: Optional[torch.Generator],
           batch_size: int, indices: Optional[torch.Tensor] = None) -> Any:
    """Uniform draw with replacement over the valid prefix.

    ``indices`` (optional, (batch_size,) integer rows) takes the place of
    the draw from ``generator``, as the env's draws can be handed in."""
    if indices is None:
        indices = torch.randint(0, max(buf.size, 1), (batch_size,),
                                generator=generator,
                                device=buf.data[0].device)
    indices = indices.long()
    return type(buf.data)(*(store[indices] for store in buf.data))
