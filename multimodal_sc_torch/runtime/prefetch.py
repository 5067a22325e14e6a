"""Host-to-device input prefetching (double buffering).

Counterpart of ``multimodal_sc_tpu/runtime/prefetch.py``: batch N+1 is
copied to the device while batch N trains. A host batch (a tensor, or a
tuple or list of them) is pinned and copied with ``non_blocking=True``, so
the copy runs on the stream while the host goes on; a batch already on the
device (the synthetic generators make theirs there) passes through. With
a ``mesh`` each process keeps its rows of every batch, as the JAX
package's ``shard_batch`` places them.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator

import torch

from multimodal_sc_torch.runtime.mesh import shard_batch


def _put(batch, device: torch.device):
    if isinstance(batch, (tuple, list)):
        return type(batch)(_put(b, device) for b in batch)
    if batch.device.type == device.type and device.index in (
            None, batch.device.index):
        return batch
    if device.type == "cuda" and not batch.is_pinned():
        batch = batch.pin_memory()
    return batch.to(device, non_blocking=True)


def prefetch_to_device(iterator: Iterable, size: int = 2,
                       device="cuda", mesh=None) -> Iterator:
    """Yield the batches of ``iterator`` on ``device``, keeping ``size``
    copies in flight; given a ``mesh`` (``runtime/mesh.py``), this
    process's rows of each (the leading axis split over ``data``)."""
    device = torch.device(device)

    def put(batch):
        if mesh is not None:
            batch = shard_batch(mesh, batch)
        return _put(batch, device)

    queue = collections.deque()
    it = iter(iterator)
    try:
        for _ in range(size):
            queue.append(put(next(it)))
    except StopIteration:
        pass
    while queue:
        out = queue.popleft()
        try:
            queue.append(put(next(it)))
        except StopIteration:
            pass
        yield out
