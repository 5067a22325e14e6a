"""Host-to-device input prefetching (double buffering).

Counterpart of ``multimodal_sc_tpu/runtime/prefetch.py``: batch N+1 is
copied to the device while batch N trains. A host batch (a tensor, or a
tuple or list of them) is pinned and copied with ``non_blocking=True``, so
the copy runs on the stream while the host goes on; a batch already on the
device (the synthetic generators make theirs there) passes through.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator

import torch


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
                       device="cuda") -> Iterator:
    """Yield the batches of ``iterator`` on ``device``, keeping ``size``
    copies in flight."""
    device = torch.device(device)
    queue = collections.deque()
    it = iter(iterator)
    try:
        for _ in range(size):
            queue.append(_put(next(it), device))
    except StopIteration:
        pass
    while queue:
        out = queue.popleft()
        try:
            queue.append(_put(next(it), device))
        except StopIteration:
            pass
        yield out
