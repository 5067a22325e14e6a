"""On-device n-step return window for DQN.

Counterpart of ``multimodal_sc_tpu/rl/nstep.py``. A ring of the last ``n``
per-env (obs, action, reward, done) entries; each push writes the newest
and emits the n-step transition anchored at the oldest:

    R = sum_{k<n} gamma^k r_k * prod_{j<k} (1 - done_j)

Stores are written IN PLACE (the JAX package returned new arrays). Cursor
and fill are Python ints: they count pushes, so no device sync is needed.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch


class NStepWindow(NamedTuple):
    entries: Dict[str, torch.Tensor]   # leaves (n, B, ...)
    reward: torch.Tensor               # (n, B)
    done: torch.Tensor                 # (n, B) bool
    cursor: int                        # next write slot
    fill: int                          # valid entries (saturates at n)


def create(example_entry: Dict[str, torch.Tensor], n: int,
           batch: int) -> NStepWindow:
    """example_entry: dict of batched tensors (B, ...)."""
    dev = next(iter(example_entry.values())).device
    entries = {k: torch.zeros((n,) + tuple(x.shape), dtype=x.dtype,
                              device=x.device)
               for k, x in example_entry.items()}
    return NStepWindow(
        entries=entries,
        reward=torch.zeros((n, batch), dtype=torch.float32, device=dev),
        done=torch.zeros((n, batch), dtype=torch.bool, device=dev),
        cursor=0, fill=0)


def push(win: NStepWindow, entry: Dict[str, torch.Tensor],
         reward: torch.Tensor, done: torch.Tensor, gamma: float
         ) -> Tuple[NStepWindow, Dict[str, torch.Tensor], torch.Tensor,
                    torch.Tensor, bool]:
    """Push the newest entry; emit the oldest-anchored n-step transition.

    Returns (win', oldest_entry, R, done_any, valid): ``valid`` is False
    until the window is full. ``oldest_entry`` are copies, so the next
    push may overwrite the slot.
    """
    n = win.reward.shape[0]
    c = win.cursor
    for k, x in entry.items():
        win.entries[k][c] = x.to(win.entries[k].dtype)
    win.reward[c] = reward.float()
    win.done[c] = done

    order = [(c + 1 + i) % n for i in range(n)]      # oldest -> newest
    r_ord = win.reward[order]
    d_ord = win.done[order]
    alive = torch.cumprod(1.0 - d_ord.float(), dim=0)
    alive_before = torch.cat([torch.ones_like(alive[:1]), alive[:-1]], dim=0)
    disc = (gamma ** torch.arange(n, dtype=torch.float32,
                                  device=r_ord.device))[:, None]
    big_r = (disc * r_ord * alive_before).sum(0)
    done_any = d_ord.any(0)
    oldest = {k: s[order[0]].clone() for k, s in win.entries.items()}
    fill = min(win.fill + 1, n)
    new_win = win._replace(cursor=(c + 1) % n, fill=fill)
    return new_win, oldest, big_r, done_any, fill >= n
