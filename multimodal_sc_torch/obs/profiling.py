"""Tracing hook and the training watchdogs.

Counterpart of ``multimodal_sc_tpu/obs/profiling.py``: ``maybe_trace`` on
``torch.profiler`` (a Chrome trace in the given directory), the named
scope ``annotate`` (a profiler range, and an NVTX range on the card), the
NaN watchdog, the greedy-collapse watchdog and the fault-injection hook
``corrupt_symbols``.
"""

from __future__ import annotations

import contextlib
import math
import os
import sys
from typing import Iterator, Optional

import torch

from multimodal_sc_torch.obs.metrics_writer import to_host


@contextlib.contextmanager
def maybe_trace(logdir: Optional[str]) -> Iterator[None]:
    """Profile the enclosed steps into ``logdir/trace.json`` when set (host
    and, where there is one, device activity); no-op otherwise."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named scope visible in a ``torch.profiler`` trace (per-layer
    attribution), the counterpart of JAX's ``TraceAnnotation``; where CUDA
    is available, also an NVTX range of the same name."""
    with torch.profiler.record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


class NaNWatchdog:
    """Halts training when a watched scalar goes non-finite. The caller
    checks at its logging cadence, so the host pull adds no extra sync."""

    def __init__(self, keys=("loss",)):
        self.keys = keys

    def check(self, step: int, metrics: dict) -> None:
        watched = {k: metrics[k] for k in self.keys if k in metrics}
        for k, v in to_host(watched).items():
            if not math.isfinite(v):
                raise FloatingPointError(
                    f"non-finite {k!r}={v} at step {step}; halting "
                    f"(metrics dump: {to_host(metrics)})")


class CollapseWatchdog:
    """Flags greedy-policy collapse from the executed-action entropy.

    At exploration rate eps, a collapsed policy's executed actions are
    ~(1-eps) one action + eps uniform, whose entropy has a known value; a
    healthy policy sits well above it. ``consecutive`` debounces the early
    phase (the floor check only arms once epsilon has annealed below
    ``eps_armed``). Warns on stderr rather than halting: collapse is a
    training outcome, not a corrupted state."""

    def __init__(self, num_actions: int = 9, margin: float = 0.15,
                 eps_armed: float = 0.2, consecutive: int = 3):
        self.num_actions = num_actions
        self.margin = margin
        self.eps_armed = eps_armed
        self.consecutive = consecutive
        self._hits = 0
        self.tripped = False

    @staticmethod
    def collapsed_entropy(eps: float, num_actions: int) -> float:
        """Entropy of the executed-action histogram for a constant-argmax
        policy under eps-greedy exploration."""
        p_top = (1.0 - eps) + eps / num_actions
        p_rest = eps / num_actions
        h = -p_top * math.log(p_top + 1e-12)
        h -= (num_actions - 1) * p_rest * math.log(p_rest + 1e-12)
        return float(h)

    def check(self, step: int, metrics: dict) -> None:
        if "action_entropy" not in metrics or "epsilon" not in metrics:
            return
        host = to_host({k: metrics[k] for k in ("epsilon", "action_entropy")})
        eps, ent = host["epsilon"], host["action_entropy"]
        if eps > self.eps_armed:
            self._hits = 0
            return
        floor = self.collapsed_entropy(eps, self.num_actions)
        if ent < floor + self.margin:
            self._hits += 1
        else:
            self._hits = 0
        if self._hits >= self.consecutive and not self.tripped:
            self.tripped = True
            print(
                f"WARNING: greedy-collapse telltale at step {step}: "
                f"executed-action entropy {ent:.3f} is within "
                f"{self.margin} of the constant-argmax floor "
                f"{floor:.3f} (eps={eps:.3f}) for {self._hits} "
                f"consecutive checks. The learned Q-function has likely "
                f"collapsed to a constant action; greedy eval will sit at "
                f"random level.",
                file=sys.stderr, flush=True)


def corrupt_symbols(z: torch.Tensor, mode: str = "nan") -> torch.Tensor:
    """Fault-injection hook: a corrupted copy of channel output ``z``
    (B, K, 2): ``nan`` or ``inf`` in the first component of every symbol,
    or ``burst``: the first quarter of the symbols set to 100."""
    out = z.clone()
    if mode == "nan":
        out[..., 0] = float("nan")
    elif mode == "inf":
        out[..., 0] = float("inf")
    elif mode == "burst":
        out[:, :z.shape[1] // 4] = 100.0
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    return out
