"""Lightweight metrics writer: JSONL file plus a stderr table.

Counterpart of ``multimodal_sc_tpu/obs/metrics_writer.py``. Scalars stay on
the device until ``write`` pulls the whole dict in one transfer, so a
training loop that logs every K steps syncs with the device every K steps.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional

import torch


def to_host(scalars: Dict[str, object]) -> Dict[str, float]:
    """A dict of 0-dim tensors / numbers as Python floats, with one
    device-to-host copy for all the tensors together."""
    keys = [k for k, v in scalars.items() if isinstance(v, torch.Tensor)]
    out = {k: float(v) for k, v in scalars.items() if k not in keys}
    if keys:
        vals = torch.stack([scalars[k].detach().reshape(()).double()
                            for k in keys]).tolist()
        out.update(zip(keys, vals))
    return {k: out[k] for k in scalars}


class MetricsWriter:
    def __init__(self, path: Optional[str] = None, stdout: bool = True,
                 config_json: Optional[str] = None):
        self.path = path
        self.stdout = stdout
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")
            if config_json:
                # First record pins the exact experiment config.
                self._fh.write(json.dumps(
                    {"config": json.loads(config_json)}) + "\n")
                self._fh.flush()
        self._t0 = time.time()

    def write(self, step: int, scalars: Dict[str, object]) -> None:
        host = to_host(scalars)
        rec = {"step": int(step), "t": round(time.time() - self._t0, 3), **host}
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.stdout:
            kv = " ".join(f"{k}={v:.4g}" for k, v in host.items())
            print(f"[step {step:>7d}] {kv}", file=sys.stderr)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


class Timer:
    """Wall-clock timer for steps/sec metrics. The caller synchronizes the
    device before leaving the block: PyTorch returns before the card has
    finished."""

    def __init__(self):
        self.t0 = None
        self.elapsed = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False


def steps_per_sec_per_chip(num_steps: int, elapsed_s: float,
                           n_chips: int = 1) -> float:
    """The port drives one card per process, hence the default of 1."""
    return num_steps / max(elapsed_s, 1e-9) / max(n_chips, 1)
