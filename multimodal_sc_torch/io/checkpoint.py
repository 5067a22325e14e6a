"""Checkpoint and resume for the JSCC training states.

Counterpart of the core of ``multimodal_sc_tpu/io/checkpoint.py``: a
``CheckpointManager`` that pins the config beside the checkpoints, saves a
train state at a step, keeps the last ``max_to_keep``, restores the newest
one, and restores the parameters alone for evaluation. A train state is a
``NamedTuple`` (``train.jscc.TrainState``, ``train.fusion_jscc.TrainState``)
whose fields are modules, optimizers, learning-rate schedules, generators
and plain numbers; each is saved as its ``state_dict`` (a generator as its
``get_state()``) with ``torch.save`` and restored into the live objects of
a freshly built state, so a resumed run continues the same streams. A
checkpoint is written to a temporary file and moved into place with
``os.replace``: a reader never sees half of one.

A saved field the target lacks, or a target field the checkpoint lacks,
raises and names itself (the JAX package's upgrade shim pairs the two
trees by position and would drop such an entry). The DQN/PPO states, the
best-policy snapshot and the evaluation restore of a policy are ROADMAP
item 10's rest.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, NamedTuple, Optional

import torch
from torch import nn

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _save_field(value: Any) -> Any:
    if isinstance(value, torch.Generator):
        return value.get_state()
    if hasattr(value, "state_dict"):
        return value.state_dict()
    return value


def _load_field(path: str, live: Any, saved: Any) -> Any:
    """``saved`` into the live object ``live``; returns the field's new
    value (the same object, or the saved plain value)."""
    if isinstance(live, torch.Generator):
        live.set_state(saved.cpu())
    elif isinstance(live, nn.Module):
        try:
            live.load_state_dict(saved, strict=True)
        except RuntimeError as e:
            raise KeyError(f"checkpoint field {path!r}: {e}") from None
    elif hasattr(live, "load_state_dict"):
        live.load_state_dict(saved)
    else:
        return type(live)(saved) if live is not None else saved
    return live


def _check_fields(saved: Dict[str, Any], fields) -> None:
    missing = sorted(set(fields) - set(saved))
    extra = sorted(set(saved) - set(fields))
    if missing or extra:
        raise KeyError(
            f"checkpoint does not match the train state: missing "
            f"{missing}, not in the state {extra}")


class CheckpointManager:
    """Step-numbered checkpoints ``ckpt_<step>.pt`` under ``directory``."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def save_config(self, config_json: str) -> None:
        """Pin the experiment config beside the checkpoints."""
        with open(os.path.join(self.directory, "config.json"), "w") as f:
            f.write(config_json)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def steps(self):
        """The steps of the checkpoints on disk, oldest first."""
        out = []
        for name in os.listdir(self.directory):
            m = _NAME.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: NamedTuple) -> None:
        """Write ``state`` as the checkpoint of ``step``; drop the oldest
        beyond ``max_to_keep``."""
        payload = {f: _save_field(getattr(state, f)) for f in state._fields}
        tmp = self._path(step) + f".tmp{os.getpid()}"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def _read(self, step: int) -> Dict[str, Any]:
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)

    def restore_latest(self, state: NamedTuple) -> Optional[NamedTuple]:
        """The newest checkpoint loaded into ``state``'s live objects (a
        freshly built state of the same config); None if there is none."""
        step = self.latest_step()
        if step is None:
            return None
        saved = self._read(step)
        _check_fields(saved, state._fields)
        return type(state)(**{
            f: _load_field(f, getattr(state, f), saved[f])
            for f in state._fields})

    def restore_params_latest(self, module: nn.Module,
                              field: str = "params") -> Optional[nn.Module]:
        """Only the ``field`` module of the newest checkpoint, loaded into
        ``module`` (strictly: every parameter on both sides); None if there
        is no checkpoint."""
        step = self.latest_step()
        if step is None:
            return None
        saved = self._read(step)
        if field not in saved:
            raise KeyError(f"checkpoint has no field {field!r}: "
                           f"{sorted(saved)}")
        return _load_field(field, module, saved[field])

    def close(self) -> None:
        """Saves are synchronous; nothing is left to flush."""
