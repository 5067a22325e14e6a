"""Checkpoint and resume for the JSCC and RL training states.

Counterpart of ``multimodal_sc_tpu/io/checkpoint.py``: a
``CheckpointManager`` that pins the config beside the checkpoints, saves a
train state at a step, keeps the last ``max_to_keep``, restores the newest
one, restores one network alone for evaluation, and keeps the DQN driver's
best-policy snapshot under ``<dir>/best``. A train state is a
``NamedTuple`` (``train.jscc.TrainState``, ``train.fusion_jscc.TrainState``,
``rl.dqn.DQNState``, ``rl.ppo.PPOState``) whose fields are modules,
optimizers, learning-rate schedules, generators, tensors, plain numbers,
and nested named tuples and dicts of those (the env states, the replay
buffer, the n-step window). Each is saved with ``torch.save``: a module,
optimizer or schedule as its ``state_dict``, a generator as its
``get_state()``, a nested tuple or dict field by field. A restore loads
into the live objects of a freshly built state of the same config, tensors
copied IN PLACE on their device, so a resumed run continues the same
streams. A checkpoint is written to a temporary file and moved into place
with ``os.replace``: a reader never sees half of one. Reads map the file
(``mmap``), so a restore of one network leaves the replay buffer on disk.

Nothing is cast or truncated: a saved entry the target lacks, a target
entry the checkpoint lacks (the JAX package's upgrade shim pairs the two
trees by position and would drop such an entry), a tensor of another dtype
or shape, or a plain value of another type raises and names its path.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, NamedTuple, Optional

import torch
from torch import nn

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")
_BEST = os.path.join("best", "policy.pt")


def _save_field(value: Any) -> Any:
    if isinstance(value, torch.Generator):
        return value.get_state()
    if hasattr(value, "state_dict"):
        return value.state_dict()
    if hasattr(value, "_fields"):
        return {f: _save_field(getattr(value, f)) for f in value._fields}
    if isinstance(value, dict):
        return {k: _save_field(v) for k, v in value.items()}
    return value


def _check_tensor(path: str, live: torch.Tensor, saved: Any) -> None:
    if not isinstance(saved, torch.Tensor):
        raise TypeError(f"checkpoint entry {path!r}: a tensor in the state, "
                        f"{type(saved).__name__} in the checkpoint")
    if saved.dtype != live.dtype or saved.shape != live.shape:
        raise ValueError(
            f"checkpoint entry {path!r}: {saved.dtype} {tuple(saved.shape)} "
            f"in the checkpoint, {live.dtype} {tuple(live.shape)} in the "
            "state (a restore never casts or reshapes)")


def _check_fields(saved: Any, fields, path: str = "") -> None:
    if not isinstance(saved, dict):
        raise TypeError(f"checkpoint entry {path!r}: a {type(saved).__name__}"
                        " where the state holds a tuple or dict")
    missing = sorted(set(fields) - set(saved))
    extra = sorted(set(saved) - set(fields))
    if missing or extra:
        where = f" at {path!r}" if path else ""
        raise KeyError(
            f"checkpoint does not match the train state{where}: missing "
            f"{missing}, not in the state {extra}")


def _load_module(path: str, live: nn.Module, saved: Dict) -> None:
    target = live.state_dict()
    _check_fields(saved, target, path)
    for k, t in target.items():
        _check_tensor(f"{path}.{k}", t, saved[k])
    live.load_state_dict(saved, strict=True)


def _load_field(path: str, live: Any, saved: Any) -> Any:
    """``saved`` into the live object ``live``; returns the field's new
    value (the same object, or the saved plain value)."""
    if isinstance(live, torch.Generator):
        _check_tensor(path, live.get_state(), saved)
        live.set_state(saved.cpu())
    elif isinstance(live, nn.Module):
        try:
            _load_module(path, live, saved)
        except RuntimeError as e:
            raise KeyError(f"checkpoint field {path!r}: {e}") from None
    elif hasattr(live, "load_state_dict"):
        live.load_state_dict(saved)
    elif hasattr(live, "_fields"):
        _check_fields(saved, live._fields, path)
        return type(live)(**{f: _load_field(f"{path}.{f}", getattr(live, f),
                                            saved[f])
                             for f in live._fields})
    elif isinstance(live, dict):
        _check_fields(saved, live, path)
        return {k: _load_field(f"{path}.{k}", v, saved[k])
                for k, v in live.items()}
    elif isinstance(live, torch.Tensor):
        _check_tensor(path, live, saved)
        with torch.no_grad():
            live.copy_(saved)
    elif live is not None and type(saved) is not type(live):
        raise TypeError(f"checkpoint entry {path!r}: {type(live).__name__} "
                        f"in the state, {type(saved).__name__} in the "
                        "checkpoint")
    else:
        return saved
    return live


def _read(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


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

    @staticmethod
    def _write(path: str, payload: Any) -> None:
        tmp = path + f".tmp{os.getpid()}"
        torch.save(payload, tmp)
        os.replace(tmp, path)

    def save(self, step: int, state: NamedTuple,
             extra: Optional[Dict[str, Any]] = None) -> None:
        """Write ``state`` (and the plain entries of ``extra``) as the
        checkpoint of ``step``; drop the oldest beyond ``max_to_keep``."""
        self._write(self._path(step), {**_save_field(state), **(extra or {})})
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def _shard_path(self, step: int, shard: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.shard{shard}.pt")

    def save_shard(self, step: int, shard: int, state: NamedTuple,
                   fields) -> None:
        """Write ``fields`` of ``state`` as data shard ``shard``'s part of
        the checkpoint of ``step`` (beside the step's own file, which a
        resume and ``steps`` read); drop this shard's parts of steps no
        longer kept."""
        self._write(self._shard_path(step, shard),
                    {f: _save_field(getattr(state, f)) for f in fields})
        suffix = f".shard{shard}.pt"
        kept = set(self.steps()[-self.max_to_keep:]) | {step}
        for name in os.listdir(self.directory):
            if name.startswith("ckpt_") and name.endswith(suffix):
                old = int(name[len("ckpt_"):-len(suffix)])
                if old not in kept:
                    os.remove(os.path.join(self.directory, name))

    def read(self, step: int, shard: Optional[int] = None) -> Dict[str, Any]:
        """The checkpoint of ``step`` as written (or data shard
        ``shard``'s part of it), mapped from disk."""
        return _read(self._path(step) if shard is None
                     else self._shard_path(step, shard))

    @staticmethod
    def load_into(state: NamedTuple, saved: Dict[str, Any]) -> NamedTuple:
        """``saved`` (one entry a field of ``state``) loaded into
        ``state``'s live objects, as ``restore_latest`` loads."""
        _check_fields(saved, state._fields)
        return type(state)(**{f: _load_field(f, getattr(state, f), saved[f])
                              for f in state._fields})

    def restore_latest(self, state: NamedTuple) -> Optional[NamedTuple]:
        """The newest checkpoint loaded into ``state``'s live objects (a
        freshly built state of the same config); None if there is none."""
        step = self.latest_step()
        if step is None:
            return None
        saved = _read(self._path(step))
        _check_fields(saved, state._fields)
        return type(state)(**{
            f: _load_field(f, getattr(state, f), saved[f])
            for f in state._fields})

    def restore_params_latest(self, module: nn.Module,
                              field: str = "params") -> Optional[nn.Module]:
        """Only the ``field`` module of the newest checkpoint (``params``,
        or a DQN state's ``target_params`` / ``ema_params``), loaded into
        ``module`` (strictly: every parameter on both sides, same dtypes
        and shapes); None if there is no checkpoint. The rest of the file
        (a replay buffer, env states) is never read."""
        step = self.latest_step()
        if step is None:
            return None
        return _load_field(field, module, self.read_field(step, field))

    def read_field(self, step: int, field: str = "params") -> Any:
        """The saved ``field`` of the checkpoint of ``step`` as it was
        written (a module as its state dict, on the CPU)."""
        saved = _read(self._path(step))
        if field not in saved:
            raise KeyError(f"checkpoint has no field {field!r}: "
                           f"{sorted(saved)}")
        return saved[field]

    def save_best_policy(self, tree: Dict[str, Any]) -> bool:
        """Keep the best-eval policy snapshot under ``<dir>/best``: ``tree``
        is ``{"params", "target_params", "ema_params", "step",
        "eval_return"}``, the networks as modules or state dicts. Apart from
        the step-numbered checkpoints, so a resume never takes it for a
        train state. Overwrites an existing snapshot only if
        ``eval_return`` is higher (a resumed run cannot regress the deployed
        policy); returns whether it wrote."""
        prev = self.restore_best_policy()
        if prev is not None and prev["eval_return"] >= tree["eval_return"]:
            return False
        os.makedirs(os.path.join(self.directory, "best"), exist_ok=True)
        self._write(os.path.join(self.directory, _BEST),
                    {k: _save_field(v) for k, v in tree.items()})
        return True

    def restore_best_policy(self) -> Optional[Dict[str, Any]]:
        """The ``<dir>/best`` snapshot (state dicts on the CPU, the step and
        the return), or None."""
        path = os.path.join(self.directory, _BEST)
        return _read(path) if os.path.exists(path) else None

    def close(self) -> None:
        """Saves are synchronous; nothing is left to flush."""


def guard_world(ckpt: CheckpointManager, n_shards: int) -> None:
    """Refuse to resume a checkpoint written by another number of data
    shards (a single-process run's counts one): its per-shard state is
    split otherwise."""
    step = ckpt.latest_step()
    if step is None:
        return
    saved = int(ckpt.read(step).get("data_shards", 1))
    if saved != n_shards:
        raise ValueError(
            f"checkpoint dir {ckpt.directory!r} holds a run of {saved} data "
            f"shard(s) but this run has {n_shards}; resume it at the world "
            "size that wrote it, or start a fresh checkpoint dir")


def _whole(state: NamedTuple) -> NamedTuple:
    """``state`` with its modules and optimizers as their state dicts in
    the single-card layout (``runtime/tp.py``: each model-sharded tensor
    gathered whole). Every rank of the mesh calls it."""
    from multimodal_sc_torch.runtime.tp import (whole_optimizer_state,
                                                whole_state_dict)

    def whole(value):
        if isinstance(value, nn.Module):
            return whole_state_dict(value)
        if isinstance(value, torch.optim.Optimizer):
            return whole_optimizer_state(value)
        return value

    return type(state)(*(whole(v) for v in state))


def save_sharded(ckpt: CheckpointManager, step: int, state: NamedTuple,
                 mesh, shard_fields) -> None:
    """The checkpoint of ``step`` of a run on a mesh (``runtime/mesh.py``):
    the first rank writes every field (its own shard's among them) and,
    past one data shard, their number; the first model rank of each other
    data shard writes its ``shard_fields`` beside it. On a model axis of
    several ranks the networks and the optimizer moments are written
    whole (``_whole``), so the checkpoint restores at any model-axis size
    and on one card. A mesh of one process writes what ``ckpt.save``
    does. Returns when every rank has written."""
    import torch.distributed as dist

    if mesh.model > 1:
        state = _whole(state)
    if mesh.rank == 0:
        ckpt.save(step, state, extra={"data_shards": mesh.data}
                  if mesh.data > 1 else None)
    if mesh.size == 1:
        return
    dist.barrier()
    if mesh.data_index != 0 and mesh.model_index == 0:
        ckpt.save_shard(step, mesh.data_index, state, shard_fields)
    dist.barrier()


def restore_sharded(ckpt: CheckpointManager, state: NamedTuple,
                    mesh) -> Optional[NamedTuple]:
    """The newest checkpoint of a data-parallel run loaded into
    ``state``'s live objects: the replicated fields from the step's file,
    the shard's own from its part; None if there is none."""
    step = ckpt.latest_step()
    if step is None:
        return None
    guard_world(ckpt, mesh.data)
    saved = dict(ckpt.read(step))
    saved.pop("data_shards", None)
    if mesh.data_index != 0:
        saved.update(ckpt.read(step, mesh.data_index))
    return ckpt.load_into(state, saved)
