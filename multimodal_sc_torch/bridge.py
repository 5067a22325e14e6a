"""Carry JAX-package parameters, optimizer and env states over to the port.

Every function takes plain numpy data (nested dicts of arrays, or an object
with array fields), so this module needs no JAX. Layout conversions:

* flax ``Dense`` kernel ``(in, out)`` -> ``nn.Linear`` weight ``(out, in)``;
* flax ``DenseGeneral`` of an attention module: a q/k/v kernel ``(dim,
  heads, hd)`` with bias ``(heads, hd)``, or the output projection's kernel
  ``(heads, hd, dim)``, flattened head-major to ``nn.Linear`` ``(out, in)``
  and a flat bias;
* flax ``Conv`` kernel HWIO -> ``F.conv2d`` weight OIHW;
* flax ``ConvTranspose`` kernel HWIO (applied unflipped) -> the
  ``F.conv_transpose2d`` weight of ``camera_cnn.ConvTransposeSame``, IOHW
  with the window flipped;
* a ``kernel`` the port keeps under the same name (the hand conv's HWIO
  filter bank) is copied unchanged, as are the packed MHA weights and bare
  parameters such as a ViT's ``pos`` table;
* LayerNorm ``scale`` -> ``weight``.

The trees carried so far: the c4 ``QNetwork``, the c5 ``ActorCritic``, the
c3 ``LateFusionJSCC`` (``camera.encoder.*``, ``camera.decoder.*``,
``lidar.*``), the c1 ``CameraJSCC`` (``encoder.*``, ``decoder.*``) and the
c1_vq ``VQCameraJSCC`` (``codebook``, ``enc*``, ``to_code``,
``from_code``, ``dec*``, ``deconv*`` / ``deprelu*``, ``conv_out``, and
``mask_embed`` when pruned), the digital camera trunk's ``cam_vq`` and
``cam_tok`` among the ``QNetwork``'s, and the c3_vq ``LidarBEVVQCodec``
under ``lidar.*`` (``pfn``, ``backbone``, ``to_code``, ``codebook``,
``from_code``, ``mask_embed`` when pruned, ``dec_backbone``,
``occ_head``), each with its Adam moments. A VQ ``codebook`` and a
``mask_embed`` are bare parameters, copied unchanged; ``to_code`` is a 1x1
``Conv``, the BEV codec's ``from_code`` a ``Dense``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from multimodal_sc_torch.device import resolve_device
from multimodal_sc_torch.envs.driving import EnvState


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + "."))
        else:
            out[path] = np.asarray(v)
    return out


def _converted(flat: Dict[str, np.ndarray], module: nn.Module,
               target: Mapping):
    """Yield ``(flax path, port key, array in the port's layout)`` for each
    leaf of a flattened flax tree (paths joined by ``.``)."""
    for path, a in flat.items():
        mod, _, leaf = path.rpartition(".")
        key = path
        if leaf == "kernel" and path not in target:
            key = f"{mod}.weight"
            if a.ndim == 3:
                # DenseGeneral: heads split out of the output (q/k/v, whose
                # bias is (heads, hd)) or of the input (the out-projection).
                split_out = flat[f"{mod}.bias"].ndim == 2
                a = (a.reshape(a.shape[0], -1) if split_out
                     else a.reshape(-1, a.shape[2]))
            if isinstance(module.get_submodule(mod), nn.ConvTranspose2d):
                a = np.ascontiguousarray(a[::-1, ::-1].transpose(2, 3, 0, 1))
            else:
                a = a.T if a.ndim == 2 else a.transpose(3, 2, 0, 1)
        elif leaf == "bias" and a.ndim == 2 and path in target:
            a = a.reshape(-1)
        elif leaf == "scale":
            key = f"{mod}.weight"
        yield path, key, a


def key_map(flax_params: Mapping, module: nn.Module) -> Dict[str, str]:
    """The map :func:`to_state_dict` applies: flax path (joined by ``/``,
    as ``jax.tree_util`` key paths print) -> the port's parameter name."""
    target = module.state_dict()
    return {path.replace(".", "/"): key for path, key, _ in
            _converted(_flatten(flax_params), module, target)}


def flax_leaf(module: nn.Module, key: str):
    """The inverse of :func:`key_map` for one parameter of ``module``:
    ``(flax path joined by "/", the flax leaf's ndim)``. A ``Linear``'s
    ``weight`` is a ``kernel`` (three axes for the q/k/v/o projections of
    an attention module, flax ``DenseGeneral``), a conv's ``weight`` a
    four-axis ``kernel``, a LayerNorm's ``weight`` its ``scale``; any other
    name is kept."""
    from multimodal_sc_torch.codec.camera_vit import MHA

    mod, _, leaf = key.rpartition(".")
    p = module.get_parameter(key)
    sub = module.get_submodule(mod) if mod else module
    parent_mod, _, attr = mod.rpartition(".")
    parent = module.get_submodule(parent_mod) if parent_mod else module
    general = isinstance(parent, MHA) and attr in ("q", "k", "v", "o")
    path = key.replace(".", "/")
    if isinstance(sub, nn.Linear) and leaf == "weight":
        return f"{mod.replace('.', '/')}/kernel", 3 if general else 2
    if isinstance(sub, nn.Linear) and leaf == "bias":
        return path, 2 if general and attr != "o" else 1
    if isinstance(sub, (nn.Conv2d, nn.ConvTranspose2d)) and leaf == "weight":
        return f"{mod.replace('.', '/')}/kernel", 4
    if isinstance(sub, nn.LayerNorm) and leaf == "weight":
        return f"{mod.replace('.', '/')}/scale", 1
    return path, p.dim()


def to_state_dict(flax_params: Mapping, module: nn.Module) -> Dict[str, torch.Tensor]:
    """A flax parameter tree -> a ``state_dict`` for ``module``.

    ``module`` is the port's counterpart of the flax module the tree came
    from; its own parameter names decide each conversion. Raises when a
    parameter is missing on either side or a shape disagrees.
    """
    target = module.state_dict()
    out = {}
    for path, key, a in _converted(_flatten(flax_params), module, target):
        if key not in target:
            raise KeyError(f"flax parameter {path!r} has no counterpart "
                           f"{key!r} in {type(module).__name__}")
        if tuple(a.shape) != tuple(target[key].shape):
            raise ValueError(f"{key}: flax shape {a.shape} vs port shape "
                             f"{tuple(target[key].shape)}")
        out[key] = torch.tensor(a, dtype=target[key].dtype)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"port parameters with no flax counterpart: {missing}")
    return out


def load_adam_state(opt: torch.optim.Optimizer, module: nn.Module, count: int,
                    mu: Mapping, nu: Mapping) -> None:
    """An optax ``ScaleByAdamState`` (``count`` and the ``mu`` / ``nu`` trees,
    as numpy) into ``opt``, the ``torch.optim.Adam`` or ``AdamW`` over
    ``module``'s parameters, so a step in the port starts where one in optax
    would. In the state of ``optax.chain(clip_by_global_norm, adam)`` or
    ``chain(clip_by_global_norm, adamw)`` it is ``opt_state[1][0]``."""
    first, second = to_state_dict(mu, module), to_state_dict(nu, module)
    for name, p in module.named_parameters():
        opt.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": first[name].to(p.device),
            "exp_avg_sq": second[name].to(p.device)}


def env_state_from_jax(state, device="cuda") -> EnvState:
    """A JAX ``EnvState`` (fields as arrays, batched or single) -> the
    port's batched ``EnvState`` on ``device``. The PRNG key is dropped: the
    port draws from a ``torch.Generator`` or takes the draws as arguments."""
    device = resolve_device(device)

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    ego = t(state.ego, torch.float32)
    single = ego.dim() == 1
    fields = EnvState(ego=ego, npcs=t(state.npcs, torch.float32),
                      road=t(state.road, torch.float32),
                      t=t(state.t, torch.int32),
                      fog=t(state.fog, torch.float32))
    if single:
        fields = EnvState(*(f.unsqueeze(0) for f in fields))
    return fields
