"""JSCC pretraining -> RL warm start.

Counterpart of ``multimodal_sc_tpu/rl/warmstart.py``
``load_jscc_into_perception``: reconstruction pretraining (configs 1-3)
learns the semantic codecs, and this copies those codecs' weights into the
RL perception trunk, whose submodules mirror the codec modules, so DQN /
PPO start from a channel-robust representation instead of random features.

Sources, the newest checkpoint of a ``train.jscc`` or ``train.fusion_jscc``
run (its ``params`` field):

* a ``CameraJSCC`` or ``ViTJSCC`` (c1 / c2): ``encoder`` -> ``cam_enc``;
* a ``VQCameraJSCC`` (c1_vq): its ``enc*``, ``to_code`` and ``codebook``
  -> the digital trunk's ``cam_vq``, whose names mirror the codec's by
  design, so the deployed transmitter is copied by name;
* a ``LateFusionJSCC`` (c3): ``camera.encoder`` -> ``cam_enc`` and the LiDAR
  codec's ``pfn``, ``backbone``, ``dec_backbone``, ``sym_head`` and
  ``sym_embed`` -> ``pfn``, ``lid_backbone``, ``lid_dec``, ``lid_sym_head``,
  ``lid_sym_embed``.

Each submodule is copied only if its entries and shapes match the source's
exactly; otherwise (a ViT camera checkpoint into a CNN trunk, an
SNR-conditioned encoder into the unconditioned ViT trunk) it is skipped and
named in a warning, never mis-assigned. A digital camera trunk whose
codebook the source did not bring is seeded from its own encoder's outputs
on rendered env observations (:func:`seed_vq_codebook_params`), as is a
cold start's. The digital LiDAR trunk waits for ROADMAP item 14c and
raises.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from multimodal_sc_torch.codec.semantic_vq import seed_codebook
from multimodal_sc_torch.config.configs import ExperimentConfig

# Trunk submodule <- LiDAR codec submodule (analog arch).
_LIDAR = (("pfn", "pfn"), ("lid_backbone", "backbone"),
          ("lid_dec", "dec_backbone"), ("lid_sym_head", "sym_head"),
          ("lid_sym_embed", "sym_embed"))


def _sub(tree: Dict[str, torch.Tensor], name: str
         ) -> Optional[Dict[str, torch.Tensor]]:
    """The entries of a flat state dict under ``name.``, the prefix cut;
    None if there are none."""
    pre = name + "."
    out = {k[len(pre):]: v for k, v in tree.items() if k.startswith(pre)}
    return out or None


def _shape_checked_copy(dst: nn.Module, src: Dict[str, torch.Tensor]) -> bool:
    """Copy ``src`` into ``dst`` in place if their entries and shapes match
    exactly; returns whether it did."""
    target = dst.state_dict()
    if set(target) != set(src) or any(
            tuple(target[k].shape) != tuple(src[k].shape) for k in target):
        return False
    with torch.no_grad():
        for k, t in target.items():
            t.copy_(src[k].to(t.dtype))
    return True


def load_jscc_into_perception(cfg: ExperimentConfig, net: nn.Module,
                              ckpt_dir: str, return_loaded: bool = False):
    """Warm-start ``net.perception`` (a ``QNetwork`` or ``ActorCritic``) in
    place from the JSCC checkpoint directory ``ckpt_dir``; returns ``net``,
    or ``(net, loaded_names)`` with ``return_loaded``. Raises if there is
    no checkpoint or nothing at all could be mapped."""
    from multimodal_sc_torch.io.checkpoint import CheckpointManager

    if cfg.lidar.arch == "vq":
        raise NotImplementedError(
            "warm-starting a digital LiDAR trunk and its codebook seeding "
            "are not ported yet (ROADMAP item 14c)")
    mgr = CheckpointManager(ckpt_dir)
    step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint found under {ckpt_dir!r}")
    src = mgr.read_field(step)
    per = net.perception

    cam_src, lid_src = None, None
    if _sub(src, "encoder") is not None:         # CameraJSCC / ViTJSCC
        cam_src = src
    vq_src = ("codebook" in src and _sub(src, "to_code") is not None)
    if _sub(src, "camera") is not None:          # LateFusionJSCC (c3)
        cam_src, lid_src = _sub(src, "camera"), _sub(src, "lidar")

    assignments: List[Tuple[str, Optional[Dict]]] = []
    if cam_src is not None and _sub(cam_src, "encoder") is not None:
        assignments.append(("cam_enc", _sub(cam_src, "encoder")))
    if vq_src and hasattr(per, "cam_vq"):        # VQCameraJSCC (c1_vq)
        assignments.append(("cam_vq", {k: src[k] for k in
                                       per.cam_vq.state_dict() if k in src}))
    if lid_src is not None:
        assignments += [(dst, _sub(lid_src, name)) for dst, name in _LIDAR]

    loaded, skipped = [], []
    for name, sub in assignments:
        ok = (sub is not None and hasattr(per, name)
              and _shape_checked_copy(getattr(per, name), sub))
        (loaded if ok else skipped).append(name)
    if not loaded:
        raise ValueError(
            f"warm-start from {ckpt_dir!r} mapped nothing into the "
            f"perception trunk (skipped: {skipped}) — arch/shape mismatch?")
    if skipped:
        warnings.warn(
            f"warm-start skipped {skipped} (shape/arch mismatch with "
            f"{ckpt_dir!r}); loaded {loaded}", stacklevel=2)
    return (net, loaded) if return_loaded else net


@torch.no_grad()
def seed_vq_codebook_params(cfg: ExperimentConfig, net: nn.Module,
                            generator: Optional[torch.Generator] = None
                            ) -> nn.Module:
    """Data-dependent codebook seeding of ``net``'s digital camera trunk in
    place: the codebook becomes a sample of the fresh encoder's outputs on
    64 freshly rendered env observations (the fix for a small-uniform
    init's interchangeable codes). ``generator`` defaults to one seeded by
    ``train.seed``; the JAX package draws from ``fold_in(key(seed),
    0xC0DE)``, the port from its own generator. The drivers call it on
    fresh runs only, never on resume or after a warm start that brought a
    codebook."""
    from multimodal_sc_torch.envs import driving

    if cfg.lidar.arch == "vq":
        raise NotImplementedError(
            "seeding the digital LiDAR codebook is not ported yet (ROADMAP "
            "item 14c)")
    vq = net.perception.cam_vq
    dev = vq.codebook.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(
            (cfg.train.seed * 0x9E3779B1 + 0xC0DE) & 0xFFFFFFFF)
    states = driving.reset_batch(cfg.env, 64, generator, dev)
    img, _, _ = driving.observe_batch(cfg.env, states)
    seed_codebook(vq.codebook, vq.encode_features(img), generator)
    return net


def warm_start(cfg: ExperimentConfig, nets, init_from: str) -> None:
    """Warm-start ``nets[0]``'s perception trunk from the JSCC checkpoint
    ``init_from`` (a digital camera trunk that got no codebook from it is
    seeded from its encoder's outputs); the other networks (target, EMA)
    restart from the warm weights, so none blends the random init into
    early targets or the averaged deployment policy."""
    _, loaded = load_jscc_into_perception(cfg, nets[0], init_from,
                                          return_loaded=True)
    if cfg.camera.arch == "vq" and "cam_vq" not in loaded:
        seed_vq_codebook_params(cfg, nets[0])
    with torch.no_grad():
        for other in nets[1:]:
            other.load_state_dict(nets[0].state_dict())
