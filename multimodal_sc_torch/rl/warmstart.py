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
  codec's ``pfn``, ``backbone`` and ``dec_backbone`` -> ``pfn``,
  ``lid_backbone``, ``lid_dec``; then, gated on the TARGET trunk's modules,
  the analog ``sym_head`` and ``sym_embed`` -> ``lid_sym_head``,
  ``lid_sym_embed``, or the digital codec's (c3_vq, c3_vq_prune)
  ``to_code``, ``codebook``, ``from_code`` and, into a pruned trunk,
  ``mask_embed`` -> ``lid_to_code``, ``lid_codebook``, ``lid_from_code``,
  ``lid_mask_embed``.

Each submodule (or bare parameter) is copied only if its entries and shapes
match the source's exactly; otherwise (a ViT camera checkpoint into a CNN
trunk, an SNR-conditioned encoder into the unconditioned ViT trunk, an
analog LiDAR codec into a digital trunk) it is skipped and named in a
warning, never mis-assigned. A digital trunk whose codebook the source did
not bring is seeded from its own encoder's outputs on rendered env
observations (:func:`seed_vq_codebook_params`), as is a cold start's.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from multimodal_sc_torch.codec.semantic_vq import seed_codebook
from multimodal_sc_torch.config.configs import ExperimentConfig

# Trunk entry <- LiDAR codec entry: the shared BEV modules, then the
# analog or the digital link's, as the target trunk has them.
_LIDAR = (("pfn", "pfn"), ("lid_backbone", "backbone"),
          ("lid_dec", "dec_backbone"))
_LIDAR_ANALOG = (("lid_sym_head", "sym_head"),
                 ("lid_sym_embed", "sym_embed"))
_LIDAR_VQ = (("lid_to_code", "to_code"), ("lid_codebook", "codebook"),
             ("lid_from_code", "from_code"))


def _sub(tree: Dict[str, torch.Tensor], name: str
         ) -> Optional[Dict[str, torch.Tensor]]:
    """The entries of a flat state dict under ``name.``, the prefix cut;
    None if there are none."""
    pre = name + "."
    out = {k[len(pre):]: v for k, v in tree.items() if k.startswith(pre)}
    return out or None


def _lidar_entry(tree: Dict[str, torch.Tensor], name: str):
    """The LiDAR codec's entry ``name``: a submodule's state dict, or a
    bare parameter's tensor (``codebook``, ``mask_embed``); None if
    absent."""
    return tree[name] if name in tree else _sub(tree, name)


def _shape_checked_copy(dst, src) -> bool:
    """Copy ``src`` into ``dst`` in place if their entries and shapes match
    exactly (a module and a state dict, or a parameter and a tensor);
    returns whether it did."""
    if isinstance(dst, nn.Parameter):
        if not isinstance(src, torch.Tensor) or src.shape != dst.shape:
            return False
        with torch.no_grad():
            dst.copy_(src.to(dst.dtype))
        return True
    if not isinstance(src, dict):
        return False
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
        pairs = _LIDAR + (_LIDAR_VQ if hasattr(per, "lid_to_code")
                          else _LIDAR_ANALOG)
        if hasattr(per, "lid_mask_embed"):
            pairs += (("lid_mask_embed", "mask_embed"),)
        assignments += [(dst, _lidar_entry(lid_src, name))
                        for dst, name in pairs]

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
                            generator: Optional[torch.Generator] = None,
                            seed_camera: bool = True,
                            seed_lidar: bool = True) -> nn.Module:
    """Data-dependent codebook seeding of ``net``'s digital trunk in place:
    each codebook becomes a sample of its fresh encoder's outputs on 64
    freshly rendered env observations (the fix for a small-uniform init's
    interchangeable codes): the camera's (``camera.arch="vq"`` and
    ``seed_camera``) from the images, the LiDAR's (``lidar.arch="vq"`` and
    ``seed_lidar``) from ``lid_to_code``'s BEV features of the ego rays
    only. Under ``train.bf16`` the features are the bf16 encoders',
    widened to f32, as JAX seeds them. ``generator`` defaults to one
    seeded by ``train.seed``; the JAX package draws from
    ``fold_in(key(seed), 0xC0DE)``, the port from its own generator. The
    drivers call it on fresh runs only, never on resume, and after a warm
    start only for a codebook it did not bring."""
    from multimodal_sc_torch.envs import driving

    per = net.perception
    dev = next(per.parameters()).device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(
            (cfg.train.seed * 0x9E3779B1 + 0xC0DE) & 0xFFFFFFFF)
    states = driving.reset_batch(cfg.env, 64, generator, dev)
    img, pts, mask = driving.observe_batch(cfg.env, states)
    if cfg.camera.arch == "vq" and seed_camera:
        vq = per.cam_vq
        seed_codebook(vq.codebook, vq.encode_features(img), generator)
    if cfg.lidar.arch == "vq" and seed_lidar:
        r = cfg.env.lidar_rays
        bev = per.lid_backbone(per.pfn(pts[:, :r], mask[:, :r]))
        seed_codebook(per.lid_codebook, per.lid_to_code(bev).float(),
                      generator)
    return net


def warm_start(cfg: ExperimentConfig, nets, init_from: str) -> None:
    """Warm-start ``nets[0]``'s perception trunk from the JSCC checkpoint
    ``init_from`` (a digital trunk's codebook that did not come over is
    seeded from its encoder's outputs); the other networks (target, EMA)
    restart from the warm weights, so none blends the random init into
    early targets or the averaged deployment policy."""
    _, loaded = load_jscc_into_perception(cfg, nets[0], init_from,
                                          return_loaded=True)
    seed_cam = cfg.camera.arch == "vq" and "cam_vq" not in loaded
    seed_lid = cfg.lidar.arch == "vq" and "lid_codebook" not in loaded
    if seed_cam or seed_lid:
        seed_vq_codebook_params(cfg, nets[0], seed_camera=seed_cam,
                                seed_lidar=seed_lid)
    restart_from(nets)


def restart_from(nets) -> None:
    """The other networks (target, EMA) take ``nets[0]``'s weights."""
    with torch.no_grad():
        for other in nets[1:]:
            other.load_state_dict(nets[0].state_dict())


def cold_start(cfg: ExperimentConfig, nets) -> None:
    """A fresh run's digital trunk seeds its codebooks (camera and LiDAR,
    as configured) and the other networks take the seeded weights; an
    analog trunk is left alone."""
    if cfg.camera.arch == "vq" or cfg.lidar.arch == "vq":
        seed_vq_codebook_params(cfg, nets[0])
        restart_from(nets)
