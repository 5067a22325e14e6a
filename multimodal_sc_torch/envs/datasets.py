"""Image datasets (CIFAR-10 / KITTI crops with a synthetic fallback) and
seeded synthetic LiDAR clouds.

Counterpart of ``multimodal_sc_tpu/envs/datasets.py``. Every random value a
synthetic generator consumes is an argument (a draws tuple, values already
in their ranges); ``draw_image`` / ``draw_pointcloud`` fill one from a
``torch.Generator`` on the device, and a test can hand in the JAX package's
own draws instead. The real files (``cifar-10-batches-py/``, ``kitti/``
under ``data_root``) are read when present into a bank of images in host
memory; without them ``cifar`` and ``kitti`` fall back to their synthetic
twins, as in the JAX package.

Synthetic images are structured (smooth gradients + random shapes + noise)
rather than pure noise, so JSCC reconstruction quality is a meaningful,
improvable signal.
"""

from __future__ import annotations

import os
import pickle
import warnings
from typing import Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from multimodal_sc_torch.device import resolve_device

SEG_CLASSES = 4        # 0=background, 1=box, 2=disk, 3=stripe
SEG_OBJECTS = 3        # shapes drawn per image (can overlap; later wins)
BEV_CLASSES = 4        # 0=empty, 1=ground, 2=car, 3=clutter
N_CLUSTERS = 4         # Gaussian car clusters per cloud


def _uniform(shape, lo, hi, generator, device):
    return lo + torch.rand(shape, generator=generator, device=device) * (hi - lo)


class ImageDraws(NamedTuple):
    """The random values one image batch consumes (J = SEG_OBJECTS)."""
    gcoef: torch.Tensor    # (B, C) in [-1, 1): vertical gradient
    hcoef: torch.Tensor    # (B, C) in [-1, 1): horizontal gradient
    cls: torch.Tensor      # (B, J) int in [1, SEG_CLASSES)
    cy: torch.Tensor       # (B, J) in [0.15, 0.85)
    cx: torch.Tensor       # (B, J) in [0.15, 0.85)
    half: torch.Tensor     # (B, J) in [0.08, 0.22)
    slope: torch.Tensor    # (B, J) in [-1, 1)
    color: torch.Tensor    # (B, J, C) in [0, 1)
    noise: torch.Tensor    # (B, H, W, C) standard normal


def draw_image(batch: int, hw: Tuple[int, int], generator: torch.Generator,
               device, channels: int = 3) -> ImageDraws:
    g, dev, j = generator, device, SEG_OBJECTS
    return ImageDraws(
        gcoef=_uniform((batch, channels), -1.0, 1.0, g, dev),
        hcoef=_uniform((batch, channels), -1.0, 1.0, g, dev),
        cls=torch.randint(1, SEG_CLASSES, (batch, j), generator=g, device=dev),
        cy=_uniform((batch, j), 0.15, 0.85, g, dev),
        cx=_uniform((batch, j), 0.15, 0.85, g, dev),
        half=_uniform((batch, j), 0.08, 0.22, g, dev),
        slope=_uniform((batch, j), -1.0, 1.0, g, dev),
        color=torch.rand((batch, j, channels), generator=g, device=dev),
        noise=torch.randn((batch, hw[0], hw[1], channels), generator=g,
                          device=dev))


def synthetic_image_seg_batch(draws: ImageDraws, hw: Tuple[int, int]):
    """Structured synthetic images in [0,1] + multi-class segmentation.

    Returns (img (B,H,W,C) float32, seg (B,H,W) int32 in [0, SEG_CLASSES)).
    SEG_OBJECTS overlapping shapes per image (an axis-aligned box, a disk or
    a diagonal stripe, each with random position, size and color) blended at
    65% over a gradient background; later shapes occlude earlier ones.
    """
    h, w = hw
    dev = draws.noise.device
    yy = torch.linspace(0.0, 1.0, h, device=dev).reshape(1, h, 1)
    xx = torch.linspace(0.0, 1.0, w, device=dev).reshape(1, 1, w)
    gcoef = draws.gcoef[:, None, None, :]
    hcoef = draws.hcoef[:, None, None, :]
    img = 0.5 + 0.25 * (gcoef * (yy[..., None] * 2 - 1)
                        + hcoef * (xx[..., None] * 2 - 1))
    seg = torch.zeros((img.shape[0], h, w), dtype=torch.int32, device=dev)
    for j in range(SEG_OBJECTS):
        cls, cy, cx, half, slope = (t[:, j, None, None] for t in (
            draws.cls, draws.cy, draws.cx, draws.half, draws.slope))
        dy, dx = yy - cy, xx - cx
        box = (dy.abs() < half) & (dx.abs() < half * 1.3)
        disk = (dy * dy + dx * dx) < half * half
        stripe = ((dx + slope * dy).abs() < 0.35 * half) & (dy.abs() < 0.45)
        mask = torch.where(cls == 1, box, torch.where(cls == 2, disk, stripe))
        color = draws.color[:, j, None, None, :]
        img = torch.where(mask[..., None], 0.35 * img + 0.65 * color, img)
        seg = torch.where(mask, cls.to(torch.int32), seg)
    img = torch.clamp(img + 0.02 * draws.noise, 0.0, 1.0).float()
    return img, seg


def synthetic_image_batch(draws: ImageDraws, hw: Tuple[int, int]) -> torch.Tensor:
    return synthetic_image_seg_batch(draws, hw)[0]


def _try_load_kitti_crops(root: str, hw: Tuple[int, int],
                          max_images: int = 2000) -> Optional[np.ndarray]:
    """KITTI-style images under ``<root>/kitti/**.png|jpg`` as a fixed bank
    of (N, h, w, 3) float32 crops (4 per frame, at seeded offsets); None
    (the synthetic fallback) when the directory, its images or PIL are
    absent."""
    d = os.path.join(root, "kitti")
    if not os.path.isdir(d):
        return None
    try:
        from PIL import Image
    except ImportError:
        return None
    paths = []
    for base, _, files in os.walk(d):
        paths += [os.path.join(base, f) for f in files
                  if f.lower().endswith((".png", ".jpg", ".jpeg"))]
    if not paths:
        return None
    h, w = hw
    rng = np.random.default_rng(0)
    crops = []
    for p in sorted(paths)[:max_images]:
        try:
            img = np.asarray(Image.open(p).convert("RGB"), np.float32) / 255.0
        except OSError:
            continue
        if img.shape[0] < h or img.shape[1] < w:
            continue
        for _ in range(4):
            y0 = rng.integers(0, img.shape[0] - h + 1)
            x0 = rng.integers(0, img.shape[1] - w + 1)
            crops.append(img[y0:y0 + h, x0:x0 + w])
    if not crops:
        return None
    return np.stack(crops)


def _try_load_cifar(root: str) -> Optional[np.ndarray]:
    """CIFAR-10 python-format batches under ``<root>/cifar-10-batches-py``
    as a (N, 32, 32, 3) float32 bank in [0, 1]; None when absent."""
    d = os.path.join(root, "cifar-10-batches-py")
    if not os.path.isdir(d):
        return None
    arrays = []
    for i in range(1, 6):
        p = os.path.join(d, f"data_batch_{i}")
        if not os.path.exists(p):
            continue
        with open(p, "rb") as f:
            batch = pickle.load(f, encoding="bytes")
        arrays.append(batch[b"data"])
    if not arrays:
        return None
    x = np.concatenate(arrays).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return x.astype(np.float32) / 255.0


class ImageDataset:
    """Infinite seeded iterator of (B, H, W, C) float32 batches in [0,1].

    name: synthetic_cifar | synthetic_kitti | cifar | kitti. Batch ``i``
    depends on ``(seed, i)`` only, so setting ``_step`` replays the stream
    from there. Synthetic batches are made on ``device``; batches of a real
    bank come from host memory (``runtime.prefetch.prefetch_to_device``
    moves them). ``real_bank`` reuses an already-loaded bank (the train
    dataset's, for the held-out batch) instead of reading the files again.
    """

    SHAPES = {
        "synthetic_cifar": (32, 32),
        "cifar": (32, 32),
        "synthetic_kitti": (64, 64),   # KITTI crops
        "kitti": (64, 64),
    }

    def __init__(self, name: str, batch_size: int, seed: int = 0,
                 with_seg: bool = False, device="cuda",
                 data_root: str = "data",
                 real_bank: Optional[np.ndarray] = None):
        if name not in self.SHAPES:
            raise KeyError(f"unknown dataset {name!r}")
        self.name = name
        self.hw = self.SHAPES[name]
        self.batch_size = batch_size
        self.seed = seed
        self.with_seg = with_seg
        self.device = resolve_device(device)
        self._real: Optional[np.ndarray] = real_bank
        if real_bank is None and name == "cifar":
            self._real = _try_load_cifar(data_root)
        elif real_bank is None and name == "kitti":
            self._real = _try_load_kitti_crops(data_root, self.hw)
        if self._real is not None and with_seg:
            # Seg labels exist for the synthetic generator only.
            warnings.warn(
                f"dataset {name!r} loaded {len(self._real)} real images but "
                "with_seg=True has no real labels; falling back to the "
                "SYNTHETIC image+seg generator", stacklevel=2)
        self._gen = torch.Generator(device=self.device)
        self._step = 0

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._real is not None and not self.with_seg:
            rng = np.random.default_rng((self.seed, self._step))
            self._step += 1
            idx = rng.integers(0, len(self._real), self.batch_size)
            return torch.from_numpy(self._real[idx])
        # Both in the low 32 bits: the CPU generator keeps no more of a seed.
        self._gen.manual_seed((self.seed * 0x9E3779B1 + self._step)
                              & 0x7FFFFFFFFFFFFFFF)
        self._step += 1
        draws = draw_image(self.batch_size, self.hw, self._gen, self.device)
        img, seg = synthetic_image_seg_batch(draws, self.hw)
        return (img, seg) if self.with_seg else img


class PointcloudDraws(NamedTuple):
    """The random values one point-cloud batch consumes (K = N_CLUSTERS)."""
    centers: torch.Tensor     # (B, K, 2) cluster centers inside the range
    assign: torch.Tensor      # (B, N) int in [0, K): a car return's cluster
    car_offs: torch.Tensor    # (B, N, 2) standard normal
    car_z: torch.Tensor       # (B, N) in [0.2, 1.6)
    uni_xy: torch.Tensor      # (B, N, 2) uniform over the range
    ground_z: torch.Tensor    # (B, N) in [0, 0.15)
    clutter_z: torch.Tensor   # (B, N) in [0, 1.8)
    pop_u: torch.Tensor       # (B, N) uniform [0, 1): population
    jitter: torch.Tensor      # (B, N, 2) standard normal
    intensity: torch.Tensor   # (B, N) uniform [0, 1)
    keep_u: torch.Tensor      # (B, N) uniform [0, 1): dropout


def draw_pointcloud(batch: int, max_points: int, generator: torch.Generator,
                    device, x_range=(0.0, 48.0),
                    y_range=(-12.0, 12.0)) -> PointcloudDraws:
    g, dev, n = generator, device, max_points

    def xy(shape, x_margin, y_margin):
        return torch.stack([
            _uniform(shape, x_range[0] + x_margin, x_range[1] - x_margin, g, dev),
            _uniform(shape, y_range[0] + y_margin, y_range[1] - y_margin, g, dev),
        ], dim=-1)

    return PointcloudDraws(
        centers=xy((batch, N_CLUSTERS), 5.0, 2.0),
        assign=torch.randint(0, N_CLUSTERS, (batch, n), generator=g,
                             device=dev),
        car_offs=torch.randn((batch, n, 2), generator=g, device=dev),
        car_z=_uniform((batch, n), 0.2, 1.6, g, dev),
        uni_xy=xy((batch, n), 0.0, 0.0),
        ground_z=_uniform((batch, n), 0.0, 0.15, g, dev),
        clutter_z=_uniform((batch, n), 0.0, 1.8, g, dev),
        pop_u=torch.rand((batch, n), generator=g, device=dev),
        jitter=torch.randn((batch, n, 2), generator=g, device=dev),
        intensity=torch.rand((batch, n), generator=g, device=dev),
        keep_u=torch.rand((batch, n), generator=g, device=dev))


def synthetic_pointcloud_batch(draws: PointcloudDraws, x_range=(0.0, 48.0),
                               y_range=(-12.0, 12.0),
                               with_classes: bool = False):
    """Synthetic semantic LiDAR clouds with sensor noise.

    Three point populations: ~50% GROUND returns (uniform over the range,
    z in [0, 0.15)), ~35% CAR returns (N_CLUSTERS Gaussian clusters, z in
    [0.2, 1.6)), ~15% CLUTTER (uniform, any height). Sensor noise: 0.15 m
    xy jitter on every return and 5% random dropout.

    Returns (points (B,N,4): x,y,z,intensity; mask (B,N) bool); with
    ``with_classes`` also the per-point class (B,N) int32 (1=ground, 2=car,
    3=clutter; 0 is reserved for empty cells).
    """
    d = draws
    ctr = torch.gather(d.centers, 1,
                       d.assign.long().unsqueeze(-1).expand(-1, -1, 2))
    car_xy = ctr + d.car_offs * torch.tensor([2.0, 0.8],
                                             device=d.car_offs.device)
    u = d.pop_u
    cls = torch.where(u < 0.50, 1, torch.where(u < 0.85, 2, 3)).to(torch.int32)
    is_car, is_ground = cls == 2, cls == 1
    xy = torch.where(is_car.unsqueeze(-1), car_xy, d.uni_xy)
    z = torch.where(is_car, d.car_z,
                    torch.where(is_ground, d.ground_z, d.clutter_z))
    xy = xy + 0.15 * d.jitter
    pts = torch.cat([xy, z.unsqueeze(-1), d.intensity.unsqueeze(-1)],
                    dim=-1).float()
    mask = ((pts[..., 0] >= x_range[0]) & (pts[..., 0] < x_range[1])
            & (pts[..., 1] >= y_range[0]) & (pts[..., 1] < y_range[1])
            & (d.keep_u > 0.05))
    if with_classes:
        return pts, mask, cls
    return pts, mask
