"""Reconstruction / segmentation metrics, all on the tensors' device.

Counterpart of ``multimodal_sc_tpu/evaluation/metrics.py``: ``mse``,
``psnr``, ``ssim``, ``ms_ssim``, ``confusion_matrix`` and ``miou``. Images
are NHWC, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def mse(x: torch.Tensor, y: torch.Tensor,
        per_example: bool = False) -> torch.Tensor:
    d = (x.float() - y.float()).square()
    if per_example:
        return d.reshape(d.shape[0], -1).mean(dim=-1)
    return d.mean()


def psnr(x: torch.Tensor, y: torch.Tensor, max_val: float = 1.0,
         per_example: bool = False) -> torch.Tensor:
    """PSNR = 10 log10(MAX^2 / MSE), in dB."""
    m = mse(x, y, per_example=per_example)
    return 10.0 * torch.log10((max_val * max_val) / torch.clamp(m, min=1e-12))


def _gaussian_window(size: int, sigma: float, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (x / sigma).square())
    return g / g.sum()


def _blur(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable depthwise gaussian blur, VALID padding, on NCHW."""
    c, size = x.shape[1], win.shape[0]
    x = F.conv2d(x, win.reshape(1, 1, size, 1).expand(c, 1, size, 1),
                 groups=c)
    return F.conv2d(x, win.reshape(1, 1, 1, size).expand(c, 1, 1, size),
                    groups=c)


def _ssim_maps(x, y, max_val, filter_size, filter_sigma, k1, k2):
    """Per-pixel luminance and contrast-structure maps (Wang et al. 2004)
    of NCHW images, in the VALID-padded gaussian-window form of
    ``tf.image.ssim`` (biased covariances, E[x^2] - E[x]^2)."""
    win = _gaussian_window(filter_size, filter_sigma, x.device)
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    mx, my = _blur(x, win), _blur(y, win)
    mxx, myy, mxy = mx * mx, my * my, mx * my
    vx = _blur(x * x, win) - mxx
    vy = _blur(y * y, win) - myy
    cov = _blur(x * y, win) - mxy
    lum = (2.0 * mxy + c1) / (mxx + myy + c1)
    cs = (2.0 * cov + c2) / (vx + vy + c2)
    return lum, cs


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.float().permute(0, 3, 1, 2)


def ssim(x: torch.Tensor, y: torch.Tensor, max_val: float = 1.0,
         filter_size: int = 11, filter_sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03, per_example: bool = False) -> torch.Tensor:
    """Structural similarity of NHWC image batches in [0, max_val]: an
    11-tap gaussian window of sigma 1.5, VALID padding (``tf.image.ssim``)."""
    lum, cs = _ssim_maps(_nchw(x), _nchw(y), max_val, filter_size,
                         filter_sigma, k1, k2)
    v = (lum * cs).mean(dim=(1, 2, 3))
    return v if per_example else v.mean()


def _downsample2(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean pool, stride 2, of NCHW; an odd side is first extended by
    its last row or column (symmetric padding by one)."""
    h, w = x.shape[2], x.shape[3]
    if h % 2 or w % 2:
        x = F.pad(x, (0, w % 2, 0, h % 2), mode="replicate")
    return F.avg_pool2d(x, 2)


MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def ms_ssim(x: torch.Tensor, y: torch.Tensor, max_val: float = 1.0,
            weights=MS_SSIM_WEIGHTS, filter_size: int = 11,
            filter_sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03,
            per_example: bool = False) -> torch.Tensor:
    """Multi-scale SSIM (``tf.image.ssim_multiscale``): contrast-structure
    at every scale, luminance only at the coarsest, negatives clipped before
    the power weighting, channels averaged last. Needs ``min(H, W) >=
    filter_size * 2 ** (len(weights) - 1)``."""
    if min(x.shape[1], x.shape[2]) < filter_size * 2 ** (len(weights) - 1):
        raise ValueError(
            f"image {x.shape[1]}x{x.shape[2]} too small for "
            f"{len(weights)}-scale MS-SSIM with filter {filter_size}; "
            "pass fewer `weights` or a smaller `filter_size`")
    x, y = _nchw(x), _nchw(y)
    w = torch.tensor(weights, dtype=torch.float32, device=x.device)
    vals = []          # per scale (B, C)
    for i in range(len(weights)):
        lum, cs = _ssim_maps(x, y, max_val, filter_size, filter_sigma, k1, k2)
        m = lum * cs if i == len(weights) - 1 else cs
        vals.append(torch.clamp(m.mean(dim=(2, 3)), min=0.0))
        if i < len(weights) - 1:
            x, y = _downsample2(x), _downsample2(y)
    v = torch.pow(torch.stack(vals, -1), w).prod(dim=-1).mean(dim=-1)
    return v if per_example else v.mean()


def confusion_matrix(pred: torch.Tensor, label: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """(num_classes, num_classes) int32 confusion matrix from int tensors,
    rows the label, columns the prediction."""
    idx = label.reshape(-1).long() * num_classes + pred.reshape(-1).long()
    # A fixed-size scatter-add: no host sync, unlike torch.bincount.
    cm = torch.zeros(num_classes * num_classes, dtype=torch.int32,
                     device=idx.device)
    cm.scatter_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return cm.reshape(num_classes, num_classes)


def miou(pred: torch.Tensor, label: torch.Tensor,
         num_classes: int) -> torch.Tensor:
    """Mean IoU over classes present in either pred or label."""
    return miou_from_confusion(confusion_matrix(pred, label, num_classes))


def miou_from_confusion(cm: torch.Tensor) -> torch.Tensor:
    """Mean IoU of a confusion matrix (classes present in either axis)."""
    cm = cm.float()
    inter = cm.diagonal()
    union = cm.sum(0) + cm.sum(1) - inter
    present = union > 0
    iou = torch.where(present, inter / torch.clamp(union, min=1.0),
                      torch.zeros_like(inter))
    return iou.sum() / torch.clamp(present.sum(), min=1)
