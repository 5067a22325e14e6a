"""Reconstruction / segmentation metrics, all on the tensors' device.

Counterpart of ``multimodal_sc_tpu/evaluation/metrics.py``: ``mse``,
``psnr``, ``confusion_matrix`` and ``miou``. ``ssim`` and ``ms_ssim`` are
not ported and raise (ROADMAP item 12).
"""

from __future__ import annotations

import torch


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


def ssim(*args, **kwargs):
    raise NotImplementedError("ssim is not ported yet (ROADMAP item 12)")


def ms_ssim(*args, **kwargs):
    raise NotImplementedError("ms_ssim is not ported yet (ROADMAP item 12)")


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
    cm = confusion_matrix(pred, label, num_classes).float()
    inter = cm.diagonal()
    union = cm.sum(0) + cm.sum(1) - inter
    present = union > 0
    iou = torch.where(present, inter / torch.clamp(union, min=1.0),
                      torch.zeros_like(inter))
    return iou.sum() / torch.clamp(present.sum(), min=1)
