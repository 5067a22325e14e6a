"""Generic multi-head attention on the (B, H, L, D) layout.

Counterpart of ``multimodal_sc_tpu/kernels/attention.py``: the plain
version and the ``attention`` dispatch. The flash kernels of that file
(forward, dQ, fused dK/dV) are still to be ported (ROADMAP section 2, row
5); they serve the shapes ``attention_packed.packed_eligible`` refuses.
"""

from __future__ import annotations

from typing import Optional

import torch


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain softmax attention. q (B,H,Lq,D), k and v (B,H,Lk,D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    probs = torch.softmax(q.float() @ k.float().transpose(-1, -2) * scale,
                          dim=-1)
    return (probs @ v.float()).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: Optional[float] = None,
              use_pallas: bool = False) -> torch.Tensor:
    """Dispatch: the flash kernel when asked for, else the plain version.

    ``use_pallas`` keeps the JAX package's name for "run the hand-written
    kernel". On a CUDA tensor that kernel does not exist yet, and the call
    raises rather than give way to the plain version; on a CPU tensor the
    plain version runs, as for every kernel of the port.
    """
    if use_pallas and q.is_cuda:
        raise NotImplementedError(
            "the flash attention kernels (multimodal_sc_tpu/kernels/"
            "attention.py, ROADMAP section 2 row 5) are not ported yet; "
            "shapes packed_eligible accepts go through packed_attention")
    return attention_reference(q, k, v, scale)
