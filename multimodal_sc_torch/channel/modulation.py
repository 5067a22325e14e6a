"""Digital modulation: square M-QAM mapping of channel symbols.

Counterpart of ``multimodal_sc_tpu/channel/modulation.py``. Each I/Q
component is quantized to sqrt(M) uniform levels with unit average symbol
power, trained with a straight-through estimator (the hard constellation
point forward, an identity gradient backward). The digital index link, its
FEC and HARQ are ``channel/digital.py``, ``fec.py`` and ``harq.py``; its
entropy coding is ``entropy_coding.py``.
"""

from __future__ import annotations

import math

import torch


def qam_levels(m: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Per-component levels of unit-average-power square M-QAM:
    +-{1, 3, ..} d with d = sqrt(3 / (2 (M - 1)))."""
    side = math.isqrt(m)
    if side * side != m or side < 2:
        raise ValueError(f"M must be a square >= 4, got {m}")
    d = math.sqrt(3.0 / (2.0 * (m - 1)))
    i = torch.arange(side, dtype=dtype, device=device)
    return (2 * i - (side - 1)) * d


def qam_demodulate_indices(z_hat: torch.Tensor, m: int = 16) -> torch.Tensor:
    """Hard-decision per-component level indices (..., 2) int32 (the
    nearest level; a tie at a midpoint goes to the lower one)."""
    levels = qam_levels(m, z_hat.dtype, z_hat.device)
    return (z_hat[..., None] - levels).abs().argmin(dim=-1).to(torch.int32)


def qam_modulate(z: torch.Tensor, m: int = 16) -> torch.Tensor:
    """Map (..., 2) symbols to the nearest M-QAM point, straight-through:
    the hard point forward, the identity backward. Input should be roughly
    unit-power (after power normalization)."""
    levels = qam_levels(m, z.dtype, z.device)
    hard = levels[qam_demodulate_indices(z, m).long()]
    return z + (hard - z).detach()


def symbol_error_rate(z_tx: torch.Tensor, z_rx: torch.Tensor,
                      m: int = 16) -> torch.Tensor:
    """Fraction of complex symbols whose hard decision changed in transit."""
    wrong = (qam_demodulate_indices(z_tx, m)
             != qam_demodulate_indices(z_rx, m)).any(dim=-1)
    return wrong.float().mean()


def qam_ser_awgn_theory(m: int, snr_db: float) -> float:
    """Closed-form square-M-QAM SER over AWGN: 1 - (1 - p)^2 with
    p = 2 (1 - 1/sqrt(M)) Q(sqrt(3 snr / (M - 1)))."""
    snr = 10.0 ** (snr_db / 10.0)
    x = math.sqrt(3.0 * snr / (m - 1))
    q = 0.5 * math.erfc(x / math.sqrt(2.0))
    p = 2.0 * (1.0 - 1.0 / math.sqrt(m)) * q
    return 1.0 - (1.0 - p) ** 2
