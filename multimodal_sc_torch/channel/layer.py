"""Differentiable power-normalized channel layer (ideal / AWGN).

Counterpart of ``multimodal_sc_tpu/channel/layer.py``. Complex channel
symbols stay trailing real/imag pairs ``(..., 2)``. Randomness comes from
an explicit ``torch.Generator``; ``awgn`` also takes the noise itself, so a
test can hand in the JAX package's draw.

Math: z_norm = z * sqrt(k) / ||z|| per example (k complex symbols, unit
average power); AWGN y = z + n with n ~ CN(0, 10^(-snr/10)), each real
component of variance sigma^2 / 2.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

CHANNEL_KINDS = ("ideal", "awgn", "rayleigh", "rician", "ofdm")
PORTED_KINDS = ("ideal", "awgn")


def _num_complex_symbols(z: torch.Tensor) -> int:
    """Number of complex symbols per example for z of shape (B, ..., 2)."""
    if z.shape[-1] != 2:
        raise ValueError(
            f"channel symbols must have trailing real/imag dim 2, got "
            f"{tuple(z.shape)}")
    k = 1
    for d in z.shape[1:-1]:
        k *= d
    return k


def power_normalize(z: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize each example to unit average complex-symbol power."""
    k = _num_complex_symbols(z)
    dims = tuple(range(1, z.dim()))
    sq = z.square().sum(dim=dims, keepdim=True)
    root_k = torch.sqrt(torch.tensor(float(k), dtype=z.dtype, device=z.device))
    return z * (root_k * torch.rsqrt(sq + eps))


def _broadcast_snr(snr_db: Union[float, torch.Tensor],
                   z: torch.Tensor) -> torch.Tensor:
    """Scalar or per-example (B,) snr, shaped to broadcast against z."""
    snr = torch.as_tensor(snr_db, dtype=z.dtype, device=z.device)
    if snr.dim() == 0:
        return snr
    if snr.dim() == 1 and snr.shape[0] == z.shape[0]:
        return snr.reshape((z.shape[0],) + (1,) * (z.dim() - 1))
    raise ValueError(f"snr_db must be scalar or shape ({z.shape[0]},), got "
                     f"{tuple(snr.shape)}")


def _noise_sigma(snr_db: torch.Tensor) -> torch.Tensor:
    """Per-real-component std dev for unit-power symbols at snr_db."""
    noise_power = torch.pow(torch.tensor(10.0, dtype=snr_db.dtype,
                                         device=snr_db.device),
                            -snr_db / 10.0)
    return torch.sqrt(noise_power / 2.0)


def awgn(z: torch.Tensor, snr_db: Union[float, torch.Tensor],
         generator: Optional[torch.Generator] = None,
         noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = z + sigma * n, n standard normal of z's shape.

    ``noise`` (optional) supplies n; otherwise it is drawn from
    ``generator`` on z's device."""
    sigma = _noise_sigma(_broadcast_snr(snr_db, z))
    if noise is None:
        noise = torch.randn(z.shape, generator=generator, dtype=z.dtype,
                            device=z.device)
    return z + sigma * noise


def channel_kwargs(ch) -> dict:
    """``channel()`` kwargs from a ChannelConfig (as the JAX package)."""
    return dict(normalize=ch.normalize, modulation=ch.modulation,
                pilots=ch.pilots, subcarriers=ch.ofdm_subcarriers,
                taps=ch.ofdm_taps)


def channel(z: torch.Tensor, snr_db: Union[float, torch.Tensor], kind: str,
            generator: Optional[torch.Generator] = None,
            normalize: bool = True, modulation: int = 0, pilots: int = 0,
            subcarriers: int = 64, taps: int = 8,
            mask: Optional[torch.Tensor] = None,
            noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Power-normalize then apply the selected channel.

    Ported kinds: ``ideal`` and ``awgn``. Fading kinds, M-QAM modulation
    and adaptive-rate masks raise until ROADMAP items 2 and 14 port them.
    ``subcarriers``/``taps`` (OFDM only) are accepted for signature parity.
    """
    if kind not in CHANNEL_KINDS:
        raise ValueError(f"kind must be one of {CHANNEL_KINDS}, got {kind!r}")
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"channel kind {kind!r} is not ported yet (ROADMAP item 2)")
    if modulation or mask is not None or pilots:
        raise NotImplementedError(
            "modulation, pilots and adaptive-rate masks are not ported yet "
            "(ROADMAP items 2 and 14)")
    if normalize:
        z = power_normalize(z)
    if kind == "ideal":
        return z
    return awgn(z, snr_db, generator, noise)
