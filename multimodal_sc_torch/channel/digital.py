"""Digital index transmission: semantic tokens -> bits -> QPSK symbols.

Counterpart of ``multimodal_sc_tpu/channel/digital.py``. The discrete
codebook codec (``codec/semantic_vq.py``) transmits integer codebook
indices. Each index carries log2(codes) bits, little-endian within the
index; the bits ride unit-power QPSK symbols, one bit per I/Q component at
+-1/sqrt(2) (bit 0 -> -1/sqrt(2), consecutive pairs as I, Q); the receiver
hard-decides each component's sign (``y > 0``, so a zero-power symbol
decodes to 0).

Per-bit error over AWGN at linear symbol SNR s is Q(sqrt(s)): each component
carries amplitude 1/sqrt(2) against noise of per-component variance
10^(-snr/10) / 2. Everything here is elementwise integer or float work on
the tensor's own device.
"""

from __future__ import annotations

import math

import torch

_QPSK_AMP = math.sqrt(0.5)   # per-component amplitude; |symbol|^2 == 1


def index_bits(codes: int) -> int:
    """Bits per index; codes must be a power of 4 so indices fill whole
    QPSK symbols (2 bits each)."""
    n = int(round(math.log2(codes)))
    if 2 ** n != codes or n % 2 != 0:
        raise ValueError(
            f"codes must be a power of 4 (whole QPSK symbols), got {codes}")
    return n


def _shifts(n_bits: int, device) -> torch.Tensor:
    return torch.arange(n_bits, dtype=torch.int32, device=device)


def bits_from_indices(idx: torch.Tensor, codes: int) -> torch.Tensor:
    """(B, N) integer indices -> (B, N * bits) 0/1 int32 bits,
    little-endian within each index."""
    n_bits = index_bits(codes)
    bits = (idx.to(torch.int32)[..., None] >> _shifts(n_bits, idx.device)) & 1
    return bits.reshape(idx.shape[0], -1)


def indices_from_bits(bits: torch.Tensor, codes: int) -> torch.Tensor:
    """Inverse of :func:`bits_from_indices`: (B, N * bits) -> (B, N)."""
    n_bits = index_bits(codes)
    grouped = bits.to(torch.int32).reshape(bits.shape[0], -1, n_bits)
    return (grouped << _shifts(n_bits, bits.device)).sum(-1).to(torch.int32)


def bits_to_qpsk(bits: torch.Tensor) -> torch.Tensor:
    """(B, M) 0/1 bits (M even) -> (B, M/2, 2) unit-power QPSK symbols."""
    comps = bits.reshape(bits.shape[0], -1, 2)
    return (comps.to(torch.float32) * 2.0 - 1.0) * _QPSK_AMP


def qpsk_to_bits(y: torch.Tensor) -> torch.Tensor:
    """Hard decision, the inverse of :func:`bits_to_qpsk`:
    (B, M/2, 2) received symbols -> (B, M) 0/1 int32 bits."""
    return (y > 0).to(torch.int32).reshape(y.shape[0], -1)


def qpsk_soft_bits(y: torch.Tensor) -> torch.Tensor:
    """(B, M/2, 2) received symbols -> (B, M) soft bit values (sign = hard
    decision, magnitude = reliability) for ``fec.hamming74_decode_soft``.
    Over AWGN the raw component is the maximum-likelihood bit metric up to
    a positive scale."""
    return y.reshape(y.shape[0], -1).to(torch.float32)


def indices_to_qpsk(idx: torch.Tensor, codes: int) -> torch.Tensor:
    """(B, N) indices -> (B, N * bits/2, 2) unit-power QPSK symbols."""
    return bits_to_qpsk(bits_from_indices(idx, codes))


def qpsk_to_indices(y: torch.Tensor, codes: int) -> torch.Tensor:
    """Hard-decision inverse of :func:`indices_to_qpsk`:
    (B, N * bits/2, 2) received symbols -> (B, N) int32."""
    return indices_from_bits(qpsk_to_bits(y), codes)


def qpsk_ber_awgn_theory(snr_db: float) -> float:
    """Closed-form per-bit error rate of unit-power QPSK over AWGN."""
    snr = 10.0 ** (snr_db / 10.0)
    return 0.5 * math.erfc(math.sqrt(snr) / math.sqrt(2.0))
