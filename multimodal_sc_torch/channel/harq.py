"""Type-I HARQ with CRC-8 block detection and chase combining for the
digital semantic-token path.

Counterpart of ``multimodal_sc_tpu/channel/harq.py``. Parameter-transparent
like FEC: the same trained VQ checkpoint deploys one-shot, coded or under
HARQ; this module only changes how the bits cross the channel.

Protocol (stop-and-wait Type-I chase): the payload is split into fixed
blocks, each extended with a CRC-8 (x^8 + x^2 + x + 1, CRC-8/ATM); the
receiver hard-decides, checks each block's CRC and NACKs failures over an
error-free feedback link; failed blocks are sent again, up to
``max_rounds`` rounds, and the receiver sums the raw received symbols of
all copies (for AWGN that is maximal-ratio combining). Every round draws a
fresh channel over the whole payload, but only still-failed blocks join the
sum and count toward the bandwidth. The rounds are a short Python loop over
device tensors; nothing is read back to the host between rounds.

A block survives only if its CRC passes, so residual index errors come
from CRC-undetected patterns (~2^-8 per corrupted block) or from blocks
still failing after ``max_rounds`` (``residual_fail_rate``).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from multimodal_sc_torch.channel.digital import bits_to_qpsk, qpsk_to_bits
from multimodal_sc_torch.channel.fec import gf2_matmul
from multimodal_sc_torch.channel.layer import ChannelDraws
from multimodal_sc_torch.channel.layer import channel as channel_op

CRC8_POLY = 0x07          # x^8 + x^2 + x + 1 (CRC-8/ATM)


def _crc8_of_message(msg_bits) -> int:
    """Bit-true CRC-8 of a list of 0/1 bits, the reference from which the
    GF(2) generator matrix is built (linearity does the rest)."""
    reg = 0
    for b in msg_bits:
        reg ^= int(b) << 7
        if reg & 0x80:
            reg = ((reg << 1) ^ CRC8_POLY) & 0xFF
        else:
            reg = (reg << 1) & 0xFF
    return reg


def crc_matrix(k: int, c: int = 8) -> np.ndarray:
    """(k, c) GF(2) generator: crc_bits = msg_bits @ G mod 2. The CRC of a
    message is the XOR of the CRCs of its one-hot parts, so G's rows are
    exactly those."""
    if c != 8:
        raise ValueError(f"only CRC-8 is implemented, got c={c}")
    g = np.zeros((k, c), np.int32)
    for i in range(k):
        msg = [0] * k
        msg[i] = 1
        crc = _crc8_of_message(msg)
        g[i] = [(crc >> (c - 1 - j)) & 1 for j in range(c)]
    return g


@functools.lru_cache(maxsize=None)
def _crc_table(k: int, c: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(crc_matrix(k, c), device=device)


def _crc(bits: torch.Tensor, c: int) -> torch.Tensor:
    return gf2_matmul(bits, _crc_table(bits.shape[-1], c, bits.device))


def crc_append(bits: torch.Tensor, c: int = 8) -> torch.Tensor:
    """(B, nb, k) message bits -> (B, nb, k + c) with the CRC appended."""
    bits = bits.to(torch.int32)
    return torch.cat([bits, _crc(bits, c)], dim=-1)


def crc_check(bits: torch.Tensor, c: int = 8) -> torch.Tensor:
    """(B, nb, k + c) received bits -> (B, nb) bool CRC-pass mask."""
    k = bits.shape[-1] - c
    return (_crc(bits[..., :k], c) == bits[..., k:]).all(dim=-1)


def harq_transmit(
    bits: torch.Tensor, snr_db, kind: str,
    generator: Optional[torch.Generator] = None, *,
    block_bits: int = 64, crc_bits: int = 8, max_rounds: int = 4,
    draws: Optional[Sequence[Union[torch.Tensor, ChannelDraws]]] = None,
    **channel_kw,
) -> Tuple[torch.Tensor, dict]:
    """Carry (B, M) payload bits over the channel under Type-I HARQ.

    ``draws`` (optional): one channel draw per round (the AWGN noise of the
    (B, nb * symbols per block, 2) payload, or a ``ChannelDraws``), in place
    of draws from ``generator``. Returns ``(bits_rx (B, M) int32, info)``,
    info holding 0-d f32 tensors:

    - ``symbols_per_item``: mean QPSK symbols sent per payload (CRC
      overhead and retransmissions included);
    - ``mean_rounds``: mean transmission rounds per block;
    - ``residual_fail_rate``: blocks still failing after ``max_rounds``;
    - ``oneshot_symbols``: what one CRC-less shot would have cost.
    """
    b, m = bits.shape
    if m % block_bits != 0:
        raise ValueError(f"payload of {m} bits not divisible into "
                         f"{block_bits}-bit blocks")
    if (block_bits + crc_bits) % 2 != 0:
        raise ValueError("block_bits + crc_bits must fill whole QPSK "
                         "symbols (even)")
    nb = m // block_bits
    coded = crc_append(bits.reshape(b, nb, block_bits), crc_bits)
    spb = (block_bits + crc_bits) // 2          # symbols per block
    sym = bits_to_qpsk(coded.reshape(b, -1)).reshape(b, nb, spb, 2)

    channel_kw.setdefault("normalize", False)   # QPSK is unit power
    channel_kw.setdefault("modulation", 0)

    accum = torch.zeros_like(sym)               # chase-combining sum
    failed = torch.ones((b, nb), dtype=torch.bool, device=bits.device)
    rounds = torch.zeros((b, nb), dtype=torch.int32, device=bits.device)
    for r in range(max_rounds):
        y = channel_op(sym.reshape(b, nb * spb, 2), snr_db, kind, generator,
                       noise=None if draws is None else draws[r],
                       **channel_kw).reshape(b, nb, spb, 2)
        # Only still-failed blocks are (re)transmitted and combined.
        accum = accum + torch.where(failed[:, :, None, None], y, 0.0)
        rounds = rounds + failed.to(torch.int32)
        dec = qpsk_to_bits(accum.reshape(b, nb * spb, 2)).reshape(
            b, nb, block_bits + crc_bits)
        failed = failed & ~crc_check(dec, crc_bits)

    bits_rx = dec[..., :block_bits].reshape(b, m)
    info = {
        "symbols_per_item": rounds.sum(1).to(torch.float32).mean() * spb,
        "mean_rounds": rounds.to(torch.float32).mean(),
        "residual_fail_rate": failed.to(torch.float32).mean(),
        "oneshot_symbols": torch.tensor(m / 2, dtype=torch.float32,
                                        device=bits.device),
    }
    return bits_rx, info
