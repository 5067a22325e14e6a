"""Forward error correction for the digital semantic-token path.

Counterpart of ``multimodal_sc_tpu/channel/fec.py``: Hamming(7,4) between
the VQ codec's index bits and the QPSK mapper (``channel/digital.py``).
Every 4 payload bits become a 7-bit codeword that corrects any single bit
error, at a 7/4 bandwidth cost. The code sits between the indices and the
modulator, so one trained VQ checkpoint deploys coded or uncoded
(``channel.fec``).

Positional construction: parity at positions 1, 2, 4 and data at 3, 5, 6,
7 (1-indexed), so the 3-bit syndrome is the binary error position. The
products over GF(2) are written as broadcast integer sums (a CUDA tensor
has no integer matmul); the soft decoder's correlations as broadcast float
sums, so no TF32 setting can round them.

With per-bit channel error rate p a block decodes wrong iff >= 2 of its 7
bits flip: P_block = 1 - (1-p)^7 - 7 p (1-p)^6.
"""

from __future__ import annotations

import itertools

import torch

# Codeword c[0..6] = positions 1..7: parity p1 p2 at c[0] c[1], data d0 at
# c[2], parity p4 at c[3], data d1 d2 d3 at c[4] c[5] c[6].
_DATA_POS = (2, 4, 5, 6)

# Row i = codeword bit i's dependence on (d0, d1, d2, d3), mod 2.
_G = ((1, 1, 0, 1),   # p1 = d0 + d1 + d3
      (1, 0, 1, 1),   # p2 = d0 + d2 + d3
      (1, 0, 0, 0),   # d0
      (0, 1, 1, 1),   # p4 = d1 + d2 + d3
      (0, 1, 0, 0),   # d1
      (0, 0, 1, 0),   # d2
      (0, 0, 0, 1))   # d3

# Syndrome rows: bit k of the (1-indexed) error position, s = H r mod 2.
_H = ((1, 0, 1, 0, 1, 0, 1),
      (0, 1, 1, 0, 0, 1, 1),
      (0, 0, 0, 1, 1, 1, 1))


def _table(rows, device) -> torch.Tensor:
    return torch.tensor(rows, dtype=torch.int32, device=device)


def gf2_matmul(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(..., k) 0/1 ints times (k, n) 0/1 ints over GF(2) -> (..., n)."""
    return (a.to(torch.int32)[..., None] * m).sum(-2) % 2


def hamming74_encode(bits: torch.Tensor) -> torch.Tensor:
    """(..., 4k) payload bits -> (..., 7k) coded bits (int32 0/1)."""
    if bits.shape[-1] % 4 != 0:
        raise ValueError(
            f"payload bit count must be a multiple of 4, got "
            f"{tuple(bits.shape)}")
    nibbles = bits.reshape(*bits.shape[:-1], -1, 4)
    coded = gf2_matmul(nibbles, _table(_G, bits.device).T)
    return coded.reshape(*bits.shape[:-1], -1).to(torch.int32)


def hamming74_decode(bits: torch.Tensor) -> torch.Tensor:
    """(..., 7k) received hard bits -> (..., 4k) corrected payload bits.

    Corrects any single flipped bit per 7-bit block; >= 2 flips decode to
    a wrong but valid word."""
    if bits.shape[-1] % 7 != 0:
        raise ValueError(
            f"coded bit count must be a multiple of 7, got "
            f"{tuple(bits.shape)}")
    words = bits.to(torch.int32).reshape(*bits.shape[:-1], -1, 7)
    syndrome = gf2_matmul(words, _table(_H, bits.device).T)  # (..., k, 3)
    pos = syndrome[..., 0] + 2 * syndrome[..., 1] + 4 * syndrome[..., 2]
    flip = (pos[..., None] == torch.arange(
        1, 8, dtype=torch.int32, device=bits.device)).to(torch.int32)
    data = ((words + flip) % 2)[..., list(_DATA_POS)]
    return data.reshape(*bits.shape[:-1], -1)


def all_codewords(device=None):
    """``(codewords (16, 7), data (16, 4))`` int32: every Hamming(7,4)
    word, the data rows in the JAX package's order (d0 slowest), so the
    soft decoder's argmax picks the same word on a tie."""
    data = _table(list(itertools.product((0, 1), repeat=4)), device)
    return gf2_matmul(data, _table(_G, device).T), data


def hamming74_decode_soft(soft: torch.Tensor) -> torch.Tensor:
    """Maximum-likelihood soft-decision decode: (..., 7k) soft bit values
    (sign = hard decision, magnitude = reliability, e.g. the received QPSK
    components) -> (..., 4k) data bits. Each 7-block is correlated with
    all 16 codewords; the first best one wins."""
    if soft.shape[-1] % 7 != 0:
        raise ValueError(
            f"coded bit count must be a multiple of 7, got "
            f"{tuple(soft.shape)}")
    codes, data = all_codewords(soft.device)
    signs = (2.0 * codes - 1.0).to(torch.float32)           # (16, 7)
    words = soft.to(torch.float32).reshape(*soft.shape[:-1], -1, 7)
    scores = (words[..., None, :] * signs).sum(-1)          # (..., k, 16)
    out = data[scores.argmax(dim=-1)]                       # (..., k, 4)
    return out.reshape(*soft.shape[:-1], -1)


def hamming74_block_error_theory(ber: float) -> float:
    """Closed-form block (4-bit nibble) error probability at channel
    bit-error rate ``ber``: wrong iff >= 2 of the 7 coded bits flip."""
    q = 1.0 - ber
    return 1.0 - q ** 7 - 7.0 * ber * q ** 6
