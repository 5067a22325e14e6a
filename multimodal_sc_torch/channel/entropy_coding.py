"""Entropy-aware index transport for the digital semantic-token links.

Counterpart of ``multimodal_sc_tpu/channel/entropy_coding.py``. The
fixed-length digital link (``channel/digital.py``) spends log2(codes) bits
on every token whatever the trained code distribution. Two
parameter-transparent deployments of the same checkpoint spend fewer:

* **Variable-length (Huffman)**: a canonical Huffman code built on the host
  from the trained code distribution; a batched encode into a padded bit
  buffer (:func:`encode_vlc`), zero-power padding beyond each item's actual
  length, and a table-automaton decode. One bit error can desynchronise the
  rest of the stream, which the SNR sweep measures.
* **Re-alphabet** (:func:`topk_remap`): keep the ``2^b`` most used codes,
  snap the rest to their nearest kept code in codebook space, and send
  fixed ``b``-bit indices through the existing uncoded / FEC / HARQ link.

Probabilities are floored at ``P_FLOOR`` so every code stays encodable and
the padded buffer stays small. Symbols an item: ceil(total_bits / 2).

The code construction (``huffman_lengths``, ``canonical_code``,
``decode_table``, ``entropy_bits``, ``topk_remap``) is numpy and ``heapq`` on
the host, with the JAX package's tie rules: the heap orders ``(p, uid)``,
the canonical order is ``np.lexsort`` by length then symbol, and the kept
codes are ``np.argsort(-p)[:keep_codes]`` with numpy's default sort kind.
Bits are MSB-first within a codeword. :func:`decode_vlc` walks the
automaton one bit position at a time over the whole batch (the parity
twin; at ~6,000 bits an item it is slow); the sweep decodes on the host
with :func:`decode_vlc_np`, as the JAX package does.
"""

from __future__ import annotations

import heapq
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from multimodal_sc_torch.channel.digital import bits_to_qpsk, qpsk_to_bits
from multimodal_sc_torch.channel.layer import channel as channel_op

P_FLOOR = 1e-4


def huffman_lengths(probs: np.ndarray) -> np.ndarray:
    """Codeword length per symbol of a binary Huffman code on ``probs``
    (floored at ``P_FLOOR`` and renormalised, so unused codes stay
    encodable); heap ties broken by node id."""
    p = np.maximum(np.asarray(probs, np.float64), P_FLOOR)
    p = p / p.sum()
    k = p.shape[0]
    if k == 1:
        return np.array([1], np.int32)
    heap = [(p[i], i, ("leaf", i)) for i in range(k)]
    heapq.heapify(heap)
    uid = k
    while len(heap) > 1:
        pa, _, a = heapq.heappop(heap)
        pb, _, b = heapq.heappop(heap)
        heapq.heappush(heap, (pa + pb, uid, ("node", a, b)))
        uid += 1
    lens = np.zeros(k, np.int32)
    stack = [(heap[0][2], 0)]
    while stack:
        node, depth = stack.pop()
        if node[0] == "leaf":
            lens[node[1]] = max(depth, 1)
        else:
            stack.append((node[1], depth + 1))
            stack.append((node[2], depth + 1))
    return lens


def canonical_code(lens: np.ndarray) -> np.ndarray:
    """Canonical Huffman codewords from lengths: (K, Lmax) 0/1 int32, MSB
    first, row i valid for lens[i] bits."""
    k = lens.shape[0]
    lmax = int(lens.max())
    order = np.lexsort((np.arange(k), lens))     # by length, then symbol
    codes = np.zeros((k, lmax), np.int32)
    code = 0
    prev_len = 0
    for sym in order:
        n = int(lens[sym])
        code <<= (n - prev_len)
        prev_len = n
        for j in range(n):
            codes[sym, j] = (code >> (n - 1 - j)) & 1
        code += 1
    return codes


def decode_table(lens: np.ndarray, codes: np.ndarray):
    """The binary decode automaton: children (n_nodes, 2) int32 node ids
    and emit (n_nodes,) int32 (the symbol at a leaf, -1 inside). Node 0 is
    the root; a child that no codeword reaches points back to it."""
    children = [[-1, -1]]
    emit = [-1]
    for sym in range(lens.shape[0]):
        node = 0
        for j in range(int(lens[sym])):
            b = int(codes[sym, j])
            if children[node][b] == -1:
                children.append([-1, -1])
                emit.append(-1)
                children[node][b] = len(children) - 1
            node = children[node][b]
        emit[node] = sym
    ch = np.asarray(children, np.int32)
    ch[ch < 0] = 0
    return ch, np.asarray(emit, np.int32)


class HuffmanCodec(NamedTuple):
    """Canonical Huffman tables, as tensors on the link's device."""

    code_bits: torch.Tensor   # (K, Lmax) 0/1 int32, MSB first
    code_len: torch.Tensor    # (K,) int32
    children: torch.Tensor    # (n_nodes, 2) int32
    emit: torch.Tensor        # (n_nodes,) int32, -1 = internal

    @property
    def lmax(self) -> int:
        return self.code_bits.shape[1]


def build_huffman(probs, device="cpu") -> HuffmanCodec:
    lens = huffman_lengths(np.asarray(probs))
    codes = canonical_code(lens)
    ch, emit = decode_table(lens, codes)
    return HuffmanCodec(*(torch.as_tensor(a, device=device)
                          for a in (codes, lens, ch, emit)))


def entropy_bits(probs) -> float:
    p = np.maximum(np.asarray(probs, np.float64), 0.0)
    p = p / p.sum()
    nz = p[p > 0]
    return float(-(nz * np.log2(nz)).sum())


def encode_vlc(codec: HuffmanCodec, idx: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N) indices -> (bits (B, M) int32 with M = N * Lmax rounded up to
    even, total_len (B,) int32). Each row's codewords are scattered into an
    (M + 1)-wide buffer whose last slot takes the invalid positions; bits
    beyond total_len are zero padding."""
    b, n = idx.shape
    lmax = codec.lmax
    m = n * lmax + (n * lmax) % 2
    i = idx.long()
    lens = codec.code_len[i].long()                           # (B, N)
    offs = lens.cumsum(1) - lens
    j = torch.arange(lmax, device=idx.device)
    pos = torch.where(j < lens[..., None], offs[..., None] + j, m)
    out = torch.zeros((b, m + 1), dtype=torch.int32, device=idx.device)
    out.scatter_(1, pos.reshape(b, -1), codec.code_bits[i].reshape(b, -1))
    return out[:, :m], lens.sum(1).to(torch.int32)


def decode_vlc(codec: HuffmanCodec, bits: torch.Tensor,
               total_len: torch.Tensor, n_tokens: int) -> torch.Tensor:
    """(B, M) hard bits -> (B, N) int32 indices through the automaton, one
    bit position a step over the whole batch: a symbol is emitted at each
    leaf, bits at or past ``total_len`` are ignored, and tokens a
    desynchronised stream never reaches decode as code 0."""
    b, m = bits.shape
    dev = bits.device
    rows = torch.arange(b, device=dev)
    node = torch.zeros(b, dtype=torch.long, device=dev)
    cnt = torch.zeros(b, dtype=torch.long, device=dev)
    out = torch.zeros((b, n_tokens), dtype=torch.int32, device=dev)
    children, emit = codec.children.long(), codec.emit
    total = total_len.long()
    for i in range(m):
        nxt = children[node, bits[:, i].long()]
        sym = emit[nxt]
        is_leaf = sym >= 0
        active = (i < total) & (cnt < n_tokens)
        emit_now = is_leaf & active
        slot = cnt.clamp(max=n_tokens - 1)
        out[rows, slot] = torch.where(emit_now, sym, out[rows, slot])
        cnt = cnt + emit_now.long()
        node = torch.where(active, torch.where(is_leaf, 0, nxt), node)
    return out


def decode_vlc_np(codec: HuffmanCodec, bits, total_len,
                  n_tokens: int) -> np.ndarray:
    """The host twin of :func:`decode_vlc`: the receiver's sequential
    automaton walk, item by item, on numpy (or host-copied) inputs; the
    SNR sweep decodes with it."""
    ch = np.asarray(codec.children.cpu()).tolist()
    emit = np.asarray(codec.emit.cpu()).tolist()
    bits = np.asarray(bits.cpu() if torch.is_tensor(bits) else bits)
    total_len = np.asarray(total_len.cpu() if torch.is_tensor(total_len)
                           else total_len)
    out = np.zeros((bits.shape[0], n_tokens), np.int32)
    for i in range(bits.shape[0]):
        row = bits[i].tolist()
        node = 0
        cnt = 0
        for j in range(int(total_len[i])):
            if cnt >= n_tokens:
                break
            node = ch[node][row[j]]
            sym = emit[node]
            if sym >= 0:
                out[i, cnt] = sym
                cnt += 1
                node = 0
    return out


def vlc_symbols(bits: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """The QPSK symbols of a VLC buffer with zero power past each row's
    length: (B, M/2, 2), symbol j active where ``2 * j < total``."""
    sym = bits_to_qpsk(bits)
    j = torch.arange(sym.shape[1], device=bits.device)
    active = (j[None, :] * 2 < total[:, None]).to(torch.float32)
    return sym * active[..., None]


def transmit_vlc(codec: HuffmanCodec, idx_tx: torch.Tensor, snr_db,
                 kind: str, n_tokens: int,
                 generator: Optional[torch.Generator] = None, noise=None,
                 **channel_kw):
    """The whole variable-length link: encode -> zero-power-padded QPSK ->
    channel (unnormalised) -> hard bits -> automaton decode. Returns
    ``(idx_rx, info)`` with the exact symbol accounting. ``noise``: the
    channel's draws, in place of draws from ``generator``."""
    bits, total = encode_vlc(codec, idx_tx)
    channel_kw.setdefault("normalize", False)
    channel_kw.setdefault("modulation", 0)
    y = channel_op(vlc_symbols(bits, total), snr_db, kind, generator,
                   noise=noise, **channel_kw)
    idx_rx = decode_vlc(codec, qpsk_to_bits(y), total, n_tokens)
    info = {"symbols_per_item": torch.ceil(total / 2.0).mean(),
            "bits_per_token": total.float().mean() / n_tokens,
            "fixed_symbols_per_item": torch.tensor(
                n_tokens * int(np.log2(codec.code_len.shape[0])) / 2,
                dtype=torch.float32)}
    return idx_rx, info


def topk_remap(probs, codebook, keep_codes: int,
               device="cpu") -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Re-alphabet tables: keep the ``keep_codes`` most used codes and map
    every full-alphabet index to its nearest kept code in codebook space.
    Returns ``(kept_ids (k,) int32, full_to_small (K,) int32,
    small_codebook (k, D))`` as tensors on ``device``."""
    p = np.asarray(probs)
    kept = np.sort(np.argsort(-p)[:keep_codes])
    cb = np.asarray(codebook.detach().cpu() if torch.is_tensor(codebook)
                    else codebook)
    d2 = ((cb[:, None, :] - cb[kept][None, :, :]) ** 2).sum(-1)   # (K, k)
    full_to_small = np.argmin(d2, axis=1).astype(np.int32)
    return tuple(torch.as_tensor(a, device=device) for a in (
        kept.astype(np.int32), full_to_small, cb[kept]))
