"""The port's entropy-aware index transport against the JAX package on the
CPU (``channel/entropy_coding.py``).

* the Huffman lengths, canonical codewords and decode tables, equal,
  including tied and floored probabilities and tied usage histograms;
* ``encode_vlc`` bit-equal; ``decode_vlc`` and ``decode_vlc_np`` equal to
  JAX's ``decode_vlc`` and ``decode_vlc_np`` on clean bits and on bits
  with flips (a desynchronised stream);
* ``transmit_vlc`` given JAX's channel noise, equal;
* ``topk_remap`` and ``entropy_bits`` equal on tied histograms.

All of it integer work or f64 on the host: held exactly (``entropy_bits``
to 1e-12).
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_sc_torch
from multimodal_sc_torch.channel import entropy_coding as tec
from multimodal_sc_tpu.channel import entropy_coding as jec

PKG = pathlib.Path(multimodal_sc_torch.__file__).parent


def _histograms():
    rng = np.random.default_rng(0)
    return {
        # Skewed usage with many zero (floored) and tied counts, as a
        # trained codebook's histogram.
        "usage": np.bincount(np.minimum(rng.geometric(0.15, 600), 63),
                             minlength=64) / 600.0,
        "uniform": np.full(16, 1 / 16),
        "tied_pairs": np.repeat(rng.integers(0, 5, 32), 2).astype(
            np.float64),
        "one_hot": np.eye(16)[3],
        "single": np.ones(1),
    }


@pytest.mark.parametrize("name", list(_histograms()))
def test_huffman_tables_equal_jax(name):
    p = _histograms()[name]
    lens = tec.huffman_lengths(p)
    np.testing.assert_array_equal(lens, jec.huffman_lengths(p))
    assert lens.dtype == np.int32
    codes = tec.canonical_code(lens)
    np.testing.assert_array_equal(codes, jec.canonical_code(lens))
    for got, want in zip(tec.decode_table(lens, codes),
                         jec.decode_table(lens, codes)):
        np.testing.assert_array_equal(got, want)
    # Kraft equality: a complete prefix code.
    if len(p) > 1:
        assert np.sum(2.0 ** -lens.astype(np.float64)) == 1.0
    assert tec.entropy_bits(p) == pytest.approx(jec.entropy_bits(p),
                                                abs=1e-12)


def _codecs(name):
    p = _histograms()[name]
    return p, tec.build_huffman(p), jec.build_huffman(p)


@pytest.mark.parametrize("name", ["usage", "tied_pairs"])
def test_encode_and_decode_vlc_equal_jax(name):
    """Indices drawn from the histogram (and a few of its rarest codes):
    the bit buffer and lengths bit-equal; every decoder agrees on clean
    bits, and on bits with flips past which the stream desynchronises."""
    p, tc, jc = _codecs(name)
    rng = np.random.default_rng(1)
    n = 24
    idx = rng.choice(len(p), size=(3, n), p=p / p.sum()).astype(np.int32)
    idx[2, :4] = np.argsort(p)[:4]
    jbits, jtotal = jec.encode_vlc(jc, jnp.asarray(idx))
    bits, total = tec.encode_vlc(tc, torch.from_numpy(idx))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    np.testing.assert_array_equal(total.numpy(), np.asarray(jtotal))
    assert bits.dtype == total.dtype == torch.int32
    assert bits.shape[1] % 2 == 0
    flipped = bits.clone()
    for row, pos in ((0, 3), (1, 0), (1, 17), (2, 9)):
        flipped[row, pos] ^= 1
    for b in (bits, flipped):
        want = np.asarray(jec.decode_vlc(jc, jnp.asarray(b.numpy()), jtotal,
                                         n))
        np.testing.assert_array_equal(
            jec.decode_vlc_np(jc, b.numpy(), np.asarray(jtotal), n), want)
        np.testing.assert_array_equal(tec.decode_vlc(tc, b, total, n).numpy(),
                                      want)
        np.testing.assert_array_equal(tec.decode_vlc_np(tc, b, total, n),
                                      want)
    np.testing.assert_array_equal(tec.decode_vlc(tc, bits, total, n).numpy(),
                                  idx)
    assert not np.array_equal(tec.decode_vlc_np(tc, flipped, total, n), idx)


@pytest.mark.parametrize("snr", [25.0, 2.0])
def test_transmit_vlc_equals_jax_given_its_noise(snr):
    """The whole variable-length link over AWGN with JAX's noise: the
    received indices (with desync at 2 dB) and the symbol accounting."""
    p, tc, jc = _codecs("usage")
    rng = np.random.default_rng(2)
    idx = rng.choice(len(p), size=(2, 20), p=p).astype(np.int32)
    key = jax.random.key(3)
    jrx, jinfo = jec.transmit_vlc(jc, jnp.asarray(idx), snr, "awgn", key, 20)
    m = 20 * int(jc.code_bits.shape[1])
    noise = torch.tensor(np.asarray(jax.random.normal(key, (2, m // 2, 2))))
    rx, info = tec.transmit_vlc(tc, torch.from_numpy(idx), snr, "awgn", 20,
                                noise=noise)
    np.testing.assert_array_equal(rx.numpy(), np.asarray(jrx))
    assert set(info) == set(jinfo)
    for k in info:
        assert float(info[k]) == pytest.approx(float(jinfo[k]), rel=1e-6), k
    assert (snr > 10) == np.array_equal(rx.numpy(), idx)


@pytest.mark.parametrize("keep", [4, 16])
def test_topk_remap_equals_jax_on_tied_histograms(keep):
    """numpy's default (unstable) argsort decides among tied counts; the
    port uses the same call, so the kept set and the snap agree."""
    rng = np.random.default_rng(4)
    counts = rng.integers(0, 4, 64).astype(np.float64)   # many ties
    cb = rng.standard_normal((64, 8)).astype(np.float32)
    j = jec.topk_remap(counts, jnp.asarray(cb), keep)
    t = tec.topk_remap(counts, torch.from_numpy(cb), keep)
    for got, want in zip(t, j):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert t[0].dtype == t[1].dtype == torch.int32


def test_entropy_module_imports_no_jax():
    banned = ("jax", "flax", "optax", "multimodal_sc_tpu")
    tree = ast.parse((PKG / "channel/entropy_coding.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert all(n.split(".")[0] not in banned for n in names), names
