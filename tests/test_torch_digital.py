"""The port's digital link against the JAX package on the CPU: index bits,
QPSK, Hamming(7,4) (hard and soft), CRC-8 and Type-I HARQ.

Everything but the channel noise is integer or sign work, so the port must
equal JAX exactly: over all 16 nibbles, all 128 received 7-bit words and
random payloads. ``harq_transmit`` is given JAX's own per-round draws
(``normal(fold_in(key, r), ...)``): its bits must be equal and its
accounting within 1e-6. The closed-form error rates must be equal as
floats.
"""

import ast
import itertools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_sc_torch
from multimodal_sc_torch.channel import digital as tdig
from multimodal_sc_torch.channel import fec as tfec
from multimodal_sc_torch.channel import harq as tharq
from multimodal_sc_tpu.channel import digital as jdig
from multimodal_sc_tpu.channel import fec as jfec
from multimodal_sc_tpu.channel import harq as jharq

PKG = pathlib.Path(multimodal_sc_torch.__file__).parent


def _t(x):
    return torch.tensor(np.array(x))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("codes", [4, 16, 256])
def test_index_bits_and_qpsk_match_jax(codes):
    idx = np.random.default_rng(codes).integers(0, codes, (3, 16)).astype(
        np.int32)
    assert tdig.index_bits(codes) == jdig.index_bits(codes)
    bits = tdig.bits_from_indices(torch.from_numpy(idx), codes)
    _eq(bits, jdig.bits_from_indices(jnp.asarray(idx), codes))
    _eq(tdig.indices_from_bits(bits, codes), idx)
    sym = tdig.indices_to_qpsk(torch.from_numpy(idx), codes)
    _eq(sym, jdig.indices_to_qpsk(jnp.asarray(idx), codes))
    # Received symbols with exact zeros: y > 0 decodes a zero to bit 0.
    y = np.random.default_rng(1).standard_normal(sym.shape).astype(np.float32)
    y[0, :3] = 0.0
    _eq(tdig.qpsk_to_bits(torch.from_numpy(y)),
        jdig.qpsk_to_bits(jnp.asarray(y)))
    _eq(tdig.qpsk_to_indices(torch.from_numpy(y), codes),
        jdig.qpsk_to_indices(jnp.asarray(y), codes, 16))
    _eq(tdig.qpsk_soft_bits(torch.from_numpy(y)),
        jdig.qpsk_soft_bits(jnp.asarray(y)))


@pytest.mark.parametrize("codes", [8, 32, 12])
def test_index_bits_refuses_what_jax_refuses(codes):
    with pytest.raises(ValueError, match="power of 4"):
        tdig.index_bits(codes)
    with pytest.raises(ValueError, match="power of 4"):
        jdig.index_bits(codes)


def test_hamming_encode_and_hard_decode_match_jax_on_every_word():
    nibbles = np.array(list(itertools.product((0, 1), repeat=4)), np.int32)
    payload = nibbles.reshape(1, -1)                     # all 16 nibbles
    coded = tfec.hamming74_encode(torch.from_numpy(payload))
    _eq(coded, jfec.hamming74_encode(jnp.asarray(payload)))
    _eq(tfec.hamming74_decode(coded), payload)
    # Every 7-bit word a receiver can see, as one payload and as a batch.
    words = np.array(list(itertools.product((0, 1), repeat=7)), np.int32)
    _eq(tfec.hamming74_decode(torch.from_numpy(words.reshape(1, -1))),
        jfec.hamming74_decode(jnp.asarray(words.reshape(1, -1))))
    _eq(tfec.hamming74_decode(torch.from_numpy(words)),
        jfec.hamming74_decode(jnp.asarray(words)))
    codes_t, data_t = tfec.all_codewords()
    codes_j, data_j = jfec._all_codewords()
    _eq(codes_t, codes_j)
    _eq(data_t, data_j)


def test_hamming_soft_decode_matches_jax():
    rng = np.random.default_rng(7)
    soft = rng.standard_normal((6, 7 * 40)).astype(np.float32)
    # Exact ties between codewords: all-zero blocks (the first word wins).
    soft[0, :14] = 0.0
    _eq(tfec.hamming74_decode_soft(torch.from_numpy(soft)),
        jfec.hamming74_decode_soft(jnp.asarray(soft)))
    clean = 2.0 * np.asarray(jfec.hamming74_encode(
        jnp.asarray(rng.integers(0, 2, (2, 64)).astype(np.int32)))) - 1.0
    noisy = (clean + 0.4 * rng.standard_normal(clean.shape)).astype(
        np.float32)
    _eq(tfec.hamming74_decode_soft(torch.from_numpy(noisy)),
        jfec.hamming74_decode_soft(jnp.asarray(noisy)))


@pytest.mark.parametrize("bad", ["encode", "decode", "soft"])
def test_hamming_refuses_partial_blocks(bad):
    fn = {"encode": tfec.hamming74_encode, "decode": tfec.hamming74_decode,
          "soft": tfec.hamming74_decode_soft}[bad]
    with pytest.raises(ValueError, match="multiple of"):
        fn(torch.zeros((2, 6), dtype=torch.int32 if bad != "soft"
                       else torch.float32))


@pytest.mark.parametrize("k", [8, 64])
def test_crc8_matches_jax(k):
    np.testing.assert_array_equal(tharq.crc_matrix(k), jharq.crc_matrix(k))
    rng = np.random.default_rng(k)
    msg = rng.integers(0, 2, (3, 5, k)).astype(np.int32)
    coded = tharq.crc_append(torch.from_numpy(msg))
    _eq(coded, jharq.crc_append(jnp.asarray(msg)))
    rx = coded.numpy().copy()
    flips = rng.random(rx.shape) < 0.02
    rx = np.where(flips, 1 - rx, rx).astype(np.int32)
    _eq(tharq.crc_check(torch.from_numpy(rx)),
        jharq.crc_check(jnp.asarray(rx)))
    assert tharq.crc_check(coded).all()


def _round_draws(key, shape, rounds):
    return [_t(jax.random.normal(jax.random.fold_in(key, r), shape))
            for r in range(rounds)]


@pytest.mark.parametrize("snr", [-2.0, 3.0, 12.0])
def test_harq_transmit_matches_jax_given_its_draws(snr):
    b, m, block, rounds = 4, 128, 64, 4
    bits = np.random.default_rng(3).integers(0, 2, (b, m)).astype(np.int32)
    key = jax.random.key(11)
    snr_vec = np.full((b,), snr, np.float32)
    want_bits, want = jharq.harq_transmit(jnp.asarray(bits),
                                          jnp.asarray(snr_vec), "awgn", key,
                                          block_bits=block,
                                          max_rounds=rounds)
    spb = (block + 8) // 2
    got_bits, got = tharq.harq_transmit(
        torch.from_numpy(bits), torch.from_numpy(snr_vec), "awgn",
        block_bits=block, max_rounds=rounds,
        draws=_round_draws(key, (b, m // block * spb, 2), rounds))
    _eq(got_bits, want_bits)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=0, atol=1e-6, err_msg=name)
    if snr < 0:
        assert float(got["mean_rounds"]) > 1.0


def test_harq_refusals():
    with pytest.raises(ValueError, match="not divisible"):
        tharq.harq_transmit(torch.zeros((1, 100), dtype=torch.int32), 5.0,
                            "awgn", block_bits=64)
    with pytest.raises(ValueError, match="even"):
        tharq.harq_transmit(torch.zeros((1, 63), dtype=torch.int32), 5.0,
                            "awgn", block_bits=63)


@pytest.mark.parametrize("x", [-5.0, 0.0, 4.0, 10.0, 0.01, 0.1])
def test_error_rate_theory_matches_jax(x):
    assert tdig.qpsk_ber_awgn_theory(x) == jdig.qpsk_ber_awgn_theory(x)
    p = abs(x) / 20.0
    assert (tfec.hamming74_block_error_theory(p)
            == jfec.hamming74_block_error_theory(p))


def test_qpsk_link_error_rate_follows_theory():
    """The port's own draws: hard-decision bit errors at 4 dB over 200k
    bits within 5 standard deviations of Q(sqrt(s))."""
    from multimodal_sc_torch.channel.layer import awgn

    g = torch.Generator().manual_seed(0)
    bits = torch.randint(0, 2, (100, 2000), generator=g)
    y = awgn(tdig.bits_to_qpsk(bits), 4.0, g)
    ber = float((tdig.qpsk_to_bits(y) != bits).float().mean())
    p = tdig.qpsk_ber_awgn_theory(4.0)
    assert abs(ber - p) < 5 * np.sqrt(p * (1 - p) / bits.numel())


@pytest.mark.parametrize("module", ["channel/digital.py", "channel/fec.py",
                                    "channel/harq.py",
                                    "codec/semantic_vq.py"])
def test_digital_modules_import_no_jax(module):
    banned = ("jax", "flax", "optax", "multimodal_sc_tpu")
    for node in ast.walk(ast.parse((PKG / module).read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in banned, (module, name)
