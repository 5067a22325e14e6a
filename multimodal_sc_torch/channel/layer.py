"""Differentiable power-normalized channel layer: ideal, AWGN, Rayleigh,
Rician and OFDM multipath, with pilot-estimated CSI, M-QAM and
adaptive-rate masks.

Counterpart of ``multimodal_sc_tpu/channel/layer.py``. Complex channel
symbols stay trailing real/imag pairs ``(..., 2)``. Randomness comes from
an explicit ``torch.Generator``; every function that draws also takes its
standard-normal draws as tensors (``awgn(noise=...)``, ``ChannelDraws`` for
the fading kinds), so a test can hand in the JAX package's own draws. The
JAX stream layout, for a test to copy: ``key_h, key_n = split(key)``, the
fading gain (or OFDM taps) from ``key_h``, the noise from ``key_n``, the
CSI estimate's error from ``fold_in(key, 2)``.

Math: z_norm = z * sqrt(k) / ||z|| per example (k complex symbols, unit
average power); AWGN y = z + n with n ~ CN(0, 10^(-snr/10)), each real
component of variance sigma^2 / 2. Block fading y = h z + n with one h a
codeword, equalised by conj(h_hat) y / (|h_hat|^2 + eps); h_hat is h, or
with ``pilots`` P > 0 the least-squares estimate h + e, e ~ CN(0, sigma^2 /
P). Rayleigh h ~ CN(0, 1); Rician h = sqrt(K / (K + 1)) + sqrt(1 / (K + 1))
CN(0, 1), the line of sight on the real part. OFDM: L taps of an
exponential power-delay profile (sum 1), the per-subcarrier response by a
real-arithmetic DFT, symbol i on subcarrier i mod N, one estimate per
subcarrier shared by every symbol on it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch

CHANNEL_KINDS = ("ideal", "awgn", "rayleigh", "rician", "ofdm")

RICIAN_K = 4.0  # LOS-to-scatter power ratio; typical V2V/V2I values 3-7


class ChannelDraws(NamedTuple):
    """Standard-normal draws of one channel use; a ``None`` field is drawn
    from the generator. ``h``: the fading gain, (B, 2) for Rayleigh and
    Rician, the taps (B, taps, 2) for OFDM; ``noise``: z's shape; ``csi``:
    the estimate's error, the shape of the gain as it meets the symbols
    ((B, 1, ..., 1, 2), for OFDM (B, subcarriers, 2))."""
    noise: Optional[torch.Tensor] = None
    h: Optional[torch.Tensor] = None
    csi: Optional[torch.Tensor] = None


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


def power_normalize_masked(z: torch.Tensor, mask: torch.Tensor,
                           eps: float = 1e-12) -> torch.Tensor:
    """Unit average power over the transmitted symbols only (adaptive rate).

    mask: 0/1, broadcastable to z with a trailing singleton (e.g. (B, k,
    1)). With a full mask this equals ``power_normalize``."""
    zm = z * mask
    dims = tuple(range(1, z.dim()))
    sq = zm.square().sum(dim=dims, keepdim=True)
    k_eff = mask.expand(z.shape[:-1] + (1,)).sum(dim=dims, keepdim=True)
    return zm * (torch.sqrt(k_eff.to(z.dtype)) * torch.rsqrt(sq + eps))


def rate_mask(batch: int, k: int, c_sym: int, m: torch.Tensor) -> torch.Tensor:
    """Per-example mask keeping the first m of c_sym symbol channels.

    The CNN codec flattens (h, w, 2 c_sym) to (h w c_sym, 2), so flat symbol
    i carries feature channel i % c_sym. m: (B,) int in [1, c_sym]. Returns
    (B, k, 1) float32 0/1."""
    ch = torch.arange(k, dtype=torch.int32, device=m.device) % c_sym
    return (ch[None, :] < m[:, None]).to(torch.float32)[..., None]


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


def _noise_power(snr_db: torch.Tensor) -> torch.Tensor:
    return torch.pow(torch.tensor(10.0, dtype=snr_db.dtype,
                                  device=snr_db.device), -snr_db / 10.0)


def _noise_sigma(snr_db: torch.Tensor) -> torch.Tensor:
    """Per-real-component std dev for unit-power symbols at snr_db."""
    return torch.sqrt(_noise_power(snr_db) / 2.0)


def _normal(given, shape, like: torch.Tensor, generator) -> torch.Tensor:
    if given is not None:
        if tuple(given.shape) != tuple(shape):
            raise ValueError(f"draw of shape {tuple(given.shape)}, expected "
                             f"{tuple(shape)}")
        return given.to(like.dtype)
    return draw(torch.randn, shape, generator, dtype=like.dtype,
                device=like.device)


def draw(sampler, shape, generator: Optional[torch.Generator] = None,
         **kw) -> torch.Tensor:
    """``sampler(shape, generator=generator, **kw)`` for ``torch.randn`` or
    ``torch.rand``. Without a generator the keyword is left out: spelled
    out as ``None`` it picks the overload that ``torch.export`` cannot
    trace at a symbolic batch size; the device's default generator draws
    the same numbers either way."""
    if generator is None:
        return sampler(shape, **kw)
    return sampler(shape, generator=generator, **kw)


def awgn(z: torch.Tensor, snr_db: Union[float, torch.Tensor],
         generator: Optional[torch.Generator] = None,
         noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = z + sigma * n, n standard normal of z's shape.

    ``noise`` (optional) supplies n; otherwise it is drawn from
    ``generator`` on z's device."""
    sigma = _noise_sigma(_broadcast_snr(snr_db, z))
    return z + sigma * _normal(noise, z.shape, z, generator)


def _cplx_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Complex multiply on trailing real/imag pairs."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return torch.stack([ar * br - ai * bi, ar * bi + ai * br], dim=-1)


def _equalize(h_hat: torch.Tensor, y: torch.Tensor,
              eps: float) -> torch.Tensor:
    """MRC/ZF equalization with (possibly estimated) CSI h_hat."""
    h_conj = torch.stack([h_hat[..., 0], -h_hat[..., 1]], dim=-1)
    h_pow = h_hat.square().sum(dim=-1, keepdim=True)
    return _cplx_mul(h_conj, y) / (h_pow + eps)


def _estimate_csi(h: torch.Tensor, snr: torch.Tensor, pilots: int,
                  e: torch.Tensor) -> torch.Tensor:
    """LS pilot estimate h_hat = h + e, e ~ CN(0, noise_power / pilots),
    ``e`` the standard-normal draw of h's shape."""
    sig_e = torch.sqrt(_noise_power(snr) / (2.0 * pilots))
    return h + sig_e * e


def _block_fading(z, snr_db, h, pilots, eps, draws, generator):
    """y = h z + n equalised with h or its pilot estimate; h (B, 2)."""
    batch = z.shape[0]
    h = h.reshape((batch,) + (1,) * (z.dim() - 2) + (2,))
    snr = _broadcast_snr(snr_db, z)
    noise = _noise_sigma(snr) * _normal(draws.noise, z.shape, z, generator)
    y = _cplx_mul(h, z) + noise
    h_hat = h
    if pilots:
        h_hat = _estimate_csi(h, snr, pilots,
                              _normal(draws.csi, h.shape, z, generator))
    return _equalize(h_hat, y, eps)


def rayleigh(z: torch.Tensor, snr_db: Union[float, torch.Tensor],
             generator: Optional[torch.Generator] = None, eps: float = 1e-12,
             pilots: int = 0,
             draws: ChannelDraws = ChannelDraws()) -> torch.Tensor:
    """Block-fading Rayleigh channel, one h ~ CN(0, 1) per example, MRC
    equalization with perfect (pilots == 0) or pilot-estimated CSI."""
    h = _normal(draws.h, (z.shape[0], 2), z, generator) * math.sqrt(0.5)
    return _block_fading(z, snr_db, h, pilots, eps, draws, generator)


def rician(z: torch.Tensor, snr_db: Union[float, torch.Tensor],
           generator: Optional[torch.Generator] = None,
           k_factor: float = RICIAN_K, eps: float = 1e-12, pilots: int = 0,
           draws: ChannelDraws = ChannelDraws()) -> torch.Tensor:
    """Rician block fading: h = sqrt(K/(K+1)) + sqrt(1/(K+1)) CN(0, 1), so
    E|h|^2 = 1; the line of sight adds to the real part."""
    scatter = _normal(draws.h, (z.shape[0], 2), z, generator) * torch.sqrt(
        torch.tensor(0.5 / (k_factor + 1.0), dtype=z.dtype, device=z.device))
    los = torch.sqrt(torch.tensor(k_factor / (k_factor + 1.0), dtype=z.dtype,
                                  device=z.device))
    h = torch.stack([scatter[:, 0] + los, scatter[:, 1]], dim=-1)
    return _block_fading(z, snr_db, h, pilots, eps, draws, generator)


def exp_power_delay_profile(taps: int, dtype=torch.float32,
                            device=None) -> torch.Tensor:
    """Exponential power-delay profile p_l, normalized to sum 1."""
    decay = torch.exp(-torch.arange(taps, dtype=dtype, device=device)
                      / max(taps / 3.0, 1.0))
    return decay / decay.sum()


def ofdm_freq_response(h_taps: torch.Tensor,
                       subcarriers: int) -> torch.Tensor:
    """Per-subcarrier response H_k = sum_l h_l e^{-2 pi i k l / N}.

    h_taps: (B, L, 2) -> (B, N, 2), by a real-arithmetic DFT (two small
    matmuls of the taps with the cos and sin tables), as the JAX package
    writes it. Exact f32 on the card only with TF32 matmuls off (PyTorch's
    default)."""
    n_taps = h_taps.shape[1]
    k = torch.arange(subcarriers, dtype=h_taps.dtype, device=h_taps.device)
    lags = torch.arange(n_taps, dtype=h_taps.dtype, device=h_taps.device)
    theta = 2.0 * math.pi * torch.outer(lags, k) / subcarriers   # (L, N)
    c, s = torch.cos(theta), torch.sin(theta)
    hr, hi = h_taps[..., 0], h_taps[..., 1]                      # (B, L)
    return torch.stack([hr @ c + hi @ s, hi @ c - hr @ s], dim=-1)


def ofdm(z: torch.Tensor, snr_db: Union[float, torch.Tensor],
         generator: Optional[torch.Generator] = None, pilots: int = 0,
         subcarriers: int = 64, taps: int = 8, eps: float = 1e-12,
         draws: ChannelDraws = ChannelDraws()) -> torch.Tensor:
    """Frequency-selective Rayleigh multipath over OFDM subcarriers: taps
    h_l ~ CN(0, p_l), symbol i on subcarrier i mod N, per-subcarrier MRC
    with perfect (pilots == 0) or pilot-estimated CSI."""
    batch = z.shape[0]
    pdp = exp_power_delay_profile(taps, z.dtype, z.device)
    h_taps = _normal(draws.h, (batch, taps, 2), z, generator)
    h_taps = h_taps * torch.sqrt(pdp / 2.0)[None, :, None]
    h_freq = ofdm_freq_response(h_taps, subcarriers)            # (B, N, 2)

    flat = z.reshape(batch, -1, 2)                              # (B, S, 2)
    snr = torch.as_tensor(snr_db, dtype=z.dtype, device=z.device)
    if snr.dim() == 1 and snr.shape[0] == batch:
        snr = snr.reshape(batch, 1, 1)
    elif snr.dim() != 0:
        raise ValueError(f"snr_db must be scalar or shape ({batch},), got "
                         f"{tuple(snr.shape)}")
    noise = _noise_sigma(snr) * _normal(draws.noise, flat.shape, z, generator)
    h_freq_hat = h_freq
    if pilots:
        h_freq_hat = _estimate_csi(
            h_freq, snr, pilots,
            _normal(draws.csi, h_freq.shape, z, generator))
    idx = torch.arange(flat.shape[1], device=z.device) % subcarriers
    y = _cplx_mul(h_freq[:, idx], flat) + noise
    return _equalize(h_freq_hat[:, idx], y, eps).reshape(z.shape)


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
            noise: Union[None, torch.Tensor, ChannelDraws] = None
            ) -> torch.Tensor:
    """Power-normalize, optionally map to M-QAM (straight-through), then
    apply the selected channel.

    ``mask`` (optional, (B, ..., 1) 0/1): the adaptive rate's transmitted
    symbols; power spreads over them only and the receiver zeros the rest.
    ``noise``: the channel's standard-normal draws, a tensor (the additive
    noise) or a ``ChannelDraws``; what it leaves out is drawn from
    ``generator``. ``pilots``, ``subcarriers`` and ``taps`` as in the JAX
    package (fading kinds; OFDM)."""
    if kind not in CHANNEL_KINDS:
        raise ValueError(f"kind must be one of {CHANNEL_KINDS}, got {kind!r}")
    draws = noise if isinstance(noise, ChannelDraws) else ChannelDraws(noise)
    if normalize:
        z = (power_normalize_masked(z, mask) if mask is not None
             else power_normalize(z))
    elif mask is not None:
        z = z * mask
    if modulation:
        from multimodal_sc_torch.channel.modulation import qam_modulate

        z = qam_modulate(z, modulation)
    if kind == "ideal":
        y = z
    elif kind == "awgn":
        y = awgn(z, snr_db, generator, draws.noise)
    elif kind == "rician":
        y = rician(z, snr_db, generator, pilots=pilots, draws=draws)
    elif kind == "ofdm":
        y = ofdm(z, snr_db, generator, pilots=pilots,
                 subcarriers=subcarriers, taps=taps, draws=draws)
    else:
        y = rayleigh(z, snr_db, generator, pilots=pilots, draws=draws)
    return y * mask if mask is not None else y
