"""Discrete semantic-token camera codec: a VQ bottleneck over a digital link.

Counterpart of ``multimodal_sc_tpu/codec/semantic_vq.py``. The encoder
quantises each spatial cell against a learned codebook (VQ-VAE: a
straight-through estimator, codebook and commitment losses) and sends the
integer indices as bits over QPSK (``channel/digital.py``), optionally
Hamming(7,4)-coded (``channel/fec.py``) or under Type-I HARQ
(``channel/harq.py``). Noise-aware training: the decoder's forward sees the
received (possibly corrupted) codes while the gradient takes the clean
straight-through path, ``z_rx = z_ste + sg(codebook[idx_rx] - z_ste)``; the
codebook moves only through the VQ loss.

The encoder's 5x5 convs and the decoder's stride-1 convs are
``FusedConvPReLU`` (the CUDA kernel on the card); the 1x1 ``to_code``, the
token decoder's conv, the transposed convs and the nearest-code search are
plain PyTorch, as they are plain XLA in the JAX package. Under
``train.bf16`` the encoder, the token decoder and the image decoder take
``dtype=torch.bfloat16`` and follow flax's dtype rules (``act_dtype``):
the code features are rounded to bf16 by ``to_code`` and widened to f32
before the search, the image's sigmoid is taken in f32, and the codebook,
the indices, the VQ losses and the channel stay f32. The search is one
(B*N, K) distance matmul, ``|x|^2 - 2 x.c + |c|^2``, whose cancellation
wants f32 products: on the card it runs at PyTorch's default f32 matmul
precision (no TF32), so acting and learning pick the same codes.
``torch.argmin`` returns the first minimum, as JAX does; ``torch.topk``'s
order among tied errors is unspecified, so the re-seeding candidates match
JAX's only where the errors have no ties.

Semantic token pruning (``camera.vq_prune``): the model trains on random
kept subsets and deploys at any kept fraction; dropped tokens send zero
symbols and the receiver decodes the learned ``mask_embed`` in their place.
The kept set is each row's top ``ceil(keep * N)`` tokens by one of five
selection rules (:func:`kept_tokens`): ``random``, ``scatter`` (the
farthest-point order of the token grid), ``damage`` (the single-bit-error
damage), ``drop_damage`` (the damage of decoding the mask embedding) and
``drop_damage_scatter`` (the two ranks summed). Semantic unequal power
allocation (``channel.uep_alpha > 0``): per-token QPSK amplitudes at exactly
unit mean power, power proportional to damage^alpha or SNR-aware
water-filling (``channel.uep_mode``). The damage estimates are VJP probes of
the decoder: one ``torch.autograd.grad`` of ``<decode(z), v_p>`` with
respect to the code vectors alone for each of ``channel.uep_probes`` probes
(no parameter gradient, the result detached), not a vmap: the conv
kernel's autograd function defines no vmap rule. Ranks use stable sorts, as
JAX's ``argsort`` is stable; the farthest-point order is computed once per
grid shape.

Random draws (the channel, code seeding, the re-seeding coin, the random
selection scores, the damage probes) come from an explicit
``torch.Generator`` or are handed in, so the tests can feed JAX's draws.

Data parallelism: handed a ``runtime/mesh.py`` mesh whose data axis has S >
1 ranks, each holding its rows of one global batch, the quantiser's batch
statistics cover the global batch, as GSPMD computes them in the JAX
package: the usage loss's softmax scale and soft-usage mean are taken over
the data group (``mean_over_data``: its identity backward, followed by the
gradient mean over the group, gives the global batch's gradient), the usage
counts are summed, the re-seeding candidates are the global batch's
worst-quantised rows in the order one process's ``topk`` gives them, and
``VQCameraJSCC``'s code perplexity and index error rate come from the
summed histogram and error counts.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodal_sc_torch.act_dtype import Conv, PointwiseConv
from multimodal_sc_torch.channel.digital import (bits_from_indices,
                                                 bits_to_qpsk, index_bits,
                                                 indices_from_bits,
                                                 indices_to_qpsk,
                                                 qpsk_soft_bits, qpsk_to_bits,
                                                 qpsk_to_indices)
from multimodal_sc_torch.channel.fec import (hamming74_decode,
                                             hamming74_decode_soft,
                                             hamming74_encode)
from multimodal_sc_torch.channel.harq import harq_transmit
from multimodal_sc_torch.channel.layer import channel as channel_op
from multimodal_sc_torch.channel.layer import channel_kwargs
from multimodal_sc_torch.codec.camera_cnn import ConvTransposeSame, PReLU
from multimodal_sc_torch.config.configs import ExperimentConfig
from multimodal_sc_torch.kernels.conv_block import FusedConvPReLU
from multimodal_sc_torch.nn_init import (init_like_flax_,
                                         variance_scaling_uniform_)
from multimodal_sc_torch.runtime.mesh import (Mesh, all_gather_rows,
                                              data_parallel,
                                              from_first_shard,
                                              mean_over_data)


@functools.lru_cache(maxsize=None)
def farthest_point_order(h: int, w: int) -> np.ndarray:
    """Greedy farthest-point ordering of an (h, w) grid: the (h*w,) rank of
    each position, every prefix of the order maximally spread. The
    ``scatter`` selection score; computed once per grid shape (a 1,024-step
    loop at 32x32) and returned read-only."""
    pts = np.stack(np.meshgrid(np.arange(h), np.arange(w),
                               indexing="ij"), -1).reshape(-1, 2).astype(
        np.float64)
    n = h * w
    order = np.empty(n, np.int64)
    # Start at the centre-most point.
    center = np.array([(h - 1) / 2.0, (w - 1) / 2.0])
    order[0] = int(np.argmin(np.sum((pts - center) ** 2, axis=1)))
    mind = np.sum((pts - pts[order[0]]) ** 2, axis=1)
    for i in range(1, n):
        mind[order[:i]] = -1.0
        order[i] = int(np.argmax(mind))
        mind = np.minimum(mind, np.sum((pts - pts[order[i]]) ** 2, axis=1))
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    rank.flags.writeable = False
    return rank


@functools.lru_cache(maxsize=None)
def _farthest_point_rank_on(h: int, w: int, device: str) -> torch.Tensor:
    return torch.as_tensor(np.array(farthest_point_order(h, w)),
                           device=device)


def topk_mask(scores: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(B, N) scores, (B,) counts -> (B, N) bool keeping each row's top-m
    scores, ties going to the earlier position (two stable argsorts, as
    JAX's stable ``argsort`` ranks them)."""
    order = torch.argsort(-scores, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    return rank < m[:, None]


def probe_grads(decode: Callable, z_clean: torch.Tensor,
                probes: torch.Tensor) -> torch.Tensor:
    """(P, B, N, D): for each probe v_p (P, *decode's output shape) the
    vector-Jacobian product v_p^T d decode / dz at ``z_clean`` (B, N, D),
    one backward a probe with respect to z alone, detached."""
    with torch.enable_grad():
        z = z_clean.detach().requires_grad_(True)
        out = decode(z)
        grads = [torch.autograd.grad((out * v).sum(), z,
                                     retain_graph=i + 1 < probes.shape[0])[0]
                 for i, v in enumerate(probes)]
    return torch.stack(grads).detach()


def drop_damage(decode: Callable, codebook: torch.Tensor,
                mask_embed: torch.Tensor, idx_tx: torch.Tensor,
                probes: torch.Tensor) -> torch.Tensor:
    """(B, N) expected squared output damage when a token is not sent and
    the receiver decodes the mask embedding: D_t = ||J_t (mask_embed -
    e_{idx_t})||^2, estimated with the VJP probes (unbiased: E[(v^T J
    delta)^2] = ||J delta||^2 for v ~ N(0, I))."""
    z_clean = codebook.detach()[idx_tx.long()]                 # (B, N, D)
    g = probe_grads(decode, z_clean, probes)                   # (P, B, N, D)
    delta = mask_embed.detach()[None, None, :] - z_clean
    dot = torch.einsum("pbnd,bnd->pbn", g, delta)
    return (dot * dot).mean(0)


def waterfill_power(damage: torch.Tensor, snr_db) -> torch.Tensor:
    """SNR-aware Chernoff water-filling: minimise sum_t D_t exp(-s w_t^2 /
    2) subject to sum_t w_t^2 = N at linear SNR s. The KKT point is w_t^2 =
    max(0, (2/s) ln(s D_t / (2 lambda))), lambda found by 50 bisection
    steps a row; the budget is then met exactly (uniform where every w_t is
    0). Returns the per-token POWER (B, N), mean 1."""
    n = damage.shape[1]
    s = torch.as_tensor(snr_db, dtype=torch.float32, device=damage.device)
    s = s.reshape(-1, 1) if s.dim() == 1 else s.reshape(1, 1)
    s = torch.pow(10.0, s / 10.0)
    a = torch.log(s * damage / 2.0 + 1e-30)                    # (B, N)
    hi = a.max(dim=1, keepdim=True).values                     # total(hi) = 0
    lo = hi - s * (n / 2.0)                                    # total(lo) >= N
    for _ in range(50):
        mid = 0.5 * (lo + hi)
        total = ((2.0 / s) * (a - mid)).clamp(min=0.0).sum(1, keepdim=True)
        big = total > n
        lo, hi = torch.where(big, mid, lo), torch.where(big, hi, mid)
    w2 = ((2.0 / s) * (a - 0.5 * (lo + hi))).clamp(min=0.0)
    tot = w2.sum(1, keepdim=True)
    return torch.where(tot > 1e-8, w2 * (n / tot.clamp(min=1e-8)),
                       torch.ones_like(w2))


# The pairwise error exponent's distance under each FEC, by which water-
# filling scales the SNR: soft Hamming(7,4) d_min 3, hard decoding ~2.
UEP_DMIN = {"none": 1.0, "hamming74": 2.0, "hamming74_soft": 3.0}
SELECTS = ("drop_damage", "damage", "scatter", "drop_damage_scatter",
           "random")


def kept_tokens(select: str, idx_tx: torch.Tensor, keep: torch.Tensor,
                grid_hw: Tuple[int, int], damage: dict,
                draws: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(B, N) bool: each row's top ``ceil(keep * N)`` tokens (the count in
    f32, as the JAX package takes it) by the ``select`` rule's score.
    ``damage`` maps ``"damage"`` / ``"drop_damage"`` to a function of
    ``(idx_tx, probes)``; ``draws``: the rule's draws (the uniform scores
    of ``random``, the probes of a damage rule), else drawn from
    ``generator`` (the probes inside the damage function)."""
    m = torch.ceil(keep.to(torch.float32) * idx_tx.shape[1]).to(torch.int32)
    dev = idx_tx.device
    if select in ("scatter", "drop_damage_scatter"):
        sc_rank = _farthest_point_rank_on(*grid_hw, str(dev)).expand(
            idx_tx.shape)
    if select == "scatter":
        scores = -sc_rank.to(torch.float32)
    elif select == "random":
        scores = draws if draws is not None else torch.rand(
            idx_tx.shape, generator=generator, device=dev)
    elif select == "drop_damage_scatter":
        dmg = damage["drop_damage"](idx_tx, draws)
        dmg_rank = torch.argsort(torch.argsort(-dmg, dim=1, stable=True),
                                 dim=1, stable=True)
        scores = -(dmg_rank + sc_rank).to(torch.float32)
    else:
        scores = damage[select](idx_tx, draws)
    return topk_mask(scores, m)


USAGE_SAMPLE_WEIGHT = 0.0


def vq_usage_loss(d2: torch.Tensor, temp: float = 0.5,
                  sample_weight: Optional[float] = None,
                  mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Codebook-usage regulariser on soft assignments q_i = softmax(-d2_i /
    s): ``sample_weight * mean_i H(q_i) - H(mean_i q_i)``, the softmax scale
    s = ``temp * mean(d2)`` held out of the gradient. With ``mesh`` (this
    rank's rows of a global batch) s and mean_i q_i are the global batch's;
    the sample entropy, a plain mean, stays this rank's."""
    if sample_weight is None:
        sample_weight = USAGE_SAMPLE_WEIGHT
    scale = temp * mean_over_data(d2.mean().detach(), mesh) + 1e-9
    logp = F.log_softmax(-d2 / scale, dim=-1)
    p = logp.exp()
    avg = mean_over_data(p.reshape(-1, p.shape[-1]).mean(0), mesh)
    avg_ent = -(avg * torch.log(avg + 1e-9)).sum()
    if sample_weight == 0.0:
        return -avg_ent
    sample_ent = -(p * logp).sum(-1).mean()
    return sample_weight * sample_ent - avg_ent


class _CodeRows(torch.autograd.Function):
    """``codebook[idx]`` whose backward sums each code's rows in a fixed
    order: the one-hot (N, K) transposed times the (N, D) gradient, in f64.
    Indexing's and ``F.embedding``'s scatter-adds may sum in another order
    from one call to the next (on the CPU and on the card respectively), so
    a resumed run would not repeat a step bit for bit."""

    @staticmethod
    def forward(ctx, codebook, idx):
        ctx.save_for_backward(idx)
        ctx.codes = codebook.shape[0]
        return codebook[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        one_hot = F.one_hot(idx, ctx.codes).to(torch.float64)
        return (one_hot.T @ grad.to(torch.float64)).to(grad.dtype), None


def code_rows(codebook: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(K, D) codebook, (N,) int64 indices -> (N, D) rows, differentiable
    in the codebook with a reproducible backward (``_CodeRows``)."""
    return _CodeRows.apply(codebook, idx)


def _global_candidates(flat: torch.Tensor, err: torch.Tensor, k: int,
                       mesh: Mesh) -> torch.Tensor:
    """The rows of the global batch (each rank's ``flat`` rows in data
    order) with the ``min(k, rows)`` largest errors, in the order ``topk``
    gives them on the global batch's errors: the errors are gathered, the
    chosen rows taken from the rank that holds each."""
    n = flat.shape[0]
    err_g = all_gather_rows(err, mesh)
    sel = err_g.topk(min(k, err_g.shape[0])).indices
    owner = sel // n
    mine = torch.where((owner == mesh.data_index)[:, None], flat[sel % n],
                       torch.zeros((), dtype=flat.dtype, device=flat.device))
    parts = all_gather_rows(mine[None], mesh)             # (S, kk, D)
    return parts[owner, torch.arange(sel.shape[0], device=sel.device)]


def vector_quantize(z_e: torch.Tensor, codebook: torch.Tensor,
                    beta: float = 0.25, usage_coef: float = 0.0,
                    usage_temp: float = 0.5, with_stats: bool = False,
                    mesh: Optional[Mesh] = None):
    """Nearest-code quantisation with the straight-through estimator:
    z_e (..., D), codebook (K, D) -> ``(z_ste, indices int32 (...),
    vq_loss)``, and with ``with_stats`` also ``{"counts": (K,) int32 batch
    usage, "candidates": (K, D) the encoder outputs with the largest
    quantisation error, tiled up to K}`` for dead-code re-seeding, both out
    of the graph. With ``mesh`` (``z_e`` this rank's rows of a global
    batch) the usage loss, the counts and the candidates are the global
    batch's; the codebook and commitment losses, plain means, this
    rank's."""
    dim = codebook.shape[1]
    flat = z_e.reshape(-1, dim)
    d2 = ((flat * flat).sum(1, keepdim=True)
          - 2.0 * flat @ codebook.T
          + (codebook * codebook).sum(1)[None, :])           # (BN, K)
    idx = d2.argmin(dim=1)
    z_q = code_rows(codebook, idx).reshape(z_e.shape)
    codebook_loss = (z_e.detach() - z_q).square().mean()
    commit_loss = (z_e - z_q.detach()).square().mean()
    vq_loss = codebook_loss + beta * commit_loss
    if usage_coef > 0:
        vq_loss = vq_loss + usage_coef * vq_usage_loss(d2, usage_temp,
                                                       mesh=mesh)
    z_ste = z_e + (z_q - z_e).detach()
    idx_r = idx.reshape(z_e.shape[:-1]).to(torch.int32)
    if not with_stats:
        return z_ste, idx_r, vq_loss
    k = codebook.shape[0]
    with torch.no_grad():
        counts = torch.bincount(idx, minlength=k).to(torch.int32)
        err = d2.gather(1, idx[:, None])[:, 0]
        if data_parallel(mesh):
            torch.distributed.all_reduce(counts, group=mesh.data_group)
            cand = _global_candidates(flat, err, k, mesh)
        else:
            cand = flat[err.topk(min(k, flat.shape[0])).indices]
        # Fewer rows than codes (a tiny batch): tile the worst rows up to K.
        kk = cand.shape[0]
        if kk < k:
            cand = cand.repeat(-(-k // kk), 1)[:k]
    return z_ste, idx_r, vq_loss, {"counts": counts,
                                   "candidates": cand.detach()}


def reseed_coin(counts: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                coin: Optional[torch.Tensor] = None,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The (K,) uniform draws of one re-seeding: ``coin``, else drawn from
    ``generator``; with ``mesh`` the data group's first rank's, so every
    rank re-seeds the same codes."""
    if coin is None:
        coin = torch.rand(counts.shape, generator=generator,
                          device=counts.device)
    return coin if mesh is None else from_first_shard(coin, mesh)


def reseed_dead_codes(codebook: torch.Tensor, counts: torch.Tensor,
                      candidates: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      rate: float = 0.0,
                      coin: Optional[torch.Tensor] = None):
    """Each code unused in the batch (``counts < 1``) jumps, with
    probability ``rate``, to its row of the batch's worst-quantised encoder
    outputs. ``coin``: the (K,) uniform draws, in place of draws from
    ``generator``. Returns ``(new_codebook, n_reseeded)``."""
    coin = reseed_coin(counts, generator, coin)
    take = (counts < 1) & (coin < rate)
    new_cb = torch.where(take[:, None], candidates.to(codebook.dtype),
                         codebook)
    return new_cb, take.to(torch.int32).sum()


class VectorQuantizer(nn.Module):
    """A codebook parameter and :func:`vector_quantize` over it."""

    def __init__(self, codes: int, dim: int, beta: float = 0.25):
        super().__init__()
        self.beta = beta
        self.codebook = nn.Parameter(
            variance_scaling_uniform_(torch.empty(codes, dim)))

    def forward(self, z_e: torch.Tensor):
        return vector_quantize(z_e, self.codebook, self.beta)


def _link_kwargs(ch) -> dict:
    kw = channel_kwargs(ch)
    kw["normalize"] = False           # QPSK is exactly unit power
    kw["modulation"] = 0              # the mapping is already digital
    return kw


def transmit_indices(ch, idx_tx: torch.Tensor, codes: int, snr_db,
                     generator: Optional[torch.Generator] = None,
                     token_weights: Optional[torch.Tensor] = None,
                     noise=None) -> torch.Tensor:
    """The digital link: (B, N) indices -> bits [-> Hamming(7,4)] -> QPSK ->
    the ``ch.kind`` channel, unnormalised -> hard (or soft-ML) decision ->
    received indices (B, N). ``token_weights`` (optional (B, N)): a
    per-token amplitude, repeated over the token's symbols. ``noise``: the
    channel's draws, in place of draws from ``generator``."""
    fec = ch.fec
    if fec in ("hamming74", "hamming74_soft"):
        sym = bits_to_qpsk(hamming74_encode(bits_from_indices(idx_tx, codes)))
    else:
        sym = indices_to_qpsk(idx_tx, codes)
    if token_weights is not None:
        spt = sym.shape[1] // idx_tx.shape[1]
        sym = sym * token_weights.repeat_interleave(spt, dim=1)[..., None]
    y = channel_op(sym, snr_db, ch.kind, generator, noise=noise,
                   **_link_kwargs(ch))
    if fec == "hamming74":
        return indices_from_bits(hamming74_decode(qpsk_to_bits(y)), codes)
    if fec == "hamming74_soft":
        return indices_from_bits(
            hamming74_decode_soft(qpsk_soft_bits(y)), codes)
    return qpsk_to_indices(y, codes)


def transmit_indices_harq(ch, idx_tx: torch.Tensor, codes: int, snr_db,
                          generator: Optional[torch.Generator] = None,
                          draws: Optional[Sequence] = None):
    """Type-I HARQ variant of :func:`transmit_indices`, uncoded bits plus
    CRC-8 blocks of ``ch.harq_block_bits`` over ``ch.harq_rounds`` rounds:
    ``(idx_rx, info)``, info the exact bandwidth accounting of
    ``harq_transmit``. ``draws``: one channel draw per round."""
    bits_rx, info = harq_transmit(
        bits_from_indices(idx_tx, codes), snr_db, ch.kind, generator,
        block_bits=ch.harq_block_bits, max_rounds=ch.harq_rounds,
        draws=draws, **_link_kwargs(ch))
    return indices_from_bits(bits_rx, codes), info


class VQEncoderTokens(nn.Module):
    """Image -> codebook indices: two stride-2 and two stride-1 5x5 conv +
    PReLU blocks (``enc0``-``enc3``), a 1x1 ``to_code`` and the
    ``codebook``. The deployed VQ transmitter of the RL trunk; its names
    mirror :class:`VQCameraJSCC`'s, which extends it, so a c1_vq checkpoint
    warm-starts it by name. Fresh weights are drawn as flax's. ``dtype``:
    the activation dtype of the convs and ``to_code``."""

    def __init__(self, features: Sequence[int], vq_dim: int, vq_codes: int,
                 vq_beta: float = 0.25, vq_usage_coef: float = 0.0,
                 vq_usage_temp: float = 0.5, vq_reseed: float = 0.0,
                 in_channels: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        index_bits(vq_codes)                 # codes must be a power of 4
        self.dtype = dtype
        self.vq_dim, self.vq_codes, self.vq_beta = vq_dim, vq_codes, vq_beta
        self.vq_usage_coef, self.vq_usage_temp = vq_usage_coef, vq_usage_temp
        self.vq_reseed = vq_reseed
        self.n_enc = len(features)
        cin = in_channels
        for i, (f, s) in enumerate(zip(features, (2, 2, 1, 1))):
            setattr(self, f"enc{i}", FusedConvPReLU(cin, f, 5, stride=s,
                                                    dtype=dtype))
            cin = f
        self.to_code = init_like_flax_(PointwiseConv(cin, vq_dim, dtype))
        self.codebook = nn.Parameter(
            variance_scaling_uniform_(torch.empty(vq_codes, vq_dim)))

    def encode_features(self, img: torch.Tensor) -> torch.Tensor:
        """Image (B, H, W, 3) -> pre-quantisation features (B, h, w, D),
        f32."""
        x = img.to(self.dtype)
        for i in range(self.n_enc):
            x = getattr(self, f"enc{i}")(x)
        return self.to_code(x).float()

    def quantize(self, z_e: torch.Tensor, with_stats: bool = True,
                 mesh: Optional[Mesh] = None):
        """(B, h, w, D) features -> ``(indices (B, N) int32, vq_loss, z_ste
        (B, N, D), stats)``; ``stats`` the re-seeding inputs of
        :func:`vector_quantize` when ``vq_reseed > 0`` and ``with_stats``,
        else None (what the JAX module sows, returned). ``mesh``: pool the
        batch statistics over its data group (:func:`vector_quantize`)."""
        out = vector_quantize(z_e, self.codebook, self.vq_beta,
                              self.vq_usage_coef, self.vq_usage_temp,
                              with_stats=with_stats and self.vq_reseed > 0,
                              mesh=mesh)
        z_ste, idx, vq_loss = out[:3]
        b, h, w, _ = z_e.shape
        return (idx.reshape(b, h * w), vq_loss,
                z_ste.reshape(b, h * w, self.vq_dim),
                out[3] if len(out) > 3 else None)

    def forward(self, img: torch.Tensor, with_stats: bool = True,
                mesh: Optional[Mesh] = None):
        return self.quantize(self.encode_features(img), with_stats, mesh)


class VQTokensCamera(nn.Module):
    """Received code vectors (B, N, vq_dim) -> fusion tokens (B, N, dim): one
    plain 5x5 conv + PReLU on the token grid, the receiver half of the RL
    VQ camera branch; in ``dtype``, the tokens out in f32."""

    def __init__(self, dim: int, vq_dim: int,
                 image_hw: Tuple[int, int] = (32, 32),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.vq_dim, self.dtype = dim, vq_dim, dtype
        self.hw = (image_hw[0] // 4, image_hw[1] // 4)
        # 5x5 stride-1 SAME: symmetric padding 2, as XLA pads it.
        self.conv_in = Conv(vq_dim, dim, 5, padding=2, dtype=dtype)
        self.prelu_in = PReLU(dim)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        b = z.shape[0]
        h, w = self.hw
        x = z.reshape(b, h, w, self.vq_dim).permute(0, 3, 1, 2).to(
            self.dtype)
        x = self.prelu_in(self.conv_in(x).permute(0, 2, 3, 1))
        return x.reshape(b, h * w, self.dim).float()


def check_digital_camera(cfg: ExperimentConfig) -> None:
    """What a VQ camera link refuses, as the JAX package: FEC over a payload
    that is no whole number of bytes, and unequal power allocation together
    with token pruning."""
    cam, ch = cfg.camera, cfg.channel
    n_bits = index_bits(cam.vq_codes)
    n_tok = (cam.image_hw[0] // 4) * (cam.image_hw[1] // 4)
    if ch.fec != "none" and (n_tok * n_bits) % 8 != 0:
        raise ValueError(
            "channel.fec needs n_tokens * bits_per_index divisible by 8, "
            f"got {n_tok} * {n_bits}")
    if cam.vq_prune and ch.uep_alpha > 0:
        raise ValueError(
            "channel.uep_alpha with camera.vq_prune is not supported yet "
            "(power renormalization over the kept set is unimplemented)")


class VQCameraJSCC(VQEncoderTokens):
    """Camera -> semantic tokens -> QPSK digital channel -> reconstruction.

    ``cfg.camera``: ``features``, ``vq_codes`` (a power of 4), ``vq_dim``,
    ``vq_beta``, the usage and re-seeding knobs and ``vq_prune`` (which adds
    ``mask_embed``, drawn from normal(0.02) as flax's). The decoder:
    ``from_code`` and ``dec0``, ``dec1`` (5x5 conv + PReLU),
    ``deconv2``/``deprelu2`` and ``deconv3``/``deprelu3`` (stride-2
    transposed convs + PReLU), and ``conv_out`` (5x5, no PReLU), then a
    sigmoid. Fresh weights are drawn as flax's. ``dtype``: the activation
    dtype of the encoder and the decoder (``act_dtype.activation_dtype``);
    the image comes out f32."""

    def __init__(self, cfg: ExperimentConfig,
                 dtype: torch.dtype = torch.float32):
        cam = cfg.camera
        check_digital_camera(cfg)
        super().__init__(cam.features, cam.vq_dim, cam.vq_codes, cam.vq_beta,
                         cam.vq_usage_coef, cam.vq_usage_temp, cam.vq_reseed,
                         dtype=dtype)
        self.cfg = cfg
        self.image_hw = tuple(cam.image_hw)
        self.vq_prune = cam.vq_prune
        if cam.vq_prune:
            # The receiver's stand-in for untransmitted tokens.
            self.mask_embed = nn.Parameter(
                torch.empty(cam.vq_dim).normal_(0.0, 0.02))
        feats = tuple(cam.features)
        self.from_code = FusedConvPReLU(cam.vq_dim, feats[-1], 5, dtype=dtype)
        self.dec_strides = (1, 1, 2, 2)
        cin = feats[-1]
        for i, (f, s) in enumerate(zip(reversed(feats), self.dec_strides)):
            if s == 1:
                setattr(self, f"dec{i}", FusedConvPReLU(cin, f, 5,
                                                        dtype=dtype))
            else:
                setattr(self, f"deconv{i}", ConvTransposeSame(cin, f, 5, s,
                                                              dtype))
                setattr(self, f"deprelu{i}", PReLU(f))
            cin = f
        self.conv_out = FusedConvPReLU(cin, 3, 5, with_prelu=False,
                                       dtype=dtype)
        init_like_flax_(self)

    @property
    def n_tokens(self) -> int:
        h, w = self.image_hw
        return (h // 4) * (w // 4)

    @property
    def bits_per_image(self) -> int:
        return self.n_tokens * index_bits(self.vq_codes)

    def encode_tokens(self, img: torch.Tensor):
        """Image -> ``(indices (B, N) int32, vq_loss, z_ste (B, N, D))``, the
        transmitter; the indices are the payload."""
        return self.quantize(self.encode_features(img))[:3]

    def codes_to_image(self, z: torch.Tensor) -> torch.Tensor:
        """(B, N, D) code vectors -> reconstructed image (f32), the
        receiver."""
        h, w = self.image_hw[0] // 4, self.image_hw[1] // 4
        x = self.from_code(z.reshape(z.shape[0], h, w, self.vq_dim).to(
            self.dtype))
        for i, s in enumerate(self.dec_strides):
            if s == 1:
                x = getattr(self, f"dec{i}")(x)
            else:
                x = getattr(self, f"deprelu{i}")(
                    getattr(self, f"deconv{i}")(x))
        return torch.sigmoid(self.conv_out(x).float())

    def decode_tokens(self, idx: torch.Tensor) -> torch.Tensor:
        """(B, N) received indices -> image."""
        return self.codes_to_image(self.codebook[idx.long()])

    # --- semantic importance: unequal power allocation and pruning ---

    def _probes(self, probes, batch: int, generator, ch) -> torch.Tensor:
        """The damage estimators' probes v ~ N(0, I), (P, B, H, W, 3), as
        given or drawn from ``generator``."""
        if probes is not None:
            return probes
        h, w = self.image_hw
        return torch.randn((ch.uep_probes, batch, h, w, 3),
                           generator=generator,
                           device=self.codebook.device)

    def token_damage(self, idx_tx: torch.Tensor,
                     probes: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     ch=None) -> torch.Tensor:
        """(B, N) expected squared reconstruction damage of a single-bit
        index error: D_t = (1/n_bits) sum_b ||J_t (e_{idx_t xor 2^b} -
        e_{idx_t})||^2 with J_t = d recon / d z_t at the clean codes,
        estimated with ``ch.uep_probes`` VJP probes (``probes``, else drawn
        from ``generator``)."""
        ch = self.cfg.channel if ch is None else ch
        idx = idx_tx.long()
        cb = self.codebook.detach()
        z_clean = cb[idx]                                      # (B, N, D)
        g = probe_grads(self.codes_to_image, z_clean,
                        self._probes(probes, idx.shape[0], generator, ch))
        shifts = 1 << torch.arange(index_bits(self.vq_codes),
                                   device=idx.device)
        delta = cb[idx[..., None] ^ shifts] - z_clean[:, :, None, :]
        dot = torch.einsum("pbnd,bnkd->pbnk", g, delta)
        return (dot * dot).mean(dim=(0, 3))

    def token_drop_damage(self, idx_tx: torch.Tensor,
                          probes: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None,
                          ch=None) -> torch.Tensor:
        """(B, N) expected squared reconstruction damage of not sending a
        token (the receiver decodes ``mask_embed``): :func:`drop_damage`
        through the image decoder. Needs ``camera.vq_prune``."""
        ch = self.cfg.channel if ch is None else ch
        return drop_damage(self.codes_to_image, self.codebook,
                           self.mask_embed, idx_tx,
                           self._probes(probes, idx_tx.shape[0], generator,
                                        ch))

    def uep_weights(self, idx_tx: torch.Tensor, snr_db,
                    probes: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    ch=None) -> torch.Tensor:
        """(B, N) per-token QPSK amplitudes at exactly unit mean power:
        power proportional to damage^alpha (``channel.uep_mode="alpha"``),
        or :func:`waterfill_power` at the SNR raised by 10 log10 d_min of
        the FEC (``"waterfill"``)."""
        ch = self.cfg.channel if ch is None else ch
        damage = self.token_damage(idx_tx, probes, generator, ch)
        if ch.uep_mode == "waterfill":
            snr_eff = torch.as_tensor(
                snr_db, dtype=torch.float32, device=damage.device) + 10.0 * (
                    torch.log10(torch.tensor(UEP_DMIN[ch.fec],
                                             dtype=torch.float32,
                                             device=damage.device)))
            return torch.sqrt(waterfill_power(damage, snr_eff))
        p_tok = torch.pow(damage + 1e-12, ch.uep_alpha)
        return torch.sqrt(p_tok / p_tok.mean(dim=1, keepdim=True))

    def forward(self, img: torch.Tensor, snr_db,
                generator: Optional[torch.Generator] = None, noise=None,
                ch=None, keep: Optional[torch.Tensor] = None,
                select: Optional[str] = None,
                select_draws: Optional[torch.Tensor] = None,
                uep_draws: Optional[torch.Tensor] = None,
                side_generator: Optional[torch.Generator] = None,
                data_mesh: Optional[Mesh] = None):
        """``(recon, aux)``: transmitter, channel and receiver in one
        forward at ``snr_db`` (scalar or (B,)) over ``ch`` (a
        ``ChannelConfig``, by default ``cfg.channel``).

        ``keep`` (B,) kept-token fractions (``camera.vq_prune`` models;
        ``None`` falls back to ``ch.token_keep`` when below 1), ranked by
        ``select`` (default ``ch.token_select``; a name outside the five
        rules ranks at random, as the JAX package). Dropped tokens send
        zero symbols and decode as ``mask_embed``; the index error rate
        counts sent tokens only. With ``ch.uep_alpha > 0`` each token's
        symbols carry its UEP amplitude.

        aux: ``vq_loss``, ``index_error_rate``, ``code_perplexity``; with
        ``camera.vq_reseed > 0`` the re-seeding inputs ``vq_counts`` and
        ``vq_candidates``; under UEP ``uep_power_spread`` (the mean over
        the batch of the std of the per-token power); under pruning
        ``token_keep_frac``. Draws (else from ``generator``, in this
        order): ``select_draws`` (the ``random`` rule's (B, N) uniform
        scores or a damage rule's probes), ``uep_draws`` (the UEP damage
        probes), ``noise`` (the channel's). ``side_generator``, when
        given, draws the selection and UEP draws instead, so that
        deployments of one point meet the same channel noise.
        ``data_mesh``: ``img`` is this rank's rows of a global batch; the
        usage loss, the re-seeding inputs, ``code_perplexity`` and
        ``index_error_rate`` are the global batch's (the other entries,
        plain means, this rank's)."""
        ch = self.cfg.channel if ch is None else ch
        side = generator if side_generator is None else side_generator
        idx_tx, vq_loss, z_ste, stats = self.quantize(
            self.encode_features(img), mesh=data_mesh)
        b = idx_tx.shape[0]
        if keep is None and self.vq_prune and ch.token_keep < 1.0:
            keep = torch.full((b,), ch.token_keep, dtype=torch.float32,
                              device=idx_tx.device)
        if keep is not None and not self.vq_prune:
            raise ValueError("keep requires camera.vq_prune=true")
        kept = None
        if keep is not None:
            select = ch.token_select if select is None else select
            damage = {"damage": functools.partial(
                          self.token_damage, generator=side, ch=ch),
                      "drop_damage": functools.partial(
                          self.token_drop_damage, generator=side, ch=ch)}
            kept = kept_tokens(select if select in SELECTS else "random",
                               idx_tx, keep, (self.image_hw[0] // 4,
                                              self.image_hw[1] // 4),
                               damage, select_draws, side)
        w_tok = token_weights = None
        if ch.uep_alpha > 0:
            w_tok = token_weights = self.uep_weights(
                idx_tx, snr_db, uep_draws, side, ch)
        if kept is not None:
            # Dropped tokens send nothing (UEP with pruning is refused).
            token_weights = kept.to(torch.float32)
        idx_rx = transmit_indices(ch, idx_tx, self.vq_codes, snr_db,
                                  generator, token_weights=token_weights,
                                  noise=noise)
        err = (idx_rx != idx_tx).float()
        # Received codes on the forward path, the clean STE on the backward.
        z_rx = z_ste + (self.codebook[idx_rx.long()] - z_ste).detach()
        sent = torch.ones_like(err) if kept is None else kept.to(torch.float32)
        if kept is not None:
            z_rx = torch.where(kept[..., None], z_rx,
                               self.mask_embed.expand_as(z_rx))
        counts = torch.bincount(idx_tx.reshape(-1).long(),
                                minlength=self.vq_codes)
        # Errors and sent tokens: whole numbers, exact in any order.
        sums = torch.stack([(err * sent).sum(), sent.sum()])
        n_tok = idx_tx.numel()
        if data_parallel(data_mesh):
            for t in (counts, sums):
                torch.distributed.all_reduce(t, group=data_mesh.data_group)
            n_tok *= data_mesh.data
        idx_err = (sums[0] / sums[1].clamp(min=1.0) if kept is not None
                   else sums[0] / n_tok)
        recon = self.codes_to_image(z_rx)
        p = counts.float() / n_tok
        aux = {"vq_loss": vq_loss, "index_error_rate": idx_err,
               "code_perplexity": torch.exp(-(p * torch.log(p + 1e-10)).sum())}
        if stats is not None:
            aux["vq_counts"] = stats["counts"]
            aux["vq_candidates"] = stats["candidates"]
        if w_tok is not None:
            aux["uep_power_spread"] = w_tok.square().std(
                dim=1, correction=0).mean()
        if kept is not None:
            aux["token_keep_frac"] = kept.to(torch.float32).mean()
        return recon, aux


@torch.no_grad()
def seed_codebook(codebook: torch.Tensor, z: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Overwrite ``codebook`` (K, D) in place with a random sample of the
    encoder outputs ``z`` (..., D), with replacement only when there are
    fewer rows than codes, plus N(0, 0.01^2) jitter so duplicated rows
    separate; returns it. The JAX package draws with ``jax.random.choice``;
    the port draws from ``generator``."""
    flat = z.reshape(-1, z.shape[-1]).to(codebook.dtype)
    k, n = codebook.shape[0], flat.shape[0]
    dev = flat.device
    if n < k:
        sel = torch.randint(0, n, (k,), generator=generator, device=dev)
    else:
        sel = torch.randperm(n, generator=generator, device=dev)[:k]
    rows = flat[sel]
    rows = rows + 0.01 * torch.randn(rows.shape, generator=generator,
                                     device=dev, dtype=rows.dtype)
    return codebook.copy_(rows)


@torch.no_grad()
def init_codebook_from_batch(model: VQEncoderTokens, img: torch.Tensor,
                             generator: Optional[torch.Generator] = None
                             ) -> torch.Tensor:
    """Data-dependent codebook seeding: the codebook becomes a sample of the
    model's own encoder outputs on a real batch (the fix for the degenerate
    optimum of a small-uniform init, where codes are interchangeable). A
    train driver calls it on a fresh run only, never on resume."""
    return seed_codebook(model.codebook, model.encode_features(img),
                         generator)
