"""Camera ViT-JSCC encoder/decoder, and the MHA module the unfused fusion
layer shares.

Counterpart of ``multimodal_sc_tpu/codec/camera_vit.py``: patch embed ->
transformer encoder -> per-patch symbol head; symmetric transformer decoder
-> patch de-embed. An optional SNR token conditions both directions. Images
are NHWC at the module boundary, as in the JAX package. Attention runs
through ``kernels.attention_packed`` or ``kernels.attention`` (the CUDA
kernels under ``use_pallas`` on the card).

Under ``train.bf16`` (``dtype=torch.bfloat16``) every projection, the
patch embedding, the LayerNorms, the MLPs and the attention run in bf16 on
f32 parameters by flax's dtype rules (``act_dtype``); the image, the
positional table and ``snr_db`` are cast to bf16 on the way in, and the
symbols, tokens and image come out f32, as the JAX modules build them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_sc_torch.act_dtype import Conv, Dense, LayerNorm
from multimodal_sc_torch.kernels.attention import attention
from multimodal_sc_torch.kernels.attention_packed import (packed_attention,
                                                          packed_eligible)

_LN_EPS = 1e-6      # flax LayerNorm's epsilon (torch's default is 1e-5)


class MHA(nn.Module):
    """q/k/v/o projections around softmax attention.

    The projections are ``Dense(dim, dim)`` with the heads head-major in
    the output columns (flax ``DenseGeneral((heads, hd))`` flattened), so
    q, k and v come out in the packed (B, L, H*d) layout; ``o`` reads the
    flattened heads (flax's ``DenseGeneral(dim, axis=(-2, -1))``). With
    ``use_pallas`` and a ``packed_eligible`` shape the packed kernel runs
    on them as they are; otherwise heads are split out for ``attention``.
    """

    def __init__(self, dim: int, heads: int, use_pallas: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} not divisible by heads {heads}")
        self.dim, self.heads, self.use_pallas = dim, heads, use_pallas
        self.q = Dense(dim, dim, dtype)
        self.k = Dense(dim, dim, dtype)
        self.v = Dense(dim, dim, dtype)
        self.o = Dense(dim, dim, dtype)

    def forward(self, x_q: torch.Tensor,
                x_kv: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x_kv is None:
            x_kv = x_q
        hd = self.dim // self.heads
        q, k, v = self.q(x_q), self.k(x_kv), self.v(x_kv)
        if self.use_pallas and packed_eligible(self.heads, hd, k.shape[1]):
            o = packed_attention(q, k, v, self.heads)
        else:
            b, lq, lk = q.shape[0], q.shape[1], k.shape[1]
            # (B, L, H*D) -> (B, H, L, D)
            qh = q.reshape(b, lq, self.heads, hd).transpose(1, 2)
            kh = k.reshape(b, lk, self.heads, hd).transpose(1, 2)
            vh = v.reshape(b, lk, self.heads, hd).transpose(1, 2)
            o = attention(qh, kh, vh, use_pallas=self.use_pallas)
            o = o.transpose(1, 2).reshape(b, lq, self.dim)
        return self.o(o)


class TransformerBlock(nn.Module):
    """Pre-norm block: x + MHA(LN(x)), then x + MLP(LN(x)) with the tanh
    GELU (flax ``nn.gelu``'s default)."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4,
                 use_pallas: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln1 = LayerNorm(dim, _LN_EPS, dtype)
        self.attn = MHA(dim, heads, use_pallas, dtype)
        self.ln2 = LayerNorm(dim, _LN_EPS, dtype)
        self.mlp1 = Dense(dim, dim * mlp_ratio, dtype)
        self.mlp2 = Dense(dim * mlp_ratio, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        h = F.gelu(self.mlp1(self.ln2(x)), approximate="tanh")
        return x + self.mlp2(h)


class SNRToken(nn.Module):
    """Embed snr_db into one extra token prepended to the sequence."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.dtype = dim, dtype
        self.fc1 = Dense(1, dim, dtype)
        self.fc2 = Dense(dim, dim, dtype)

    def forward(self, snr_db: torch.Tensor, batch: int) -> torch.Tensor:
        s = (snr_db.reshape(-1, 1).to(self.dtype) - 10.0) / 15.0
        return self.fc2(torch.tanh(self.fc1(s))).reshape(batch, 1, self.dim)


class _ViTTrunk(nn.Module):
    """What the three ViT stacks share: the positional table, the optional
    SNR token, ``depth`` transformer blocks and the output LayerNorm."""

    def __init__(self, image_hw, patch: int, dim: int, depth: int, heads: int,
                 snr_conditioning: bool, use_pallas: bool,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.image_hw, self.patch, self.dim = tuple(image_hw), patch, dim
        self.depth, self.snr_conditioning = depth, snr_conditioning
        self.dtype = dtype
        self.pos = nn.Parameter(0.02 * torch.randn(1, self.num_patches, dim))
        if snr_conditioning:
            self.snr_token = SNRToken(dim, dtype)
        for i in range(depth):
            setattr(self, f"block{i}", TransformerBlock(
                dim, heads, use_pallas=use_pallas, dtype=dtype))
        self.ln_out = LayerNorm(dim, _LN_EPS, dtype)

    @property
    def num_patches(self) -> int:
        return (self.image_hw[0] // self.patch) * (self.image_hw[1] // self.patch)

    def _blocks(self, x: torch.Tensor,
                snr_db: Optional[torch.Tensor]) -> torch.Tensor:
        """(B, n, dim) embedded tokens -> (B, n, dim) after ln_out; the SNR
        token rides along in front and is dropped at the end."""
        x = x + self.pos.to(self.dtype)
        with_snr = self.snr_conditioning and snr_db is not None
        if with_snr:
            x = torch.cat([self.snr_token(snr_db, x.shape[0]), x], dim=1)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        x = self.ln_out(x)
        return x[:, 1:] if with_snr else x


class ViTEncoderJSCC(_ViTTrunk):
    """img (B, H, W, 3) -> channel symbols (B, num_patches * c_sym, 2)."""

    def __init__(self, image_hw=(32, 32), patch: int = 4, dim: int = 128,
                 depth: int = 4, heads: int = 4, c_sym: int = 8,
                 snr_conditioning: bool = True, use_pallas: bool = False,
                 in_channels: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__(image_hw, patch, dim, depth, heads, snr_conditioning,
                         use_pallas, dtype)
        self.c_sym = c_sym
        # VALID conv with stride = patch.
        self.patch_embed = Conv(in_channels, dim, patch, dtype=dtype,
                                stride=patch)
        self.sym_head = Dense(dim, 2 * c_sym, dtype)

    def forward(self, img: torch.Tensor,
                snr_db: Optional[torch.Tensor] = None) -> torch.Tensor:
        b = img.shape[0]
        x = self.patch_embed(img.to(self.dtype).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)                        # (B, n, dim)
        x = self.sym_head(self._blocks(x, snr_db))
        return x.reshape(b, self.num_patches * self.c_sym, 2).float()


class ViTDecoderJSCC(_ViTTrunk):
    """Received symbols (B, num_patches * c_sym, 2) -> image (B, H, W, C)
    in (0, 1)."""

    def __init__(self, image_hw=(32, 32), patch: int = 4, dim: int = 128,
                 depth: int = 4, heads: int = 4, c_sym: int = 8,
                 out_channels: int = 3, snr_conditioning: bool = True,
                 use_pallas: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(image_hw, patch, dim, depth, heads, snr_conditioning,
                         use_pallas, dtype)
        self.c_sym, self.out_channels = c_sym, out_channels
        self.sym_embed = Dense(2 * c_sym, dim, dtype)
        self.pixel_head = Dense(dim, patch * patch * out_channels, dtype)

    def forward(self, z_hat: torch.Tensor,
                snr_db: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, p = z_hat.shape[0], self.patch
        x = self.sym_embed(z_hat.to(self.dtype).reshape(
            b, self.num_patches, 2 * self.c_sym))
        x = self.pixel_head(self._blocks(x, snr_db))
        hp, wp = self.image_hw[0] // p, self.image_hw[1] // p
        x = x.reshape(b, hp, wp, p, p, self.out_channels)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(
            b, self.image_hw[0], self.image_hw[1], self.out_channels)
        return torch.sigmoid(x.float())


class ViTTokensDecoder(_ViTTrunk):
    """Noisy symbols -> decoded ViT tokens (B, num_patches, dim) for fusion:
    the front half of ``ViTDecoderJSCC`` (no pixel head, no SNR token)."""

    def __init__(self, image_hw=(32, 32), patch: int = 4, dim: int = 128,
                 depth: int = 2, heads: int = 4, c_sym: int = 8,
                 use_pallas: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(image_hw, patch, dim, depth, heads, False, use_pallas,
                         dtype)
        self.c_sym = c_sym
        self.sym_embed = Dense(2 * c_sym, dim, dtype)

    def forward(self, z_hat: torch.Tensor,
                snr_db: Optional[torch.Tensor] = None) -> torch.Tensor:
        b = z_hat.shape[0]
        x = self.sym_embed(z_hat.to(self.dtype).reshape(
            b, self.num_patches, 2 * self.c_sym))
        return self._blocks(x, None).float()


class ViTJSCC(nn.Module):
    """Bundled ViT encoder/decoder with the codec protocol (encode/decode)."""

    def __init__(self, image_hw=(32, 32), patch: int = 4, dim: int = 128,
                 depth: int = 4, heads: int = 4, c_sym: int = 8,
                 out_channels: int = 3, snr_conditioning: bool = True,
                 use_pallas: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.c_sym = c_sym
        kw = dict(image_hw=image_hw, patch=patch, dim=dim, depth=depth,
                  heads=heads, c_sym=c_sym, snr_conditioning=snr_conditioning,
                  use_pallas=use_pallas, dtype=dtype)
        self.encoder = ViTEncoderJSCC(**kw)
        self.decoder = ViTDecoderJSCC(out_channels=out_channels, **kw)

    def encode(self, img, snr_db=None) -> torch.Tensor:
        return self.encoder(img, snr_db)

    def decode(self, z_hat, snr_db=None) -> torch.Tensor:
        return self.decoder(z_hat, snr_db)

    def forward(self, img, snr_db=None) -> torch.Tensor:
        return self.decode(self.encode(img, snr_db), snr_db)

    @property
    def k(self) -> int:
        return self.encoder.num_patches * self.encoder.c_sym
