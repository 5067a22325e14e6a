"""Camera CNN-JSCC encoder and decoders.

Counterpart of ``multimodal_sc_tpu/codec/camera_cnn.py``: ``PReLU``,
``SNRFiLM``, ``RateFiLM``, ``CameraEncoderCNN``, ``CameraDecoderCNN``,
``CameraTokensCNN`` and ``CameraJSCC`` (with the bandwidth-agile
``adaptive_rate`` codec and ``decode_seg``). Activations are NHWC as in the
JAX package. The 5x5 convs are ``FusedConvPReLU`` (the CUDA kernel on the
card); the token decoder's ``conv_in``, the decoder's upsampling transposed
convs and its segmentation head are plain convolutions in the JAX package
too (XLA), so they stay ``F.conv2d`` / ``F.conv_transpose2d``.

Under ``train.bf16`` every module takes ``dtype=torch.bfloat16`` and follows
flax's dtype rules (``act_dtype``): the convs and the PReLU run in bf16 on
f32 parameters, the FiLMs' MLPs in f32 (flax's ``Dense`` without a dtype
promotes to f32, and so does the modulation of a bf16 map by their f32
output); the encoder's symbols, the tokens, the image (its sigmoid taken in
f32) and the seg logits come out f32, so the channel stays f32.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_sc_torch.act_dtype import Conv
from multimodal_sc_torch.kernels.conv_block import FusedConvPReLU
from multimodal_sc_torch.nn_init import init_like_flax_


class PReLU(nn.Module):
    """Parametric ReLU with a learned per-channel negative slope."""

    def __init__(self, features: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((features,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, x * self.alpha.to(x.dtype))


class SNRFiLM(nn.Module):
    """FiLM modulation from an SNR(dB) scalar: x -> x * (1+g(snr)) + b(snr)."""

    def __init__(self, features: int):
        super().__init__()
        self.features = features
        self.fc1 = nn.Linear(1, 64)
        self.fc2 = nn.Linear(64, 2 * features)

    def forward(self, x: torch.Tensor, snr_db: torch.Tensor) -> torch.Tensor:
        s = (snr_db.reshape(-1, 1).to(x.dtype) - 10.0) / 15.0
        gamma, beta = self.fc2(F.relu(self.fc1(s.float()))).chunk(2, dim=-1)
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (self.features,)
        return x * (1.0 + gamma.reshape(shape)) + beta.reshape(shape)


class RateFiLM(nn.Module):
    """FiLM modulation from the adaptive-rate fraction m/c_sym in (0, 1]:
    x -> x * (1 + g(r)) + b(r), r = (rate - 0.5) * 2."""

    def __init__(self, features: int):
        super().__init__()
        self.features = features
        self.fc1 = nn.Linear(1, 32)
        self.fc2 = nn.Linear(32, 2 * features)

    def forward(self, x: torch.Tensor, rate: torch.Tensor) -> torch.Tensor:
        r = (rate.reshape(-1, 1).to(x.dtype) - 0.5) * 2.0
        gamma, beta = self.fc2(F.relu(self.fc1(r.float()))).chunk(2, dim=-1)
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (self.features,)
        return x * (1.0 + gamma.reshape(shape)) + beta.reshape(shape)


class CameraEncoderCNN(nn.Module):
    """Image (B,H,W,3) in [0,1] -> channel symbols (B, k, 2).

    Two stride-2 then two stride-1 5x5 conv+PReLU blocks, then a conv to
    2*c_sym channels read as (real, imag) pairs: k = (H/4)*(W/4)*c_sym.
    """

    def __init__(self, features: Sequence[int] = (32, 64, 128, 128),
                 c_sym: int = 8, in_channels: int = 3,
                 snr_conditioning: bool = False, adaptive_rate: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.c_sym, self.dtype = c_sym, dtype
        cin = in_channels
        for i, (f, s) in enumerate(zip(features, (2, 2, 1, 1))):
            setattr(self, f"block{i}", FusedConvPReLU(cin, f, 5, stride=s,
                                                      dtype=dtype))
            cin = f
        self.n_blocks = len(features)
        self.snr_film = SNRFiLM(features[-1]) if snr_conditioning else None
        self.rate_film = RateFiLM(features[-1]) if adaptive_rate else None
        self.conv_out = FusedConvPReLU(cin, 2 * c_sym, 5, with_prelu=False,
                                       dtype=dtype)

    def forward(self, img: torch.Tensor,
                snr_db: Optional[torch.Tensor] = None,
                rate: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = img.to(self.dtype)
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x)
        if self.snr_film is not None:
            x = self.snr_film(x, snr_db)
        if self.rate_film is not None:
            x = self.rate_film(x, rate)
        x = self.conv_out(x)
        b, h, w, _ = x.shape
        return x.reshape(b, h * w * self.c_sym, 2).float()


class CameraTokensCNN(nn.Module):
    """Noisy symbols -> decoded feature tokens (B, h*w, dim) for fusion."""

    def __init__(self, dim: int = 128, c_sym: int = 8,
                 image_hw: Tuple[int, int] = (32, 32),
                 snr_conditioning: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.c_sym, self.dtype = dim, c_sym, dtype
        self.hw = (image_hw[0] // 4, image_hw[1] // 4)
        # 5x5 stride-1 SAME: symmetric padding 2, as XLA pads it.
        self.conv_in = Conv(2 * c_sym, dim, 5, padding=2, dtype=dtype)
        self.prelu_in = PReLU(dim)
        self.snr_film = SNRFiLM(dim) if snr_conditioning else None

    def forward(self, z_hat: torch.Tensor,
                snr_db: Optional[torch.Tensor] = None) -> torch.Tensor:
        b = z_hat.shape[0]
        h, w = self.hw
        x = z_hat.reshape(b, h, w, 2 * self.c_sym).to(self.dtype)
        x = self.prelu_in(self.conv_in(x.permute(0, 3, 1, 2))
                          .permute(0, 2, 3, 1))
        if self.snr_film is not None:
            x = self.snr_film(x, snr_db)
        return x.reshape(b, h * w, self.dim).float()


class ConvTransposeSame(nn.ConvTranspose2d):
    """flax ``nn.ConvTranspose(features, (k, k), strides=(s, s),
    padding="SAME")`` on NHWC activations.

    Flax correlates the stride-dilated input with the kernel as it stands
    (``transpose_kernel=False``) after padding it ``lax``'s way, which is
    asymmetric: (3, 2) at k = 5, s = 2. ``F.conv_transpose2d`` pads both
    sides alike and flips the kernel, so the weight holds flax's kernel
    flipped and in torch's (in, out, kh, kw) layout (``bridge`` converts),
    the padding is the larger side's, and the output loses the extra rows
    and columns at the end."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, stride: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride)
        self.act_dtype = dtype
        k, s = kernel_size, stride
        # lax._conv_transpose_padding for "SAME".
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
        pad_b = pad_len - pad_a
        if pad_a < pad_b:
            raise NotImplementedError(f"kernel {k}, stride {s}: flax pads "
                                      "more after than before")
        self.torch_pad, self.crop = k - 1 - pad_a, pad_a - pad_b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.act_dtype
        if d == torch.float32:
            y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight,
                                   self.bias, self.stride, self.torch_pad)
        else:       # flax's dtype: the product rounded, then the bias added
            y = F.conv_transpose2d(x.to(d).permute(0, 3, 1, 2),
                                   self.weight.to(d), None, self.stride,
                                   self.torch_pad) + self.bias.to(d)[:, None,
                                                                     None]
        h, w = y.shape[2] - self.crop, y.shape[3] - self.crop
        return y[:, :, :h, :w].permute(0, 2, 3, 1)


class CameraDecoderCNN(nn.Module):
    """Channel symbols (B, k, 2) -> reconstructed image (B, H, W, 3) in
    [0, 1]: a conv in, two stride-1 conv blocks, two stride-2 transposed
    convs with PReLU, a conv out and a sigmoid; with ``seg_classes`` also a
    3x3 segmentation head on the last features."""

    def __init__(self, features: Sequence[int] = (128, 128, 64, 32),
                 c_sym: int = 8, image_hw: Tuple[int, int] = (32, 32),
                 out_channels: int = 3, seg_classes: int = 0,
                 snr_conditioning: bool = False, adaptive_rate: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.c_sym, self.dtype = c_sym, dtype
        self.hw = (image_hw[0] // 4, image_hw[1] // 4)
        self.block_in = FusedConvPReLU(2 * c_sym, features[0], 5, dtype=dtype)
        self.snr_film = SNRFiLM(features[0]) if snr_conditioning else None
        self.rate_film = RateFiLM(features[0]) if adaptive_rate else None
        self.strides = (1, 1, 2, 2)
        cin = features[0]
        for i, (f, s) in enumerate(zip(features, self.strides)):
            if s == 1:
                setattr(self, f"block{i}", FusedConvPReLU(cin, f, 5,
                                                          dtype=dtype))
            else:
                setattr(self, f"deconv{i}", ConvTransposeSame(cin, f, 5, s,
                                                              dtype))
                setattr(self, f"prelu{i}", PReLU(f))
            cin = f
        self.conv_out = FusedConvPReLU(cin, out_channels, 5, with_prelu=False,
                                       dtype=dtype)
        # 3x3 stride-1 SAME: symmetric padding 1.
        self.seg_head = (Conv(cin, seg_classes, 3, padding=1, dtype=dtype)
                         if seg_classes > 0 else None)

    def forward(self, z_hat: torch.Tensor,
                snr_db: Optional[torch.Tensor] = None,
                rate: Optional[torch.Tensor] = None):
        b = z_hat.shape[0]
        h, w = self.hw
        x = self.block_in(z_hat.reshape(b, h, w, 2 * self.c_sym).to(
            self.dtype))
        if self.snr_film is not None:
            x = self.snr_film(x, snr_db)
        if self.rate_film is not None:
            x = self.rate_film(x, rate)
        for i, s in enumerate(self.strides):
            if s == 1:
                x = getattr(self, f"block{i}")(x)
            else:
                x = getattr(self, f"prelu{i}")(getattr(self, f"deconv{i}")(x))
        recon = torch.sigmoid(self.conv_out(x).float())
        if self.seg_head is None:
            return recon
        seg = self.seg_head(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return recon, seg.float()


class CameraJSCC(nn.Module):
    """Encoder and decoder under one parameter tree (configs 1-3). With
    ``adaptive_rate`` both sides are FiLM-conditioned on the deployed rate
    m/c_sym, which ``encode``, ``decode`` and ``decode_seg`` then require.
    Fresh weights are drawn as flax's."""

    def __init__(self, features: Sequence[int] = (32, 64, 128, 128),
                 c_sym: int = 8, image_hw: Tuple[int, int] = (32, 32),
                 out_channels: int = 3, seg_classes: int = 0,
                 snr_conditioning: bool = False, adaptive_rate: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.c_sym, self.image_hw = c_sym, tuple(image_hw)
        self.seg_classes = seg_classes
        self.snr_conditioning = snr_conditioning
        self.adaptive_rate = adaptive_rate
        self.encoder = CameraEncoderCNN(features, c_sym,
                                        snr_conditioning=snr_conditioning,
                                        adaptive_rate=adaptive_rate,
                                        dtype=dtype)
        self.decoder = CameraDecoderCNN(tuple(reversed(features)), c_sym,
                                        image_hw, out_channels, seg_classes,
                                        snr_conditioning, adaptive_rate, dtype)
        init_like_flax_(self)

    @property
    def k(self) -> int:
        """Complex channel symbols per image."""
        h, w = self.image_hw
        return (h // 4) * (w // 4) * self.c_sym

    def _snr(self, snr_db):
        return snr_db if self.snr_conditioning else None

    def _rate(self, rate):
        if not self.adaptive_rate:
            return None
        if rate is None:
            raise ValueError("adaptive_rate codec requires a rate argument")
        return rate

    def encode(self, img: torch.Tensor,
               snr_db: Optional[torch.Tensor] = None,
               rate: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.encoder(img, self._snr(snr_db), self._rate(rate))

    def decode(self, z_hat: torch.Tensor,
               snr_db: Optional[torch.Tensor] = None,
               rate: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = self.decoder(z_hat, self._snr(snr_db), self._rate(rate))
        return out[0] if self.seg_classes > 0 else out

    def decode_seg(self, z_hat: torch.Tensor,
                   snr_db: Optional[torch.Tensor] = None,
                   rate: Optional[torch.Tensor] = None):
        """``(recon, seg_logits)``, the logits NHWC; only with a seg head."""
        if self.seg_classes <= 0:
            raise ValueError("decode_seg requires seg_classes > 0")
        return self.decoder(z_hat, self._snr(snr_db), self._rate(rate))

    def forward(self, img: torch.Tensor,
                snr_db: Optional[torch.Tensor] = None,
                rate: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Encode, then decode through an ideal channel (full rate when an
        adaptive codec is given none)."""
        if self.adaptive_rate and rate is None:
            rate = torch.ones(img.shape[0], device=img.device)
        return self.decode(self.encode(img, snr_db, rate), snr_db, rate)
