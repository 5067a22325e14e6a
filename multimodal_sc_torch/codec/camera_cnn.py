"""Camera CNN-JSCC encoder and token decoder (the RL trunk's half).

Counterpart of ``multimodal_sc_tpu/codec/camera_cnn.py``: ``PReLU``,
``SNRFiLM``, ``CameraEncoderCNN`` and ``CameraTokensCNN``. Activations are
NHWC as in the JAX package. The encoder's convs are ``FusedConvPReLU``
(the CUDA kernel on the card); the token decoder's ``conv_in`` is a plain
convolution in the JAX package too, so it stays ``F.conv2d``. The JSCC
reconstruction decoder (``CameraDecoderCNN``, ``CameraJSCC``,
``RateFiLM``) waits for the c1/c2 slice (ROADMAP item 12).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_sc_torch.kernels.conv_block import FusedConvPReLU


class PReLU(nn.Module):
    """Parametric ReLU with a learned per-channel negative slope."""

    def __init__(self, features: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((features,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, x * self.alpha)


class SNRFiLM(nn.Module):
    """FiLM modulation from an SNR(dB) scalar: x -> x * (1+g(snr)) + b(snr)."""

    def __init__(self, features: int):
        super().__init__()
        self.features = features
        self.fc1 = nn.Linear(1, 64)
        self.fc2 = nn.Linear(64, 2 * features)

    def forward(self, x: torch.Tensor, snr_db: torch.Tensor) -> torch.Tensor:
        s = (snr_db.reshape(-1, 1).to(x.dtype) - 10.0) / 15.0
        gamma, beta = self.fc2(F.relu(self.fc1(s))).chunk(2, dim=-1)
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (self.features,)
        return x * (1.0 + gamma.reshape(shape)) + beta.reshape(shape)


class CameraEncoderCNN(nn.Module):
    """Image (B,H,W,3) in [0,1] -> channel symbols (B, k, 2).

    Two stride-2 then two stride-1 5x5 conv+PReLU blocks, then a conv to
    2*c_sym channels read as (real, imag) pairs: k = (H/4)*(W/4)*c_sym.
    """

    def __init__(self, features: Sequence[int] = (32, 64, 128, 128),
                 c_sym: int = 8, in_channels: int = 3,
                 snr_conditioning: bool = False):
        super().__init__()
        self.c_sym = c_sym
        cin = in_channels
        for i, (f, s) in enumerate(zip(features, (2, 2, 1, 1))):
            setattr(self, f"block{i}", FusedConvPReLU(cin, f, 5, stride=s))
            cin = f
        self.n_blocks = len(features)
        self.snr_film = SNRFiLM(features[-1]) if snr_conditioning else None
        self.conv_out = FusedConvPReLU(cin, 2 * c_sym, 5, with_prelu=False)

    def forward(self, img: torch.Tensor,
                snr_db: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = img.float()
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x)
        if self.snr_film is not None:
            x = self.snr_film(x, snr_db)
        x = self.conv_out(x)
        b, h, w, _ = x.shape
        return x.reshape(b, h * w * self.c_sym, 2)


class CameraTokensCNN(nn.Module):
    """Noisy symbols -> decoded feature tokens (B, h*w, dim) for fusion."""

    def __init__(self, dim: int = 128, c_sym: int = 8,
                 image_hw: Tuple[int, int] = (32, 32),
                 snr_conditioning: bool = False):
        super().__init__()
        self.dim, self.c_sym = dim, c_sym
        self.hw = (image_hw[0] // 4, image_hw[1] // 4)
        # 5x5 stride-1 SAME: symmetric padding 2, as XLA pads it.
        self.conv_in = nn.Conv2d(2 * c_sym, dim, 5, padding=2)
        self.prelu_in = PReLU(dim)
        self.snr_film = SNRFiLM(dim) if snr_conditioning else None

    def forward(self, z_hat: torch.Tensor,
                snr_db: Optional[torch.Tensor] = None) -> torch.Tensor:
        b = z_hat.shape[0]
        h, w = self.hw
        x = z_hat.reshape(b, h, w, 2 * self.c_sym).permute(0, 3, 1, 2)
        x = self.prelu_in(self.conv_in(x).permute(0, 2, 3, 1))
        if self.snr_film is not None:
            x = self.snr_film(x, snr_db)
        return x.reshape(b, h * w, self.dim)
