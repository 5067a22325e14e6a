"""PyTorch/CUDA port of ``multimodal_sc_tpu`` for NVIDIA Hopper.

Mirrors the JAX package's sub-package and module names. Entry points take
an explicit ``device`` (default ``"cuda"``); the hand-written CUDA kernels
under ``csrc/`` are built with ``nvcc`` at first use
(``kernels/_build.py``). Imports ``torch`` and numpy, never JAX.
"""

from multimodal_sc_torch.config import get_preset
from multimodal_sc_torch.device import resolve_device

__all__ = ["get_preset", "resolve_device"]
