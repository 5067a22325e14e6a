"""Tests of the port's CUDA kernels that need the card (marked ``cuda``;
each skips without one). This file imports no JAX, so it also runs where
only the port's packages are installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import pytest
import torch

from multimodal_sc_torch.kernels import conv_block as tconv


@pytest.mark.cuda
def test_banded_kernel_is_bit_equal_to_one_band_an_image_on_the_card(
        monkeypatch):
    """On the card: the planned bands give the same bits as one band an
    image (the kernel as it ran before banding), and the plain version's
    values within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    # The plain version on cuDNN in exact f32, not TF32.
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    g = torch.Generator(device="cuda").manual_seed(0)
    for h, cin, cout, s in ((32, 32, 3, 1), (32, 3, 32, 2)):
        x = torch.randn(64, h, h, cin, generator=g, device="cuda")
        w = torch.randn(5, 5, cin, cout, generator=g, device="cuda") / 20
        b = torch.randn(cout, generator=g, device="cuda")
        oh = -(-h // s)
        one = tconv._conv_prelu_cuda(x, w, b, None, s, band=oh)
        banded = tconv._conv_prelu_cuda(x, w, b, None, s)
        assert torch.equal(one, banded)
        torch.testing.assert_close(
            banded, tconv.conv_prelu_reference(x, w, b, None, s),
            atol=1e-4, rtol=1e-4)
