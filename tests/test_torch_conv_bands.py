"""The banded path of the port's ``conv_prelu`` kernel (Cin or Cout no
multiple of 4): the plan that picks a block's band of output rows, and a
PyTorch model of the kernel's banded index map (which padded input rows a
band loads into shared memory, and where its outputs land) against the
plain version and the JAX package's reference on the same numpy-seeded
inputs. The CUDA kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sc_torch.kernels import conv_block as tconv
from multimodal_sc_tpu.kernels import conv_block as jconv

SMS = 132


def _banded_model(x, w, b, alpha, stride, band):
    """What the kernel computes, block by block: for image n and band j the
    window holds padded rows ``oy0 * stride + r`` (r < (rows - 1) * stride +
    K) of every padded column, read from the image where the row and column
    fall inside it and zero elsewhere; output row ``oy0 + oy`` reads window
    rows ``oy * stride + ky``."""
    n, h, wd, cin = x.shape
    k, cout = w.shape[0], w.shape[3]
    oh, ow = -(-h // stride), -(-wd // stride)
    (pad_h, _), (pad_w, _) = (tconv.same_pads(h, k, stride),
                              tconv.same_pads(wd, k, stride))
    wp = (ow - 1) * stride + k
    out = torch.full((n, oh, ow, cout), float("nan"))
    bands = -(-oh // band)
    for blk in range(n * bands):
        img, oy0 = blk // bands, (blk % bands) * band
        rows = min(band, oh - oy0)
        hb = (rows - 1) * stride + k
        iy = oy0 * stride + torch.arange(hb) - pad_h
        ix = torch.arange(wp) - pad_w
        inside = ((iy >= 0) & (iy < h))[:, None] & ((ix >= 0) & (ix < wd))
        win = torch.zeros(hb, wp, cin)
        win[inside] = x[img][iy.clamp(0, h - 1)][:, ix.clamp(0, wd - 1)][inside]
        # The kernel's window: these pixels at a stride of cin | 1 floats.
        assert tconv.band_window_bytes(rows, ow, cin, k, stride) == \
            hb * wp * (cin | 1) * 4
        # The window's outputs: a VALID conv of it at the layer's stride.
        y = torch.nn.functional.conv2d(
            win.permute(2, 0, 1)[None], w.permute(3, 2, 0, 1), b,
            stride=stride)[0].permute(1, 2, 0)
        assert y.shape == (rows, ow, cout)
        if alpha is not None:
            y = torch.where(y >= 0, y, y * alpha)
        assert torch.isnan(out[img, oy0:oy0 + rows]).all()   # written once
        out[img, oy0:oy0 + rows] = y
    return out


@pytest.mark.parametrize("hw,cin,cout,stride,prelu,batch", [
    ((32, 32), 32, 3, 1, False, 3),      # c1's decoder conv_out
    ((32, 32), 3, 32, 2, True, 2),       # the encoder's block0
    ((64, 64), 32, 3, 1, False, 1),      # c3-cnn's conv_out
    ((64, 64), 3, 32, 2, True, 1),       # c3-cnn's block0
    ((9, 7), 5, 6, 2, True, 4),          # odd maps, asymmetric padding
    ((7, 9), 6, 5, 1, False, 2)])
def test_banded_index_map_matches_plain_and_jax(hw, cin, cout, stride, prelu,
                                                batch):
    rng = np.random.default_rng(hw[0] * 100 + cin * 10 + stride)
    x = rng.standard_normal((batch, *hw, cin)).astype(np.float32)
    w = (rng.standard_normal((5, 5, cin, cout)) / np.sqrt(25 * cin)).astype(
        np.float32)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    a = rng.uniform(0, 1, cout).astype(np.float32) if prelu else None
    tx, tw, tb = (torch.from_numpy(v) for v in (x, w, b))
    ta = torch.from_numpy(a) if prelu else None
    want = tconv.conv_prelu_reference(tx, tw, tb, ta, stride)
    jwant = np.asarray(jconv.conv_prelu_reference(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        jnp.asarray(a) if prelu else None, stride))
    oh, ow = want.shape[1:3]
    plan = tconv.band_plan(batch, oh, ow, cin, 5, stride)
    for band in sorted({1, 2, plan, oh}):
        got = _banded_model(tx, tw, tb, ta, stride, band)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=f"band {band}")
        np.testing.assert_allclose(got.numpy(), jwant, atol=1e-5, rtol=1e-5,
                                   err_msg=f"band {band}")


@pytest.mark.parametrize("batch", [32, 64])
@pytest.mark.parametrize("size", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("cin,cout,stride", [(32, 3, 1), (3, 32, 2),
                                             (16, 3, 1), (3, 16, 1)])
def test_band_plan_fits_and_fills_the_card(batch, size, cin, cout, stride):
    oh = ow = -(-size // stride)
    band = tconv.band_plan(batch, oh, ow, cin, 5, stride)
    assert 1 <= band <= oh
    smem = tconv.band_window_bytes(band, ow, cin, 5, stride)
    assert smem <= tconv._SMEM_LIMIT
    # Within the aim unless one row alone exceeds it.
    assert smem <= tconv._SMEM_AIM or band == 1
    assert batch * -(-oh // band) >= SMS


def test_band_plan_keeps_large_batches_whole_and_refuses_wide_rows():
    # c4's act batch: one band an image, as the kernel ran before banding.
    assert tconv.band_plan(1024, 16, 16, 3, 5, 2) == 16
    # A batch too small for 132 blocks takes one row a block.
    assert tconv.band_plan(1, 8, 8, 32, 5, 1) == 1
    # At Cin 32 (33 floats a pixel) and K 5 one row of a 348-pixel image
    # fits, of 349 not.
    tconv.band_plan(1, 348, 348, 32, 5, 1)
    with pytest.raises(ValueError, match="at most 348 pixels wide"):
        tconv.band_plan(1, 349, 349, 32, 5, 1)
