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


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
def test_bf16_kernels_against_their_plain_versions_on_the_card(monkeypatch):
    """train.bf16's kernels on the card: the conv (both routes) within one
    bf16 step of its plain version (outputs below 2^-14 of the largest at
    that floor's step), the scatter forward and backward bit for bit, the
    fused block's bf16 I/O within a bf16 step of its own plus 5e-3 of its
    bf16-mode plain version (``chip_smoke.py`` states why)."""
    from multimodal_sc_torch.kernels import mha_block as tmha
    from multimodal_sc_torch.kernels import pillar_scatter as tscatter

    _card()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    g = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16

    def step(t):
        _, e = torch.frexp(t.float().abs().clamp(min=2.0 ** -126))
        return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)

    for h, cin, cout, s in ((16, 32, 64, 2), (8, 128, 16, 1), (32, 3, 32, 2),
                            (32, 32, 3, 1)):
        x = torch.randn(64, h, h, cin, generator=g, device="cuda").to(bf)
        w = (torch.randn(5, 5, cin, cout, generator=g, device="cuda")
             / (25 * cin) ** 0.5).to(bf)
        b = (0.1 * torch.randn(cout, generator=g, device="cuda")).to(bf)
        a = torch.rand(cout, generator=g, device="cuda").to(bf)
        got = tconv.conv_prelu(x, w, b, a, s).float()
        want = tconv.conv_prelu_reference(x, w, b, a, s).float()
        floor = 2.0 ** -14 * want.abs().max()
        gate = torch.maximum(step(torch.maximum(want.abs(), floor)),
                             step(torch.maximum(got.abs(), floor)))
        assert bool(((got - want).abs() <= gate).all())

    feats = torch.randn(32, 64, 64, generator=g, device="cuda").to(bf)
    cell = torch.randint(0, 257, (32, 64), generator=g, device="cuda",
                         dtype=torch.int32)
    cell[:, 1::8], feats[:, 1::8] = cell[:, ::8], feats[:, ::8]   # ties
    x = feats.clone().requires_grad_(True)
    out = tscatter.scatter_max(x, cell, 256)
    assert torch.equal(out, tscatter.scatter_max_reference(feats, cell, 256))
    gy = torch.randn(32, 256, 64, generator=g, device="cuda").to(bf)
    (gx,) = torch.autograd.grad(out, x, gy)
    assert torch.equal(gx, tscatter.scatter_max_backward_reference(
        feats, cell, out.detach(), gy, 256))

    p = {k: (torch.randn(128, 128, generator=g, device="cuda") / 11.3
             if k.startswith("w") else
             0.1 * torch.randn(128, generator=g, device="cuda"))
         for k in tmha.PARAM_KEYS}
    x_q = torch.randn(64, 65, 128, generator=g, device="cuda").to(bf)
    x_kv = torch.randn(64, 256, 128, generator=g, device="cuda").to(bf)
    got = tmha.mha_block(x_q, x_kv, p, 4)
    want = tmha.mha_block_reference_bf16(x_q, x_kv, p, 4)
    assert got.dtype == bf
    assert bool(((got.float() - want.float()).abs()
                 <= step(got) + 5e-3).all())
    assert (got != want).float().mean().item() <= 1e-2


def _bf16_io_close(got, want):
    """A bf16-I/O attention kernel's output against its plain version that
    rounds where it does: within 1e-2 plus one bf16 step of the output (its
    own rounding, which sums in other orders can flip), at most 1% of the
    entries differing (``chip_smoke.py`` states the gates)."""
    assert got.dtype == want.dtype == torch.bfloat16
    _, e = torch.frexp(want.float().abs().clamp(min=2.0 ** -126))
    step = torch.ldexp(torch.ones_like(want, dtype=torch.float32), e - 8)
    assert bool(((got.float() - want.float()).abs() <= 1e-2 + step).all())
    assert (got != want).float().mean().item() <= 1e-2


def _packed_inputs(lq=200, lk=70):
    g = torch.Generator(device="cuda").manual_seed(2)
    return [torch.randn(16, n, 128, generator=g, device="cuda").to(
        torch.bfloat16) for n in (lq, lk, lk, lq)]


@pytest.mark.cuda
def test_packed_attention_bf16_io_forward_on_the_card():
    from multimodal_sc_torch.kernels import attention_packed as ap

    _card()
    q, k, v, _ = _packed_inputs()
    before = ap.launches_fwd_bf16
    got = ap.packed_attention(q, k, v, 4)
    assert ap.launches_fwd_bf16 == before + 1
    _bf16_io_close(got, ap.packed_attention_fwd_reference(q, k, v, 4,
                                                          bf16=True)[0])


@pytest.mark.cuda
def test_packed_attention_bf16_io_backward_on_the_card():
    """Lq = 200: dK and dV summed per 128-query block in bf16."""
    from multimodal_sc_torch.kernels import attention_packed as ap

    _card()
    q, k, v, do = _packed_inputs()
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ap.packed_attention(*ins, 4)
    before = ap.launches_bwd_bf16
    got = torch.autograd.grad(out, ins, do)
    assert ap.launches_bwd_bf16 == before + 1
    _, lse = ap.packed_attention_fwd_reference(q, k, v, 4, bf16=True)
    want = ap.packed_attention_bwd_reference(q, k, v, out.detach(), do, 4,
                                             bf16=True, lse=lse)
    for a, w in zip(got, want):
        _bf16_io_close(a, w)
    with pytest.raises(NotImplementedError):
        ap.packed_attention(q, k, v, 4, mxu_bf16=False)


def _flash_inputs():
    g = torch.Generator(device="cuda").manual_seed(3)
    return [torch.randn(8, n, 3, 64, generator=g, device="cuda").to(
        torch.bfloat16).transpose(1, 2) for n in (200, 70, 70, 200)]


@pytest.mark.cuda
def test_flash_attention_bf16_io_forward_on_the_card():
    from multimodal_sc_torch.kernels import attention as fa

    _card()
    q, k, v, _ = _flash_inputs()
    before = fa.launches_fwd_bf16
    out, lse = fa._fwd_cuda(q, k, v, 0.125)
    assert fa.launches_fwd_bf16 == before + 1
    want, want_lse = fa.flash_attention_fwd_reference(q, k, v, 0.125)
    _bf16_io_close(out, want)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
def test_flash_attention_bf16_io_dq_on_the_card():
    from multimodal_sc_torch.kernels import attention as fa

    _card()
    q, k, v, do = _flash_inputs()
    out, lse = fa._fwd_cuda(q, k, v, 0.125)
    before = fa.launches_bwd_dq_bf16
    dq, delta = fa._bwd_dq_cuda(q, k, v, out, lse, do, 0.125)
    assert fa.launches_bwd_dq_bf16 == before + 1
    want, want_delta = fa.flash_attention_dq_reference(q, k, v, out, lse, do,
                                                       0.125)
    _bf16_io_close(dq, want)
    torch.testing.assert_close(delta, want_delta, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_flash_attention_bf16_io_dkv_on_the_card():
    from multimodal_sc_torch.kernels import attention as fa

    _card()
    q, k, v, do = _flash_inputs()
    out, lse = fa._fwd_cuda(q, k, v, 0.125)
    _, delta = fa._bwd_dq_cuda(q, k, v, out, lse, do, 0.125)
    before = fa.launches_bwd_dkv_bf16
    got = fa._bwd_dkv_cuda(q, k, v, lse, delta, do, 0.125)
    assert fa.launches_bwd_dkv_bf16 == before + 1
    want = fa.flash_attention_dkv_reference(q, k, v, lse, delta, do, 0.125)
    for a, w in zip(got, want):
        _bf16_io_close(a, w)


# The bf16 wgmma kernels at their other shapes: (B, H, Lq, Lk, D, layout).
# D 32 and 96: q scale in three bf16 pieces (no power-of-two scale); D 96
# and 128 at compiled width 128 (32-row backward tiles); D 12 no multiple of
# 8 (8-byte copies); ragged Lk and Lq throughout; "heads" the (B, L, H, D)
# projection read as (B, H, L, D) in place.
FLASH_BF16_SHAPES = {
    "d32_ragged": (2, 4, 100, 70, 32, "contiguous"),
    "d96_heads": (2, 3, 40, 130, 96, "heads"),
    "d128_heads": (3, 2, 33, 130, 128, "heads"),
    "d12_8byte": (2, 3, 90, 150, 12, "contiguous"),
    "d8_heads": (4, 5, 300, 7, 8, "heads"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FLASH_BF16_SHAPES))
def test_flash_attention_bf16_wgmma_kernels_on_the_card(name):
    from multimodal_sc_torch.kernels import attention as fa

    _card()
    b, h, lq, lk, d, layout = FLASH_BF16_SHAPES[name]
    g = torch.Generator(device="cuda").manual_seed(4)

    def make(n):
        if layout == "heads":
            return torch.randn(b, n, h, d, generator=g, device="cuda").to(
                torch.bfloat16).transpose(1, 2)
        return torch.randn(b, h, n, d, generator=g, device="cuda").to(
            torch.bfloat16)

    q, k, v, do = make(lq), make(lk), make(lk), make(lq)
    scale = d ** -0.5
    counts = ("launches_fwd_bf16", "launches_bwd_dq_bf16",
              "launches_bwd_dkv_bf16")
    before = [getattr(fa, c) for c in counts]
    out, lse = fa._fwd_cuda(q, k, v, scale)
    dq, delta = fa._bwd_dq_cuda(q, k, v, out, lse, do, scale)
    dk, dv = fa._bwd_dkv_cuda(q, k, v, lse, delta, do, scale)
    assert [getattr(fa, c) - n for c, n in zip(counts, before)] == [1, 1, 1]
    # Each result is its f32 sums rounded once, at the store.
    f32 = torch.float32
    assert torch.equal(out, fa._fwd_cuda(q, k, v, scale, out_dtype=f32)[0]
                       .bfloat16())
    assert torch.equal(dq, fa._bwd_dq_cuda(q, k, v, out, lse, do, scale,
                                           out_dtype=f32)[0].bfloat16())
    for a, w in zip((dk, dv), fa._bwd_dkv_cuda(q, k, v, lse, delta, do,
                                               scale, out_dtype=f32)):
        assert torch.equal(a, w.bfloat16())
    want, want_lse = fa.flash_attention_fwd_reference(q, k, v, scale)
    _bf16_io_close(out, want)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=2e-5)
    want_dq, want_delta = fa.flash_attention_dq_reference(q, k, v, out, lse,
                                                          do, scale)
    _bf16_io_close(dq, want_dq)
    torch.testing.assert_close(delta, want_delta, atol=1e-5, rtol=1e-5)
    for a, w in zip((dk, dv), fa.flash_attention_dkv_reference(
            q, k, v, lse, delta, do, scale)):
        _bf16_io_close(a, w)


@pytest.mark.cuda
def test_bf16_c4_vq_act_step_on_the_card(monkeypatch):
    """One act iteration of c4_vq under train.bf16 at 64 envs: the camera's
    4 encoder convs, the 8 fused blocks and the scatter on their bf16-I/O
    kernels, no f32 kernel; the code features bf16-valued, widened to f32
    for the nearest-code search; Q finite; parameters f32."""
    from multimodal_sc_torch.codec import semantic_vq
    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.kernels import mha_block as tmha
    from multimodal_sc_torch.kernels import pillar_scatter as tscatter
    from multimodal_sc_torch.rl import dqn
    from multimodal_sc_torch.rl.warmstart import cold_start

    _card()
    cfg = get_preset("c4").override_str(["camera.arch=vq", "train.bf16=true"])
    state = dqn.init(cfg, seed=0, num_envs=64, device="cuda")
    cold_start(cfg, (state.params, state.target_params, state.ema_params))
    mods = {"conv": (tconv, 4), "mha": (tmha, 8), "scatter": (tscatter, 1)}
    before = {k: (m.launches, m.launches_bf16) for k, (m, _) in mods.items()}
    features = []
    quantize = semantic_vq.vector_quantize

    def seen(z_e, *args, **kwargs):
        features.append(z_e.detach())
        return quantize(z_e, *args, **kwargs)

    monkeypatch.setattr(semantic_vq, "vector_quantize", seen)
    state, metrics = dqn.make_iteration(cfg, learn=False)(state)
    torch.cuda.synchronize()
    for k, (m, n) in mods.items():
        assert (m.launches, m.launches_bf16) == (before[k][0],
                                                 before[k][1] + n), k
    (z,) = features
    assert z.dtype == torch.float32
    assert torch.equal(z, z.to(torch.bfloat16).float())
    with torch.no_grad():
        q = state.params(dqn.dequantize_image(state.obs_image),
                         state.obs_points, state.obs_mask,
                         generator=state.generator)
    assert q.shape == (64, cfg.rl.num_actions) and torch.isfinite(q).all()
    assert all(torch.isfinite(v).all() for v in metrics.values())
    assert all(p.dtype == torch.float32 for p in state.params.parameters())


def _bf16_step(t):
    _, e = torch.frexp(t.float().abs().clamp(min=2.0 ** -126))
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


# The bf16 wgmma conv: a small grid whose output tiles split their taps over
# a cluster of blocks (B 32 on 8 x 8 maps: 16 tiles) and a large one that
# does not (B 1024), the first layer's Cin = 3 (K flattened), and a ragged M
# (3 images of 7 x 9) with Cout 24 (a 32-wide tile, 8 columns masked).
CONV_BF16_SHAPES = {  # (B, H, W, Cin, Cout, stride)
    "split_b32": (32, 8, 8, 128, 128, 1),
    "unsplit_b1024": (1024, 8, 8, 128, 128, 1),
    "cin3_flat": (64, 32, 32, 3, 32, 2),
    "ragged_m": (3, 7, 9, 32, 24, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONV_BF16_SHAPES))
def test_conv_prelu_bf16_wgmma_kernel_on_the_card(name, monkeypatch):
    """Within one bf16 step of the plain version (outputs below 2^-14 of the
    largest at that floor's step), one launch, and the same bits on a second
    run (a split tile adds its blocks' sums in rank order)."""
    _card()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    b, h, w, cin, cout, s = CONV_BF16_SHAPES[name]
    g = torch.Generator(device="cuda").manual_seed(5)
    bf = torch.bfloat16
    x = torch.randn(b, h, w, cin, generator=g, device="cuda").to(bf)
    wt = (torch.randn(5, 5, cin, cout, generator=g, device="cuda")
          / (25 * cin) ** 0.5).to(bf)
    bias = (0.1 * torch.randn(cout, generator=g, device="cuda")).to(bf)
    a = torch.rand(cout, generator=g, device="cuda").to(bf)
    assert tconv.tensor_core_path(cin, cout, bf)
    splits = tconv.bf16_splits(b, h, w, cin, cout, 5, s)
    if name == "split_b32":
        assert splits > 1
    if name == "unsplit_b1024":
        assert splits == 1
    before = tconv.launches_bf16
    got = tconv.conv_prelu(x, wt, bias, a, s)
    assert tconv.launches_bf16 == before + 1
    want = tconv.conv_prelu_reference(x, wt, bias, a, s)
    g32, w32 = got.float(), want.float()
    floor = 2.0 ** -14 * w32.abs().max()
    gate = torch.maximum(_bf16_step(torch.maximum(w32.abs(), floor)),
                         _bf16_step(torch.maximum(g32.abs(), floor)))
    assert bool(((g32 - w32).abs() <= gate).all())
    assert torch.equal(got, tconv.conv_prelu(x, wt, bias, a, s))


# The bf16 wgmma packed forward: one pass at Lk 65 and 256 (one and four
# 64-key chunks), two passes over 256-key chunks at Lk 300 and 1100; head
# dims 8 (tiles 32 wide, half a k-step) and 64, with d 32 beside them.
PACKED_BF16_SHAPES = {  # (B, Lq, Lk, dm, heads)
    "lk65_d32": (64, 65, 65, 128, 4),
    "lk65_d64": (16, 130, 65, 128, 2),
    "lk256_d8": (8, 65, 256, 128, 16),
    "lk256_d64": (8, 256, 256, 128, 2),
    "lk300_d8": (8, 70, 300, 128, 16),
    "lk1100_d64": (4, 100, 1100, 128, 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PACKED_BF16_SHAPES))
def test_packed_attention_bf16_wgmma_forward_on_the_card(name):
    """The bf16-I/O output and lse within the plain version's gates, and
    within the same gates of the bf16 mode's f32-I/O kernel on the widened
    values (its output rounded to bf16)."""
    from multimodal_sc_torch.kernels import attention_packed as ap

    _card()
    b, lq, lk, dm, heads = PACKED_BF16_SHAPES[name]
    g = torch.Generator(device="cuda").manual_seed(6)
    q, k, v = (torch.randn(b, n, dm, generator=g, device="cuda").to(
        torch.bfloat16) for n in (lq, lk, lk))
    scale = (dm // heads) ** -0.5
    before = ap.launches_fwd_bf16
    out, lse = ap._fwd_cuda(q, k, v, heads, scale, True, want_lse=True)
    assert ap.launches_fwd_bf16 == before + 1
    out32, lse32 = ap._fwd_cuda(q.float(), k.float(), v.float(), heads,
                                scale, True, want_lse=True)
    _bf16_io_close(out, out32.bfloat16())
    torch.testing.assert_close(lse, lse32, atol=2e-5, rtol=2e-5)
    want, want_lse = ap.packed_attention_fwd_reference(q, k, v, heads, scale,
                                                       bf16=True)
    _bf16_io_close(out, want)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=2e-5)


# The bf16 wgmma fused block (mha_wgmma_bf16_kernel): the CPU model's shapes
# (tests/test_torch_mha_bf16_wgmma.py). At B 2 a batch element's query
# tiles split over blocks wherever it has two or more; in a batch of 140
# they do not.
MHA_BF16_SHAPES = {  # (B, Lq, Lk, heads)
    "lq17_lk70_h4": (2, 17, 70, 4),
    "lq65_lk65_h2": (2, 65, 65, 2),
    "lq33_lk256_h4": (2, 33, 256, 4),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MHA_BF16_SHAPES))
def test_mha_block_bf16_wgmma_kernel_on_the_card(name):
    """At each shape in a batch of 140: every output within one bf16 step
    of its own plus 5e-3 of the plain version and at most 1% of them
    differing (``chip_smoke.py``'s gates; the share is taken over the whole
    batch: over B 2's few thousand outputs it is noise, up to 0.75% for
    ``mha_mma_kernel``). The batch's first B elements alone: one launch,
    query tiles split over blocks, the same bits as inside the batch and
    on a second run."""
    from multimodal_sc_torch.kernels import mha_block as tmha

    _card()
    b, lq, lk, heads = MHA_BF16_SHAPES[name]
    assert tmha.wgmma_route(True, True, lk)
    g = torch.Generator(device="cuda").manual_seed(8)
    p = {}
    for k in tmha.PARAM_KEYS:
        if k.startswith("w"):
            p[k] = torch.randn(128, 128, generator=g, device="cuda") / 11.3
        elif "scale" in k:
            p[k] = 1.0 + 0.1 * torch.randn(128, generator=g, device="cuda")
        else:
            p[k] = 0.1 * torch.randn(128, generator=g, device="cuda")
    x_q = torch.randn(140, lq, 128, generator=g, device="cuda").to(
        torch.bfloat16)
    x_kv = torch.randn(140, lk, 128, generator=g, device="cuda").to(
        torch.bfloat16)
    big = tmha.mha_block(x_q, x_kv, p, heads)
    want = tmha.mha_block_reference_bf16(x_q, x_kv, p, heads)
    assert big.dtype == torch.bfloat16
    assert bool(((big.float() - want.float()).abs()
                 <= _bf16_step(big) + 5e-3).all())
    assert (big != want).float().mean().item() <= 1e-2
    before = tmha.launches_bf16
    got = tmha.mha_block(x_q[:b], x_kv[:b], p, heads)
    assert tmha.launches_bf16 == before + 1
    assert torch.equal(got, big[:b])
    assert torch.equal(got, tmha.mha_block(x_q[:b], x_kv[:b], p, heads))


# The bf16 wgmma packed backward (bwd_wgmma_bf16_kernel): the CPU model's
# shapes (tests/test_torch_packed_bwd_bf16_wgmma.py), each tensor at least
# 30,000 outputs.
PACKED_BWD_BF16_SHAPES = {  # (B, Lq, Lk, heads)
    "lq65_lk65_h4": (4, 65, 65, 4),
    "lq65_lk256_h4": (4, 65, 256, 4),
    "lq200_lk48_h4": (5, 200, 48, 4),
    "lq130_lk100_h2": (2, 130, 120, 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PACKED_BWD_BF16_SHAPES))
def test_packed_attention_bf16_wgmma_backward_on_the_card(name):
    """dQ, dK and dV within the plain version's gates (``_bf16_io_close``),
    one launch counted, and the same bits on a second run."""
    from multimodal_sc_torch.kernels import attention_packed as ap

    _card()
    b, lq, lk, heads = PACKED_BWD_BF16_SHAPES[name]
    assert ap.bwd_wgmma_route(True, True, lk)
    g = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, do = (torch.randn(b, n, 128, generator=g, device="cuda").to(
        torch.bfloat16) for n in (lq, lk, lk, lq))
    scale = (128 // heads) ** -0.5
    out, lse = ap._fwd_cuda(q, k, v, heads, scale, True, want_lse=True)
    before = ap.launches_bwd_bf16
    got = ap._bwd_cuda(q, k, v, out, lse, do, heads, scale, True)
    assert ap.launches_bwd_bf16 == before + 1
    want = ap.packed_attention_bwd_reference(q, k, v, out, do, heads, scale,
                                             bf16=True, lse=lse)
    for a, w in zip(got, want):
        _bf16_io_close(a, w)
    again = ap._bwd_cuda(q, k, v, out, lse, do, heads, scale, True)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
