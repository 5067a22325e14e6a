#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``multimodal_sc_torch``) on one GPU.

    python3 chip_smoke.py [--profile]

Builds every CUDA kernel from ``multimodal_sc_torch/csrc`` with ``nvcc``,
holds each kernel against its plain PyTorch version on the card at the
shapes of the c4 paths, times both, then drives three paths through the
port's entry points at 1024 envs, full widths, random weights from seed 0:

* the c4 DQN act-only iteration;
* arm A, act+learn on the c4 preset as it stands (fused blocks: the kernel
  when acting, the plain version inside the learner);
* arm B, act+learn with ``pallas_mha_block=False, pallas_attention=True``
  (the unfused fusion layers on the packed attention kernels, forward and
  backward), plus one learn step on a fixed batch through the kernels in
  f32 mode against the same step through the plain versions.

Each path is driven with the launch counts set to 0 just before and read
just after, and fails unless every kernel of that path ran the expected
number of times and the outputs are finite. Prints the card, the
per-kernel JSON line and, last, ``{"ok": true, "device": {...}}``. Exits
non-zero, printing no result, when CUDA is absent or any phase fails.
Imports nothing of JAX.

``--profile`` adds, after each path, where its time goes: the layers of
the act iteration and the parts of one learn step timed alone, the
device's idle share (an unprofiled wall time against the device time a
CUDA-only ``torch.profiler`` trace sees), and the trace's kernels by
device time.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time
from unittest import mock

# Published H100 SXM peaks (dense): bf16 tensor-core and f32 CUDA-core
# FLOP/s, HBM bytes/s. A card below its 700 W limit runs slower.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

NUM_ENVS = 1024
WARMUP_ITERS = 3
TIMED_ITERS = 10
# Per-act-step launches the c4 main path must show: 4 fused blocks x
# depth 2; 5 encoder convs; one batched scatter.
EXPECTED_LAUNCHES = {"mha_block": 8, "conv_prelu": 5, "scatter_max": 1,
                     "packed_attention_fwd": 0, "packed_attention_bwd": 0}
FUSION_DEPTH = 2            # c4 fusion.depth: each block shape twice a step
# Per act+learn iteration: the act forward at 1024 envs, then the learner's
# three forwards (and, for the packed attention, one backward) at batch 128.
# Arm A: the learner runs the fused blocks through the plain version.
EXPECTED_LEARN_A = {"mha_block": 8, "conv_prelu": 5 + 15,
                    "scatter_max": 1 + 3, "packed_attention_fwd": 0,
                    "packed_attention_bwd": 0}
# Arm B: four attentions x depth 2 per forward. The backward runs for six
# of the eight: the last layer's LiDAR stream (lid2cam, lid_self) feeds
# nothing after it (the state is read from the camera stream's CLS token),
# so autograd never reaches those two.
ATTN_BWD_PER_STEP = 4 * FUSION_DEPTH - 2
EXPECTED_LEARN_B = {"mha_block": 0, "conv_prelu": 5 + 15,
                    "scatter_max": 1 + 3, "packed_attention_fwd": 8 + 24,
                    "packed_attention_bwd": ATTN_BWD_PER_STEP}
ARM_B = ["pallas_mha_block=false", "pallas_attention=true"]
LEARN_WARMUP_ITERS = 5      # the replay is warm from iteration 3 (n_step 3)
LEARN_TIMED_ITERS = 10
LEARN_BATCH = 128           # c4 rl.batch_size
C4_ATTN_SHAPES = ((65, 256), (256, 65), (65, 65), (256, 256))


def _counters():
    """name -> (module, attribute) of every kernel wrapper's launch count."""
    from multimodal_sc_torch.kernels import (attention_packed, conv_block,
                                             mha_block, pillar_scatter)

    return {"mha_block": (mha_block, "launches"),
            "conv_prelu": (conv_block, "launches"),
            "scatter_max": (pillar_scatter, "launches"),
            "packed_attention_fwd": (attention_packed, "launches_fwd"),
            "packed_attention_bwd": (attention_packed, "launches_bwd")}


def _reset_counts():
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def _read_counts():
    return {k: getattr(mod, attr) for k, (mod, attr) in _counters().items()}


def _check_counts(launches, expected, iters, what):
    for k, per_iter in expected.items():
        if launches[k] != per_iter * iters:
            raise RuntimeError(
                f"{what}: {k} launched {launches[k]} times in {iters} "
                f"iterations, expected {per_iter} per iteration")


def _ms(fn, iters=10, warmup=2):
    """Mean device time of ``fn`` in ms over ``iters`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _bound_ms(flops, nbytes, peak_ops):
    t_ops = flops / peak_ops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _entry(name, route, source, replaces, rows):
    """One kernel's line: times and bounds per act step, each shape's row
    weighted by how often one act step launches it (``per_step``)."""
    def total(key):
        vals = [r[key] for r in rows]
        if any(v is None for v in vals):
            return None
        return sum(v * r["per_step"] for v, r in zip(vals, rows))

    bound = total("bound_ms")
    by_ops = sum(r["bound_ms"] * r["per_step"] for r in rows
                 if r["bound_by"] == "operations")
    return {"name": name, "route": route, "source": source,
            "replaces": replaces, "launches": 0,
            "max_abs_err": max(r["err"] for r in rows),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": bound,
            "bound_by": "operations" if by_ops >= bound / 2 else "bytes",
            "library_ms": total("library_ms")}


def check_mha_block():
    """Kernel vs plain version at the four (Lq, Lk) pairs of the c4 path."""
    import torch

    from multimodal_sc_torch.kernels import mha_block as mb

    g = torch.Generator(device="cuda").manual_seed(0)
    dim, heads, b = 128, 4, NUM_ENVS

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    p = {}
    for k in mb.PARAM_KEYS:
        if k.startswith("w"):
            p[k] = rnd(dim, dim) * dim ** -0.5
        elif "scale" in k:
            p[k] = 1.0 + 0.1 * rnd(dim)
        else:
            p[k] = 0.1 * rnd(dim)
    rows = []
    for lq, lk in ((65, 256), (256, 65), (65, 65), (256, 256)):
        x_q, x_kv = rnd(b, lq, dim), rnd(b, lk, dim)
        ref = mb.mha_block_reference(x_q, x_kv, p, heads)
        ref_bf16 = mb.mha_block_reference_bf16(x_q, x_kv, p, heads)
        out_f32 = mb.mha_block(x_q, x_kv, p, heads, mxu_bf16=False)
        out_bf16 = mb.mha_block(x_q, x_kv, p, heads)
        torch.cuda.synchronize()
        err_f32 = (out_f32 - ref).abs().max().item()
        err_bf16 = (out_bf16 - ref_bf16).abs().max().item()
        mean_bf16 = (out_bf16 - ref_bf16).abs().mean().item()
        err_vs_f32 = (out_bf16 - ref).abs().max().item()
        mean_vs_f32 = (out_bf16 - ref).abs().mean().item()
        att = (ref - x_q).abs().max().item()
        # f32 mode: same arithmetic as the plain version in another order
        # of summation (128-term dots, <=256-term softmax sums): 1e-4.
        torch.testing.assert_close(out_f32, ref, atol=1e-4, rtol=1e-4)
        # bf16 mode (the main path) against the plain version that rounds
        # the same operands to bf16 in the same order. Only the order of
        # the f32 sums differs; now and then that flips one operand's
        # rounding by one bf16 step (2^-8 relative, 2^-6 for an attention
        # output in [2, 4)), which moves the outputs it feeds by up to
        # step * |wo| ~ 5e-3: the max gate, absolute (no rtol, so it is not
        # loosened by the O(1) residual x_q). Flips are rare, so the mean
        # error must stay below 1e-5, about 1% of the mean distance between
        # the bf16 and the exact f32 results (printed): a kernel that
        # rounded elsewhere, or not at all, fails it. Then the loose gate
        # against exact f32, 3e-2.
        torch.testing.assert_close(out_bf16, ref_bf16, atol=5e-3, rtol=0)
        if mean_bf16 > 1e-5:
            raise AssertionError(f"mha_block bf16 mode: mean error "
                                 f"{mean_bf16:.3e} against its plain version")
        torch.testing.assert_close(out_bf16, ref, atol=3e-2, rtol=3e-2)
        ms = _ms(lambda: mb.mha_block(x_q, x_kv, p, heads))
        plain = _ms(lambda: mb.mha_block_reference(x_q, x_kv, p, heads))
        flops = 2 * b * (2 * lq * dim * dim + 2 * lk * dim * dim
                         + 2 * lq * lk * dim)
        nbytes = 4 * (2 * b * lq * dim + b * lk * dim + 4 * dim * dim
                      + 8 * dim)
        bound, by = _bound_ms(flops, nbytes, PEAK_BF16)
        print(f"  mha_block B={b} Lq={lq} Lk={lk} (att {att:.3f}): err bf16 "
              f"{err_bf16:.3e} mean {mean_bf16:.2e} (vs f32 {err_vs_f32:.3e} "
              f"mean {mean_vs_f32:.2e}), f32 mode {err_f32:.3e}; "
              f"kernel {ms:.3f} ms, plain {plain:.3f} ms, "
              f"bound {bound:.4f} ms ({by})", flush=True)
        # Each (Lq, Lk) pair runs once per fusion layer.
        rows.append({"per_step": FUSION_DEPTH, "err": err_bf16, "ms": ms,
                     "plain_ms": plain,
                     "bound_ms": bound, "bound_by": by, "library_ms": None})
        del x_q, x_kv, ref, ref_bf16, out_f32, out_bf16
    return _entry("mha_block", "cuda", "multimodal_sc_torch/csrc/mha_block.cu",
                  "multimodal_sc_tpu/kernels/mha_block.py:149", rows)


def check_conv_prelu():
    """Kernel vs plain version at the five camera-encoder conv shapes."""
    import torch
    import torch.nn.functional as F

    from multimodal_sc_torch.kernels import conv_block as cb

    g = torch.Generator(device="cuda").manual_seed(1)
    b = NUM_ENVS
    # (H, W, Cin, Cout, stride, PReLU) of CameraEncoderCNN at c4 widths.
    shapes = ((32, 32, 3, 32, 2, True), (16, 16, 32, 64, 2, True),
              (8, 8, 64, 128, 1, True), (8, 8, 128, 128, 1, True),
              (8, 8, 128, 16, 1, False))
    rows = []
    for h, w, cin, cout, s, prelu in shapes:
        x = torch.randn(b, h, w, cin, generator=g, device="cuda")
        wt = torch.randn(5, 5, cin, cout, generator=g,
                         device="cuda") / (25 * cin) ** 0.5
        bias = 0.1 * torch.randn(cout, generator=g, device="cuda")
        alpha = (torch.rand(cout, generator=g, device="cuda")
                 if prelu else None)
        ref = cb.conv_prelu_reference(x, wt, bias, alpha, s)
        out = cb.conv_prelu(x, wt, bias, alpha, s)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        # Exact f32 on both sides (TF32 off), sums of up to 3200 products
        # in another order: 1e-4.
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
        ms = _ms(lambda: cb.conv_prelu(x, wt, bias, alpha, s))
        plain = _ms(lambda: cb.conv_prelu_reference(x, wt, bias, alpha, s))
        # Library yardstick: one cuDNN convolution (+ bias) on the input
        # padded beforehand; it leaves out the PReLU.
        (plo, phi), (qlo, qhi) = cb.same_pads(h, 5, s), cb.same_pads(w, 5, s)
        xc = F.pad(x.permute(0, 3, 1, 2), (qlo, qhi, plo, phi)).contiguous(
            memory_format=torch.channels_last)
        wc = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        lib = _ms(lambda: F.conv2d(xc, wc, bias, stride=s))
        oh, ow = -(-h // s), -(-w // s)
        flops = 2 * b * oh * ow * cout * 25 * cin
        nbytes = 4 * (b * h * w * cin + 25 * cin * cout + 2 * cout
                      + b * oh * ow * cout)
        bound, by = _bound_ms(flops, nbytes, PEAK_F32)
        print(f"  conv_prelu B={b} {h}x{w}x{cin}->{cout} s{s}: err "
              f"{err:.3e}; kernel {ms:.3f} ms, plain {plain:.3f} ms, cuDNN "
              f"{lib:.3f} ms, bound {bound:.4f} ms ({by})", flush=True)
        rows.append({"per_step": 1, "err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": bound, "bound_by": by, "library_ms": lib})
    return _entry("conv_prelu", "cuda", "multimodal_sc_torch/csrc/conv_prelu.cu",
                  "multimodal_sc_tpu/kernels/conv_block.py:69", rows)


def _pillar_inputs():
    """Point features and cells as the c4 path makes them: a real LiDAR
    observation of NUM_ENVS envs, voxelized (trash cells included)."""
    import torch

    from multimodal_sc_torch.codec.lidar_bev import voxelize
    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.envs import driving

    cfg = get_preset("c4")
    g = torch.Generator(device="cuda").manual_seed(2)
    states = driving.reset_batch(cfg.env, NUM_ENVS, g, device="cuda")
    _, pts, mask = driving.observe_batch(cfg.env, states)
    lid = cfg.lidar
    _, cell = voxelize(pts, mask, lid.bev_hw, lid.x_range, lid.y_range)
    feats = torch.randn(NUM_ENVS, pts.shape[1], lid.pillar_dim, generator=g,
                        device="cuda")
    return feats, cell, lid.bev_hw[0] * lid.bev_hw[1]


def check_scatter_max():
    import torch

    from multimodal_sc_torch.kernels import pillar_scatter as ps

    feats, cell, cells = _pillar_inputs()
    b, n, d = feats.shape
    ref = ps.scatter_max_reference(feats, cell, cells)
    out = ps.scatter_max(feats, cell, cells)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    # Max is exact and order-independent: the kernel must agree bit for bit.
    torch.testing.assert_close(out, ref, atol=0.0, rtol=0.0)
    ms = _ms(lambda: ps.scatter_max(feats, cell, cells), iters=50)
    plain = _ms(lambda: ps.scatter_max_reference(feats, cell, cells), iters=50)
    buf = torch.full((b, cells + 1, d), float("-inf"), device="cuda")
    idx = cell.long().unsqueeze(-1).expand(b, n, d)
    lib = _ms(lambda: torch.scatter_reduce(buf, 1, idx, feats, "amax"),
              iters=50)
    valid = int((cell < cells).sum().item())
    nbytes = 4 * (b * n + valid * d + b * cells * d)
    bound, by = _bound_ms(valid * d, nbytes, PEAK_F32)
    print(f"  scatter_max B={b} N={n} D={d} cells={cells} ({valid} of {b * n} "
          f"points in range): err {err:.3e}; kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, scatter_reduce {lib:.4f} ms, bound {bound:.5f} ms "
          f"({by})", flush=True)
    row = {"per_step": 1, "err": err, "ms": ms, "plain_ms": plain,
           "bound_ms": bound, "bound_by": by, "library_ms": lib}
    return _entry("scatter_max", "cuda",
                  "multimodal_sc_torch/csrc/pillar_scatter.cu",
                  "multimodal_sc_tpu/kernels/pillar_scatter.py:79", [row])


def _gate_bf16(name, got, ref_bf16, ref_f32):
    """The gates of the packed attention kernels' bf16 mode. Against the
    plain version that rounds the same operands only the order of the f32
    sums differs; now and then that flips the bf16 rounding of one
    probability p (or one dS), a step of up to 2^-8 p, which moves the
    outputs it feeds by that step times a v or dO entry (up to ~5.5 among
    the 33M normal draws of the largest case): 2e-2 p, and p reaches ~0.5,
    so the max gate is 1e-2, absolute. Flips are rare: the mean error must
    stay below 1e-5, a few percent of the mean distance between the bf16
    and the exact f32 results (1e-4 to 1e-3). Then the loose gate against
    exact f32, 3e-2. Returns (max, mean) against the rounding twin."""
    import torch

    diff = (got - ref_bf16).abs()
    mx, mean = diff.max().item(), diff.mean().item()
    torch.testing.assert_close(got, ref_bf16, atol=1e-2, rtol=0)
    if mean > 1e-5:
        raise AssertionError(f"{name} bf16 mode: mean error {mean:.3e} "
                             "against its plain version")
    torch.testing.assert_close(got, ref_f32, atol=3e-2, rtol=3e-2)
    return mx, mean


def check_packed_attention():
    """Forward and backward kernels vs their plain versions: the four c4
    (Lq, Lk) pairs at the act batch (1024) and the learner batch (128),
    plus ragged, two-group and d = 64 shapes. Times are per act+learn
    iteration of arm B: each c4 pair runs twice per forward (depth 2), one
    forward at 1024 and three at 128, and the backward of one forward."""
    import torch
    import torch.nn.functional as F

    from multimodal_sc_torch.kernels import attention_packed as ap

    g = torch.Generator(device="cuda").manual_seed(3)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    def heads_first(t, heads):
        b, l, dm = t.shape
        return t.reshape(b, l, heads, dm // heads).transpose(1, 2).contiguous()

    # (B, Lq, Lk, dm, heads, forward launches per iteration, backward ones)
    cases = [(NUM_ENVS, lq, lk, 128, 4, FUSION_DEPTH, 0)
             for lq, lk in C4_ATTN_SHAPES]
    # Backward: the camera-stream attentions (Lq = 65) in both layers, the
    # LiDAR-stream ones in all layers but the last (ATTN_BWD_PER_STEP).
    cases += [(LEARN_BATCH, lq, lk, 128, 4, 3 * FUSION_DEPTH,
               FUSION_DEPTH if lq == 65 else FUSION_DEPTH - 1)
              for lq, lk in C4_ATTN_SHAPES]
    cases += [(64, 33, 70, 128, 4, 0, 0), (64, 64, 64, 256, 8, 0, 0),
              (64, 17, 100, 128, 2, 0, 0), (64, 200, 48, 128, 4, 0, 0),
              (64, 40, 24, 256, 8, 0, 0)]
    fwd_rows, bwd_rows = [], []
    worst_fwd = worst_bwd = 0.0     # bf16-mode errors over every case
    for b, lq, lk, dm, heads, n_fwd, n_bwd in cases:
        q, k, v = rnd(b, lq, dm), rnd(b, lk, dm), rnd(b, lk, dm)
        do = rnd(b, lq, dm)
        ref = ap.packed_attention_reference(q, k, v, heads)
        ref_bf16 = ap.packed_attention_reference_bf16(q, k, v, heads)
        out_f32 = ap.packed_attention(q, k, v, heads, mxu_bf16=False)
        out_bf16 = ap.packed_attention(q, k, v, heads)
        torch.cuda.synchronize()
        # f32 mode: the plain version's arithmetic in another order of
        # summation (d-term dots, <= 256-term softmax sums): 1e-4.
        torch.testing.assert_close(out_f32, ref, atol=1e-4, rtol=1e-4)
        err_f32 = (out_f32 - ref).abs().max().item()
        err, mean = _gate_bf16("packed_attention forward", out_bf16, ref_bf16,
                               ref)
        line = (f"  packed_attention B={b} Lq={lq} Lk={lk} dm={dm} h={heads}: "
                f"fwd err bf16 {err:.3e} mean {mean:.2e}, f32 mode "
                f"{err_f32:.3e}")

        # Backward through autograd, so the Function's backward is what is
        # checked: gradients of sum(out * do) with respect to q, k, v.
        scale = (dm // heads) ** -0.5
        grads = {}
        for mode in (False, True):
            ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out = ap.packed_attention(*ins, heads, mxu_bf16=mode)
            grads[mode] = torch.autograd.grad(out, ins, do)
        torch.cuda.synchronize()
        ref_g = ap.packed_attention_bwd_reference(q, k, v, ref, do, heads,
                                                  scale)
        ref_g_bf16 = ap.packed_attention_bwd_reference(
            q, k, v, out_bf16, do, heads, scale, bf16=True)
        errs_f32, errs, means = [], [], []
        for got32, got16, want, want16 in zip(grads[False], grads[True],
                                              ref_g, ref_g_bf16):
            # f32 mode: sums of up to 256 products of O(1) terms in another
            # order, through exp and a difference (dp - delta): 5e-4.
            torch.testing.assert_close(got32, want, atol=5e-4, rtol=5e-4)
            errs_f32.append((got32 - want).abs().max().item())
            e, m = _gate_bf16("packed_attention backward", got16, want16, want)
            errs.append(e)
            means.append(m)
        berr, bmean, berr_f32 = max(errs), max(means), max(errs_f32)
        worst_fwd, worst_bwd = max(worst_fwd, err), max(worst_bwd, berr)
        line += (f"; bwd err bf16 {berr:.3e} mean {bmean:.2e}, f32 mode "
                 f"{berr_f32:.3e}")
        if not (n_fwd or n_bwd):
            print(line, flush=True)
            continue

        ms = _ms(lambda: ap.packed_attention(q, k, v, heads))
        plain = _ms(lambda: ap.packed_attention_reference(q, k, v, heads))
        qh, kh, vh = (heads_first(t, heads) for t in (q, k, v))
        lib = _ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
        bound, by = _bound_ms(4 * b * lq * lk * dm,
                              4 * 2 * b * (lq + lk) * dm, PEAK_BF16)
        line += (f"; fwd kernel {ms:.3f} ms, plain {plain:.3f} ms, SDPA "
                 f"{lib:.3f} ms, bound {bound:.4f} ms ({by})")
        fwd_rows.append({"per_step": n_fwd, "err": err, "ms": ms,
                         "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                         "library_ms": lib})
        if n_bwd:
            ms = _ms(lambda: ap._bwd_cuda(q, k, v, out_bf16, do, heads, scale,
                                          True))
            plain = _ms(lambda: ap.packed_attention_bwd_reference(
                q, k, v, ref, do, heads, scale))
            for t in (qh, kh, vh):
                t.requires_grad_(True)
            lib_out = F.scaled_dot_product_attention(qh, kh, vh)
            doh = heads_first(do, heads)
            lib = _ms(lambda: torch.autograd.grad(lib_out, (qh, kh, vh), doh,
                                                  retain_graph=True))
            bound, by = _bound_ms(10 * b * lq * lk * dm,
                                  4 * 4 * b * (lq + lk) * dm, PEAK_BF16)
            line += (f"; bwd kernels {ms:.3f} ms, plain {plain:.3f} ms, SDPA "
                     f"backward {lib:.3f} ms, bound {bound:.4f} ms ({by})")
            bwd_rows.append({"per_step": n_bwd, "err": berr, "ms": ms,
                             "plain_ms": plain, "bound_ms": bound,
                             "bound_by": by, "library_ms": lib})
        print(line, flush=True)
        del q, k, v, do, ref, ref_bf16, out_f32, out_bf16, grads
    src = "multimodal_sc_torch/csrc/attention_packed.cu"
    entries = [
        _entry("packed_attention_fwd", "cuda", src,
               "multimodal_sc_tpu/kernels/attention_packed.py:170", fwd_rows),
        _entry("packed_attention_bwd", "cuda", src,
               "multimodal_sc_tpu/kernels/attention_packed.py:201", bwd_rows)]
    entries[0]["max_abs_err"], entries[1]["max_abs_err"] = worst_fwd, worst_bwd
    return entries


def check_kernels():
    import torch

    # Exact f32 on the plain side: cuDNN convolutions default to TF32 on
    # Hopper, matmuls do not; both are pinned off for every comparison and
    # restored after, so the main path runs with PyTorch's defaults.
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return [check_mha_block(), check_conv_prelu(), check_scatter_max(),
                *check_packed_attention()]
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def drive_main_path():
    """The c4 act-only iteration at 1024 envs; returns the launches of the
    timed run, the steps/s, and the state and iteration it ended with."""
    import torch

    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.rl import dqn

    cfg = get_preset("c4")
    t0 = time.perf_counter()
    state = dqn.init(cfg, seed=0, num_envs=NUM_ENVS, device="cuda")
    iteration = dqn.make_iteration(cfg, learn=False)
    for _ in range(WARMUP_ITERS):
        state, metrics = iteration(state)
    torch.cuda.synchronize()
    print(f"  init + {WARMUP_ITERS} warm-up iterations: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    _reset_counts()
    t0 = time.perf_counter()
    rewards = []
    for _ in range(TIMED_ITERS):
        state, metrics = iteration(state)
        rewards.append(metrics["reward"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()

    sps = TIMED_ITERS * NUM_ENVS / wall
    print(f"  act-only: {TIMED_ITERS} iterations x {NUM_ENVS} envs in "
          f"{wall:.3f} s = {sps:.1f} agent steps/s", flush=True)
    print(f"  launches in the timed run: {launches}", flush=True)
    print(f"  metrics: " + ", ".join(
        f"{k}={float(v):.4f}" for k, v in metrics.items()), flush=True)
    _check_counts(launches, EXPECTED_LAUNCHES, TIMED_ITERS, "act-only")
    if not all(torch.isfinite(r).all() for r in rewards):
        raise RuntimeError("non-finite reward on the main path")
    if not all(torch.isfinite(v).all() for v in metrics.values()):
        raise RuntimeError(f"non-finite metrics: {metrics}")
    # Q-values of the final carried observation through the same network.
    with torch.no_grad():
        img = dqn.dequantize_image(state.obs_image)
        q = state.params(img, state.obs_points, state.obs_mask,
                         generator=state.generator)
    if q.shape != (NUM_ENVS, cfg.rl.num_actions) or not torch.isfinite(q).all():
        raise RuntimeError(f"bad Q-values: shape {tuple(q.shape)}")
    print(f"  Q-values {tuple(q.shape)} finite, mean {q.mean().item():.4f}",
          flush=True)
    return launches, sps, state, iteration


def _clone_params(net):
    return [p.detach().clone() for p in net.parameters()]


def _same(net, tensors):
    import torch

    return all(torch.equal(p, q) for p, q in zip(net.parameters(), tensors))


def drive_learn(name, overrides, expected):
    """The c4 act+learn iteration at 1024 envs through ``make_iteration``;
    returns the launches of the timed run, the steps/s, and the config,
    state and iteration it ended with."""
    import torch

    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.rl import dqn

    cfg = get_preset("c4").override_str(overrides)
    t0 = time.perf_counter()
    state = dqn.init(cfg, seed=0, num_envs=NUM_ENVS, device="cuda")
    target0 = _clone_params(state.target_params)
    iteration = dqn.make_iteration(cfg)
    for _ in range(LEARN_WARMUP_ITERS):
        state, metrics = iteration(state)
    torch.cuda.synchronize()
    # The n-step window emits from iteration n_step on; 1024 rows at once
    # make the replay warm, so every iteration since has learned.
    warm_steps = LEARN_WARMUP_ITERS - (cfg.rl.n_step - 1)
    if state.step != warm_steps:
        raise RuntimeError(f"{name}: {state.step} learn steps after "
                           f"{LEARN_WARMUP_ITERS} iterations, expected "
                           f"{warm_steps}")
    print(f"  init + {LEARN_WARMUP_ITERS} warm-up iterations: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    online0 = _clone_params(state.params)
    ema0 = _clone_params(state.ema_params)
    _reset_counts()
    t0 = time.perf_counter()
    losses = []
    for _ in range(LEARN_TIMED_ITERS):
        state, metrics = iteration(state)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()

    sps = LEARN_TIMED_ITERS * NUM_ENVS / wall
    print(f"  act+learn ({name}): {LEARN_TIMED_ITERS} iterations x {NUM_ENVS} "
          f"envs in {wall:.3f} s = {sps:.1f} agent steps/s", flush=True)
    print(f"  launches in the timed run: {launches}", flush=True)
    print(f"  metrics: " + ", ".join(
        f"{k}={float(v):.4f}" for k, v in metrics.items()), flush=True)
    _check_counts(launches, expected, LEARN_TIMED_ITERS, name)
    losses = torch.stack(losses)
    if not torch.isfinite(losses).all() or not (losses != 0).all():
        raise RuntimeError(f"{name}: losses {losses.tolist()}")
    if not all(torch.isfinite(v).all() for v in metrics.values()):
        raise RuntimeError(f"{name}: non-finite metrics: {metrics}")
    if state.step != warm_steps + LEARN_TIMED_ITERS:
        raise RuntimeError(f"{name}: step {state.step} after "
                           f"{LEARN_TIMED_ITERS} more iterations")
    if _same(state.params, online0):
        raise RuntimeError(f"{name}: the online parameters did not change")
    if _same(state.ema_params, ema0):
        raise RuntimeError(f"{name}: the EMA did not move")
    if state.step >= cfg.rl.target_update_period or not _same(
            state.target_params, target0):
        raise RuntimeError(f"{name}: the target moved before its first sync")
    if any(p.grad is not None for p in state.target_params.parameters()):
        raise RuntimeError(f"{name}: the target network holds gradients")
    # Force the hard sync: one iteration that ends on a multiple of the
    # period must leave the target equal to the online network.
    state = state._replace(step=cfg.rl.target_update_period - 1)
    state, _ = iteration(state)
    torch.cuda.synchronize()
    if not _same(state.target_params, state.params.parameters()):
        raise RuntimeError(f"{name}: target != online after the sync step")
    print(f"  loss {losses[0].item():.4f} -> {losses[-1].item():.4f}; online "
          "and EMA moved, target still until the forced sync, then equal to "
          "the online network", flush=True)
    return launches, sps, cfg, state, iteration


def compare_learn_routes(cfg, state):
    """One TD loss and its gradients on a fixed batch and fixed channel
    noise, twice: through the kernels (packed attention in its f32 mode,
    forward and backward) and through every kernel's plain version."""
    import torch

    from multimodal_sc_torch.codec import camera_vit, lidar_bev
    from multimodal_sc_torch.kernels import (attention_packed, conv_block,
                                             pillar_scatter)
    from multimodal_sc_torch.rl import dqn, replay

    bs = cfg.rl.batch_size
    g = torch.Generator(device="cuda").manual_seed(7)
    batch = dqn.dequantize_obs(cfg, replay.sample(
        state.buffer, None, bs, torch.arange(bs, device="cuda")))
    hw, lid = cfg.camera.image_hw, cfg.lidar
    n_cam = (hw[0] // 4) * (hw[1] // 4) * cfg.camera.c_sym
    n_lid = lid.bev_hw[0] * lid.bev_hw[1] * lid.c_sym

    def noise():
        return tuple(torch.randn(bs, n, 2, generator=g, device="cuda")
                     for n in (n_cam, n_lid))

    draws = dqn.LearnDraws(indices=torch.arange(bs, device="cuda"),
                           snr_db=None, noise_online=noise(),
                           noise_target=noise(), noise_double=noise())
    forward = dqn.learner_forward(cfg)
    params = list(state.params.parameters())

    def loss_and_grads():
        loss = dqn._td_loss(cfg, forward, state.params, state.target_params,
                            batch, draws)
        # The last layer's LiDAR-stream tail feeds nothing: no gradient.
        return loss.detach(), torch.autograd.grad(loss, params,
                                                  allow_unused=True)

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        before = _read_counts()
        with mock.patch.object(camera_vit, "packed_attention",
                               functools.partial(
                                   attention_packed.packed_attention,
                                   mxu_bf16=False)):
            loss_k, grads_k = loss_and_grads()
        ran = {k: v - before[k] for k, v in _read_counts().items()}
        if (ran["packed_attention_fwd"] != 24
                or ran["packed_attention_bwd"] != ATTN_BWD_PER_STEP):
            raise RuntimeError(f"kernel route of the learn step ran {ran}")
        before = _read_counts()
        with mock.patch.object(camera_vit, "packed_attention",
                               attention_packed.packed_attention_reference), \
                mock.patch.object(conv_block, "conv_prelu",
                                  conv_block.conv_prelu_reference), \
                mock.patch.object(lidar_bev, "scatter_max",
                                  pillar_scatter.scatter_max_reference):
            loss_p, grads_p = loss_and_grads()
        if _read_counts() != before:
            raise RuntimeError("the plain route of the learn step launched a "
                               "kernel")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    torch.cuda.synchronize()
    # Exact f32 on both routes (TF32 off), each kernel within 1e-4 of its
    # plain version, through ~20 layers: loss 1e-5, gradients rtol 1e-3
    # (atol 1e-5 for the entries near zero).
    torch.testing.assert_close(loss_k, loss_p, atol=1e-5, rtol=1e-5)
    worst_abs = worst_rel = 0.0
    for (pname, _), gk, gp in zip(state.params.named_parameters(), grads_k,
                                  grads_p):
        if gk is None or gp is None:
            if gk is not gp:
                raise RuntimeError(f"{pname}: a gradient on one route only")
            continue
        torch.testing.assert_close(gk, gp, atol=1e-5, rtol=1e-3,
                                   msg=lambda m: f"{pname}: {m}")
        diff, top = (gk - gp).abs().max().item(), gp.abs().max().item()
        worst_abs = max(worst_abs, diff)
        # A key bias shifts every score of a row alike, so its gradient is
        # zero but for rounding: tensors that small say nothing relative.
        if top > 1e-4:
            worst_rel = max(worst_rel, diff / top)
    print(f"  learn step, kernels (f32 mode) vs plain versions: loss "
          f"{loss_k.item():.6f} vs {loss_p.item():.6f}; worst gradient "
          f"difference {worst_abs:.2e} absolute, {worst_rel:.2e} of its "
          f"tensor's largest entry (tensors above 1e-4), over {len(params)} "
          "tensors", flush=True)


def profile_main_path(cfg, state, iteration):
    """Where the time of one act-only iteration goes: each layer timed alone
    on the main path's own inputs, then the device's busy share."""
    import torch

    from multimodal_sc_torch.envs import driving
    from multimodal_sc_torch.rl import dqn

    holder = [state]

    def step_all():
        holder[0], _ = iteration(holder[0])

    net = state.params.eval()
    per = net.perception
    g = state.generator
    img = dqn.dequantize_image(state.obs_image)
    pts, mask = state.obs_points, state.obs_mask
    actions = torch.zeros(NUM_ENVS, dtype=torch.int32, device="cuda")
    snr = torch.full((NUM_ENVS,), cfg.channel.snr_db, device="cuda")
    with torch.no_grad():
        z = per.cam_enc(img)
        cam_tok = per.cam_tok(z)
        lid_tok = per._lidar_branch(pts, mask, snr, g, None)
        parts = {
            "iteration": _ms(step_all, warmup=1),
            "q_network": _ms(lambda: net(img, pts, mask, g)),
            "camera_encoder": _ms(lambda: per.cam_enc(img)),
            "camera_tokens": _ms(lambda: per.cam_tok(z)),
            "lidar_branch": _ms(lambda: per._lidar_branch(pts, mask, snr, g,
                                                          None)),
            "fusion": _ms(lambda: per.fusion(cam_tok, lid_tok)),
            "env_step": _ms(lambda: driving.step_batch(
                cfg.env, holder[0].env_states, actions, g)),
        }
    print("  ms per call, each part timed alone (CUDA events):", flush=True)
    for k, v in parts.items():
        print(f"    {k:16s} {v:9.3f}", flush=True)

    _idle_share(step_all, parts["iteration"])


def _idle_share(step_all, wall, n=10):
    """The device's idle share of ``step_all``: ``wall`` is its unprofiled
    time in ms (the profiler's own host work would stretch it), the device
    time comes from a trace that records the device only."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step_all()
        torch.cuda.synchronize()
        wall_prof = (time.perf_counter() - t0) * 1e3 / n
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3 / n
    if busy <= 0:
        raise RuntimeError("the profiler saw no device time")
    print(f"  per iteration over {n}: unprofiled wall {wall:.3f} ms, device "
          f"busy {busy:.3f} ms, idle {100 * (1 - busy / wall):.1f}% "
          f"(wall under the profiler {wall_prof:.3f} ms)", flush=True)
    for e in sorted(events, key=lambda e: e.self_device_time_total,
                    reverse=True)[:12]:
        print(f"    {e.self_device_time_total / 1e3 / n:9.3f} ms "
              f"{e.count / n:6.1f}x  {e.key[:90]}", flush=True)


def profile_learn(cfg, state, iteration):
    """Where the time of one act+learn iteration goes: the learner's parts
    timed alone on one sampled batch, then the device's busy share."""
    import torch

    from multimodal_sc_torch.rl import dqn, replay

    holder = [state]

    def step_all():
        holder[0], _ = iteration(holder[0])

    forward = dqn.learner_forward(cfg)
    bs = cfg.rl.batch_size
    dev = state.obs_points.device
    params = list(state.params.parameters())

    def draw():
        return dqn.draw_learn(cfg, state.buffer.size, state.generator, dev)

    def sample(draws):
        return dqn.dequantize_obs(cfg, replay.sample(state.buffer, None, bs,
                                                     draws.indices))

    draws = draw()
    batch = sample(draws)
    g = state.generator

    def loss():
        return dqn._td_loss(cfg, forward, state.params, state.target_params,
                            batch, draws, g)

    def one_forward(with_grad):
        with torch.set_grad_enabled(with_grad):
            return forward(state.params, batch.image, batch.points,
                           batch.mask, g)

    parts = {
        "iteration": _ms(step_all, warmup=1),
        "learn_step": _ms(lambda: dqn.learn_step(cfg, holder[0], batch, draws,
                                                 forward)),
        "sample_batch": _ms(lambda: sample(draw())),
        "forward_no_grad": _ms(lambda: one_forward(False)),
        "forward_with_grad": _ms(lambda: one_forward(True)),
        "loss_3_forwards": _ms(loss),
        "loss_and_backward": _ms(
            lambda: torch.autograd.grad(loss(), params, allow_unused=True)),
    }
    parts["backward (difference)"] = (parts["loss_and_backward"]
                                      - parts["loss_3_forwards"])
    parts["clip_adam_target_ema (difference)"] = (
        parts["learn_step"] - parts["loss_and_backward"])
    print("  ms per call, each part timed alone (CUDA events):", flush=True)
    for k, v in parts.items():
        print(f"    {k:34s} {v:9.3f}", flush=True)
    _idle_share(step_all, parts["iteration"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also break each path's iteration time down by "
                         "layer and kernel, with the device's idle share")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 1
    try:
        from multimodal_sc_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e}); run from the "
              "repository root", file=sys.stderr)
        return 1

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    built = _build.build()
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, (_, log) in sorted(built.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    print("kernel checks (TF32 off):", flush=True)
    kernels = check_kernels()
    from multimodal_sc_torch.config import get_preset

    # Each path is driven with the counts set to 0 just before it and read
    # just after; a kernel's line reports its launches summed over the paths.
    print("main path (c4 act-only):", flush=True)
    launches, sps, state, iteration = drive_main_path()
    rates = {"act-only": sps}
    if args.profile:
        print("profile (c4 act-only):", flush=True)
        profile_main_path(get_preset("c4"), state, iteration)
    del state, iteration
    totals = dict(launches)
    for name, overrides, expected in (
            ("arm A: c4 preset", [], EXPECTED_LEARN_A),
            ("arm B: unfused fusion on packed_attention", ARM_B,
             EXPECTED_LEARN_B)):
        print(f"main path (c4 act+learn, {name}):", flush=True)
        launches, rates[f"act+learn, {name}"], cfg, state, iteration = (
            drive_learn(name, overrides, expected))
        for k, v in launches.items():
            totals[k] += v
        if overrides:
            compare_learn_routes(cfg, state)
        if args.profile:
            print(f"profile (c4 act+learn, {name}):", flush=True)
            profile_learn(cfg, state, iteration)
        del state, iteration
        torch.cuda.empty_cache()
    for k in kernels:
        k["launches"] = totals[k["name"]]
        if k["launches"] <= 0:
            raise RuntimeError(f"{k['name']} was launched on no main path")
    print(f"agent steps/s at {NUM_ENVS} envs on {card}: " + "; ".join(
        f"{k} {v:.1f}" for k, v in rates.items()), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
