#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``multimodal_sc_torch``) on one GPU.

    python3 chip_smoke.py [--profile]

Builds every CUDA kernel from ``multimodal_sc_torch/csrc`` with ``nvcc``,
holds each kernel against its plain PyTorch version on the card at the
shapes of the paths below, times both, then drives five paths through the
port's entry points at full widths, random weights from seed 0. At 1024
envs:

* the c4 DQN act-only iteration;
* arm A, act+learn on the c4 preset as it stands (fused blocks: the kernel
  when acting, the plain version inside the learner);
* arm B, act+learn with ``pallas_mha_block=False, pallas_attention=True``
  (the unfused fusion layers on the packed attention kernels, forward and
  backward), plus one learn step on a fixed batch through the kernels in
  f32 mode against the same step through the plain versions.

Then the c3 late-fusion JSCC train step (ViT camera codec + LiDAR BEV
codec, batch 64, 64x64 images, 1024 points, 32x32 BEV) in two arms:

* arm P, the c3 preset with ``pallas_attention=true``: the ViT's attention
  (dim 128, 4 heads) on the packed attention kernels, forward and backward;
* arm F, the same with ``camera.dim=192 camera.heads=3`` (head dim 64, a
  model dim the packed kernels refuse): the flash attention kernels,
  forward, dQ and dK/dV.

Each arm takes a few dozen train steps (the loss must fall) and one loss
and its gradients through the kernels are held against the same through
the plain versions.

Each path is driven with the launch counts set to 0 just before and read
just after, and fails unless every kernel of that path ran the expected
number of times and the outputs are finite. Prints the card, the
per-kernel JSON line and, last, ``{"ok": true, "device": {...}}``. Exits
non-zero, printing no result, when CUDA is absent or any phase fails.
Imports nothing of JAX.

``--profile`` adds, after each path, where its time goes: the layers of
the act iteration and the parts of one learn or train step timed alone, the
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

# Published H100 SXM peaks (dense): bf16 and TF32 tensor-core and f32
# CUDA-core FLOP/s, HBM bytes/s. A card below its 700 W limit runs slower.
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

NUM_ENVS = 1024
WARMUP_ITERS = 3
TIMED_ITERS = 10
# Per-act-step launches the c4 main path must show: 4 fused blocks x
# depth 2; 5 encoder convs; one batched scatter.
# (A kernel a table does not name must not run on that path at all.)
EXPECTED_LAUNCHES = {"mha_block": 8, "conv_prelu": 5, "scatter_max": 1}
FUSION_DEPTH = 2            # c4 fusion.depth: each block shape twice a step
# Per act+learn iteration: the act forward at 1024 envs, then the learner's
# three forwards (and, for the packed attention, one backward) at batch 128.
# Arm A: the learner runs the fused blocks through the plain version.
EXPECTED_LEARN_A = {"mha_block": 8, "conv_prelu": 5 + 15,
                    "scatter_max": 1 + 3}
# Arm B: four attentions x depth 2 per forward. The backward runs for six
# of the eight: the last layer's LiDAR stream (lid2cam, lid_self) feeds
# nothing after it (the state is read from the camera stream's CLS token),
# so autograd never reaches those two.
ATTN_BWD_PER_STEP = 4 * FUSION_DEPTH - 2
EXPECTED_LEARN_B = {"conv_prelu": 5 + 15,
                    "scatter_max": 1 + 3, "packed_attention_fwd": 8 + 24,
                    "packed_attention_bwd": ATTN_BWD_PER_STEP}
ARM_B = ["pallas_mha_block=false", "pallas_attention=true"]
LEARN_WARMUP_ITERS = 5      # the replay is warm from iteration 3 (n_step 3)
LEARN_TIMED_ITERS = 10
LEARN_BATCH = 128           # c4 rl.batch_size
C4_ATTN_SHAPES = ((65, 256), (256, 65), (65, 65), (256, 256))

# The c3 late-fusion train step. Per step each arm runs one forward and one
# backward through 4 encoder + 4 decoder ViT blocks (every attention's
# inputs depend on parameters, so autograd reaches all eight) and one
# batched scatter in the LiDAR encoder.
C3_ARM_P = ["pallas_attention=true"]
C3_ARM_F = C3_ARM_P + ["camera.dim=192", "camera.heads=3"]
C3_ATTN_PER_STEP = 8
EXPECTED_C3_P = {"packed_attention_fwd": C3_ATTN_PER_STEP,
                 "packed_attention_bwd": C3_ATTN_PER_STEP, "scatter_max": 1}
EXPECTED_C3_F = {"flash_attention_fwd": C3_ATTN_PER_STEP,
                 "flash_attention_bwd_dq": C3_ATTN_PER_STEP,
                 "flash_attention_bwd_dkv": C3_ATTN_PER_STEP, "scatter_max": 1}
C3_BATCH = 64               # c3 train.batch_size
C3_WARMUP_STEPS = 3
C3_TIMED_STEPS = 30


def _counters():
    """name -> (module, attribute) of every kernel wrapper's launch count."""
    from multimodal_sc_torch.kernels import (attention, attention_packed,
                                             conv_block, mha_block,
                                             pillar_scatter)

    return {"mha_block": (mha_block, "launches"),
            "conv_prelu": (conv_block, "launches"),
            "scatter_max": (pillar_scatter, "launches"),
            "packed_attention_fwd": (attention_packed, "launches_fwd"),
            "packed_attention_bwd": (attention_packed, "launches_bwd"),
            "flash_attention_fwd": (attention, "launches_fwd"),
            "flash_attention_bwd_dq": (attention, "launches_bwd_dq"),
            "flash_attention_bwd_dkv": (attention, "launches_bwd_dkv")}


def _reset_counts():
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def _read_counts():
    return {k: getattr(mod, attr) for k, (mod, attr) in _counters().items()}


def _check_counts(launches, expected, iters, what):
    for k in launches:
        per_iter = expected.get(k, 0)
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
    """One kernel's line: times and bounds per step of the path its rows
    come from, each shape's row weighted by how often one step launches it
    (``per_step``)."""
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
    """Kernel vs plain version at the five camera-encoder conv shapes, at
    the act batch (1024; these rows are the kernel's line) and the learner's
    batch (128), then at shapes that reach every predicate of the kernel:
    odd maps, Cin that is no multiple of the 32-channel step, Cout that is
    no multiple of 8 (masked columns of the tensor-core path) or of 4 (the
    per-image path)."""
    import torch
    import torch.nn.functional as F

    from multimodal_sc_torch.kernels import conv_block as cb

    g = torch.Generator(device="cuda").manual_seed(1)
    # (H, W, Cin, Cout, stride, PReLU) of CameraEncoderCNN at c4 widths.
    encoder = ((32, 32, 3, 32, 2, True), (16, 16, 32, 64, 2, True),
               (8, 8, 64, 128, 1, True), (8, 8, 128, 128, 1, True),
               (8, 8, 128, 16, 1, False))
    # (B, shape, timed, launches per act step)
    cases = [(NUM_ENVS, shape, True, 1) for shape in encoder]
    cases += [(LEARN_BATCH, shape, True, 0) for shape in encoder]
    cases += [(64, shape, False, 0) for shape in (
        (7, 9, 32, 64, 1, True), (7, 9, 32, 64, 2, True),
        (9, 7, 40, 24, 2, False), (8, 8, 16, 12, 1, True),
        (8, 8, 16, 10, 1, True), (5, 5, 4, 200, 1, True),
        (3, 3, 132, 136, 2, True))]
    rows = []
    worst = 0.0
    for b, (h, w, cin, cout, s, prelu), timed, per_step in cases:
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
        worst = max(worst, err)
        # The plain side is exact f32 (TF32 off); the kernel's 3xTF32
        # products carry ~2^-22 each and sums of up to 3200 of them run in
        # another order: 1e-4, a gate for exact-f32 arithmetic.
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
        path = ("tensor cores" if cb.tensor_core_path(cin, cout)
                else "FMA units")
        line = (f"  conv_prelu B={b} {h}x{w}x{cin}->{cout} s{s} ({path}): "
                f"err {err:.3e}")
        if not timed:
            print(line, flush=True)
            continue
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
        # The least time for f32-grade products on this card: three TF32
        # tensor-core products for each one (the 3xTF32 split), or the
        # bytes, whichever takes longer.
        bound, by = _bound_ms(3 * flops, nbytes, PEAK_TF32)
        print(f"{line}; kernel {ms:.3f} ms, plain {plain:.3f} ms, cuDNN "
              f"{lib:.3f} ms, bound {bound:.4f} ms ({by})", flush=True)
        if per_step:
            rows.append({"per_step": per_step, "err": err, "ms": ms,
                         "plain_ms": plain, "bound_ms": bound,
                         "bound_by": by, "library_ms": lib})
    entry = _entry("conv_prelu", "cuda",
                   "multimodal_sc_torch/csrc/conv_prelu.cu",
                   "multimodal_sc_tpu/kernels/conv_block.py:69", rows)
    entry["max_abs_err"] = worst
    return entry


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


def _c3_pillar_inputs():
    """Point features and cells as the c3 path makes them: a batch of the
    synthetic clouds, voxelized onto the 32x32 grid (trash cells included)."""
    import torch

    from multimodal_sc_torch.codec.lidar_bev import voxelize
    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.envs import datasets

    lid = get_preset("c3").lidar
    g = torch.Generator(device="cuda").manual_seed(4)
    pts, mask = datasets.synthetic_pointcloud_batch(
        datasets.draw_pointcloud(C3_BATCH, lid.max_points, g, "cuda",
                                 lid.x_range, lid.y_range),
        lid.x_range, lid.y_range)
    _, cell = voxelize(pts, mask, lid.bev_hw, lid.x_range, lid.y_range)
    feats = torch.randn(C3_BATCH, lid.max_points, lid.pillar_dim, generator=g,
                        device="cuda")
    return feats, cell, lid.bev_hw[0] * lid.bev_hw[1]


def _scatter_case(what, feats, cell, cells, backward=False):
    """One shape of scatter_max against its plain version; its row."""
    import torch

    from multimodal_sc_torch.kernels import pillar_scatter as ps

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
    line = (f"  scatter_max ({what}) B={b} N={n} D={d} cells={cells} ({valid} "
            f"of {b * n} points in range): err {err:.3e}; kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, scatter_reduce {lib:.4f} ms, bound "
            f"{bound:.5f} ms ({by})")
    if backward:
        # The wrapper's backward recomputes through the plain version.
        f = feats.clone().requires_grad_(True)
        y = ps.scatter_max(f, cell, cells)
        gy = torch.randn_like(y)
        bwd = _ms(lambda: torch.autograd.grad(y, f, gy, retain_graph=True),
                  iters=20)
        line += f"; backward (through the plain version) {bwd:.4f} ms"
    print(line, flush=True)
    return {"per_step": 1, "err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": lib}


def check_scatter_max():
    """The c4 act shape (its row is the kernel's line) and the c3 training
    shape, whose backward is timed too."""
    row = _scatter_case("c4", *_pillar_inputs())
    _scatter_case("c3", *_c3_pillar_inputs(), backward=True)
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
    plus ragged, two-group, d = 64, 16 and 8 shapes and Lk long enough for
    several key splits (two of those timed as well). Times are per act+learn
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

    # (B, Lq, Lk, dm, heads, forward launches per iteration, backward ones).
    # A negative count marks the c3 arm-P shape: timed and printed per c3
    # train step, kept out of the kernel's line, which stays arm B's.
    cases = [(NUM_ENVS, lq, lk, 128, 4, FUSION_DEPTH, 0)
             for lq, lk in C4_ATTN_SHAPES]
    cases += [(C3_BATCH, 256, 256, 128, 4, -C3_ATTN_PER_STEP,
               -C3_ATTN_PER_STEP)]
    # Backward: the camera-stream attentions (Lq = 65) in both layers, the
    # LiDAR-stream ones in all layers but the last (ATTN_BWD_PER_STEP).
    cases += [(LEARN_BATCH, lq, lk, 128, 4, 3 * FUSION_DEPTH,
               FUSION_DEPTH if lq == 65 else FUSION_DEPTH - 1)
              for lq, lk in C4_ATTN_SHAPES]
    cases += [(64, 33, 70, 128, 4, 0, 0), (64, 64, 64, 256, 8, 0, 0),
              (64, 17, 100, 128, 2, 0, 0), (64, 200, 48, 128, 4, 0, 0),
              (64, 40, 24, 256, 8, 0, 0)]
    # Lk > 1024 (five key splits, partial dQ summed), d = 64 over three
    # splits, d = 16 and d = 8 (half a k-step of the bf16 mma).
    cases += [(4, 100, 1100, 128, 4, 0, 0), (8, 130, 300, 128, 2, 0, 0),
              (16, 70, 130, 128, 8, 0, 0), (16, 50, 300, 128, 16, 0, 0)]
    # On no main path, timed all the same (backward count -1): what the
    # partial dQ of several key splits costs. d = 64 at Lk = 256 takes two
    # splits, d = 32 at Lk = 2048 eight.
    cases += [(C3_BATCH, 256, 256, 128, 2, 0, -1),
              (C3_BATCH, 256, 2048, 128, 4, 0, -1)]
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
        # The logsumexp the forward hands the backward, both modes: the
        # flash kernels' gate, 2e-5.
        scale = (dm // heads) ** -0.5
        lse_err = 0.0
        lses = {}
        for mode in (False, True):
            _, lses[mode] = ap._fwd_cuda(q, k, v, heads, scale, mode,
                                         want_lse=True)
            _, ref_lse = ap.packed_attention_fwd_reference(q, k, v, heads,
                                                           scale, bf16=mode)
            torch.testing.assert_close(lses[mode], ref_lse, atol=2e-5,
                                       rtol=2e-5)
            lse_err = max(lse_err, (lses[mode] - ref_lse).abs().max().item())
        line = (f"  packed_attention B={b} Lq={lq} Lk={lk} dm={dm} h={heads}: "
                f"fwd err bf16 {err:.3e} mean {mean:.2e}, f32 mode "
                f"{err_f32:.3e}, lse {lse_err:.3e}")

        # Backward through autograd, so the Function's backward is what is
        # checked: gradients of sum(out * do) with respect to q, k, v.
        grads = {}
        for mode in (False, True):
            ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out = ap.packed_attention(*ins, heads, mxu_bf16=mode)
            grads[mode] = torch.autograd.grad(out, ins, do)
            # No atomics: a second run gives the same bits.
            again = ap._bwd_cuda(q, k, v, out.detach(), lses[mode], do, heads,
                                 scale, mode)
            if not all(torch.equal(a, b_) for a, b_ in zip(again,
                                                           grads[mode])):
                raise AssertionError(
                    f"packed_attention backward (bf16={mode}): two runs on "
                    "the same inputs differ")
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
        if n_fwd > 0:
            fwd_rows.append({"per_step": n_fwd, "err": err, "ms": ms,
                             "plain_ms": plain, "bound_ms": bound,
                             "bound_by": by, "library_ms": lib})
        elif n_fwd < 0:
            line += f" (c3 arm P: x{-n_fwd} per train step)"
        if n_bwd:
            ms = _ms(lambda: ap._bwd_cuda(q, k, v, out_bf16, lses[True], do,
                                          heads, scale, True))
            plain = _ms(lambda: ap.packed_attention_bwd_reference(
                q, k, v, ref, do, heads, scale))
            for t in (qh, kh, vh):
                t.requires_grad_(True)
            lib_out = F.scaled_dot_product_attention(qh, kh, vh)
            doh = heads_first(do, heads)
            lib = _ms(lambda: torch.autograd.grad(lib_out, (qh, kh, vh), doh,
                                                  retain_graph=True))
            # Five products of 2 Lq Lk d operations per head on the bf16
            # tensor cores; q, k, v, o, dO, lse read and dq, dk, dv written
            # once, in f32.
            bound, by = _bound_ms(10 * b * lq * lk * dm,
                                  4 * (4 * b * (lq + lk) * dm
                                       + b * heads * lq), PEAK_BF16)
            line += (f"; bwd kernel {ms:.3f} ms, plain {plain:.3f} ms, SDPA "
                     f"backward {lib:.3f} ms, bound {bound:.4f} ms ({by})")
            if n_bwd > 0:
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


def check_flash_attention():
    """Forward, dQ and dK/dV kernels vs their plain versions: the c3 arm-F
    shape on the transposed views the ViT's MHA hands in, plus ragged,
    cross, odd-D and contiguous shapes. Times are per arm-F train step
    (eight launches of each kernel)."""
    import torch
    import torch.nn.functional as F

    from multimodal_sc_torch.kernels import attention as fa

    g = torch.Generator(device="cuda").manual_seed(5)

    def heads_view(b, h, l, d):
        # As MHA makes it: a (B, L, H*D) projection seen as (B, H, L, D).
        return torch.randn(b, l, h, d, generator=g,
                           device="cuda").transpose(1, 2)

    def contiguous(b, h, l, d):
        return torch.randn(b, h, l, d, generator=g, device="cuda")

    # (B, H, Lq, Lk, D, layout, launches of each kernel per train step)
    cases = [(C3_BATCH, 3, 256, 256, 64, heads_view, C3_ATTN_PER_STEP),
             (2, 4, 100, 70, 32, contiguous, 0),
             (C3_BATCH, 3, 257, 257, 64, heads_view, 0),
             (2, 4, 64, 64, 48, heads_view, 0),
             (2, 2, 17, 17, 64, contiguous, 0),
             (3, 2, 33, 130, 128, heads_view, 0),
             (2, 3, 40, 24, 96, contiguous, 0),
             (4, 5, 300, 7, 8, heads_view, 0)]
    rows = {"fwd": [], "dq": [], "dkv": []}
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for b, h, lq, lk, d, make, per_step in cases:
        q, k, v = make(b, h, lq, d), make(b, h, lk, d), make(b, h, lk, d)
        do = make(b, h, lq, d)
        scale = d ** -0.5
        ref, ref_lse = fa.flash_attention_fwd_reference(q, k, v, scale)
        out, lse = fa._fwd_cuda(q, k, v, scale)
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        # Through autograd, so the Function's backward is what is checked.
        got = torch.autograd.grad(fa.attention(*ins, use_pallas=True), ins, do)
        torch.cuda.synchronize()
        want = fa.flash_attention_bwd_reference(q, k, v, ref, ref_lse, do,
                                                scale)
        # Exact f32 on both sides, sums of D and Lk products in another
        # order; the gates of the JAX package's kernel tests: 2e-5 forward
        # (and the logsumexp), 2e-4 backward.
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)
        torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=2e-5)
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, atol=2e-4, rtol=2e-4)
        errs = {"fwd": (out - ref).abs().max().item(),
                "dq": (got[0] - want[0]).abs().max().item(),
                "dkv": max((got[1] - want[1]).abs().max().item(),
                           (got[2] - want[2]).abs().max().item())}
        for key, e in errs.items():
            worst[key] = max(worst[key], e)
        line = (f"  flash_attention B={b} H={h} Lq={lq} Lk={lk} D={d} "
                f"({make.__name__}): err fwd {errs['fwd']:.3e}, lse "
                f"{(lse - ref_lse).abs().max().item():.3e}, dq "
                f"{errs['dq']:.3e}, dk/dv {errs['dkv']:.3e}")
        if not per_step:
            print(line, flush=True)
            continue

        _, delta = fa.flash_attention_dq_reference(q, k, v, ref, ref_lse, do,
                                                   scale)
        work = b * h * lq * lk * d
        rows_bytes = 4 * b * h * d
        ms = {
            "fwd": _ms(lambda: fa._fwd_cuda(q, k, v, scale)),
            "dq": _ms(lambda: fa._bwd_dq_cuda(q, k, v, out, lse, do, scale)),
            "dkv": _ms(lambda: fa._bwd_dkv_cuda(q, k, v, lse, delta, do,
                                                scale))}
        plain = {
            "fwd": _ms(lambda: fa.flash_attention_fwd_reference(q, k, v,
                                                                scale)),
            "dq": _ms(lambda: fa.flash_attention_dq_reference(
                q, k, v, ref, ref_lse, do, scale)),
            "dkv": _ms(lambda: fa.flash_attention_dkv_reference(
                q, k, v, ref_lse, delta, do, scale))}
        # Library yardstick: SDPA forward, and SDPA's backward, which gives
        # dQ, dK and dV in one call: it stands beside both backward rows.
        qc, kc, vc = (t.contiguous().requires_grad_(True) for t in (q, k, v))
        lib_fwd = _ms(lambda: F.scaled_dot_product_attention(qc, kc, vc))
        lib_out = F.scaled_dot_product_attention(qc, kc, vc)
        doc = do.contiguous()
        lib_bwd = _ms(lambda: torch.autograd.grad(lib_out, (qc, kc, vc), doc,
                                                  retain_graph=True))
        lib = {"fwd": lib_fwd, "dq": lib_bwd, "dkv": lib_bwd}
        # Operations: S and PV forward (4 per score and column); S, dP, dQ in
        # the dQ kernel (6); S, dP, dV, dK in the dK/dV kernel (8). Bytes:
        # every operand read once, every result written once.
        bounds = {
            "fwd": _bound_ms(4 * work, rows_bytes * (2 * lq + 2 * lk)
                             + 4 * b * h * lq, PEAK_F32),
            "dq": _bound_ms(6 * work, rows_bytes * (4 * lq + 2 * lk)
                            + 8 * b * h * lq, PEAK_F32),
            "dkv": _bound_ms(8 * work, rows_bytes * (2 * lq + 4 * lk)
                             + 8 * b * h * lq, PEAK_F32)}
        for key in rows:
            bound, by = bounds[key]
            line += (f"; {key} kernel {ms[key]:.3f} ms, plain "
                     f"{plain[key]:.3f} ms, bound {bound:.4f} ms ({by})")
            rows[key].append({"per_step": per_step, "err": errs[key],
                              "ms": ms[key], "plain_ms": plain[key],
                              "bound_ms": bound, "bound_by": by,
                              "library_ms": lib[key]})
        line += (f"; SDPA forward {lib_fwd:.3f} ms, backward (dQ, dK and dV "
                 f"together) {lib_bwd:.3f} ms")
        print(line, flush=True)
        del q, k, v, do, ref, out, ins, got, want, qc, kc, vc, lib_out
    src = "multimodal_sc_torch/csrc/flash_attention.cu"
    entries = [
        _entry("flash_attention_fwd", "cuda", src,
               "multimodal_sc_tpu/kernels/attention.py:103", rows["fwd"]),
        _entry("flash_attention_bwd_dq", "cuda", src,
               "multimodal_sc_tpu/kernels/attention.py:221", rows["dq"]),
        _entry("flash_attention_bwd_dkv", "cuda", src,
               "multimodal_sc_tpu/kernels/attention.py:252", rows["dkv"])]
    for e, key in zip(entries, ("fwd", "dq", "dkv")):
        e["max_abs_err"] = worst[key]
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
                *check_packed_attention(), *check_flash_attention()]
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


def drive_c3(name, overrides, expected):
    """The c3 late-fusion train step at the preset's full widths through
    ``train.fusion_jscc``: returns the launches of the timed run, the train
    steps/s, and the config, state, train step and batch stream it ended
    with."""
    import torch

    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.train import fusion_jscc as fj

    cfg = get_preset("c3").override_str(overrides)
    if cfg.train.batch_size != C3_BATCH:
        raise RuntimeError(f"c3 batch size {cfg.train.batch_size}")
    t0 = time.perf_counter()
    state = fj.create_train_state(cfg, seed=0, device="cuda")
    train_step = fj.make_train_step(cfg)
    batches = fj.make_batches(cfg, "cuda")
    before = _clone_params(state.params)
    state, first = train_step(state, *next(batches))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    for _ in range(C3_WARMUP_STEPS - 1):
        state, _ = train_step(state, *next(batches))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state.params.parameters())
    print(f"  {n_params} parameters; init + first step {first_s:.2f} s", flush=True)

    _reset_counts()
    t0 = time.perf_counter()
    history = []
    for _ in range(C3_TIMED_STEPS):
        state, metrics = train_step(state, *next(batches))
        history.append(metrics)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()

    rate = C3_TIMED_STEPS / wall
    print(f"  c3 train ({name}): {C3_TIMED_STEPS} steps x batch {C3_BATCH} in "
          f"{wall:.3f} s = {rate:.2f} train steps/s", flush=True)
    print(f"  launches in the timed run: {launches}", flush=True)
    print(f"  first step: " + ", ".join(
        f"{k}={float(v):.4f}" for k, v in first.items()), flush=True)
    print(f"  last step:  " + ", ".join(
        f"{k}={float(v):.4f}" for k, v in metrics.items()), flush=True)
    _check_counts(launches, expected, C3_TIMED_STEPS, name)
    for m in [first] + history:
        if not all(torch.isfinite(v).all() for v in m.values()):
            raise RuntimeError(f"{name}: non-finite metrics: {m}")
    if state.step != C3_WARMUP_STEPS + C3_TIMED_STEPS:
        raise RuntimeError(f"{name}: step {state.step}")
    if _same(state.params, before):
        raise RuntimeError(f"{name}: the parameters did not change")
    if not float(metrics["loss"]) < float(first["loss"]):
        raise RuntimeError(
            f"{name}: loss {float(metrics['loss']):.4f} after "
            f"{state.step} steps, not below the first step's "
            f"{float(first['loss']):.4f}")
    recon_shape = (C3_BATCH, *cfg.camera.image_hw, 3)
    with torch.no_grad():
        img, pts, mask, _ = next(batches)
        snr = torch.full((C3_BATCH,), cfg.channel.snr_db, device="cuda")
        recon, logits, _ = state.params(img, pts, mask, snr, state.generator)
    want_logits = (C3_BATCH, *cfg.lidar.bev_hw, cfg.lidar.seg_classes)
    if recon.shape != recon_shape or logits.shape != want_logits:
        raise RuntimeError(f"{name}: outputs {tuple(recon.shape)}, "
                           f"{tuple(logits.shape)}")
    print(f"  loss {float(first['loss']):.4f} -> {float(metrics['loss']):.4f}, "
          f"PSNR {float(first['psnr']):.2f} -> {float(metrics['psnr']):.2f} dB, "
          f"mIoU {float(first['miou']):.3f} -> {float(metrics['miou']):.3f}; "
          f"reconstruction {tuple(recon.shape)}, BEV logits "
          f"{tuple(logits.shape)}", flush=True)
    return launches, rate, cfg, state, train_step, batches


def _plain_attention(q, k, v, scale=None, use_pallas=False):
    from multimodal_sc_torch.kernels.attention import attention_reference

    return attention_reference(q, k, v, scale)


def compare_c3_routes(cfg, state, batches, expected):
    """One c3 loss and its gradients on a fixed batch and fixed channel
    noise, twice: through the kernels (packed attention in its f32 mode)
    and through every kernel's plain version."""
    import torch

    from multimodal_sc_torch.codec import camera_vit, lidar_bev
    from multimodal_sc_torch.kernels import attention_packed, pillar_scatter
    from multimodal_sc_torch.train import fusion_jscc as fj

    img, pts, mask, cls = next(batches)
    g = torch.Generator(device="cuda").manual_seed(8)
    model = state.params
    noise = tuple(torch.randn(C3_BATCH, n, 2, generator=g, device="cuda")
                  for n in (model.camera.k, model.lidar.k))
    snr = torch.full((C3_BATCH,), cfg.channel.snr_db, device="cuda")
    target = fj.bev_target(cfg, pts, mask, cls)
    params = list(model.parameters())

    def loss_and_grads():
        loss, _ = fj.loss_fn(cfg, model, img, pts, mask, target, snr,
                             channel_noise=noise)
        return loss.detach(), torch.autograd.grad(loss, params)

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
        _check_counts(ran, expected, 1, "kernel route of the c3 train step")
        before = _read_counts()
        with mock.patch.object(camera_vit, "packed_attention",
                               attention_packed.packed_attention_reference), \
                mock.patch.object(camera_vit, "attention", _plain_attention), \
                mock.patch.object(lidar_bev, "scatter_max",
                                  pillar_scatter.scatter_max_reference):
            loss_p, grads_p = loss_and_grads()
        if _read_counts() != before:
            raise RuntimeError("the plain route of the c3 train step launched "
                               "a kernel")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    torch.cuda.synchronize()
    # Exact f32 on both routes (TF32 off), each kernel within 1e-4 of its
    # plain version, through ~30 layers: loss 1e-5, gradients rtol 1e-3
    # (atol 1e-5 for the entries near zero), as for the c4 learn step.
    torch.testing.assert_close(loss_k, loss_p, atol=1e-5, rtol=1e-5)
    worst_abs = worst_rel = 0.0
    for (pname, _), gk, gp in zip(model.named_parameters(), grads_k, grads_p):
        torch.testing.assert_close(gk, gp, atol=1e-5, rtol=1e-3,
                                   msg=lambda m: f"{pname}: {m}")
        diff, top = (gk - gp).abs().max().item(), gp.abs().max().item()
        worst_abs = max(worst_abs, diff)
        if top > 1e-4:
            worst_rel = max(worst_rel, diff / top)
    print(f"  train step, kernels (f32 mode) vs plain versions: loss "
          f"{loss_k.item():.6f} vs {loss_p.item():.6f}; worst gradient "
          f"difference {worst_abs:.2e} absolute, {worst_rel:.2e} of its "
          f"tensor's largest entry (tensors above 1e-4), over {len(params)} "
          "tensors", flush=True)


def profile_c3(cfg, state, train_step, batches):
    """Where the time of one c3 train step goes: its parts timed alone on
    one batch, then the device's busy share of whole steps (batch
    generation included, as in ``run``)."""
    import torch

    from multimodal_sc_torch.train import fusion_jscc as fj

    holder = [state]

    def step_all():
        holder[0], _ = train_step(holder[0], *next(batches))

    img, pts, mask, cls = next(batches)
    model, g = state.params, state.generator
    snr = torch.full((C3_BATCH,), cfg.channel.snr_db, device="cuda")
    target = fj.bev_target(cfg, pts, mask, cls)
    params = list(model.parameters())

    def loss():
        return fj.loss_fn(cfg, model, img, pts, mask, target, snr, g)[0]

    parts = {
        "step incl. batch": _ms(step_all, warmup=1),
        "train_step": _ms(lambda: train_step(holder[0], img, pts, mask, cls)),
    }
    with torch.no_grad():
        z_cam = model.camera.encode(img, snr)
        z_lid = model.lidar.encode((pts, mask))
        parts.update({
            "make batch": _ms(lambda: next(batches)),
            "bev_target": _ms(lambda: fj.bev_target(cfg, pts, mask, cls)),
            "forward_no_grad": _ms(loss),
            "camera encode (no grad)": _ms(lambda: model.camera.encode(img,
                                                                      snr)),
            "camera decode (no grad)": _ms(lambda: model.camera.decode(z_cam,
                                                                      snr)),
            "lidar encode (no grad)": _ms(lambda: model.lidar.encode((pts,
                                                                     mask))),
            "lidar decode (no grad)": _ms(lambda: model.lidar.decode(z_lid)),
        })
    parts["forward_with_grad"] = _ms(loss)
    parts["loss_and_backward"] = _ms(
        lambda: torch.autograd.grad(loss(), params))
    parts["backward (difference)"] = (parts["loss_and_backward"]
                                      - parts["forward_with_grad"])
    parts["target_clip_adamw_metrics (difference)"] = (
        parts["train_step"] - parts["loss_and_backward"])
    print("  ms per call, each part timed alone (CUDA events):", flush=True)
    for k, v in parts.items():
        print(f"    {k:40s} {v:9.3f}", flush=True)
    _idle_share(step_all, parts["step incl. batch"])


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
    c3_rates = {}
    for name, overrides, expected in (
            ("arm P: ViT on packed_attention", C3_ARM_P, EXPECTED_C3_P),
            ("arm F: ViT dim 192 on flash_attention", C3_ARM_F,
             EXPECTED_C3_F)):
        print(f"main path (c3 late-fusion train, {name}):", flush=True)
        launches, c3_rates[name], cfg, state, train_step, batches = drive_c3(
            name, overrides, expected)
        for k, v in launches.items():
            totals[k] += v
        compare_c3_routes(cfg, state, batches, expected)
        if args.profile:
            print(f"profile (c3 late-fusion train, {name}):", flush=True)
            profile_c3(cfg, state, train_step, batches)
        del state, train_step, batches
        torch.cuda.empty_cache()
    for k in kernels:
        k["launches"] = totals[k["name"]]
        if k["launches"] <= 0:
            raise RuntimeError(f"{k['name']} was launched on no main path")
    print(f"agent steps/s at {NUM_ENVS} envs on {card}: " + "; ".join(
        f"{k} {v:.1f}" for k, v in rates.items()), flush=True)
    print(f"c3 train steps/s at batch {C3_BATCH} on {card}: " + "; ".join(
        f"{k} {v:.2f}" for k, v in c3_rates.items()), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
