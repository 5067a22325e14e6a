#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``multimodal_sc_torch``) on one GPU.

    python3 chip_smoke.py [--profile]

Builds every CUDA kernel from ``multimodal_sc_torch/csrc`` with ``nvcc``,
holds each kernel against its plain PyTorch version on the card at the
shapes of the c4 act path, times both, then drives the c4 DQN act-only
iteration (1024 envs, full widths, random weights from seed 0) through the
port's entry points and checks that every kernel ran on it and that its
outputs are finite. Prints the card, the per-kernel JSON line and, last,
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
when CUDA is absent or any phase fails. Imports nothing of JAX.

``--profile`` adds a phase after the main path: each layer of the act
iteration timed alone, the device's idle share (an unprofiled wall time
against the device time a CUDA-only ``torch.profiler`` trace sees), and
the trace's kernels by device time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

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
EXPECTED_LAUNCHES = {"mha_block": 8, "conv_prelu": 5, "scatter_max": 1}
FUSION_DEPTH = 2            # c4 fusion.depth: each block shape twice a step


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
        return [check_mha_block(), check_conv_prelu(), check_scatter_max()]
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def drive_main_path():
    """The c4 act-only iteration at 1024 envs; returns the launches of the
    timed run, the steps/s, and the state and iteration it ended with."""
    import torch

    from multimodal_sc_torch.config import get_preset
    from multimodal_sc_torch.kernels import conv_block, mha_block, pillar_scatter
    from multimodal_sc_torch.rl import dqn

    counters = {"mha_block": mha_block, "conv_prelu": conv_block,
                "scatter_max": pillar_scatter}
    cfg = get_preset("c4")
    t0 = time.perf_counter()
    state = dqn.init(cfg, seed=0, num_envs=NUM_ENVS, device="cuda")
    iteration = dqn.make_iteration(cfg, learn=False)
    for _ in range(WARMUP_ITERS):
        state, metrics = iteration(state)
    torch.cuda.synchronize()
    print(f"  init + {WARMUP_ITERS} warm-up iterations: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    for mod in counters.values():
        mod.launches = 0
    t0 = time.perf_counter()
    rewards = []
    for _ in range(TIMED_ITERS):
        state, metrics = iteration(state)
        rewards.append(metrics["reward"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: mod.launches for k, mod in counters.items()}

    sps = TIMED_ITERS * NUM_ENVS / wall
    print(f"  act-only: {TIMED_ITERS} iterations x {NUM_ENVS} envs in "
          f"{wall:.3f} s = {sps:.1f} agent steps/s", flush=True)
    print(f"  launches in the timed run: {launches}", flush=True)
    print(f"  metrics: " + ", ".join(
        f"{k}={float(v):.4f}" for k, v in metrics.items()), flush=True)
    for k, per_step in EXPECTED_LAUNCHES.items():
        if launches[k] != per_step * TIMED_ITERS:
            raise RuntimeError(
                f"{k}: {launches[k]} launches in {TIMED_ITERS} iterations, "
                f"expected {per_step} per iteration")
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


def profile_main_path(cfg, state, iteration):
    """Where the time of one act-only iteration goes: each layer timed alone
    on the main path's own inputs, then the device's busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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

    # Idle share: the wall is the unprofiled iteration above (the
    # profiler's own host work would stretch it), the device time from a
    # trace that records the device only.
    n, wall = 10, parts["iteration"]
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also break the act iteration's time down by layer "
                         "and kernel, with the device's idle share")
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
    print("main path (c4 act-only):", flush=True)
    launches, _, state, iteration = drive_main_path()
    if args.profile:
        from multimodal_sc_torch.config import get_preset

        print("profile (c4 act-only):", flush=True)
        profile_main_path(get_preset("c4"), state, iteration)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
