"""Where a block of the packed attention backward's bf16-I/O kernels spends
its time, on the card, and what variants of the new kernel cost.

Stamps (no arguments): builds a copy of ``multimodal_sc_torch/csrc`` whose
``attention_packed.cu`` (``bwd_mma_kernel``) and ``packed_bwd_bf16.cuh``
(``bwd_wgmma_bf16_kernel``) add ``%globaltimer`` stamps: one thread of each
128 (thread 0 of a warpgroup) adds the time since its last stamp to the
phase it has just finished, in shared memory, and writes the sums and the SM
to a device array at its end. Runs both kernels on bf16 tensors at arm B's
four shapes and the ViT trunk's (B 128) and c3 arm P's (B 64), 4 heads of
32, and prints each phase's share of a stamping thread's time (mean over
the stamping threads), its mean, the blocks and SMs. The old kernel's
phases: K and V staged; Q, dO and delta staged; phase 1 (S, dP, the
exponentials, dS, dV, dK); phase 2 (dQ); the stores. The new kernel's (a
block's items together; its grid is persistent): barrier A, where a chunk's
copies land; S^T and dP^T (the next copies are issued under the first);
the exponentials and dS; dV and dK; dQ (the warpgroup whose turn it is) or
the others' arrival; the flush; an item's end (dK and dV stored); with
TMA, the next chunk's landing and its delta, the item's K and V landing.
It also times both kernels at (Lq, Lk) =
(64 | 65, 64 | 65), what a one-row query tail and a one-key tile cost. The
stamps cost a few instructions a phase; time the kernels with
``chip_smoke.py``.

Variants (``--variants NAME ...``, or ``--variants all``): builds copies of
``csrc`` with text substitutions in ``packed_bwd_bf16.cuh``, one ``nvcc``
each in parallel, and times each beside the kernel as it is and
``bwd_mma_kernel`` in turns at the same shapes, with the share of their
outputs that differ from the plain version and those past one bf16 step.
"probe:" variants drop work and are not checked.

Gate (``--gate``): c4 arm B's bf16 learn-step route gate of
``chip_smoke.py`` on states trained (``drive_learn``) with
``bwd_mma_kernel``, with the kernel and with its ``dq1chain`` and
``dkvjoin`` variants, each state read with the kernel and with
``bwd_mma_kernel``: the worst tensors in bf16 steps.

Needs a card and ``nvcc``; imports no JAX. Raises if an anchor it
substitutes is gone from the source: edit it with the kernels.

    python3 scripts/torch_packed_bwd_bf16_stamps.py [--variants NAME ... | --gate]
"""
import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from multimodal_sc_torch.kernels import _build  # noqa: E402
from multimodal_sc_torch.kernels import attention_packed as ap  # noqa: E402

SLOTS = 16        # a stamping thread's entries: its phases, span, SM
PHASES_OLD = ("K, V staged", "Q, dO, delta staged",
              "phase 1 (S, dP, exp, dS, dV, dK)", "phase 2 (dQ)", "stores")
PHASES_NEW = ("barrier A (the chunk's copies landed)",
              "S^T, dP^T (the first: the next copies issued)",
              "exponentials, dS", "dV, dK",
              "dQ (its warpgroup) or the arrival", "flush",
              "item end: dK and dV stored",
              "the next chunk landed (TMA), its delta",
              "the item's K and V landed (TMA)")
# (B, Lq, Lk): arm B's four shapes and the ViT trunk's at B 128 (per arm-B
# act+learn step: 2, 1, 2, 1 and 6 launches), c3 arm P's at B 64.
SHAPES = ((128, 65, 256), (128, 256, 65), (128, 65, 65), (128, 256, 256),
          (128, 64, 64), (64, 256, 256))
PER_STEP = (2, 1, 2, 1, 6, 0)
HEADS, DM = 4, 128

HEADER = (
    "namespace packed_bwd_bf16 {\n"
    "__device__ unsigned long long g_dbg[1 << 17];\n"
    "__device__ __forceinline__ unsigned long long gtime() {\n"
    "  unsigned long long t;\n"
    "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
    "  return t;\n}\n")
INIT = (
    "  __shared__ unsigned long long _sacc[4][12];\n"
    "  const unsigned long long _t0 = packed_bwd_bf16::gtime();\n"
    "  unsigned long long _tp = _t0;\n"
    "  if ((threadIdx.x & 127) == 0)\n"
    "    for (int _i = 0; _i < 12; ++_i) _sacc[threadIdx.x >> 7][_i] = 0;\n")
STAMP = ("if ((threadIdx.x & 127) == 0) {{ const unsigned long long _t = "
         "packed_bwd_bf16::gtime(); _sacc[threadIdx.x >> 7][{}] += _t - _tp; "
         "_tp = _t; }}\n")
WRITE = (
    "  if ((threadIdx.x & 127) == 0) {\n"
    "    const long long _blk = ((long long)blockIdx.z * gridDim.y + "
    "blockIdx.y) * gridDim.x + blockIdx.x;\n"
    "    unsigned long long* _o = packed_bwd_bf16::g_dbg + (_blk * 4 + "
    "(threadIdx.x >> 7)) * 16;\n"
    "    for (int _i = 0; _i < 12; ++_i) _o[_i] = _sacc[threadIdx.x >> 7][_i];\n"
    "    _o[14] = packed_bwd_bf16::gtime() - _t0;\n"
    "    unsigned _sm; asm(\"mov.u32 %0, %smid;\" : \"=r\"(_sm)); _o[15] = _sm;\n"
    "  }\n")


def _s(k):
    return STAMP.format(k)


OLD = [   # attention_packed.cu, bwd_mma_kernel
    ("  load_tile_bf16<D, NTHREADS>(k + krow0, stride, nkeys, KB, Ks);\n",
     INIT + "  load_tile_bf16<D, NTHREADS>(k + krow0, stride, nkeys, KB, Ks);\n"),
    ("    ldsm_x4(vf[kd], Vs + off);\n  }\n",
     "    ldsm_x4(vf[kd], Vs + off);\n  }\n" + _s(0)),
    ("    if (tid < QT) lse_s[tid] = tid < nq ? lse_b[q0 + tid] : INFINITY;\n"
     "    __syncthreads();\n",
     "    if (tid < QT) lse_s[tid] = tid < nq ? lse_b[q0 + tid] : INFINITY;\n"
     "    __syncthreads();\n" + _s(1)),
    ("        if ((q0 + QT) % BQ == 0 || q0 + QT >= Lq) flush(q0 < BQ);\n"
     "      }\n    }\n    __syncthreads();\n",
     "        if ((q0 + QT) % BQ == 0 || q0 + QT >= Lq) flush(q0 < BQ);\n"
     "      }\n    }\n    __syncthreads();\n" + _s(2)),
    ("    // The next tile's phase 1 overwrites",
     _s(3) + "    // The next tile's phase 1 overwrites"),
    ("    }\n  }\n}\n\n// dq = the sum of the key splits'",
     "    }\n  }\n" + _s(4) + WRITE + "}\n\n// dq = the sum of the key splits'"),
]
NEW = [   # packed_bwd_bf16.cuh, bwd_wgmma_bf16_kernel
    ("namespace packed_bwd_bf16 {\n", HEADER),
    ("  const bool warp_live = wg * KEYS + 16 * warp < Lk;\n",
     "  const bool warp_live = wg * KEYS + 16 * warp < Lk;\n" + INIT),
    ("    bw::fence_async_shared();\n    __syncthreads();\n"
     "    // The next chunk (or item's first)",
     "    bw::fence_async_shared();\n    __syncthreads();\n" + _s(0)
     + "    // The next chunk (or item's first)"),
    ("    const float* dl = delta_b + buf * QC;\n",
     _s(8) + "    const float* dl = delta_b + buf * QC;\n"),
    ("      bw::wgmma_wait();\n      wgmma_operand_fence(st);\n"
     "      wgmma_operand_fence(dpt);\n"
     "      probs(n_, st, dpt, pa, dsa, buf, s, nq, dl);\n",
     "      bw::wgmma_wait();\n      wgmma_operand_fence(st);\n"
     "      wgmma_operand_fence(dpt);\n" + _s(1)
     + "      probs(n_, st, dpt, pa, dsa, buf, s, nq, dl);\n" + _s(2)),
    ("      if (next < items) chunk_landed(buf ^ 1);\n    }\n",
     "      if (next < items) chunk_landed(buf ^ 1);\n    }\n" + _s(7)),
    ("      bw::wgmma_commit_wait();\n      wgmma_operand_fence(dva);\n"
     "      wgmma_operand_fence(dka);\n    };\n",
     "      bw::wgmma_commit_wait();\n      wgmma_operand_fence(dva);\n"
     "      wgmma_operand_fence(dka);\n" + _s(3) + "    };\n"),
    ("    turn = turn + 1 == nc ? 0 : turn + 1;\n",
     "    turn = turn + 1 == nc ? 0 : turn + 1;\n" + _s(4)),
    ("      if ((q0 + QC) % BQ == 0 || q0 + QC >= Lq) flush(q0 < BQ);\n"
     "    }\n",
     "      if ((q0 + QC) % BQ == 0 || q0 + QC >= Lq) flush(q0 < BQ);\n"
     "    }\n" + _s(5)),
    ("    store_dkv(item, slot, buf);\n",
     "    store_dkv(item, slot, buf);\n" + _s(6)),
    ("    item = next;\n    j = 0;\n  }\n}\n",
     "    item = next;\n    j = 0;\n  }\n" + WRITE + "}\n"),
]

# Variants of packed_bwd_bf16.cuh: name -> substitutions.
_P_EXPR = ("          const float p0 = expf(ok ? a0 : -INFINITY);\n"
           "          const float p1 = expf(ok ? a1 : -INFINITY);\n")
_EX2 = ("[](float x) { float y; asm(\"ex2.approx.ftz.f32 %0, %1;\" : "
        "\"=f\"(y) : \"f\"(x)); return y; }")
_DQ = ("#pragma unroll 1\n    for (int w = 0; w < nc; ++w) {\n"
       "      wgmma_operand_fence(tq);\n      bw::wgmma_fence();\n"
       "#pragma unroll\n      for (int kk = 0; kk < KEYS / 16; ++kk)\n"
       "        bw::wgmma_bf16_ss<DT, 1, 1>(\n"
       "            tq, bw::mnmajor<KEYS, QC>(dst(buf, w), kk),\n"
       "            bw::mnmajor<KEYS, DT>(kt(slot) + w * KEYS * SW, kk), "
       "kk > 0);\n"
       "      bw::wgmma_commit_wait();\n      wgmma_operand_fence(tq);\n"
       "#pragma unroll\n      for (int i = 0; i < DT / 2; ++i)\n"
       "        dqa[i] = w == 0 ? tq[i] : dqa[i] + tq[i];\n    }\n")
VARIANTS = {
    # P on the exp2 unit from the plain version's argument, its product by
    # log2(e) compensated: 2^hi (1 + lo ln 2), five instructions.
    "exp5": [(_P_EXPR,
              "          auto ex2 = " + _EX2 + ";\n"
              "          auto e5 = [&](float y) {\n"
              "            const float h = y * 1.4426950408889634f;\n"
              "            const float l = fmaf(y, 1.925963033500011e-08f, "
              "fmaf(y, 1.4426950408889634f, -h));\n"
              "            const float e = ex2(h);\n"
              "            return fmaf(e, l * 0.6931471805599453f, e);\n"
              "          };\n"
              "          const float p0 = e5(ok ? a0 : -1e30f);\n"
              "          const float p1 = e5(ok ? a1 : -1e30f);\n")],
    # P on the exp2 unit: 2^(s scale log2(e) - lse log2(e)), one fma.
    "fastexp": [(_P_EXPR,
                 "          auto ex2 = " + _EX2 + ";\n"
                 "          const float p0 = ok ? ex2(fmaf(st[x], scale * "
                 "1.4426950408889634f, -l2.x * 1.4426950408889634f)) : 0.0f;\n"
                 "          const float p1 = ok ? ex2(fmaf(st[x + 1], scale * "
                 "1.4426950408889634f, -l2.y * 1.4426950408889634f)) : 0.0f;\n")],
    # No exponentials (P = s scale - lse): what they cost.
    "probe:noexp": [(_P_EXPR,
                     "          const float p0 = ok ? a0 : 0.0f;\n"
                     "          const float p1 = ok ? a1 : 0.0f;\n")],
    # dQ: every key of the item one chain (4 nc k-steps), one wait.
    "dq1chain": [(_DQ,
                  "    wgmma_operand_fence(dqa);\n    bw::wgmma_fence();\n"
                  "#pragma unroll 1\n    for (int w = 0; w < nc; ++w) {\n"
                  "#pragma unroll\n      for (int kk = 0; kk < KEYS / 16; ++kk)\n"
                  "        bw::wgmma_bf16_ss<DT, 1, 1>(\n"
                  "            dqa, bw::mnmajor<KEYS, QC>(dst(buf, w), kk),\n"
                  "            bw::mnmajor<KEYS, DT>(kt(slot) + w * KEYS * SW, "
                  "kk), w > 0 || kk > 0);\n    }\n"
                  "    bw::wgmma_commit_wait();\n    wgmma_operand_fence(dqa);\n")],
    # dV, dK: each 32 (or 16) queries a chain from zero, joined by f32 adds.
    "dkvjoin": [("      bw::wgmma_fence();\n      issue_dkv(n_, pa, dsa, buf, s);\n"
                 "      bw::wgmma_commit_wait();\n      wgmma_operand_fence(dva);\n"
                 "      wgmma_operand_fence(dka);\n",
                 "      float tv[DT / 2], tk[DT / 2];\n"
                 "      wgmma_operand_fence(tv);\n      wgmma_operand_fence(tk);\n"
                 "      bw::wgmma_fence();\n#pragma unroll\n"
                 "      for (int kk = 0; kk < N / 16; ++kk)\n"
                 "        bw::wgmma_bf16<DT, 1>(tv, pa[kk], bw::mnmajor<QC, DT>("
                 "dot(buf), s / 16 + kk), kk > 0);\n#pragma unroll\n"
                 "      for (int kk = 0; kk < N / 16; ++kk)\n"
                 "        bw::wgmma_bf16<DT, 1>(tk, dsa[kk], bw::mnmajor<QC, DT>("
                 "qt(buf), s / 16 + kk), kk > 0);\n"
                 "      bw::wgmma_commit_wait();\n"
                 "      wgmma_operand_fence(tv);\n      wgmma_operand_fence(tk);\n"
                 "#pragma unroll\n      for (int i = 0; i < DT / 2; ++i) {\n"
                 "        dva[i] += tv[i];\n        dka[i] += tk[i];\n      }\n")],
    # No delta (wrong results).
    "probe:nodelta": [("    deltas_from_tiles(b_);\n", "")],
    # No lse copies (wrong results): what issuing them costs.
    "probe:nolse": [("    if (tid < QC) {\n      const float* lr = lse", 
                     "    if (false) {\n      const float* lr = lse")],
    # The next copies issued right after barrier A, not under the first
    # products.
    "copiesfirst": [("      if (first) issue_next();\n", ""),
                    ("    chunk(buf, slot, nq, dl, issue_next);\n",
                     "    issue_next();\n    chunk(buf, slot, nq, dl, issue_next);\n")],
    # TMA issued by thread 0, not by the last warp's first lane.
    "tmafirst": [("      if (tid == nthreads - 32) {\n        mbar_expect(kbar(slot),",
                  "      if (tid == 0) {\n        mbar_expect(kbar(slot),"),
                 ("      if (tid == nthreads - 32) {\n        const int c0 = (it % heads) * D,",
                  "      if (tid == 0) {\n        const int c0 = (it % heads) * D,")],
    # The tiles by cp.async, as at head dims 8 and 16.
    "notma": [("  constexpr bool TMA = IO_BF16 && D >= 32;\n",
               "  constexpr bool TMA = false;\n")],
    # A query tail of at most 16 taken 32 wide, as the full sub-chunks.
    "notail": [("    for (; s < nq; s += 16) step(std::integral_constant<int, 16>(), "
                "s);\n",
                "    for (; s < nq; s += 16) step(std::integral_constant<int, 32>(), "
                "s);\n")],
}


def _edit(path, edits):
    src = open(path).read()
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"anchor not found once in {path}: {old!r}")
        src = src.replace(old, new)
    open(path, "w").write(src)


def _compile(src_dir, lib):
    cu = os.path.join(src_dir, "attention_packed.cu")
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                             cu], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _load(lib, stamps=False):
    cl = ctypes.CDLL(lib)
    for fn, argtypes in ap._SIG.items():
        f = getattr(cl, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    if stamps:
        cl.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        cl.read_stamps.restype = ctypes.c_int
        cl.clear_stamps.argtypes = []
        cl.clear_stamps.restype = ctypes.c_int
    return cl


def build_stamped(work):
    """The stamped library; raises if a source no longer has an anchor."""
    src_dir = os.path.join(work, "stamped")
    subprocess.run(["cp", "-r", str(_build.CSRC), src_dir], check=True)
    _edit(os.path.join(src_dir, "packed_bwd_bf16.cuh"), NEW)
    cu = os.path.join(src_dir, "attention_packed.cu")
    _edit(cu, OLD)
    with open(cu, "a") as f:
        f.write("\nextern \"C\" int read_stamps(unsigned long long* out, "
                "int n) {\n  return (int)cudaMemcpyFromSymbol(out, "
                "packed_bwd_bf16::g_dbg, n * 8);\n}\n"
                "extern \"C\" int clear_stamps() {\n  void* p;\n"
                "  cudaGetSymbolAddress(&p, packed_bwd_bf16::g_dbg);\n"
                "  return (int)cudaMemset(p, 0, sizeof(packed_bwd_bf16::g_dbg));"
                "\n}\n")
    lib = os.path.join(work, "libstamped.so")
    p = _compile(src_dir, lib)
    out = p.communicate()[0]
    if p.returncode:
        raise RuntimeError(out[-4000:])
    return _load(lib, stamps=True)


def _inputs(g, b, lq, lk):
    q, k, v, do = (torch.randn(b, n, DM, generator=g, device="cuda").to(
        torch.bfloat16) for n in (lq, lk, lk, lq))
    scale = (DM // HEADS) ** -0.5
    out, lse = ap._fwd_cuda(q, k, v, HEADS, scale, True, want_lse=True)
    return q, k, v, out, lse, do, scale


def _report(cl, nblocks, stampers, names, what, items):
    """Each phase's share of the stamping threads' time (``stampers`` a
    block: one a warpgroup, ``bwd_mma_kernel``'s 8 or 16 warps in fours);
    blocks that did not run this launch (a persistent grid is smaller than
    ``nblocks``) hold zeros."""
    buf = np.zeros(nblocks * 4 * SLOTS, dtype=np.uint64)
    if cl.read_stamps(buf.ctypes.data, len(buf)):
        raise RuntimeError("reading the stamps failed")
    x = buf.reshape(nblocks, 4, SLOTS)[:, :stampers].astype(np.int64)
    x = x.reshape(-1, SLOTS)
    x = x[x[:, 14] > 0]
    span = x[:, 14]
    blocks = len(x) // stampers
    per_sm = np.bincount(x[:, 15]) // stampers
    print(f"  {what}: {blocks} blocks for {items} items on "
          f"{np.count_nonzero(per_sm)} SMs ({per_sm.max()} at most on one); "
          f"a stamping thread's time {span.mean() / 1e3:.2f} us on average, "
          f"{span.mean() / 1e3 * blocks / items:.2f} us an item", flush=True)
    shares = x[:, :len(names)].sum(0) / max(1, span.sum())
    for name, share, mean in zip(names, shares, x[:, :len(names)].mean(0)):
        print(f"    {name}: {100 * share:.1f}% ({mean / 1e3:.2f} us)",
              flush=True)


def stamps(work):
    import chip_smoke as cs

    cl = build_stamped(work)
    _build._loaded["attention_packed"] = cl
    g = torch.Generator(device="cuda").manual_seed(5)
    for b, lq, lk in SHAPES:
        q, k, v, out, lse, do, scale = _inputs(g, b, lq, lk)
        print(f"B {b}, Lq {lq}, Lk {lk}, {HEADS} heads:", flush=True)
        for kernel in ("mma", "wgmma"):
            for _ in range(3):
                if cl.clear_stamps():
                    raise RuntimeError("clearing the stamps failed")
                ap._bwd_cuda(q, k, v, out, lse, do, HEADS, scale, True,
                             kernel=kernel)
            torch.cuda.synchronize()
            if kernel == "mma":
                nw = 16 if lk > 128 else 8
                splits = -(-lk // (16 * nw))
                _report(cl, splits * b * HEADS, nw // 4, PHASES_OLD,
                        "bwd_mma_kernel", splits * b * HEADS)
            else:
                _report(cl, b * HEADS, -(-lk // 64), PHASES_NEW,
                        "bwd_wgmma_bf16_kernel", b * HEADS)
    _build._loaded.pop("attention_packed")
    # What a one-row query tail and a one-key tile cost (unstamped build).
    print("Tails at B 128 (ms a launch; mma / wgmma):", flush=True)
    for lq, lk in ((64, 64), (65, 64), (64, 65), (65, 65), (256, 64),
                   (256, 65), (64, 256), (65, 256)):
        q, k, v, out, lse, do, scale = _inputs(g, 128, lq, lk)
        ms = [cs._device_ms(lambda: ap._bwd_cuda(
            q, k, v, out, lse, do, HEADS, scale, True, kernel=kern))
            for kern in ("mma", "wgmma")]
        print(f"  Lq {lq}, Lk {lk}: {ms[0]:.4f} / {ms[1]:.4f}", flush=True)


def variants(work, names):
    import chip_smoke as cs

    names = list(VARIANTS) if names == ["all"] else names
    libs = _build_variants(work, names)
    g = torch.Generator(device="cuda").manual_seed(7)
    step = {name: 0.0 for name in ["mma"] + list(libs)}
    for (b, lq, lk), per in zip(SHAPES, PER_STEP):
        q, k, v, out, lse, do, scale = _inputs(g, b, lq, lk)
        ref = ap.packed_attention_bwd_reference(q, k, v, out, do, HEADS,
                                                scale, bf16=True, lse=lse)
        print(f"B {b}, Lq {lq}, Lk {lk}:", flush=True)
        rows = {}
        for _ in range(2):
            for name in ["mma"] + list(libs):
                _build._loaded["attention_packed"] = (
                    libs["as is"] if name == "mma" else libs[name])
                kern = "mma" if name == "mma" else "wgmma"
                ms = cs._device_ms(lambda: ap._bwd_cuda(
                    q, k, v, out, lse, do, HEADS, scale, True, kernel=kern))
                got = ap._bwd_cuda(q, k, v, out, lse, do, HEADS, scale, True,
                                   kernel=kern)
                share = [(a != w).float().mean().item()
                         for a, w in zip(got, ref)]
                past = sum(int(((a.float() - w.float()).abs()
                                > cs._bf16_step(w)).sum())
                           for a, w in zip(got, ref))
                rows.setdefault(name, []).append((ms, share, past))
        for name, runs in rows.items():
            ms = min(r[0] for r in runs)
            share, past = runs[0][1], runs[0][2]
            step[name] += per * ms
            print(f"  {name}: {ms:.4f} ms; differing dq/dk/dv "
                  f"{'/'.join(f'{100 * x:.3f}%' for x in share)}, {past} "
                  f"past one bf16 step", flush=True)
    _build._loaded.pop("attention_packed", None)
    print("Per arm-B act+learn step (the ViT trunk's rows included): "
          + ", ".join(f"{name} {ms:.4f} ms" for name, ms in step.items()),
          flush=True)


def _build_variants(work, names):
    """{name: loaded library} of ``VARIANTS`` (and "as is"), built in
    parallel."""
    import chip_smoke as cs

    procs = {}
    for name in ["as is"] + names:
        src_dir = os.path.join(work, name.replace(":", "_").replace(" ", "_"))
        subprocess.run(["cp", "-r", str(_build.CSRC), src_dir], check=True)
        if name != "as is":
            _edit(os.path.join(src_dir, "packed_bwd_bf16.cuh"),
                  VARIANTS[name])
        lib = src_dir + ".so"
        procs[name] = (lib, _compile(src_dir, lib))
    libs = {}
    for name, (lib, p) in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{name}: {out[-4000:]}")
        for kname, report in cs._ptxas_report(out):
            if kname.startswith("bwd_wgmma_bf16_kernel<bf16, 32>"):
                print(f"  {name}: {kname} {report}", flush=True)
        libs[name] = _load(lib)
    return libs


def gate(work):
    import chip_smoke as cs

    _build.build()
    libs = _build_variants(work, ["dq1chain", "dkvjoin"])
    bwd = ap._bwd_cuda

    def use(name):
        _build._loaded["attention_packed"] = libs[
            "as is" if name == "mma" else name]
        ap._bwd_cuda = ((lambda *a, **k: bwd(*a, **{**k, "kernel": "mma"}))
                        if name == "mma" else bwd)

    gate_fn = cs._compare_grads_bf16

    def worst(what, net, loss_k, grads_k, loss_p, grads_p):
        floor = max(g.abs().max().item() for g in grads_p
                    if g is not None) / 16
        rows = sorted(
            ((gk - gp).abs().max().item()
             / (2.0 ** -8 * max(gp.abs().max().item(), floor)), pname)
            for (pname, _), gk, gp in zip(net.named_parameters(), grads_k,
                                          grads_p)
            if gk is not None and gp is not None)
        print("      " + ", ".join(f"{n} {x:.2f}" for x, n in rows[-3:]),
              flush=True)
        gate_fn(what, net, loss_k, grads_k, loss_p, grads_p)

    cs.BF16_GRAD_STEPS = float("inf")   # read, not gated
    cs._compare_grads_bf16 = worst
    try:
        for train in ("mma", "as is", "dq1chain", "dkvjoin"):
            use(train)
            print(f"trained with {train}:", flush=True)
            _, _, cfg, state, _ = cs.drive_learn(
                f"arm B, {train}", cs.ARM_B + cs.BF16,
                cs.EXPECTED_BF16_LEARN_B)
            for read in ("as is", "mma"):
                use(read)
                print(f"  read with {read}:", flush=True)
                cs.compare_learn_routes_bf16(cfg, state,
                                             cs.LEARN_ROUTE_BF16_B)
            del state
            torch.cuda.empty_cache()
    finally:
        use("as is")
        cs._compare_grads_bf16 = gate_fn


def main():
    ap_ = argparse.ArgumentParser()
    ap_.add_argument("--variants", nargs="*", default=None)
    ap_.add_argument("--gate", action="store_true")
    args = ap_.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as work:
        if args.gate:
            gate(work)
        elif args.variants is None:
            stamps(work)
        else:
            variants(work, args.variants or ["all"])


if __name__ == "__main__":
    main()
