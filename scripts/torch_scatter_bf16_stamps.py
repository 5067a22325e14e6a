"""Where a block of the bf16 pillar scatter kernels spends its time, on the
card, and what variants of the new kernels cost.

Stamps (no arguments): builds a copy of ``multimodal_sc_torch/csrc`` whose
``pillar_scatter.cu`` (the f32 kernels' ``<bf16, 4>`` instances, which
bf16 features ran before ``csrc/scatter_bf16.cuh``) and ``scatter_bf16.cuh``
(``scatter_max_bf16_kernel``, ``scatter_max_bwd_bf16_kernel``) add
``%globaltimer`` stamps: thread 0 of each block adds the time since its
last stamp to the phase it has just finished, in shared memory, and writes
the sums, its start, its span and its SM to a device array at its end.
Runs each design's forward at c4's act shape (B 1024, N 64, 256 cells) and
backward at c3's (B 64, N 1024, 1024 cells), D 64, on the chip_smoke.py
inputs (a real observation voxelized, forced ties in the backward), and
prints each phase's share of a block's time (thread 0's view: a phase ends
at the barrier after it), the blocks, their SMs, a block's mean span and
the kernel's (first start to last end). The old forward's phases: the
sentinel fill; the cell and feature loads and the atomics; the stores. The
old backward's: the zero fill; pass 1; pass 2. The new forward's: the
cells landing (barrier A); the lists linked and the features landing
(barrier B); the walks and stores. The new backward's: the cells landing,
the counts zeroed (barrier A); the copies of `g` issued, the first
gathers of `out`, the features landing (barrier B); the rest of pass 1
(hits, tie counts); `g` landing (barrier C); pass 2 (shares, stores).
Then, unstamped, both designs' times at every timed shape of
``chip_smoke.py`` (c4 act, c4 learn, c3-cnn, c5 loss, fog + V2X ego and
RSU forward; c3-cnn, c4 learn and c5 loss backward), and the write floor:
a kernel that only stores zeros over the same output span (grid-stride,
16-byte stores, at several grid sizes) and ``Tensor.zero_``.

Variants (``--variants NAME ...``, or ``--variants all``): builds copies of
``csrc`` with text substitutions in ``scatter_bf16.cuh`` (or sets
``kernels/pillar_scatter.py``'s plan), one ``nvcc`` each in parallel, and
times each beside the kernels as they are and the old instances in turns
at the same shapes, checked bit for bit against the plain versions.
"probe:" variants drop work and are not checked.

A/B (``--against HEADER``): builds ``csrc`` as it is and with
``scatter_bf16.cuh`` replaced by HEADER (another version of the kernels,
the same C entries), and times the two in turns (A B B A A B) at the same
shapes, each checked bit for bit against the plain versions.

Needs a card and ``nvcc``; imports no JAX. Raises if an anchor it
substitutes is gone from the source: edit it with the kernels.

    python3 scripts/torch_scatter_bf16_stamps.py [--variants NAME ... | --against HEADER]
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
from multimodal_sc_torch.kernels import pillar_scatter as ps  # noqa: E402

SLOTS = 16        # a block's entries: its phases, start, span, SM
MAX_BLOCKS = 8192
PHASES_OLD_FWD = ("sentinel fill, barrier", "cell and feature loads, "
                  "atomics, barrier", "stores")
PHASES_OLD_BWD = ("zero fill, barrier", "pass 1 (cell, features, out; "
                  "count atomics), barrier", "pass 2 (cell, features, out, "
                  "g; stores)")
PHASES_NEW_FWD = ("cells landed, heads reset, barrier A",
                  "lists linked, features landed, barrier B",
                  "walks and stores")
PHASES_NEW_BWD = ("cells landed, counts zeroed, barrier A",
                  "copies of g issued, first gathers of out, features "
                  "landed, barrier B", "pass 1 (hits, tie counts)",
                  "g landed, barrier C", "pass 2 (shares, stores)")

STAMP_LIB = (
    "__device__ unsigned long long g_dbg[%d];\n"
    "__shared__ unsigned long long st_acc[16];\n"
    "__shared__ unsigned long long st_prev;\n"
    "__device__ __forceinline__ unsigned long long gtime() {\n"
    "  unsigned long long t;\n"
    "  asm volatile(\"mov.u64 %%0, %%globaltimer;\" : \"=l\"(t));\n"
    "  return t;\n}\n"
    "__device__ __forceinline__ void st_init() {\n"
    "  if (threadIdx.x == 0) {\n"
    "    for (int i = 0; i < 16; ++i) st_acc[i] = 0;\n"
    "    st_prev = st_acc[13] = gtime();\n  }\n}\n"
    "__device__ __forceinline__ void st(int k) {\n"
    "  if (threadIdx.x == 0) {\n"
    "    const unsigned long long t = gtime();\n"
    "    st_acc[k] += t - st_prev;\n    st_prev = t;\n  }\n}\n"
    "__device__ __forceinline__ void st_write() {\n"
    "  if (threadIdx.x == 0) {\n"
    "    unsigned long long* o = g_dbg + (size_t)blockIdx.x * 16;\n"
    "    for (int i = 0; i < 13; ++i) o[i] = st_acc[i];\n"
    "    o[13] = st_acc[13];\n    o[14] = gtime() - st_acc[13];\n"
    "    unsigned sm; asm(\"mov.u32 %%0, %%smid;\" : \"=r\"(sm)); o[15] = sm;\n"
    "  }\n}\n") % (MAX_BLOCKS * SLOTS)

NEW = [   # scatter_bf16.cuh
    ("  __syncthreads();  // the cells landed; the heads are at -1\n",
     "  __syncthreads();  // the cells landed; the heads are at -1\n"
     "  st(0);\n"),
    ("  __syncthreads();  // the lists are linked; the features landed\n",
     "  __syncthreads();  // the lists are linked; the features landed\n"
     "  st(1);\n"),
    ("    *reinterpret_cast<uint4*>(ob + (int64_t)c * dim) = acc;\n"
     "  }\n}\n",
     "    *reinterpret_cast<uint4*>(ob + (int64_t)c * dim) = acc;\n"
     "  }\n  st(2);\n  st_write();\n}\n"),
    ("  __syncthreads();  // the cells landed; the counts are 0\n",
     "  __syncthreads();  // the cells landed; the counts are 0\n  st(0);\n"),
    ("      __syncthreads();  // the features landed\n",
     "      __syncthreads();  // the features landed\n      st(1);\n"),
    ("  cp_async_wait<0>();\n  __syncthreads();  // every tie is counted; `g` "
     "landed\n",
     "  st(2);\n  cp_async_wait<0>();\n  __syncthreads();  // every tie is "
     "counted; `g` landed\n  st(3);\n"),
    ("        make_uint4(r[0], r[1], r[2], r[3]);\n  }\n}\n",
     "        make_uint4(r[0], r[1], r[2], r[3]);\n  }\n  st(4);\n"
     "  st_write();\n}\n"),
]
NEW_INIT = ("  const Item<T> it(dim, width, n_slices);\n",
            "  st_init();\n  const Item<T> it(dim, width, n_slices);\n")
# The stamp helpers go before every kernel (pillar_scatter.cu's old ones
# include this header first).
NEW_HELPERS_AT = "__device__ __forceinline__ uint32_t smem_addr("

OLD = [   # pillar_scatter.cu, scatter_max_kernel / scatter_max_bwd_kernel
    ("  const Slot s = slot<VEC>(dim, width, n_slices);\n"
     "  const int size = num_cells * width;\n"
     "  for (int i = threadIdx.x; i < size; i += blockDim.x) grid[i] = kNeg;\n"
     "  __syncthreads();\n",
     "  scatter_bf16::st_init();\n"
     "  const Slot s = slot<VEC>(dim, width, n_slices);\n"
     "  const int size = num_cells * width;\n"
     "  for (int i = threadIdx.x; i < size; i += blockDim.x) grid[i] = kNeg;\n"
     "  __syncthreads();\n  scatter_bf16::st(0);\n"),
    ("      for (int k = 0; k < VEC; ++k) smem_max(dst + k, v[k]);\n"
     "    }\n  }\n  __syncthreads();\n",
     "      for (int k = 0; k < VEC; ++k) smem_max(dst + k, v[k]);\n"
     "    }\n  }\n  __syncthreads();\n  scatter_bf16::st(1);\n"),
    ("    R::store(ob + (int64_t)c * dim + ff, v);\n  }\n}\n",
     "    R::store(ob + (int64_t)c * dim + ff, v);\n  }\n"
     "  scatter_bf16::st(2);\n  scatter_bf16::st_write();\n}\n"),
    ("  const Slot s = slot<VEC>(dim, width, n_slices);\n"
     "  const int size = num_cells * width;\n"
     "  for (int i = threadIdx.x; i < size; i += blockDim.x) count[i] = 0;\n"
     "  __syncthreads();\n",
     "  scatter_bf16::st_init();\n"
     "  const Slot s = slot<VEC>(dim, width, n_slices);\n"
     "  const int size = num_cells * width;\n"
     "  for (int i = threadIdx.x; i < size; i += blockDim.x) count[i] = 0;\n"
     "  __syncthreads();\n  scatter_bf16::st(0);\n"),
    ("        if (v[k] == m[k]) atomicAdd(dst + k, 1);\n    }\n  }\n"
     "  __syncthreads();\n",
     "        if (v[k] == m[k]) atomicAdd(dst + k, 1);\n    }\n  }\n"
     "  __syncthreads();\n  scatter_bf16::st(1);\n"),
    ("      R::store(gf + env + (int64_t)p * dim, r);\n    }\n  }\n}\n",
     "      R::store(gf + env + (int64_t)p * dim, r);\n    }\n  }\n"
     "  scatter_bf16::st(2);\n  scatter_bf16::st_write();\n}\n"),
]
EXTRA = """
__global__ void store_floor_kernel(uint4* out, long long n16) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n16; i += (long long)gridDim.x * blockDim.x)
    out[i] = make_uint4(0u, 0u, 0u, 0u);
}
extern "C" int store_floor(void* out, long long n16, int blocks,
                           cudaStream_t stream) {
  store_floor_kernel<<<blocks, 256, 0, stream>>>((uint4*)out, n16);
  return (int)cudaGetLastError();
}
extern "C" int read_stamps(unsigned long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, scatter_bf16::g_dbg, n * 8);
}
extern "C" int clear_stamps() {
  void* p;
  cudaGetSymbolAddress(&p, scatter_bf16::g_dbg);
  return (int)cudaMemset(p, 0, sizeof(scatter_bf16::g_dbg));
}
"""

# Variants of scatter_bf16.cuh: name -> (text substitutions, settings of
# kernels/pillar_scatter.py while it is timed).
VARIANTS = {
    # The backward's pieces whose gathers of `out` fly together: 1 or 8 (4
    # as is).
    "batch1": ([("constexpr int kBatch = 4;", "constexpr int kBatch = 1;")],
               {}),
    "batch8": ([("constexpr int kBatch = 4;", "constexpr int kBatch = 8;")],
               {}),
    # Blocks of 256 threads always, or of 512 wherever a block has 1024
    # pieces or more.
    "t256": ([], {"BF16_FEW_BLOCKS": 0}),
    "t512": ([], {"BF16_FEW_BLOCKS": 1 << 30}),
    # The cells and features waited for together before the lists.
    "onewait": ([("  cp_async_wait<1>();\n  __syncthreads();  // the cells "
                  "landed; the heads are at -1\n",
                  "  cp_async_wait<0>();\n  __syncthreads();  // the cells "
                  "landed; the heads are at -1\n")], {}),
    # The cells copied 16 bytes at a time where N % 4 == 0 and they are
    # aligned.
    "cells16": ([("  for (int i = threadIdx.x; i < n; i += T) cp_async4(cs + i, "
                  "cb + i);\n",
                  "  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(cb) & 15)"
                  " == 0) {\n"
                  "    for (int i = 4 * threadIdx.x; i < n; i += 4 * T)\n"
                  "      cp_async16(cs + i, cb + i);\n"
                  "  } else {\n"
                  "    for (int i = threadIdx.x; i < n; i += T) cp_async4(cs + "
                  "i, cb + i);\n  }\n")], {}),
    # `g` copied through L1 (cp.async.ca), where points of a cell repeat it.
    "gca": ([("      cp_async16(gs + p * wp + it.l, gl + (int64_t)c * dim);\n",
              "      asm volatile(\"cp.async.ca.shared.global [%0], [%1], 16;\\n\" "
              "::\"r\"(smem_addr(gs + p * wp + it.l)), \"l\"(gl + (int64_t)c "
              "* dim) : \"memory\");\n")], {}),
    # 1024-thread blocks where 512 are planned.
    "t1024": ([("static size_t granted[2][2];   // [backward][512 threads]",
                "static size_t granted[2][3];"),
               ("&granted[0][T == 512]", "&granted[0][T / 512]"),
               ("&granted[1][T == 512]", "&granted[1][T / 512]"),
               ("  return (threads == 512 ? launch_fwd_t<512> : "
                "launch_fwd_t<256>)(",
                "  return (threads == 1024 ? launch_fwd_t<1024> : threads == "
                "512 ? launch_fwd_t<512> : launch_fwd_t<256>)("),
               ("  return (threads == 512 ? launch_bwd_t<512> : "
                "launch_bwd_t<256>)(",
                "  return (threads == 1024 ? launch_bwd_t<1024> : threads == "
                "512 ? launch_bwd_t<512> : launch_bwd_t<256>)(")],
              {"bf16_threads": lambda *a, **k: (
                  1024 if _BF16_THREADS(*a, **k) == 512 else 256)}),
    # The reciprocal by the IEEE division 1.0f / n (the same bits).
    "div": ([("g * __frcp_rn((float)n)", "g * (1.0f / (float)n)")], {}),
    # Probes (wrong results): the forward without its walks or without its
    # empty cells' stores; no feature copies; the backward without its
    # atomics, its copies of `g` or its shares (a hit's piece is g).
    "probe:nowalk": ([("    if (p >= 0) {\n      acc = key8",
                       "    if (false) {\n      acc = key8")], {}),
    "probe:nozeros": ([("    *reinterpret_cast<uint4*>(ob + (int64_t)c * dim) "
                        "= acc;\n",
                        "    if (heads[c] >= 0)\n      *reinterpret_cast"
                        "<uint4*>(ob + (int64_t)c * dim) = acc;\n")], {}),
    "probe:nocopy": ([("    cp_async16(fs + p * wp + it.l, fb + (int64_t)p * "
                       "dim);\n", "")], {}),
    "probe:noatomics": ([("        if (inc) atomicAdd(cw + i, inc);\n", "")],
                        {}),
    "probe:nog": ([("      cp_async16(gs + p * wp + it.l, gl + (int64_t)c * "
                    "dim);\n", "      ;\n")], {}),
    "probe:noshares": ([("          r[i] = share_bits(gv[2 * i], nw[i] & "
                         "0xffffu);", "          r[i] = __float_as_uint(gv[2 "
                         "* i]) >> 16;")], {}),
}


_BF16_THREADS = ps.bf16_threads


def _edit(path, edits, count=1):
    src = open(path).read()
    for old, new in edits:
        if src.count(old) != count:
            raise ValueError(f"anchor not found {count}x in {path}: {old!r}")
        src = src.replace(old, new)
    open(path, "w").write(src)


def _compile(src_dir, lib):
    cu = os.path.join(src_dir, "pillar_scatter.cu")
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                             cu], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _load(lib, stamps=False):
    cl = ctypes.CDLL(lib)
    for fn, argtypes in ps._SIG.items():
        f = getattr(cl, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    if stamps:
        cl.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        cl.clear_stamps.argtypes = []
        cl.store_floor.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                   ctypes.c_int, ctypes.c_void_p]
        for f in (cl.read_stamps, cl.clear_stamps, cl.store_floor):
            f.restype = ctypes.c_int
    return cl


def stamp_sources(src_dir):
    """Adds the stamps to the copy of ``csrc`` in ``src_dir``."""
    hdr = os.path.join(src_dir, "scatter_bf16.cuh")
    _edit(hdr, NEW + [(NEW_HELPERS_AT, STAMP_LIB + NEW_HELPERS_AT)])
    _edit(hdr, [NEW_INIT], count=2)
    cu = os.path.join(src_dir, "pillar_scatter.cu")
    _edit(cu, OLD)
    with open(cu, "a") as f:
        f.write(EXTRA)


def build_stamped(work):
    """The stamped library; raises if a source no longer has an anchor."""
    src_dir = os.path.join(work, "stamped")
    subprocess.run(["cp", "-r", str(_build.CSRC), src_dir], check=True)
    stamp_sources(src_dir)
    lib = os.path.join(work, "libstamped.so")
    p = _compile(src_dir, lib)
    out = p.communicate()[0]
    if p.returncode:
        raise RuntimeError(out[-4000:])
    return _load(lib, stamps=True)


def _report(cl, names, what, items):
    buf = np.zeros(MAX_BLOCKS * SLOTS, dtype=np.uint64)
    if cl.read_stamps(buf.ctypes.data, len(buf)):
        raise RuntimeError("reading the stamps failed")
    x = buf.reshape(MAX_BLOCKS, SLOTS).astype(np.int64)
    x = x[x[:, 14] > 0]
    span = x[:, 14]
    start, end = x[:, 13], x[:, 13] + span
    per_sm = np.bincount(x[:, 15])
    print(f"  {what}: {len(x)} blocks for {items} items on "
          f"{np.count_nonzero(per_sm)} SMs ({per_sm.max()} at most on one); "
          f"a block's span {span.mean() / 1e3:.2f} us on average (max "
          f"{span.max() / 1e3:.2f}), the kernel's {(end.max() - start.min()) / 1e3:.2f}"
          f" us, blocks starting over {(start.max() - start.min()) / 1e3:.2f} us",
          flush=True)
    shares = x[:, :len(names)].sum(0) / max(1, span.sum())
    for name, share, mean in zip(names, shares, x[:, :len(names)].mean(0)):
        print(f"    {name}: {100 * share:.1f}% ({mean / 1e3:.2f} us a block)",
              flush=True)


def _inputs():
    """chip_smoke.py's bf16 inputs: c4's act shape and c3's, the backward's
    with forced ties and its cotangent."""
    import chip_smoke as cs

    bf = torch.bfloat16
    c4 = cs._pillar_inputs()
    c4 = (c4[0].to(bf), c4[1], c4[2])
    c3 = cs._c3_pillar_inputs()
    c3 = (c3[0].to(bf), c3[1], c3[2])
    ego, rsu = ((f.to(bf), c, n) for f, c, n in cs._v2x_pillar_inputs())
    return c4, c3, ego, rsu


def _bwd_inputs(feats, cell, cells):
    import chip_smoke as cs

    feats, cell = cs._force_ties(feats, cell)
    g = torch.Generator(device="cuda").manual_seed(6)
    gy = torch.randn(feats.shape[0], cells, feats.shape[2], generator=g,
                     device="cuda").to(feats.dtype)
    out = ps.scatter_max_reference(feats, cell, cells)
    return feats, cell, out, gy


def _shapes():
    import chip_smoke as cs

    c4, c3, ego, rsu = _inputs()

    def first(n):
        return c4[0][:n], c4[1][:n], c4[2]

    fwd = {"c4 act": c4, "c4 learn": first(cs.LEARN_BATCH), "c3-cnn": c3,
           "c5 loss": first(cs.C5_LOSS_BATCH), "fog+V2X ego": ego,
           "fog+V2X RSU": rsu}
    bwd = {name: (*_bwd_inputs(*fwd[name]), fwd[name][2])
           for name in ("c3-cnn", "c4 learn", "c5 loss")}
    return fwd, bwd


def stamps(work):
    import chip_smoke as cs

    fwd, bwd = _shapes()
    cl = build_stamped(work)
    _build._loaded["pillar_scatter"] = cl
    feats, cell, cells = fwd["c4 act"]
    b, n, d = feats.shape
    print(f"forward, c4 act (B {b}, N {n}, D {d}, {cells} cells):",
          flush=True)
    for kernel in ("atomics", "lists"):
        for _ in range(3):
            if cl.clear_stamps():
                raise RuntimeError("clearing the stamps failed")
            ps._scatter_max_cuda(feats, cell, cells, kernel=kernel)
        torch.cuda.synchronize()
        if kernel == "atomics":
            w, _ = ps.slice_plan(b, d, cells)
            _report(cl, PHASES_OLD_FWD, "scatter_max_kernel<bf16, 4>",
                    b * -(-d // w))
        else:
            w = ps.bf16_plan(b, n, d, cells)
            _report(cl, PHASES_NEW_FWD, "scatter_max_bf16_kernel",
                    b * -(-d // w))
    feats, cell, out, gy, cells = bwd["c3-cnn"]
    b, n, d = feats.shape
    print(f"backward, c3-cnn (B {b}, N {n}, D {d}, {cells} cells):",
          flush=True)
    for kernel in ("atomics", "lists"):
        for _ in range(3):
            if cl.clear_stamps():
                raise RuntimeError("clearing the stamps failed")
            ps._scatter_max_bwd_cuda(feats, cell, out, gy, cells,
                                     kernel=kernel)
        torch.cuda.synchronize()
        if kernel == "atomics":
            w, _ = ps.slice_plan(b, d, cells)
            _report(cl, PHASES_OLD_BWD, "scatter_max_bwd_kernel<bf16, 4>",
                    b * -(-d // w))
        else:
            w = ps.bf16_plan(b, n, d, cells, bwd=True)
            _report(cl, PHASES_NEW_BWD, "scatter_max_bwd_bf16_kernel",
                    b * -(-d // w))
    # The write floor: zeros over each output span, 16-byte stores.
    stream = _build.stream_ptr(torch.device("cuda"))
    for what, shape in (("c4 act output", (1024, 256, 64)),
                        ("c3 gradient", (64, 1024, 64))):
        buf = torch.empty(shape, dtype=torch.bfloat16, device="cuda")
        n16 = buf.numel() // 8
        times = []
        for blocks in (132 * 4, 132 * 8, 132 * 16, -(-n16 // 256)):
            ms = cs._device_ms(lambda: cl.store_floor(
                ctypes.c_void_p(buf.data_ptr()), n16, blocks, stream),
                iters=50)
            times.append(f"{blocks} blocks {ms:.4f}")
        zero = cs._device_ms(lambda: buf.zero_(), iters=50)
        print(f"  write floor, {what} ({buf.numel() * 2 / 1e6:.1f} MB): "
              f"store-only kernel {', '.join(times)} ms; zero_ {zero:.4f} ms",
              flush=True)
    _build._loaded.pop("pillar_scatter")
    print("unstamped, ms a launch (old instance / new kernel):", flush=True)
    _build.build(["pillar_scatter"])
    for name, (feats, cell, cells) in fwd.items():
        ms = [cs._device_ms(lambda: ps._scatter_max_cuda(
            feats, cell, cells, kernel=k), iters=50)
            for k in ("atomics", "lists")]
        print(f"  forward {name}: {ms[0]:.4f} / {ms[1]:.4f}", flush=True)
    for name, (feats, cell, out, gy, cells) in bwd.items():
        ms = [cs._device_ms(lambda: ps._scatter_max_bwd_cuda(
            feats, cell, out, gy, cells, kernel=k), iters=50)
            for k in ("atomics", "lists")]
        print(f"  backward {name}: {ms[0]:.4f} / {ms[1]:.4f}", flush=True)


def _build_variants(work, names):
    """{name: loaded library} of ``VARIANTS`` (and "as is"), built in
    parallel."""
    import chip_smoke as cs

    procs = {}
    for name in ["as is"] + names:
        src_dir = os.path.join(work, name.replace(":", "_").replace(" ", "_"))
        subprocess.run(["cp", "-r", str(_build.CSRC), src_dir], check=True)
        if name != "as is":
            _edit(os.path.join(src_dir, "scatter_bf16.cuh"),
                  VARIANTS[name][0])
        lib = src_dir + ".so"
        procs[name] = (lib, _compile(src_dir, lib))
    libs = {}
    for name, (lib, p) in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{name}: {out[-4000:]}")
        for kname, report in cs._ptxas_report(out):
            if "bf16_kernel" in kname:
                print(f"  {name}: {kname} {report}", flush=True)
        libs[name] = _load(lib)
    return libs


def variants(work, names):
    import chip_smoke as cs

    names = list(VARIANTS) if names == ["all"] else names
    libs = _build_variants(work, names)
    fwd, bwd = _shapes()
    saved = {k: getattr(ps, k) for _, sets in VARIANTS.values() for k in sets}

    def use(name):
        _build._loaded["pillar_scatter"] = libs[
            "as is" if name == "old" else name]
        for k, v in saved.items():
            setattr(ps, k, v)
        for k, v in (VARIANTS[name][1] if name in VARIANTS else {}).items():
            setattr(ps, k, v)

    cases = [("forward " + k, v, False) for k, v in fwd.items()] + [
        ("backward " + k, v, True) for k, v in bwd.items()]
    try:
        for what, args, is_bwd in cases:
            rows = {}
            for _ in range(2):
                for name in ["old"] + list(libs):
                    use(name)
                    kern = "atomics" if name == "old" else "lists"
                    if is_bwd:
                        feats, cell, out, gy, cells = args
                        fn = (lambda: ps._scatter_max_bwd_cuda(
                            feats, cell, out, gy, cells, kernel=kern))
                        ref = ps.scatter_max_backward_reference(
                            feats, cell, out, gy, cells)
                    else:
                        feats, cell, cells = args
                        fn = (lambda: ps._scatter_max_cuda(
                            feats, cell, cells, kernel=kern))
                        ref = ps.scatter_max_reference(feats, cell, cells)
                    ms = cs._device_ms(fn, iters=50)
                    same = bool(torch.equal(fn(), ref))
                    if not same and not name.startswith("probe:"):
                        raise AssertionError(f"{name} differs from the plain "
                                             f"version at {what}")
                    rows.setdefault(name, []).append(ms)
            print(f"{what}: " + ", ".join(
                f"{name} {min(ms):.4f}" for name, ms in rows.items())
                + " ms", flush=True)
    finally:
        use("as is")
        _build._loaded.pop("pillar_scatter", None)


def against(work, header):
    """Times ``csrc`` as it is (A) and with ``scatter_bf16.cuh`` replaced by
    ``header`` (B) in turns."""
    import chip_smoke as cs

    procs, libs = {}, {}
    for name in ("A", "B"):
        src_dir = os.path.join(work, name)
        subprocess.run(["cp", "-r", str(_build.CSRC), src_dir], check=True)
        if name == "B":
            subprocess.run(["cp", header, os.path.join(src_dir,
                                                       "scatter_bf16.cuh")],
                           check=True)
        procs[name] = (src_dir + ".so", _compile(src_dir, src_dir + ".so"))
    for name, (lib, p) in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{name}: {out[-4000:]}")
        libs[name] = _load(lib)
    fwd, bwd = _shapes()
    cases = [("forward " + k, v, False) for k, v in fwd.items()] + [
        ("backward " + k, v, True) for k, v in bwd.items()]
    try:
        for what, args, is_bwd in cases:
            times = {"A": [], "B": []}
            for name in ("A", "B", "B", "A", "A", "B"):
                _build._loaded["pillar_scatter"] = libs[name]
                if is_bwd:
                    feats, cell, out, gy, cells = args
                    fn = (lambda: ps._scatter_max_bwd_cuda(feats, cell, out,
                                                           gy, cells))
                    ref = ps.scatter_max_backward_reference(feats, cell, out,
                                                            gy, cells)
                else:
                    feats, cell, cells = args
                    fn = lambda: ps._scatter_max_cuda(feats, cell, cells)
                    ref = ps.scatter_max_reference(feats, cell, cells)
                if not torch.equal(fn(), ref):
                    raise AssertionError(f"{name} differs from the plain "
                                         f"version at {what}")
                times[name].append(cs._device_ms(fn, iters=50))
            print(f"{what}: " + ", ".join(
                f"{name} {min(t):.4f} ({', '.join(f'{x:.4f}' for x in t)})"
                for name, t in times.items()) + " ms", flush=True)
    finally:
        _build._loaded.pop("pillar_scatter", None)


def main():
    ap_ = argparse.ArgumentParser()
    ap_.add_argument("--variants", nargs="*", default=None)
    ap_.add_argument("--against", metavar="HEADER")
    args = ap_.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as work:
        if args.against:
            against(work, os.path.abspath(args.against))
        elif args.variants is None:
            stamps(work)
        else:
            variants(work, args.variants or ["all"])


if __name__ == "__main__":
    main()
