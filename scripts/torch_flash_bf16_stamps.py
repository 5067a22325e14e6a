"""Where a block of the bf16 flash forward spends its time, on the card.

Builds a copy of ``multimodal_sc_torch/csrc`` whose ``flash_bf16.cuh``
stamps ``%globaltimer`` into a device array at each phase of a block (its
start; its q scale split into shared memory; per key tile, past the
barrier, past S and the softmax, past P V; its end) with the block's SM,
runs the forward at the c3 arm-F shape (B 64, H 3, L 256, D 64: 768 blocks)
and at B 16 (192 blocks, one wave), and prints each phase's mean and 90th
percentile over the blocks, the span and the blocks an SM. The stamps cost
a few instructions a phase; time the kernels with
``scripts/torch_flash_bf16_variants.py`` or ``chip_smoke.py``. Needs a
card and ``nvcc``; imports no JAX:

    python3 scripts/torch_flash_bf16_stamps.py
"""
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from multimodal_sc_torch.kernels import _build  # noqa: E402
from multimodal_sc_torch.kernels import attention as fa  # noqa: E402

SLOTS = 16
STAMP = "if (tid == 0) g_dbg[blockIdx.x * 16 + ({})] = gtime();\n"
EDITS = [
    ("namespace flash_bf16 {\n", "namespace flash_bf16 {\n"
     "__device__ unsigned long long g_dbg[1 << 20];\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"),
    ("  const int ntiles = (Lk + TK - 1) / TK;\n",
     "  const int ntiles = (Lk + TK - 1) / TK;\n  " + STAMP.format(0) +
     "  if (tid == 0) { unsigned sm; asm(\"mov.u32 %0, %smid;\" : \"=r\"(sm));"
     " g_dbg[blockIdx.x * 16 + 15] = sm; }\n"),
    ("               row0, Lq, D);\n\n  // Accumulator element",
     "               row0, Lq, D);\n  " + STAMP.format(1) +
     "\n  // Accumulator element"),
    ("    __syncthreads();\n\n    // S = (q scale)",
     "    __syncthreads();\n    if (j < 4) " + STAMP.format("2 + 3 * j") +
     "\n    // S = (q scale)"),
    ("    for (int i = 0; i < DT / 2; ++i) o[i] *= alpha[(i >> 1) & 1];\n",
     "    if (j < 4) " + STAMP.format("3 + 3 * j") +
     "    for (int i = 0; i < DT / 2; ++i) o[i] *= alpha[(i >> 1) & 1];\n"),
    ("    acc_by_tile<PK, DT>(o, s, vt(st));\n  }\n",
     "    acc_by_tile<PK, DT>(o, s, vt(st));\n    if (j < 4) " +
     STAMP.format("4 + 3 * j") + "  }\n"),
    ("lse[(int64_t)bh * Lq + row] = m[r] + logf(lc);\n  }\n}\n",
     "lse[(int64_t)bh * Lq + row] = m[r] + logf(lc);\n  }\n  " +
     STAMP.format(14) + "}\n"),
]
PHASES = ["q scale split"] + [
    f"tile {j}: {w}" for j in range(4)
    for w in ("barrier", "S and softmax", "P V")] + ["stores"]


def build(work):
    """The stamped library; raises if the source no longer has an anchor."""
    src_dir = os.path.join(work, "csrc")
    subprocess.run(["cp", "-r", str(_build.CSRC), src_dir], check=True)
    path = os.path.join(src_dir, "flash_bf16.cuh")
    src = open(path).read()
    for old, new in EDITS:
        if src.count(old) != 1:
            raise ValueError(f"anchor not found once: {old!r}")
        src = src.replace(old, new)
    open(path, "w").write(src)
    cu = os.path.join(src_dir, "flash_attention.cu")
    with open(cu, "a") as f:
        f.write("\nextern \"C\" int read_stamps(unsigned long long* out, "
                "int n) {\n  return (int)cudaMemcpyFromSymbol(out, "
                "flash_bf16::g_dbg, n * 8);\n}\n")
    lib = os.path.join(work, "libflash_attention.so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, cu],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError((r.stdout + r.stderr)[-4000:])
    cl = ctypes.CDLL(lib)
    for fn, argtypes in fa._SIG.items():
        f = getattr(cl, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    cl.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    cl.read_stamps.restype = ctypes.c_int
    return cl


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as work:
        cl = build(work)
        _build._loaded["flash_attention"] = cl
        g = torch.Generator(device="cuda").manual_seed(5)
        for b in (64, 16):
            q, k, v = (torch.randn(b, 256, 3, 64, generator=g,
                                   device="cuda").to(torch.bfloat16)
                       .transpose(1, 2) for _ in range(3))
            for _ in range(3):
                fa._fwd_cuda(q, k, v, 0.125)
            torch.cuda.synchronize()
            nb = b * 3 * 4
            buf = np.zeros(nb * SLOTS, dtype=np.uint64)
            if cl.read_stamps(buf.ctypes.data, nb * SLOTS):
                raise RuntimeError("reading the stamps failed")
            x = buf.reshape(nb, SLOTS).astype(np.int64)
            t0 = x[:, 0].min()
            per_sm = np.bincount(x[:, 15])
            print(f"B {b}: {nb} blocks on {np.count_nonzero(per_sm)} SMs "
                  f"({per_sm.max()} at most on one); span "
                  f"{(x[:, 14].max() - t0) / 1e3:.2f} us, a block "
                  f"{np.mean(x[:, 14] - x[:, 0]) / 1e3:.2f} us on average",
                  flush=True)
            for i, name in enumerate(PHASES, start=1):
                dt = (x[:, i] - x[:, i - 1]) / 1e3
                print(f"  {name}: {dt.mean():.3f} us mean, "
                      f"{np.percentile(dt, 90):.3f} p90", flush=True)
        _build._loaded.pop("flash_attention")


if __name__ == "__main__":
    main()
