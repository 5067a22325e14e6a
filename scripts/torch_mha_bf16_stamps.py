"""Where a block of ``mha_block``'s bf16-I/O kernels spends its time, on the
card.

Builds a copy of ``multimodal_sc_torch/csrc`` whose ``mha_block.cu``
(``mha_mma_kernel``) and ``mha_bf16.cuh`` (``mha_wgmma_bf16_kernel``) add
``%globaltimer`` stamps: one thread of a warpgroup (of ``mha_mma_kernel``'s
16 warps, thread 0) adds the time since its last stamp to the phase it has
just finished, in shared memory, and writes the sums and the SM to a device
array at its end. Runs both kernels on bf16 activations at c4's four act
shapes (B 1024, 4 heads) and c5's (B 32), and prints each phase's share of
a block's time (mean over the stamping threads), a block's mean time, the
span and the blocks an SM. The phases: the first copies (the new kernel's
weights and rows), LN of x_kv, the K and V projections, the switch to Wq
and Wo, LN of x_q (with the wait for its rows), the Q projection, S with
the row max and sum (the old kernel's pass 1), P with P V (pass 2 with P
V), the output projection with the stores. The stamps cost a few
instructions a phase; time the kernels with ``chip_smoke.py``. Needs a card
and ``nvcc``; imports no JAX:

    python3 scripts/torch_mha_bf16_stamps.py
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
from multimodal_sc_torch.kernels import mha_block as mb  # noqa: E402

SLOTS = 16        # a stamping thread's entries: 11 phases, its span, its SM
PHASES = ("first copies", "LN x_kv", "K, V projections", "Wq, Wo switch",
          "LN x_q", "Q projection", "S (the old kernel: S, max, sum)",
          "P, P V (the old kernel: S, P, P V)", "output projection",
          "row max, sum", "head outputs stored")
HEADER = (
    "namespace mha_bf16 {\n"
    "__device__ unsigned long long g_dbg[1 << 17];\n"
    "__device__ __forceinline__ unsigned long long gtime() {\n"
    "  unsigned long long t;\n"
    "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
    "  return t;\n}\n")
# Per stamping thread (thread 0 of each 128): the sums in shared memory.
INIT = (
    "  __shared__ unsigned long long _sacc[4][11];\n"
    "  const unsigned long long _t0 = mha_bf16::gtime();\n"
    "  unsigned long long _tp = _t0;\n"
    "  if ((threadIdx.x & 127) == 0)\n"
    "    for (int _i = 0; _i < 11; ++_i) _sacc[threadIdx.x >> 7][_i] = 0;\n")
STAMP = ("if ((threadIdx.x & 127) == 0) {{ const unsigned long long _t = "
         "mha_bf16::gtime(); _sacc[threadIdx.x >> 7][{}] += _t - _tp; "
         "_tp = _t; }}\n")
WRITE = (
    "  if ((threadIdx.x & 127) == 0) {\n"
    "    unsigned long long* _o = mha_bf16::g_dbg + (blockIdx.x * 4 + "
    "(threadIdx.x >> 7)) * 16;\n"
    "    for (int _i = 0; _i < 11; ++_i) _o[_i] = _sacc[threadIdx.x >> 7][_i];\n"
    "    _o[14] = mha_bf16::gtime() - _t0;\n"
    "    unsigned _sm; asm(\"mov.u32 %0, %smid;\" : \"=r\"(_sm)); _o[15] = _sm;\n"
    "  }\n")


def _s(k):
    return STAMP.format(k)


OLD = [   # mha_block.cu, mha_mma_kernel (16 warps: thread 0 stamps)
    ("  if (resident) fetch_rows(xkvb, min(RB, Lk), esz, Rs);\n",
     INIT + "  if (resident) fetch_rows(xkvb, min(RB, Lk), esz, Rs);\n"),
    ("                 last ? min(RB, Lq) : min(RB, n - r0 - RB));\n",
     "                 last ? min(RB, Lq) : min(RB, n - r0 - RB));\n" + _s(1)),
    ("                         (is_v ? Vs : Ks) + r0 * LD);\n",
     "                         (is_v ? Vs : Ks) + r0 * LD);\n" + _s(2)),
    ("               xqb + (q0 + RB) * row_bytes, min(RB, Lq - q0 - RB));\n",
     "               xqb + (q0 + RB) * row_bytes, min(RB, Lq - q0 - RB));\n"
     + _s(4)),
    ("    __syncthreads();   // Qs complete; Xs free\n",
     "    __syncthreads();   // Qs complete; Xs free\n" + _s(5)),
    ("        for (int r = 0; r < 2; ++r) ls[j][r] = m[j][r] + log2f(l[j][r]);\n"
     "    }\n",
     "        for (int r = 0; r < 2; ++r) ls[j][r] = m[j][r] + log2f(l[j][r]);\n"
     "    }\n" + _s(6)),
    ("    // Output projection, residual and bias in f32, rows written once.\n",
     _s(7) + "    // Output projection, residual and bias in f32, rows written "
     "once.\n"),
    ("    }\n  }\n}\n\n// frag: 4 * FRAGS",
     "    }\n" + _s(8) + "  }\n" + WRITE + "}\n\n// frag: 4 * FRAGS"),
]
NEW = [   # mha_bf16.cuh, mha_wgmma_bf16_kernel (thread 0 of each warpgroup)
    ("  const float scale2 = scale * LOG2E;\n",
     "  const float scale2 = scale * LOG2E;\n" + INIT),
    ("  __syncthreads();   // the weights and every warpgroup's first rows "
     "landed\n",
     "  __syncthreads();   // the weights and every warpgroup's first rows "
     "landed\n" + _s(0)),
    ("      layer_norm(min(CHUNK, Lk - c * CHUNK), lnks, lnkb, a);\n",
     "      layer_norm(min(CHUNK, Lk - c * CHUNK), lnks, lnkb, a);\n" + _s(1)),
    ("      store_keys(acc, bb, vt, c * CHUNK);\n",
     "      store_keys(acc, bb, vt, c * CHUNK);\n" + _s(2)),
    ("  __syncthreads();   // Wq, Wo and every warpgroup's first query rows "
     "landed\n",
     "  __syncthreads();   // Wq, Wo and every warpgroup's first query rows "
     "landed\n" + _s(3)),
    ("      layer_norm(min(ROWS, Lq - row0), lnqs, lnqb, a);\n",
     "      layer_norm(min(ROWS, Lq - row0), lnqs, lnqb, a);\n" + _s(4)),
    ("      __syncwarp();\n    }\n", "      __syncwarp();\n    }\n" + _s(5)),
    ("      for (int c = 0; c < NC; ++c) wgmma_operand_fence(s[c]);\n"
     "      float ls[2]",
     "      for (int c = 0; c < NC; ++c) wgmma_operand_fence(s[c]);\n"
     + _s(6) + "      float ls[2]"),
    ("      // O = P V over every chunk",
     _s(9) + "      // O = P V over every chunk"),
    ("      bw::wgmma_wait();\n      wgmma_operand_fence(o);\n",
     "      bw::wgmma_wait();\n      wgmma_operand_fence(o);\n" + _s(7)),
    ("              pack2(o[4 * nt + 2 * r], o[4 * nt + 2 * r + 1]);\n"
     "      }\n    }\n",
     "              pack2(o[4 * nt + 2 * r], o[4 * nt + 2 * r + 1]);\n"
     "      }\n" + _s(10) + "    }\n"),
    ("                  (x.y + acc[4 * nt + 2 * r + 1]) + bb[nt].y);\n"
     "      }\n    }\n  }\n}\n",
     "                  (x.y + acc[4 * nt + 2 * r + 1]) + bb[nt].y);\n"
     "      }\n    }\n" + _s(8) + "  }\n" + WRITE + "}\n"),
    ("namespace mha_bf16 {\n", HEADER),
]


def _edit(path, edits):
    src = open(path).read()
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"anchor not found once in {path}: {old!r}")
        src = src.replace(old, new)
    open(path, "w").write(src)


def build(work):
    """The stamped library; raises if a source no longer has an anchor."""
    src_dir = os.path.join(work, "csrc")
    subprocess.run(["cp", "-r", str(_build.CSRC), src_dir], check=True)
    _edit(os.path.join(src_dir, "mha_bf16.cuh"), NEW)
    cu = os.path.join(src_dir, "mha_block.cu")
    _edit(cu, OLD)
    with open(cu, "a") as f:
        f.write("\nextern \"C\" int read_stamps(unsigned long long* out, "
                "int n) {\n  return (int)cudaMemcpyFromSymbol(out, "
                "mha_bf16::g_dbg, n * 8);\n}\n")
    lib = os.path.join(work, "libmha_block.so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, cu],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError((r.stdout + r.stderr)[-4000:])
    cl = ctypes.CDLL(lib)
    for fn, argtypes in mb._SIG.items():
        f = getattr(cl, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    cl.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    cl.read_stamps.restype = ctypes.c_int
    return cl


def _report(cl, nblocks, stampers, what):
    """Each phase's share of the stamping threads' time (``stampers`` a
    block: one a warpgroup, four in ``mha_mma_kernel``'s 16 warps)."""
    buf = np.zeros(nblocks * 4 * SLOTS, dtype=np.uint64)
    if cl.read_stamps(buf.ctypes.data, len(buf)):
        raise RuntimeError("reading the stamps failed")
    x = buf.reshape(nblocks, 4, SLOTS)[:, :stampers].astype(np.int64)
    x = x.reshape(-1, SLOTS)
    span = x[:, 14]
    per_sm = np.bincount(x[:, 15]) // stampers
    print(f"  {what}: {nblocks} blocks on {np.count_nonzero(per_sm)} SMs "
          f"({per_sm.max()} at most on one); a stamping thread's time "
          f"{span.mean() / 1e3:.2f} us on average", flush=True)
    shares = x[:, :11].sum(0) / max(1, span.sum())
    for name, share, mean in zip(PHASES, shares, x[:, :11].mean(0)):
        if mean:
            print(f"    {name}: {100 * share:.1f}% ({mean / 1e3:.2f} us)",
                  flush=True)


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(5)
    bf, dim, heads = torch.bfloat16, 128, 4
    p = {}
    for k in mb.PARAM_KEYS:
        if k.startswith("w"):
            p[k] = torch.randn(dim, dim, generator=g, device="cuda") / 11.3
        elif "scale" in k:
            p[k] = 1.0 + 0.1 * torch.randn(dim, generator=g, device="cuda")
        else:
            p[k] = 0.1 * torch.randn(dim, generator=g, device="cuda")
    flat = tuple(p[k] for k in mb.PARAM_KEYS)
    with tempfile.TemporaryDirectory() as work:
        cl = build(work)
        _build._loaded["mha_block"] = cl
        for b in (1024, 32):
            for lq, lk in ((65, 256), (256, 65), (65, 65), (256, 256)):
                x_q = torch.randn(b, lq, dim, generator=g,
                                  device="cuda").to(bf)
                x_kv = torch.randn(b, lk, dim, generator=g,
                                   device="cuda").to(bf)
                print(f"B {b}, Lq {lq}, Lk {lk}, 4 heads:", flush=True)
                for kernel, stampers in (("mma", 4), ("wgmma", 2)):
                    for _ in range(3):
                        mb._mha_block_cuda(x_q, x_kv, flat, heads,
                                           (dim // heads) ** -0.5, True,
                                           kernel=kernel)
                    torch.cuda.synchronize()
                    tiles = -(-lq // 64)
                    qs = (1 if kernel == "mma" else
                          min(tiles, -(-132 // b)))
                    _report(cl, b * qs, stampers,
                            "mha_mma_kernel" if kernel == "mma"
                            else "mha_wgmma_bf16_kernel")
        _build._loaded.pop("mha_block")


if __name__ == "__main__":
    main()
