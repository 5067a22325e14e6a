"""Time variants of the bf16 flash attention kernels on the card, in turns.

Each variant is a copy of ``multimodal_sc_torch/csrc`` with text
substitutions in ``flash_bf16.cuh``, built apart with ``nvcc`` (all in
parallel) into a temporary directory, loaded in place of the package's own
build and timed at the c3 arm-F shape (B 64, H 3, L 256, D 64, the
(B, L, H, D) projection read as (B, H, L, D) in place), after a check
against the plain versions. The variants run in turns: the source as it
is, each variant, the source again. Prints the card, each variant's
registers and spills (ptxas) and its device ms a launch of the forward, dQ
and dK/dV kernels. Needs a card and ``nvcc``; imports no JAX:

    python3 scripts/torch_flash_bf16_variants.py
"""
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from multimodal_sc_torch.kernels import _build  # noqa: E402
from multimodal_sc_torch.kernels import attention as fa  # noqa: E402


def bounds(kernel, old, new):
    """The launch bounds of ``kernel`` from ``old`` to ``new``."""
    return (f"__launch_bounds__({old})\n{kernel}",
            f"__launch_bounds__({new})\n{kernel}")


MASK_EVERY_TILE = (
    """    if (nk < TK) {   // the ragged last tile
#pragma unroll
      for (int x = 0; x < TK / 2; ++x)
        if (8 * (x / 4) + 2 * t + (x & 1) >= nk) s[x] = NEG;
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG;
#pragma unroll
      for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          mx = fmaxf(mx, s[4 * nt + 2 * r + e]);""",
    """    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG;
#pragma unroll
      for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (8 * nt + 2 * t + e >= nk) s[4 * nt + 2 * r + e] = NEG;
          mx = fmaxf(mx, s[4 * nt + 2 * r + e]);
        }""")
EXPF = ("          const float p = exp2f(fmaf(s[4 * nt + 2 * r + e], LOG2E, "
        "-ml));", "          const float p = expf(s[4 * nt + 2 * r + e] - m_new);")
UNROLLED = ("#pragma unroll 1\n    for (int it = 0; it < R * C / THREADS;",
            "#pragma unroll\n    for (int it = 0; it < R * C / THREADS;")
FWD, DQ, DKV = ("flash_fwd_bf16_kernel", "flash_bwd_dq_bf16_kernel",
                "flash_bwd_dkv_bf16_kernel")
VARIANTS = {
    "as it is": [],
    "copy loops unrolled": [UNROLLED],
    "dK/dV two blocks an SM": [
        bounds(DKV, "THREADS, DT > 64 ? 1 : 3", "THREADS")],
    "forward three blocks an SM": [
        bounds(FWD, "THREADS", "THREADS, DT > 64 ? 1 : 3")],
    "dQ three blocks an SM": [
        bounds(DQ, "THREADS", "THREADS, DT > 64 ? 1 : 3")],
    "keys past Lk masked in every tile": [MASK_EVERY_TILE],
    "forward softmax by expf": [EXPF],
    "32-row tiles, four blocks an SM": [
        ("constexpr int FWD_KEYS = 64;", "constexpr int FWD_KEYS = 32;"),
        ("  return DT > 64 ? 32 : 64;", "  return 32;"),
        bounds(FWD, "THREADS", "THREADS, DT > 64 ? 1 : 4"),
        bounds(DQ, "THREADS", "THREADS, DT > 64 ? 1 : 4"),
        bounds(DKV, "THREADS, DT > 64 ? 1 : 3", "THREADS, DT > 64 ? 1 : 4")],
}


def build(work):
    """Each variant's library, built in parallel; prints ptxas's report of
    its bf16 kernels at head tile 64."""
    procs = {}
    for i, (name, reps) in enumerate(VARIANTS.items()):
        d = os.path.join(work, str(i))
        shutil.copytree(_build.CSRC, d)
        path = os.path.join(d, "flash_bf16.cuh")
        src = open(path).read()
        for old, new in reps:
            if old not in src:
                raise ValueError(f"{name}: {old!r} not in flash_bf16.cuh")
            src = src.replace(old, new)
        open(path, "w").write(src)
        lib = os.path.join(d, "libflash_attention.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
             os.path.join(d, "flash_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-4000:]}")
        for kernel, report in cs._ptxas_report(log):
            if "bf16_kernel<64, bf16>" in kernel:
                print(f"  {name}: {kernel}: {report}", flush=True)
        libs[name] = lib
    return libs


def use(path):
    """Route the wrappers' launches to the library at ``path``."""
    lib = ctypes.CDLL(path)
    for fn, argtypes in fa._SIG.items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    _build._loaded["flash_attention"] = lib


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as work:
        libs = build(work)
        g = torch.Generator(device="cuda").manual_seed(5)
        q, k, v, do = (torch.randn(64, 256, 3, 64, generator=g,
                                   device="cuda").to(torch.bfloat16)
                       .transpose(1, 2) for _ in range(4))
        scale = 64 ** -0.5
        ref = fa.flash_attention_fwd_reference(q, k, v, scale)[0]
        for name in [*VARIANTS, "as it is"]:
            use(libs[name])
            out, lse = fa._fwd_cuda(q, k, v, scale)
            dq, delta = fa._bwd_dq_cuda(q, k, v, out, lse, do, scale)
            dk, dv = fa._bwd_dkv_cuda(q, k, v, lse, delta, do, scale)
            want = (ref, *fa.flash_attention_bwd_reference(q, k, v, out, lse,
                                                            do, scale))
            err = max((a.float() - w.float()).abs().max().item()
                      for a, w in zip((out, dq, dk, dv), want))
            if err > 1e-2:
                raise AssertionError(f"{name}: {err:.3e} from the plain "
                                     "versions")
            ms = [cs._device_ms(fn, iters=50) for fn in (
                lambda: fa._fwd_cuda(q, k, v, scale),
                lambda: fa._bwd_dq_cuda(q, k, v, out, lse, do, scale),
                lambda: fa._bwd_dkv_cuda(q, k, v, lse, delta, do, scale))]
            print(f"{name}: forward {ms[0]:.4f}, dQ {ms[1]:.4f}, dK/dV "
                  f"{ms[2]:.4f} ms a launch (largest error {err:.2e})",
                  flush=True)
        _build._loaded.pop("flash_attention")


if __name__ == "__main__":
    main()
