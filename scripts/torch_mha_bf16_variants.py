"""Variants of ``mha_block``'s bf16-I/O wgmma kernel, timed in turns on the
card beside ``mha_mma_kernel``'s bf16-I/O instance.

Copies ``multimodal_sc_torch/csrc`` per variant, applies text substitutions
to ``mha_bf16.cuh``, builds every copy's ``mha_block.cu`` with ``nvcc`` in
parallel (printing ptxas's registers and spills of the head-dim-32
instances), loads each library into ``_build._loaded`` in turn and runs, on
the same bf16 inputs at c4's four act shapes (B 1024, 4 heads) and c5's (B
32): the share of outputs that differ from the plain version
(``mha_block_reference_bf16``), the outputs more than one bf16 step from it
and more than one step plus 5e-3 (``chip_smoke.py``'s gate), and the device
time (best of two ``_device_ms``), summed per c4 act step (the four shapes
twice). Variants:

* ``main``: the kernel as it stands; ``mha_mma_kernel``: the old kernel;
* ``chain1``, ``chain8``: the projections' sums run 1 or 8 k-steps (16 or
  all 128 terms) in the tensor-core accumulator before joining an f32 sum
  by adds (``main``: 2 k-steps, 32 terms);
* ``probe:noexp``, ``probe:noln``: the softmax's exponentials replaced by
  their arguments, the LayerNorm by a constant (wrong outputs, unchecked:
  what those parts cost).

Needs a card and ``nvcc``; imports no JAX:

    python3 scripts/torch_mha_bf16_variants.py [name ...]
"""
import ctypes
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from multimodal_sc_torch.kernels import _build  # noqa: E402
from multimodal_sc_torch.kernels import mha_block as mb  # noqa: E402

CHAIN = "constexpr int PROJ_CHAIN = 2;"
VARIANTS = {
    "chain1": [(CHAIN, "constexpr int PROJ_CHAIN = 1;")],
    "chain8": [(CHAIN, "constexpr int PROJ_CHAIN = 8;")],
    "probe:noexp": [
        ("              ex2(fmaf(sc[4 * nt + 2 * r + e], scale2, -m2[r]));",
         "              fmaf(sc[4 * nt + 2 * r + e], scale2, -m2[r]);"),
        ("          x = ex2(fmaf(x, scale2, -ls[r]));",
         "          x = fmaf(x, scale2, -ls[r]);")],
    "probe:noln": [
        ("                        const float* __restrict__ bi, "
         "uint32_t (&a)[8][4]) {\n",
         "                        const float* __restrict__ bi, "
         "uint32_t (&a)[8][4]) {\n    if (n > 0) {\n      for (int j = 0; "
         "j < 8; ++j)\n        for (int i = 0; i < 4; ++i) a[j][i] = "
         "0x3f803f80u;\n      return;\n    }\n")],
}
SHAPES = [(1024, lq, lk) for lq, lk in cs.C4_ATTN_SHAPES] + [
    (32, lq, lk) for lq, lk in cs.C4_ATTN_SHAPES]


def _start(work, subs):
    """A copy of csrc with ``subs`` applied to mha_bf16.cuh, its nvcc
    started; raises if an anchor is not found once."""
    os.makedirs(work, exist_ok=True)
    src = os.path.join(work, "csrc")
    subprocess.run(["cp", "-r", str(_build.CSRC), src], check=True)
    path = os.path.join(src, "mha_bf16.cuh")
    text = open(path).read()
    for old, new in subs:
        if text.count(old) != 1:
            raise ValueError(f"anchor not found once: {old!r}")
        text = text.replace(old, new)
    open(path, "w").write(text)
    lib = os.path.join(work, "libmha_block.so")
    return lib, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
         os.path.join(src, "mha_block.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(name, lib, proc):
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"{name}: {log[-4000:]}")
    for kernel, report in cs._ptxas_report(log):
        if kernel.startswith("mha_wgmma_bf16_kernel<32"):
            print(f"  {name}: {kernel} {report}", flush=True)
    for line in log.splitlines():
        if "warning" in line.lower():
            print(f"  {name}: {line}", flush=True)
    cl = ctypes.CDLL(lib)
    for fn, argtypes in mb._SIG.items():
        f = getattr(cl, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return cl


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    names = sys.argv[1:] or list(VARIANTS)
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as work:
        builds = {"main": _start(os.path.join(work, "main"), [])}
        for name in names:
            builds[name] = _start(os.path.join(work, name.replace(":", "_")),
                                  VARIANTS[name])
        libs = {name: _finish(name, *b) for name, b in builds.items()}
        g = torch.Generator(device="cuda").manual_seed(22)
        bf, dim, heads = torch.bfloat16, 128, 4
        p = {}
        for k in mb.PARAM_KEYS:
            if k.startswith("w"):
                p[k] = torch.randn(dim, dim, generator=g,
                                   device="cuda") * dim ** -0.5
            elif "scale" in k:
                p[k] = 1.0 + 0.1 * torch.randn(dim, generator=g,
                                               device="cuda")
            else:
                p[k] = 0.1 * torch.randn(dim, generator=g, device="cuda")
        flat = tuple(p[k] for k in mb.PARAM_KEYS)
        scale = (dim // heads) ** -0.5
        runs = [("mha_mma_kernel", "main", "mma"), ("main", "main", "wgmma")]
        runs += [(name, name, "wgmma") for name in names]
        per_step = {}
        for b, lq, lk in SHAPES:
            x_q = torch.randn(b, lq, dim, generator=g, device="cuda").to(bf)
            x_kv = torch.randn(b, lk, dim, generator=g, device="cuda").to(bf)
            ref = mb.mha_block_reference_bf16(x_q, x_kv, p, heads)
            print(f"B {b}, Lq {lq}, Lk {lk}:", flush=True)
            for label, lib, kernel in runs:
                _build._loaded["mha_block"] = libs[lib]

                def fn():
                    return mb._mha_block_cuda(x_q, x_kv, flat, heads, scale,
                                              True, kernel=kernel)

                out = fn()
                torch.cuda.synchronize()
                ms = min(cs._device_ms(fn) for _ in range(2))
                line = f"  {label}: {ms:.4f} ms"
                if not label.startswith("probe:"):
                    diff = (out.float() - ref.float()).abs()
                    step = cs._bf16_step(out)
                    line += (f"; {100 * (out != ref).float().mean().item():.4f}"
                             f"% of outputs differ, {int((diff > step).sum())}"
                             f" past one bf16 step, "
                             f"{int((diff > step + cs.BF16_MHA_ABS).sum())} "
                             "past the gate")
                print(line, flush=True)
                if b == 1024:
                    per_step[label] = (per_step.get(label, 0.0)
                                       + cs.FUSION_DEPTH * ms)
        _build._loaded.pop("mha_block")
    print("per c4 act step (B 1024, the four shapes twice): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in per_step.items()), flush=True)


if __name__ == "__main__":
    main()
