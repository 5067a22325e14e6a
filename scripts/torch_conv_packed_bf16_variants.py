"""Time variants of the bf16 wgmma conv and packed attention forward kernels
on the card, in turns.

Each variant is a copy of ``multimodal_sc_torch/csrc`` with text
substitutions in one file, built apart with ``nvcc`` (all in parallel)
into a temporary directory, loaded in place of the package's own build and
timed at the main paths' shapes after a check against the plain version:
the conv per c4 act step (B 1024), c5 act forward (B 32) and c1 train step
(B 64); the packed forward per arm-B act+learn step (the c4 fusion shapes
at B 1024 and 128 and the ViT trunk's, weighted as ``chip_smoke.py``
weights them). The variants of a kernel run in turns: the source as it is,
each variant, the source again. Prints the card, each variant's registers
and spills (ptxas) and its device ms. Needs a card and ``nvcc``; imports no
JAX:

    python3 scripts/torch_conv_packed_bf16_variants.py [conv|packed]
"""
import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from multimodal_sc_torch.kernels import _build  # noqa: E402
from multimodal_sc_torch.kernels import attention_packed as ap  # noqa: E402
from multimodal_sc_torch.kernels import conv_block as cb  # noqa: E402

CONV, PACKED = "conv_prelu.cu", "packed_fwd_bf16.cuh"
# Kernel family -> (source it builds, the file variants edit, its module).
FAMILIES = {"conv": ("conv_prelu", CONV, cb),
            "packed": ("attention_packed", PACKED, ap)}
# A variant named "probe: ..." removes work to see what it costs: its
# results are wrong, so it is timed without the check.
VARIANTS = {
    "conv": {
        "as it is": [],
        "four stages (copies three steps ahead)": [(
            "constexpr int CB_STAGES = 3;", "constexpr int CB_STAGES = 4;")],
        "tiles 128 wide at every grid": [(
            "Cout <= 64 || mb * ((Cout + 127) / 128) < CB_WAVES ? 64 : 128;",
            "Cout <= 64 ? 64 : 128;")],
        "probe: no proxy fence a step": [(
            "    bw::cp_async_wait<CB_STAGES - 2>();\n    bw::fence_async_shared();",
            "    bw::cp_async_wait<CB_STAGES - 2>();")],
        "probe: no products": [(
            "      bw::wgmma_bf16_ss<BN, 1>(part, bw::kmajor<CB_M, CB_K>(as, ks),",
            "      if (0) bw::wgmma_bf16_ss<BN, 1>(part, bw::kmajor<CB_M, CB_K>"
            "(as, ks),")],
        "probe: no copies past the first stages": [(
            "    if (i + CB_STAGES - 1 < nsteps)\n      load(",
            "    if (false)\n      load(")],
    },
    "packed": {
        "as it is": [],
        "four chunks at three blocks an SM": [(
            "NC == 1 ? 4 : NC == 2 ? 3 : 2)", "NC == 1 ? 4 : 3)")],
        "probe: no exponentials": [
            ('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
             "y = x;"),
            ("x = expf(__fmul_rn(x, scale) - ls[r]);",
             "x = __fmul_rn(x, scale) - ls[r];")],
    },
}

ENCODER = ((32, 32, 3, 32, 2, True), (16, 16, 32, 64, 2, True),
           (8, 8, 64, 128, 1, True), (8, 8, 128, 128, 1, True),
           (8, 8, 128, 16, 1, False))
DECODER_IN = (8, 8, 16, 128, 1, True)
# (what, batch, [(shape, launches a step)]), as chip_smoke.py sums them.
CONV_STEPS = (
    ("c4 act step", cs.NUM_ENVS, [(x, 1) for x in ENCODER]),
    ("c5 act forward", cs.C5_ENVS, [(x, 1) for x in ENCODER]),
    ("c1 train step (its 8 wgmma convs)", cs.C1_BATCH,
     [(x, 3 if x == ENCODER[3] else 1) for x in ENCODER] + [(DECODER_IN, 1)]),
)
# (B, Lq, Lk, launches an arm-B act+learn step), chip_smoke.py's rows.
PACKED_ROWS = ([(cs.NUM_ENVS, lq, lk, cs.FUSION_DEPTH)
                for lq, lk in cs.C4_ATTN_SHAPES]
               + [(cs.NUM_ENVS, cs.VIT_TOKENS, cs.VIT_TOKENS,
                   cs.VIT_ATTN_PER_FWD),
                  (cs.LEARN_BATCH, cs.VIT_TOKENS, cs.VIT_TOKENS,
                   3 * cs.VIT_ATTN_PER_FWD)]
               + [(cs.LEARN_BATCH, lq, lk, 3 * cs.FUSION_DEPTH)
                  for lq, lk in cs.C4_ATTN_SHAPES])


def build(family, work):
    """Each variant's library, built in parallel; prints ptxas's report of
    the family's bf16 wgmma kernels."""
    source, edited, _ = FAMILIES[family]
    procs = {}
    for i, (name, reps) in enumerate(VARIANTS[family].items()):
        d = os.path.join(work, f"{family}{i}")
        shutil.copytree(_build.CSRC, d)
        path = os.path.join(d, edited)
        src = open(path).read()
        for old, new in reps:
            if old not in src:
                raise ValueError(f"{name}: {old!r} not in {edited}")
            src = src.replace(old, new)
        open(path, "w").write(src)
        lib = os.path.join(d, f"lib{source}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
             os.path.join(d, f"{source}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-4000:]}")
        for kernel, report in cs._ptxas_report(log):
            if "wgmma_bf16_kernel" in kernel and (
                    family == "conv" or kernel.endswith(", false>")):
                print(f"  {name}: {kernel}: {report}", flush=True)
        # ptxas's warning that it serializes a kernel's wgmma (C7514).
        serial = sorted({cs._demangle_kernel(f) for f in re.findall(
            r"C7514.*?function '(\S+)'", log)})
        print(f"  {name}: wgmma serialized in {serial or 'no kernel'}",
              flush=True)
        libs[name] = lib
    return libs


def use(family, path):
    """Route the family's wrappers to the library at ``path``."""
    source, _, module = FAMILIES[family]
    lib = ctypes.CDLL(path)
    for fn, argtypes in module._SIG.items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    _build._loaded[source] = lib


def conv_inputs(g):
    bf = torch.bfloat16
    out = {}
    for _, b, shapes in CONV_STEPS:
        for (h, w, cin, cout, s, prelu), _ in shapes:
            x = torch.randn(b, h, w, cin, generator=g, device="cuda").to(bf)
            wt = (torch.randn(5, 5, cin, cout, generator=g, device="cuda")
                  / (25 * cin) ** 0.5).to(bf)
            bias = (0.1 * torch.randn(cout, generator=g, device="cuda")).to(bf)
            a = (torch.rand(cout, generator=g, device="cuda").to(bf)
                 if prelu else None)
            out[b, (h, w, cin, cout, s, prelu)] = (x, wt, bias, a, s)
    return out


def time_conv(inputs, check=True):
    """ms of each conv step, after a one-step check of every shape."""
    for key, (x, wt, bias, a, s) in inputs.items() if check else ():
        over, steps, _ = cs._ulp_gate(cb.conv_prelu(x, wt, bias, a, s),
                                      cb.conv_prelu_reference(x, wt, bias,
                                                              a, s))
        if over.any():
            raise AssertionError(f"{key}: {steps:.2f} bf16 steps off")
    ms = {}
    for what, b, shapes in CONV_STEPS:
        each = [cs._device_ms(lambda args=inputs[b, shape]: cb.conv_prelu(
            *args[:4], args[4]), iters=50) for shape, _ in shapes]
        ms[what] = sum(n * t for (_, n), t in zip(shapes, each))
        if b == cs.NUM_ENVS:   # the c4 step's layers
            ms.update({f"{h}x{w}x{cin}->{cout}": t for (
                (h, w, cin, cout, _, _), _), t in zip(shapes, each)})
    return ms


def packed_inputs(g):
    return {(b, lq, lk): tuple(
        torch.randn(b, n, 128, generator=g, device="cuda").to(torch.bfloat16)
        for n in (lq, lk, lk)) for b, lq, lk, _ in PACKED_ROWS}


def time_packed(inputs, check=True):
    """ms of the forward per arm-B act+learn step, after a check."""
    for key, (q, k, v) in inputs.items() if check else ():
        got = ap.packed_attention(q, k, v, 4)
        want = ap.packed_attention_fwd_reference(q, k, v, 4, bf16=True)[0]
        if (got.float() - want.float()).abs().max().item() > 2e-2:
            raise AssertionError(f"{key}: far from the plain version")
    return {"arm-B act+learn step": sum(
        n * cs._device_ms(lambda t=inputs[b, lq, lk]: ap.packed_attention(
            *t, 4), iters=50) for b, lq, lk, n in PACKED_ROWS)}


def main():
    families = sys.argv[1:] or list(FAMILIES)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(7)
    with tempfile.TemporaryDirectory() as work:
        for family in families:
            libs = build(family, work)
            inputs = (conv_inputs if family == "conv" else packed_inputs)(g)
            timer = time_conv if family == "conv" else time_packed
            for name in [*VARIANTS[family], "as it is"]:
                use(family, libs[name])
                ms = timer(inputs, check=not name.startswith("probe"))
                print(f"{family}, {name}: " + ", ".join(
                    f"{k} {v:.4f} ms" for k, v in ms.items()), flush=True)
            _build._loaded.pop(FAMILIES[family][0])


if __name__ == "__main__":
    main()
