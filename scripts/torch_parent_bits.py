"""Hold the attention kernels' existing routes bit-equal to another tree's
build.

Builds ``attention_packed.cu``, ``flash_attention.cu`` and ``mha_block.cu``
from this checkout and from the ``multimodal_sc_torch/csrc`` of another
checkout (an earlier commit unpacked with ``git archive``), runs every route
the earlier tree has on the same seeded inputs through both builds, and
exits 1 if any output differs by a bit:

* ``packed_attention`` forward and backward: f32 tensors in the f32 and
  the bf16 mode, bf16 tensors in the bf16 mode (arm B's learn shape, and
  shapes past one query block, past 256 keys and at head dims 8 and 64);
* the flash kernels (forward, dQ, dK / dV) on f32 and bf16 tensors;
* ``mha_block`` on f32 activations in both modes and on bf16 activations
  in the bf16 mode, at 256 and 512 keys.

The other tree's C entries must take this tree's arguments. Needs a card;
prints the card's name and power limit first. From the repository root:

    git archive <commit> multimodal_sc_torch/csrc | tar -x -C <dir>
    python3 scripts/torch_parent_bits.py <dir>
"""
import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from multimodal_sc_torch.kernels import _build  # noqa: E402
from multimodal_sc_torch.kernels import attention as fa  # noqa: E402
from multimodal_sc_torch.kernels import attention_packed as ap  # noqa: E402
from multimodal_sc_torch.kernels import mha_block as mb  # noqa: E402

SOURCES = {"attention_packed": ap._SIG, "flash_attention": fa._SIG,
           "mha_block": mb._SIG}


def run_routes(seed=7):
    """Every route's outputs, in a fixed order, on inputs from ``seed``."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, dt=torch.float32):
        return torch.randn(*shape, generator=g, device="cuda").to(dt)

    out = []
    for dt in (torch.float32, torch.bfloat16):
        for b, lq, lk, heads in ((128, 65, 256, 4), (64, 300, 100, 4),
                                 (16, 50, 300, 16), (8, 130, 300, 2)):
            q, k, v, do = (rnd(b, n, 128, dt=dt) for n in (lq, lk, lk, lq))
            scale = (128 // heads) ** -0.5
            for mode in (False, True) if dt == torch.float32 else (True,):
                o, lse = ap._fwd_cuda(q, k, v, heads, scale, mode,
                                      want_lse=True)
                out += [o, lse, *ap._bwd_cuda(q, k, v, o, lse, do, heads,
                                              scale, mode)]
        for b, h, lq, lk, d in ((64, 3, 256, 256, 64), (3, 2, 33, 130, 128),
                                (4, 5, 300, 7, 8)):
            q, k, v, do = (rnd(b, n, h, d, dt=dt).transpose(1, 2)
                           for n in (lq, lk, lk, lq))
            o, lse = fa._fwd_cuda(q, k, v, d ** -0.5)
            dq, delta = fa._bwd_dq_cuda(q, k, v, o, lse, do, d ** -0.5)
            out += [o, lse, dq, delta,
                    *fa._bwd_dkv_cuda(q, k, v, lse, delta, do, d ** -0.5)]
    params = {k: rnd(128, 128) * 128 ** -0.5 if k.startswith("w")
              else 0.1 * rnd(128) for k in mb.PARAM_KEYS}
    for dt in (torch.float32, torch.bfloat16):
        for b, lq, lk, heads in ((256, 65, 256, 4), (64, 256, 512, 4),
                                 (32, 33, 300, 16)):
            xq, xkv = rnd(b, lq, 128, dt=dt), rnd(b, lk, 128, dt=dt)
            for mode in (False, True) if dt == torch.float32 else (True,):
                out.append(mb.mha_block(xq, xkv, params, heads,
                                        mxu_bf16=mode))
    torch.cuda.synchronize()
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("other", help="a checkout holding "
                        "multimodal_sc_torch/csrc")
    args = parser.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print("card:", smi.stdout.strip(), flush=True)
    csrc = Path(args.other) / "multimodal_sc_torch" / "csrc"
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        procs = {n: subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             os.path.join(out_dir, f"lib{n}.so"), str(csrc / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for n in SOURCES}
        _build.build(SOURCES)
        for n, p in procs.items():
            log, _ = p.communicate()
            if p.returncode:
                raise RuntimeError(f"{csrc / n}.cu does not build:\n{log}")
        print(f"both trees built in {time.perf_counter() - t0:.1f} s",
              flush=True)
        mine = run_routes()
        for n, sig in SOURCES.items():
            lib = ctypes.CDLL(os.path.join(out_dir, f"lib{n}.so"))
            for fn, argtypes in sig.items():
                f = getattr(lib, fn)
                f.argtypes, f.restype = list(argtypes), ctypes.c_int
            _build._loaded[n] = lib
        try:
            theirs = run_routes()
        finally:
            for n in SOURCES:
                _build._loaded.pop(n)
    bad = [i for i, (a, b) in enumerate(zip(mine, theirs))
           if not torch.equal(a, b)]
    print(f"{len(mine)} tensors of the existing routes, {len(bad)} differ "
          f"from {args.other}'s build: {bad}", flush=True)
    sys.exit(1 if bad or len(mine) != len(theirs) else 0)


if __name__ == "__main__":
    main()
