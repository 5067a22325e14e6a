"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc`` into ``_build/lib<name>.so`` (listed in ``.gitignore``), which
is loaded with ``ctypes``. A source is rebuilt only when its library is
older than it (or than any ``csrc/*.cuh``). All stale sources compile in
parallel, one ``nvcc`` process each. Nothing is built when a module is
imported: the first wrapper call on a CUDA tensor builds what it needs.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (searched PATH and $CUDA_HOME/bin); the CUDA "
            "kernels are built from source at first use")
    return str(path)


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    deps = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime <= max(p.stat().st_mtime for p in deps)


def sources() -> Tuple[str, ...]:
    """Names of every kernel source under ``csrc/``."""
    return tuple(sorted(p.stem for p in CSRC.glob("*.cu")))


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Tuple[float, str]]:
    """Compile the stale sources among ``names`` (default: all) in parallel.

    Returns ``{name: (seconds, compiler log)}`` for each source compiled;
    the log holds ``ptxas``'s register / shared-memory / spill report.
    Raises with the compiler's output if any compile fails.
    """
    names = sources() if names is None else tuple(names)
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = BUILD_DIR / f"lib{n}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    out, failed = {}, []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {n}.cu (nvcc exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, _lib_path(n))   # atomic: a reader never sees half a file
        out[n] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """Build (if stale) and load ``lib<name>.so``; declare its C functions.

    ``signatures`` maps each C function to its ``argtypes``; every entry
    returns ``cudaError_t`` as an int.
    """
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (a refused launch)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def aligned(t):
    """``t`` contiguous and 16-byte aligned (a copy only when it is not):
    the kernels read rows as float4."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``: kernels launch on it."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
