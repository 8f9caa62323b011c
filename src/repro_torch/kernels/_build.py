"""Build and load the port's CUDA kernels (the counterpart of
``repro/kernels/_compat.py``, which held the Pallas/TPU shims).

The sources in ``kernels/csrc/*.cu`` expose a plain C interface.  At first
use they are compiled by ``nvcc`` for Hopper (``sm_90a``) into one shared
library under ``build/repro_torch/`` at the repository root, named by a
hash of the sources and flags, and loaded with ``ctypes``.  A later
process with the same sources loads the existing library without
recompiling.

Every step raises on failure — no ``nvcc``, no CUDA device, a device that
is not capability (9, 0), a failed compile — so a caller that asked for
the kernel never silently gets something else.  Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

#: The last build's compiler output (``-Xptxas -v``: registers and spills
#: per kernel), its wall time, and the loaded library's path.  The
#: ``ts_plan_device.stats`` counters ``traces`` (nvcc runs) and
#: ``cache_hits`` (a library already built for these sources) count builds.
build_info = {"log": "", "build_s": 0.0, "path": None}

_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int64
_D = ctypes.c_double

#: C signatures of ``csrc/ts_plan.cu`` (all return a ``cudaError_t``).
_SIGNATURES = {
    "ts_plan_window": (
        _P, _I, _P, _P, _P, _P, _P, _P, _P, _D, _I, _I, _I,
        _P, _P, _P, _P, _P, _P,
    ),
    "ts_plan_columns": (
        _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
    ),
    "ts_plan_dense": (
        _P, _P, _P, _P, _D, ctypes.c_int, _I, _I, _I, _P, _P, _P, _P, _P,
    ),
}


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels cannot be built"
    )


def check_device() -> None:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the 'cuda' ts_plan backend needs one")
    cap = torch.cuda.get_device_capability()
    if cap != (9, 0):
        raise RuntimeError(
            f"device capability {cap} is not (9, 0): the kernels are built "
            "for Hopper (sm_90a) only"
        )


def _source_hash(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is not None:
        return _lib
    from .ts_plan_device import stats

    check_device()
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    out = BUILD_DIR / f"libts_plan.{_source_hash(sources)}.so"
    if out.is_file():
        stats["cache_hits"] += 1
    else:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_info["build_s"] = time.perf_counter() - t0
        build_info["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{build_info['log']}"
            )
        os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
        stats["traces"] += 1
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    build_info["path"] = str(out)
    _lib = lib
    return lib
