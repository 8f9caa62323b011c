"""Build and load the port's CUDA kernels (the counterpart of
``repro/kernels/_compat.py``, which held the Pallas/TPU shims).

Each source ``kernels/csrc/<name>.cu`` exposes a plain C interface whose
signatures the module that owns it registers here (:func:`register`).  At
first use a source is compiled by ``nvcc`` for Hopper (``sm_90a``) into its
own shared library under ``build/repro_torch/`` at the repository root,
named by a hash of the source and flags, and loaded with ``ctypes``.  A
later process with the same source loads the existing library without
recompiling.  :func:`build` starts one ``nvcc`` per missing source, all at
once, and waits for them together.

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
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# One flag set for every source.  ``--fmad=false``: K1 must not contract a
# multiply and an add that numpy rounds separately (csrc/ts_plan.cu).  The
# other kernels need no flag of their own: their multiply-adds that must
# fuse are explicit ``fmaf`` / ``__fmaf_rn`` (K4's recurrence, the attention
# kernels' CUDA-core sums), which the flag leaves alone; K2's tensor-core
# products are ``wgmma`` (hence ``sm_90a``), and it fetches the driver's
# tensor-map encoder at run time instead of linking libcuda.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

#: Per source, after its library is loaded: the compiler output of its
#: build (``-Xptxas -v``: registers and spills per kernel; empty on a cache
#: hit), the build's wall time, and the library's path.
build_info: Dict[str, dict] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int64
_D = ctypes.c_double
_F = ctypes.c_float

# name -> (C signatures, the owner's counter group or None)
_SOURCES: Dict[str, tuple] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def register(name: str, signatures: dict, stats=None) -> None:
    """Declare ``csrc/<name>.cu``: its C functions' argument types (each
    returns a ``cudaError_t``), and optionally the owner's counter group,
    whose ``traces`` and ``cache_hits`` cells then count this source's
    builds too."""
    _SOURCES[name] = (dict(signatures), stats)


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
        raise RuntimeError("no CUDA device: the port's kernels need one")
    cap = torch.cuda.get_device_capability()
    if cap != (9, 0):
        raise RuntimeError(
            f"device capability {cap} is not (9, 0): the kernels are built "
            "for Hopper (sm_90a) only"
        )


def _library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.name.encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}.{h.hexdigest()[:16]}.so"


def _count(name: str, key: str) -> None:
    stats = _SOURCES[name][1]
    if stats is not None:
        stats["traces" if key == "builds" else key] += 1


def _load(name: str, path: Path, log: str, build_s: float) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in _SOURCES[name][0].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    build_info[name] = {"log": log, "build_s": build_s, "path": str(path)}
    _libs[name] = lib
    return lib


def build(names: Optional[Iterable[str]] = None) -> Dict[str, ctypes.CDLL]:
    """Load the libraries of ``names`` (default: every registered source),
    compiling the missing ones in parallel, one ``nvcc`` each."""
    names = list(_SOURCES if names is None else names)
    unknown = [n for n in names if n not in _SOURCES]
    if unknown:
        raise KeyError(f"no registered CUDA source named {unknown}")
    todo = [n for n in names if n not in _libs]
    if todo:
        check_device()
        nvcc = find_nvcc()
    procs = {}
    for name in todo:
        out = _library_path(name)
        if out.is_file():
            _count(name, "cache_hits")
            _load(name, out, "", 0.0)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs[name] = (proc, cmd, out, tmp, time.perf_counter())
    failed = []
    for name, (proc, cmd, out, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        build_s = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
        _count(name, "builds")
        _load(name, out, log, build_s)
    if failed:
        raise RuntimeError("\n\n".join(failed))
    return {n: _libs[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _libs.get(name)
    return lib if lib is not None else build([name])[name]
