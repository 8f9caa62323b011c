#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the card this process sees.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Sets up the cell (imports, weights made on the card from the seed, one
warm pass of every shape its traffic uses), measures for ``--seconds``,
checks what the measured path produced against the plain reference and
prints one JSON line last on standard output (``--trace 1``: the per-layer
metrics, from the benchmark's spans and the device's trace).  Compiled
Python and the program's kernel libraries are kept in fixed directories
under ``build/`` in the checkout, so only a checkout's first run compiles.
Exits non-zero, printing no result, without enough CUDA devices or where
the run loaded JAX or the JAX package.
"""
import time

T_PROCESS0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench" / "cache"


def keep_caches_in_checkout() -> None:
    """Compiled Python of every module imported from here on, and any
    compiler cache a library keeps, in fixed directories of the checkout."""
    pycache = CACHE / "pycache"
    pycache.mkdir(parents=True, exist_ok=True)
    sys.pycache_prefix, sys.dont_write_bytecode = str(pycache), False
    os.environ["PYTHONPYCACHEPREFIX"] = str(pycache)
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    keep_caches_in_checkout()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench.harness import bench

    return bench.main(args, T_PROCESS0)


if __name__ == "__main__":
    sys.exit(main())
