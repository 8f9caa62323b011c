"""Run one function on a group of ``torch.distributed`` ranks, one process
each, with a wall-clock limit.

    results = run_ranks("repro_torch.launch.expert:block", 8, payload,
                        backend="gloo", timeout_s=300)

starts ``world`` processes (``python -m repro_torch.distributed.ranks``),
each of which joins a process group through a file store in a fresh
temporary directory (``init_process_group`` with a 60 s timeout), calls
``module:function`` on the payload (written once with ``torch.save``) and
saves what it returns.  The caller gets the results in rank order.  The
first rank to exit non-zero (after the others are given ``SETTLE_S`` to
exit too), or the limit, ends every rank still running, and ``run_ranks``
raises with the last lines of every failed rank's error output: a rank
that fails never leaves the others waiting in a collective.  Each rank's
standard output and error go to files in the temporary directory, which
is removed afterwards.
"""
from __future__ import annotations

import importlib
import os
import shutil
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path
from typing import Any, List, Optional

#: ``init_process_group``'s timeout, and so the longest a collective waits.
GROUP_TIMEOUT = timedelta(seconds=60)
#: After the first rank exits non-zero, the longest the others are given to
#: exit before they are ended and the failure is reported.
SETTLE_S = 10.0


class RankFailure(RuntimeError):
    """A rank exited non-zero or the run passed its limit."""


def _tail(path: Path, n: int = 3000) -> str:
    try:
        return path.read_text(errors="replace")[-n:]
    except OSError:
        return ""


def run_ranks(target: str, world: int, payload: Any, *, backend: str = "gloo",
              timeout_s: float = 300.0, env: Optional[dict] = None) -> List[Any]:
    """``target`` (``"module:function"``) on ``world`` ranks → its results
    in rank order.  Each rank takes its share of the host's cores
    (``torch.set_num_threads``); ``env`` adds variables to the ranks'
    environment."""
    import torch

    src = str(Path(__file__).resolve().parents[2])
    workdir = Path(tempfile.mkdtemp(prefix="ranks_"))
    try:
        torch.save(payload, workdir / "payload.pt")
        threads = max(1, (os.cpu_count() or 1) // world)
        child_env = {**os.environ, "GLOO_SOCKET_IFNAME": os.environ.get("GLOO_SOCKET_IFNAME", "lo"),
                     **(env or {})}
        child_env["PYTHONPATH"] = os.pathsep.join(
            [src] + [p for p in child_env.get("PYTHONPATH", "").split(os.pathsep) if p])
        procs = []
        for rank in range(world):
            cmd = [sys.executable, "-m", "repro_torch.distributed.ranks", target, str(rank),
                   str(world), backend, f"file://{workdir / 'store'}", str(workdir),
                   str(threads)]
            with open(workdir / f"rank{rank}.out", "w") as out, \
                    open(workdir / f"rank{rank}.err", "w") as err:
                procs.append(subprocess.Popen(cmd, stdout=out, stderr=err, env=child_env))
        deadline = time.monotonic() + timeout_s
        failure = None
        while failure is None:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                # The others' errors: a rank's failure fails its peers in their next
                # collective, and the rank that failed first need not exit first.
                settle = time.monotonic() + SETTLE_S
                while any(p.poll() is None for p in procs) and time.monotonic() < settle:
                    time.sleep(0.05)
                codes = [p.poll() for p in procs]
                failure = "\n".join(
                    f"rank {r} of {world} ({target}, {backend}) exited {codes[r]}:\n"
                    + _tail(workdir / f"rank{r}.err")
                    for r, c in enumerate(codes) if c not in (None, 0))
            elif all(c == 0 for c in codes):
                break
            elif time.monotonic() > deadline:
                failure = (f"{target} on {world} {backend} ranks passed its {timeout_s} s "
                           f"limit; rank 0's error output:\n" + _tail(workdir / "rank0.err"))
            else:
                time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        if failure is not None:
            raise RankFailure(failure)
        return [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _main(argv) -> None:
    import torch
    import torch.distributed as dist

    target, rank, world, backend, init, workdir, threads = argv
    rank, world, workdir = int(rank), int(world), Path(workdir)
    torch.set_num_threads(int(threads))
    module, name = target.split(":")
    fn = getattr(importlib.import_module(module), name)
    payload = torch.load(workdir / "payload.pt", weights_only=False)
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=GROUP_TIMEOUT)
    try:
        result = fn(payload)
    finally:
        dist.destroy_process_group()
    torch.save(result, workdir / f"rank{rank}.pt")


if __name__ == "__main__":
    _main(sys.argv[1:])
