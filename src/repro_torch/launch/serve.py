"""Serving launcher: multi-replica cluster with BASS request routing.

Spins up N in-process ``ServeEngine`` replicas of a (reduced) model and
drives a batch of requests through the ``BassRouter`` — prefix-warm
requests stick to their home replica unless bandwidth + backlog make a
migration strictly faster (Algorithm 1 Case 1.2), cold requests go to the
least-loaded replica with TS-reserved context transfer (Case 2).

The model runs on ``--device`` (default ``cuda``); on a machine without a
card pass ``--device cpu``, and the router's planning scans then run on
the ``numpy`` backend.  ``--arch`` takes any architecture of the
registry, at its smoke size: dense, MoE, SSM, hybrid, encoder-decoder
(served with zero audio frames, as the reference's engine does) and VLM.
Example::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-32b --smoke \\
        --replicas 2 --requests 12 --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..configs import ARCH_NAMES, get_config
from ..configs.base import ModelConfig
from ..models.model import Model
from ..serving import BassRouter, Request, ServeEngine
from .train import TINY


def make_requests(cfg: ModelConfig, n: int, prompt_len: int, max_new: int,
                  seed: int) -> List[Request]:
    """``n`` seeded random prompts; ``prefix_hash`` groups them in threes
    (the reference launcher's locality pattern)."""
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n):
        prompt = rng.integers(2, cfg.vocab_size, size=prompt_len).astype(np.int32)
        out.append(Request(rid=rid, prompt=prompt, max_new=max_new,
                           prefix_hash=int(rid % max(n // 3, 1))))
    return out


def drive(engines: Dict[str, ServeEngine], router: BassRouter,
          requests: List[Request], log: Optional[Callable[[str], None]] = print) -> dict:
    """Route and admit every request, then tick every engine until all are
    done, re-admitting requests that found their replica full.  Returns
    the host-clock times of each prefill (an admission) and each decode
    tick that had work, in seconds, and the wall time."""
    say = log or (lambda _msg: None)
    prefill_s: List[float] = []
    tick_s: List[float] = []

    def admit(eng: ServeEngine, req: Request) -> bool:
        t0 = time.perf_counter()
        ok = eng.admit(req)
        if ok:
            prefill_s.append(time.perf_counter() - t0)
        return ok

    t_start = time.perf_counter()
    pending = []
    for req in requests:
        decision = router.route(req)
        admitted = admit(engines[decision.replica], req)
        say(f"req {req.rid:3d} -> {decision.replica} "
            f"(migrated_from={decision.migrated_from}, admitted={admitted}, "
            f"slots={decision.slots[:4]}…)")
        if not admitted:
            pending.append((req, decision.replica))

    done = 0
    while done < len(requests):
        for name, eng in engines.items():
            busy = bool(eng.active)
            t0 = time.perf_counter()
            finished = eng.tick()
            if busy:
                tick_s.append(time.perf_counter() - t0)
            for req in finished:
                done += 1
                say(f"req {req.rid:3d} finished on {name}: {len(req.tokens_out)} tokens")
        router.update_backlog({n: e.backlog_seconds() for n, e in engines.items()})
        pending = [(req, target) for req, target in pending
                   if not admit(engines[target], req)]
    return {"seconds": time.perf_counter() - t_start, "prefill_s": prefill_s,
            "tick_s": tick_s}


def main(argv=None) -> dict:
    """Parse ``argv``, serve, print one line per routing decision and
    finished request and a summary → ``drive``'s times with the
    ``requests`` served, the ``params`` and the ``cfg``."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="", choices=[""] + ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--s-max", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cpu":
        from ..kernels import ts_plan

        ts_plan.set_backend("numpy")
    cfg = get_config(args.arch, smoke=True) if args.arch else TINY
    cfg = cfg.with_(remat=False)
    model = Model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed), device)

    names = [f"pod0/host{i}" for i in range(args.replicas)]
    engines = {
        n: ServeEngine(model, params, args.slots, args.s_max, name=n, device=device)
        for n in names
    }
    router = BassRouter(names)
    reqs = make_requests(cfg, args.requests, args.prompt_len, args.max_new, args.seed)
    out = drive(engines, router, reqs, log=lambda m: print(m, flush=True))
    total_tokens = args.requests * args.max_new
    dt = out["seconds"]
    print(f"served {args.requests} requests / {total_tokens} tokens "
          f"in {dt:.1f}s ({total_tokens/dt:.1f} tok/s)", flush=True)
    return dict(out, requests=reqs, params=params, cfg=cfg)


if __name__ == "__main__":
    main()
