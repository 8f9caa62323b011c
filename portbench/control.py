#!/usr/bin/env python3
"""The readings that each cell's limits are set from; not part of a run.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 [--seconds 25]

For every seed, in one process: the cell's driver runs the program as a
run does (a short window), then prints one JSON line of the numbers its
check compares, for

* ``program``: the program, against the float32 reference (the lower
  readings);
* ``control``: the reference computed in float8 e4m3 (``reference/
  dense.py::mm_fp8``), the nearest precision below the configuration's
  bfloat16, in the program's place (the upper readings).  A served cell
  reads, at each position of the same sampled prompts and served tokens,
  the float32 gap of the token the control puts first;
* ``half_batch`` (training cells): the reference taking the mean over half
  of each batch's rows, the other half left out;
* ``unchanged`` (training cells): the reference whose steps return their
  state unchanged (a learning rate of 0), so that every step's loss is the
  starting weights'.

``--controls n`` reads the control and the faults on the first ``n``
seeds only (all by default).  The fault test under this directory plants
each fault in the program at a small size on the CPU.
"""
import time

T_PROCESS0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from portbench.run import ROOT, keep_caches_in_checkout  # noqa: E402


def serve_readings(run, driver, dense, controls: bool = True) -> dict:
    st = run.state
    st.pop("engine")
    driver.program.release(run.device)
    params = st.pop("params")
    recs = driver.sample(run, run.traffic["check_requests"])
    seqs = driver.sequences(recs, run.device)
    new = run.traffic["new_tokens"]
    ref = dense.serve_logits(params, run.dims, seqs, new)
    program = driver.gaps(ref, recs)
    out = {"program": {"max_logit_gap": max(program)}, "tokens": len(program),
           "slots": len({r["slot"] for r in recs}),
           "program_gaps_over_0": sum(g > 0 for g in program)}
    if not controls:
        return out
    low = dense.serve_logits(params, run.dims, seqs, new, mm=dense.mm_fp8)
    control = []
    for r, lo in zip(ref, low):
        first = lo.argmax(dim=-1)
        control += (r.max(dim=-1).values - r.gather(-1, first[:, None])[:, 0]).tolist()
    agree = sum(int(a == b) for r, lo in zip(ref, low)
                for a, b in zip(r.argmax(-1).tolist(), lo.argmax(-1).tolist()))
    return dict(out, control={"max_logit_gap": max(control)}, control_top_agrees=agree)


def train_readings(run, driver, dense, controls: bool = True) -> dict:
    import torch

    from portbench.harness import weights

    driver.program.release(run.device)
    dims, t = run.dims, run.traffic
    start, _ = weights.make(dense.param_spec(dims), run.seed, torch.device(run.device))
    batches = driver.reference_batches(run, driver.CHECK_STEPS)
    ref = dense.train_reference(start, dims, batches, t["optimizer"], t["microbatches"])
    opt = t["optimizer"]
    got = driver.readings(run.state, ref, start, opt)
    out = {"program": got["numbers"], "leaves": {"program": got["leaves"]},
           "reference": {"losses": ref["losses"], "global_norm": ref["global_norm"]},
           "program_losses": run.state["losses"]}
    if not controls:
        return out

    def as_program(r):
        return {"losses": r["losses"],
                "first_moment": {p: g * (1 - opt["b1"]) for p, g in r["grads"].items()},
                "change": {p: float(torch.linalg.vector_norm(
                    (r["params"][p].float() - dense.leaf(start, p).float()).double()))
                    for p in r["params"]}}

    low = dense.train_reference(start, dims, batches, opt, t["microbatches"], mm=dense.mm_fp8)
    half = [{k: v[: v.shape[0] // 2] for k, v in b.items()} for b in batches]
    cut = dense.train_reference(start, dims, half, opt, t["microbatches"])
    still = dense.train_reference(start, dims, batches, dict(opt, lr=0.0), t["microbatches"])
    for name, r in (("control", low), ("half_batch", cut), ("unchanged", still)):
        got = driver.readings(as_program(r), ref, start, opt)
        out[name] = got["numbers"]
        out["leaves"][name] = got["leaves"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--controls", type=int, default=None)
    args = ap.parse_args(argv)
    keep_caches_in_checkout()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import importlib

    import torch

    from portbench.harness import bench
    from portbench.reference import dense

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    _, conf, traffic, limits = bench.cell(args.workload)
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    readings = serve_readings if traffic["driver"] == "serve_waves" else train_readings
    n_controls = len(args.seeds) if args.controls is None else args.controls
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        run = bench.Run(workload=args.workload, conf=conf, traffic=traffic, limits=limits,
                        seed=seed, seconds=args.seconds, trace=False, device="cuda",
                        t_process0=t0)
        run.dims = dense.Dims.of(conf)
        driver.run(run)
        out = {"workload": args.workload, "seed": seed, **readings(run, driver, dense, i < n_controls),
               "seconds": time.perf_counter() - t0}
        print(json.dumps(out), flush=True)
        del run
        driver.program.release("cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
