"""Training steps as ``launch/train.py`` runs them: each step's batch from
``SyntheticLM`` (the copy task; a VLM's patch embeddings with it), uploaded
and cast as the trainer does, then ``make_train_step`` (``donate=True``,
``microbatches`` accumulated) with AdamW, no checkpoint.

Set-up builds the one step object with its model and optimizer state and
drives it from the seed through its first ``CHECK_STEPS`` steps, through
the same feed and call as the window, reading each step's loss, each
leaf's norm of the first step's gradient as the optimizer took it (its
first moment over ``1 - b1``) and each leaf's norm of the parameters'
change after the last of them.  The window then goes on from there until
``--seconds`` have passed, and ends in a synchronise.

The check, once the window has closed and the program's state is freed:
the float32 reference (``reference/dense.py``) follows the same steps from
the same weights on batches its own copy of the stream makes, and each
number of :func:`readings` stays within its limit; the last step of the
window must give a finite loss."""
from __future__ import annotations

import math
import statistics
import time

import torch

from ..harness import program, weights
from ..harness.bench import log
from ..harness.trace import DeviceTrace
from ..reference import data, dense

CHECK_STEPS = 3


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _leaves(tree: dict) -> dict:
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update({f"{key}/{k}": v for k, v in _leaves(val).items()})
        else:
            out[key] = val
    return out


def optimizer(opt: dict):
    from repro_torch.optim import AdamW, warmup_cosine

    return AdamW(lr=warmup_cosine(opt["lr"], opt["warmup"], opt["total"]), b1=opt["b1"],
                 b2=opt["b2"], eps=opt["eps"], weight_decay=opt["weight_decay"],
                 grad_clip=opt["grad_clip"])


def run(run) -> None:
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import Model

    t, dims, dev = run.traffic, run.dims, run.device
    cfg = program.port_config(run.conf, dims)
    model = Model(cfg)
    spec = dense.param_spec(dims)
    params, _ = weights.make(spec, run.seed, torch.device(dev))
    weights.check_layout(params, model.abstract())
    opt = optimizer(t["optimizer"])
    state = opt.init(params)
    step_fn = make_train_step(model, opt, accum=t["microbatches"], donate=True)
    source = SyntheticLM(DataConfig(
        seq_len=t["seq"], global_batch=t["rows"], vocab_size=dims.vocab, seed=run.seed,
        n_vision_tokens=dims.n_prefix, d_model=dims.d_model, family=cfg.family))
    spans = run.spans

    def step(i: int):
        nonlocal params, state
        with spans.span("data"):
            host = source.batch(i)
        with spans.span("upload"):
            batch = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
            if "vision_embeds" in batch:
                batch["vision_embeds"] = batch["vision_embeds"].to(torch.bfloat16)
        with spans.span("step"):
            params, state, metrics = step_fn(params, state, batch)
        return metrics

    losses = []
    for i in range(CHECK_STEPS):
        losses.append(float(step(i)["loss"]))
        if i == 0:     # m = (1 - b1) x the clipped gradient, kept on the host
            first = {p: m.detach().to("cpu", copy=True) for p, m in _leaves(state.m).items()}
    start, _ = weights.make(spec, run.seed, torch.device(dev))
    start = _leaves(start)
    change = {p: _norm(v.float() - start[p].float()) for p, v in _leaves(params).items()}
    del start
    run.state.update(losses=losses, first_moment=first, change=change)
    program.sync(dev)
    setup_peak = program.peak_bytes(dev)
    program.reset_peak(dev)
    tracer = DeviceTrace() if run.trace else None
    if tracer is not None:
        tracer.start()

    t0 = time.perf_counter()
    t_end, i = t0 + run.seconds, CHECK_STEPS
    while True:
        metrics = step(i)
        i += 1
        if time.perf_counter() >= t_end:
            break
    program.sync(dev)
    t1 = time.perf_counter()
    run.window = (t0, t1)
    if tracer is not None:
        tracer.stop(t0, t1)
        run.device_trace = tracer
    run.steps, run.step_positions = i - CHECK_STEPS, t["rows"] * t["seq"]
    run.window_peak_bytes = program.peak_bytes(dev)
    run.process_peak_bytes = max(setup_peak, run.window_peak_bytes)
    run.state["last_loss"] = float(metrics["loss"])
    run.attempted = run.steps
    run.failed = int(not math.isfinite(run.state["last_loss"]))


def reference_batches(run, steps: int) -> list:
    t, dims = run.traffic, run.dims
    out = []
    for s in range(steps):
        b = data.batch(run.seed, s, t["rows"], t["seq"], dims.vocab, dims.n_prefix, dims.d_model)
        out.append({k: torch.as_tensor(v, device=run.device) for k, v in b.items()})
    return out


def readings(prog: dict, ref: dict, start: dict, opt: dict) -> dict:
    """The numbers compared, and each leaf's terms of them: ``prog`` holds
    the program's first moment after its first step (``first_moment``,
    by path) and its parameters' change after the checked steps
    (``change``, norms by path); ``ref`` is what
    :func:`dense.train_reference` gave from the weights ``start``.

    * ``grad_norm_leaf``: the worst leaf's gap between the norms of the
      program's and the reference's first gradient, over the larger of that
      leaf's reference norm and the median leaf's;
    * ``grad_diff_leaf``: the worst leaf's norm of their difference, over
      the same;
    * ``change_leaf``: the worst leaf's gap between the norms of the
      parameters' change, over the larger of that leaf's reference norm and
      the median leaf's, among the leaves whose reference gradient is at
      least a thousandth of the median leaf's;
    * ``loss``: the largest relative gap of a step's loss."""
    dev = next(iter(ref["grads"].values())).device
    g_ref = {p: _norm(g) for p, g in ref["grads"].items()}
    g_med = statistics.median(g_ref.values())
    norm, diff = {}, {}
    for p, g in ref["grads"].items():
        mine = prog["first_moment"][p].to(dev) / (1 - opt["b1"])
        scale = max(g_ref[p], g_med)
        norm[p] = abs(_norm(mine) - g_ref[p]) / scale
        diff[p] = _norm(mine - g) / scale
        del mine
    moved = [p for p in g_ref if g_ref[p] >= 1e-3 * g_med]
    c_ref = {p: _norm(ref["params"][p].float() - dense.leaf(start, p).float()) for p in moved}
    c_med = statistics.median(c_ref.values())
    change = {p: abs(prog["change"][p] - c) / max(c, c_med, 1e-30) for p, c in c_ref.items()}
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    return {"numbers": {"grad_norm_leaf": max(norm.values()), "grad_diff_leaf": max(diff.values()),
                        "change_leaf": max(change.values()), "loss": loss},
            "leaves": {"grad_norm": norm, "grad_diff": diff, "change": change}}


def check(run) -> None:
    program.release(run.device)
    dims, t = run.dims, run.traffic
    start, _ = weights.make(dense.param_spec(dims), run.seed, torch.device(run.device))
    ref = dense.train_reference(start, dims, reference_batches(run, CHECK_STEPS),
                                t["optimizer"], t["microbatches"])
    got = readings(run.state, ref, start, t["optimizer"])
    run.checks = dict(got["numbers"], window_loss_not_finite=float(run.failed))
    log(f"losses {run.state['losses']} against the reference's {ref['losses']}")
