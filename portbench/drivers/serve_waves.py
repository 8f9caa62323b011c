"""Serving in closed-loop waves: one ``ServeEngine`` replica behind the
``BassRouter``, as ``launch/serve.py::drive`` drives them (route, admit,
tick, the backlog handed back to the router).

A wave fills every slot at once with requests of one prompt length (the
traffic's ``prompt_lengths``, in turn, from wave 0) and ``new_tokens`` each
(the prefill's token and ``new_tokens - 1`` ticks); the next wave starts
when all of its requests have finished.  The seed draws the prompts' token
ids and the weights, never a length or an arrival, so every seed gives the
same work.  A wave must refill every slot: the engine decodes all slots at
the largest position any slot holds, which is exact only when every slot
holds one length.

The window starts at a wave's start and takes every admission and tick
that starts within ``--seconds``; it ends where the last of those ends.
The wave then in flight is admitted in full and ticked to its end outside
it, so that no wave leaves a slot to a stale position.  A request's time
to first token runs from its wave's start, when it was due, to the end of
its admission.

The check, once the window has closed and the engine is freed: every
routing decision names the replica; every request admitted finished with
its tokens; the weights are the bits the seed made; and, over a sample
drawn from the seed of the finished requests (one from each slot at least,
the longest prompt always among them), the float32 reference's logits at the prompt's last position and at
each served token's position (the prefill's logits and every tick's,
through the cache) put the served token no further below their best than
the limit (``max_logit_gap``)."""
from __future__ import annotations

import time

import numpy as np
import torch

from ..harness import program, weights
from ..harness.bench import log
from ..harness.trace import DeviceTrace
from ..reference import dense

REPLICA = "pod0/host0"


def prompt(seed: int, rid: int, n: int, vocab: int) -> np.ndarray:
    """Request ``rid``'s ``n`` token ids (a warm-up's ``rid`` is negative)."""
    rng = np.random.default_rng([seed % (1 << 63), int(rid < 0), abs(rid)])
    return rng.integers(2, vocab, size=n).astype(np.int32)


def run(run) -> None:
    from repro_torch.kernels import flash_attention, ts_plan
    from repro_torch.models.model import Model
    from repro_torch.serving import BassRouter, Request, ServeEngine

    t, dims, dev = run.traffic, run.dims, run.device
    lengths, new, slots = t["prompt_lengths"], t["new_tokens"], t["slots"]
    if len(set(lengths)) > slots:
        raise ValueError("the warm-up needs a slot for each prompt length")
    if dev == "cpu":
        ts_plan.set_backend("numpy")
    model = Model(program.port_config(run.conf, dims))
    params, flat = weights.make(dense.param_spec(dims), run.seed, torch.device(dev))
    weights.check_layout(params, model.abstract())
    engine = ServeEngine(model, params, slots, max(lengths) + new, name=REPLICA, device=dev)
    router = BassRouter([REPLICA])
    run.state.update(params=params, flat=flat, fingerprint=weights.fingerprint(flat),
                     engine=engine)

    # Set-up: one admission of every prompt length, ticked to the end.
    for i, n in enumerate(sorted(set(lengths))):
        req = Request(rid=-1 - i, prompt=prompt(run.seed, -1 - i, n, dims.vocab), max_new=new)
        router.route(req)
        engine.admit(req)
    while engine.active:
        engine.tick()
    program.sync(dev)
    setup_peak = program.peak_bytes(dev)
    program.reset_peak(dev)
    k2_before = flash_attention.stats["launches"]
    tracer = DeviceTrace() if run.trace else None
    if tracer is not None:
        tracer.start()

    spans = run.spans
    t0 = time.perf_counter()
    t_end, last_end, wave, k2_window = t0 + run.seconds, t0, 0, k2_before
    while time.perf_counter() < t_end:
        n = lengths[wave % len(lengths)]
        batch = [Request(rid=rid, prompt=prompt(run.seed, rid, n, dims.vocab), max_new=new,
                         prefix_hash=rid) for rid in range(wave * slots, (wave + 1) * slots)]
        due = time.perf_counter()
        for req in batch:
            with spans.span("route"):
                decision = router.route(req)
            a = time.perf_counter()
            admitted = engine.admit(req)
            b = time.perf_counter()
            spans.items.append(("admit", a, b))
            slot = next((s for s, q in engine.active.items() if q is req), None)
            if a < t_end:
                run.work.append((a, b, n + 1))
                last_end, k2_window = b, flash_attention.stats["launches"]
            run.requests.append(dict(rid=req.rid, wave=wave, n=n, due=due, start=a, first=b,
                                     inside=a < t_end, slot=slot, replica=decision.replica,
                                     degraded=decision.degraded, admitted=admitted, req=req))
        while engine.active:
            a, active = time.perf_counter(), len(engine.active)
            engine.tick()
            b = time.perf_counter()
            spans.items.append(("tick", a, b))
            if a < t_end:
                run.work.append((a, b, active))
                last_end = b
            router.update_backlog({REPLICA: engine.backlog_seconds()})
        wave += 1
    program.sync(dev)
    run.window = (t0, last_end)
    if tracer is not None:
        tracer.stop(t0, last_end)
        run.device_trace = tracer
    run.window_peak_bytes = program.peak_bytes(dev)
    run.process_peak_bytes = max(setup_peak, run.window_peak_bytes)
    run.counters["k2_launches"] = k2_window - k2_before
    run.attempted = len(run.requests)
    run.failed = sum(not finished(r, new) for r in run.requests)
    for n in sorted(set(lengths)):
        admits = [r["first"] - r["start"] for r in run.requests if r["n"] == n and r["inside"]]
        if admits:
            log(f"prompts of {n}: {len(admits)} admitted, {1e3 * sum(admits) / len(admits):.1f} ms "
                f"an admission")
    ticks = run.spans.within("tick", *run.window)
    if ticks:
        log(f"{len(ticks)} ticks, {1e3 * sum(b - a for a, b in ticks) / len(ticks):.1f} ms a tick, "
            f"{wave} waves")


def finished(rec: dict, new: int) -> bool:
    req = rec["req"]
    return (rec["admitted"] and not rec["degraded"] and rec["replica"] == REPLICA
            and req.done and len(req.tokens_out) == new)


def sample(run, k: int) -> list:
    """``k`` finished requests drawn from the seed (at least one a slot):
    one from each slot the engine served, the longest prompt for its own
    slot, then the rest from the others."""
    new = run.traffic["new_tokens"]
    done = [r for r in run.requests if finished(r, new)]
    if not done:
        return []
    rng = np.random.default_rng([run.seed % (1 << 63), 2])
    longest = max(done, key=lambda r: (r["n"], -r["rid"]))
    picks = {longest["rid"]}
    for slot in sorted({r["slot"] for r in done} - {longest["slot"]}):
        group = [r["rid"] for r in done if r["slot"] == slot]
        picks.add(group[rng.integers(len(group))])
    rest = [r["rid"] for r in done if r["rid"] not in picks]
    picks.update(rng.choice(rest, size=min(max(k - len(picks), 0), len(rest)), replace=False)
                 .tolist())
    return [r for r in done if r["rid"] in picks]


def sequences(recs: list, device) -> list:
    """Each request's prompt and the served tokens it was given back."""
    return [torch.as_tensor(np.concatenate([r["req"].prompt, r["req"].tokens_out[:-1]]),
                            device=device) for r in recs]


def gaps(logits: list, recs: list) -> list:
    """Per served token: the reference's best logit at its position less
    the logit of the token served."""
    out = []
    for lg, r in zip(logits, recs):
        served = torch.as_tensor(r["req"].tokens_out, device=lg.device)
        out += (lg.max(dim=-1).values - lg.gather(-1, served[:, None])[:, 0]).tolist()
    return out


def check(run) -> None:
    st = run.state
    st.pop("engine")
    program.release(run.device)
    params = st.pop("params")
    recs = sample(run, run.traffic["check_requests"])
    logits = dense.serve_logits(params, run.dims, sequences(recs, run.device),
                                run.traffic["new_tokens"])
    run.checks = {
        "max_logit_gap": max(gaps(logits, recs), default=float("inf")),
        "failed_requests": float(run.failed),
        "weights_changed": float(weights.fingerprint(st.pop("flat")) != st["fingerprint"]),
    }
