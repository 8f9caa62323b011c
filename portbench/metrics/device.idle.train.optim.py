"""The share of the traced window in which no operation ran on the card
while ``train.optim`` or a span under it was the innermost of the
program's spans that the step's thread had open at the gap's middle (the
idle gaps of ``harness/trace.py::DeviceTrace.idle_gaps``, the
breakdown's rule; the spans from the program's timeline,
``repro_torch.obs``).  Nothing without the trace or the timeline, or
where the window lost a record."""


def read(run):
    from repro_torch.obs import default_registry

    trace = run.device_trace
    tl = getattr(default_registry(), "timeline", None)
    if trace is None or tl is None:
        return None
    win = tl.window(*trace.window)
    optim = win.named("train.optim") if win is not None else None
    if not optim:
        return None
    idle = 0.0
    for a, b in trace.idle_gaps():
        rec = win.innermost(0.5 * (a + b), optim[0].thread)
        if rec is not None and "train.optim" in [rec.name] + [r.name for r in win.ancestors(rec)]:
            idle += b - a
    t0, t1 = trace.window
    return 100.0 * idle / (t1 - t0)
