"""``model.decode`` inside a tick (``engine.tick``), mean per tick in the
window: the card's work on the decode step, without its waits for the
host's launches (``tick.enqueue_ms`` is the host's side).  The card's
busy time (``run.device_trace``'s operations) inside the spans' device
intervals, from the program's timeline (``repro_torch.obs``).  Nothing
without the trace or the timeline, where the window lost a record or a
device interval is missing."""


def read(run):
    from repro_torch.obs import default_registry

    tl, trace = getattr(default_registry(), "timeline", None), run.device_trace
    win = tl.window(*run.window) if tl is not None and trace is not None else None
    if win is None:
        return None
    ticks, steps = win.named("engine.tick"), win.under("model.decode", "engine.tick")
    secs = win.device_s(steps, trace.busy()) if steps else None
    return 1e3 * secs / len(ticks) if ticks and secs is not None else None
