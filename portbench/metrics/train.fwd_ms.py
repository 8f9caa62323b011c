"""The ``train.forward`` spans of a step (one a microbatch:
``Model.loss``), summed, mean per training step (``train.step``) in the
window.  The card's busy time (``run.device_trace``'s operations) inside
the spans' device intervals, from the program's timeline
(``repro_torch.obs``).  Nothing without the trace or the timeline, where
the window lost a record or a device interval is missing."""


def read(run):
    from repro_torch.obs import default_registry

    tl, trace = getattr(default_registry(), "timeline", None), run.device_trace
    win = tl.window(*run.window) if tl is not None and trace is not None else None
    if win is None:
        return None
    steps, parts = win.named("train.step"), win.under("train.forward", "train.step")
    secs = win.device_s(parts, trace.busy()) if parts else None
    return 1e3 * secs / len(steps) if steps and secs is not None else None
