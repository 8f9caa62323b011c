"""An admission's cache work: the prefill's k/v padded to the caches'
length (``prefill.pad``) and the copy into the slot
(``engine.write_slot``), summed, mean per admission (``engine.admit``)
in the window.  The card's busy time (``run.device_trace``'s operations)
inside the spans' device intervals, from the program's timeline
(``repro_torch.obs``).  Nothing without the trace or the timeline, where
the window lost a record or a device interval is missing."""


def read(run):
    from repro_torch.obs import default_registry

    tl, trace = getattr(default_registry(), "timeline", None), run.device_trace
    win = tl.window(*run.window) if tl is not None and trace is not None else None
    if win is None:
        return None
    admits = win.named("engine.admit")
    pad, write = win.under("prefill.pad", "engine.admit"), win.under("engine.write_slot",
                                                                     "engine.admit")
    secs = win.device_s(pad + write, trace.busy()) if pad and write else None
    return 1e3 * secs / len(admits) if admits and secs is not None else None
