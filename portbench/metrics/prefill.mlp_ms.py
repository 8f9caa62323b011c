"""The ``layer.mlp`` spans under ``model.prefill`` (each layer's MLP or
MoE, without its norm), summed, mean per admission (``engine.admit``) in
the window.  The card's busy time (``run.device_trace``'s operations)
inside the spans' device intervals, from the program's timeline
(``repro_torch.obs``).  Nothing without the trace or the timeline, where
the window lost a record or a device interval is missing."""


def read(run):
    from repro_torch.obs import default_registry

    tl, trace = getattr(default_registry(), "timeline", None), run.device_trace
    win = tl.window(*run.window) if tl is not None and trace is not None else None
    if win is None:
        return None
    admits, parts = win.named("engine.admit"), win.under("layer.mlp", "model.prefill")
    secs = win.device_s(parts, trace.busy()) if parts else None
    return 1e3 * secs / len(admits) if admits and secs is not None else None
