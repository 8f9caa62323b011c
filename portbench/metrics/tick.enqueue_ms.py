"""Host time of ``model.decode`` inside a tick (``engine.tick``): the
Python that launches the decode step's layers, mean per tick in the
window, from the program's timeline (``repro_torch.obs``).  Nothing
without the timeline or where the window lost a record."""


def read(run):
    from repro_torch.obs import default_registry

    tl = getattr(default_registry(), "timeline", None)
    win = tl.window(*run.window) if tl is not None else None
    if win is None:
        return None
    ticks, steps = win.named("engine.tick"), win.under("model.decode", "engine.tick")
    return 1e3 * win.host_s(steps) / len(ticks) if ticks and steps else None
