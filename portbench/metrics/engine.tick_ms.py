"""Mean host span of a `ServeEngine.tick` in the window: one decode step of
every slot, its tokens read back (a synchronise)."""


def read(run):
    return run.spans.mean_ms("tick", *run.window)
