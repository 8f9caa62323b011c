"""Mean host span of a `ServeEngine.admit` in the window: the prefill, the
slot's cache written, the first token read back (a synchronise)."""


def read(run):
    return run.spans.mean_ms("admit", *run.window)
