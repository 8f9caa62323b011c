"""Mean host span of a step's `SyntheticLM.batch` in the window (the
upload after it waits on the card's queue and has a span of its own)."""


def read(run):
    return run.spans.mean_ms("data", *run.window)
