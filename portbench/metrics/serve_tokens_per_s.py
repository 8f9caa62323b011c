"""Prompt tokens prefilled and tokens generated, by every admission and
tick of the window, over the window's seconds (host clock)."""


def read(run):
    if not run.work:
        return None
    t0, t1 = run.window
    return sum(n for _, _, n in run.work) / (t1 - t0)
