"""Positions (rows × sequence) of every training step of the window over
the window's seconds, which end in a synchronise (host clock)."""


def read(run):
    if not run.steps:
        return None
    t0, t1 = run.window
    return run.steps * run.step_positions / (t1 - t0)
