"""Seconds from the process's start to the window's: imports, weights,
the program's state and the warm-up of every shape the window uses
(host clock)."""


def read(run):
    return run.window[0] - run.t_process0
