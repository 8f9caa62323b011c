"""The share of the traced window in which no operation ran on the card:
1 − the union of the device operations' intervals over the window."""


def read(run):
    trace = run.device_trace
    if trace is None:
        return None
    t0, t1 = trace.window
    return 100.0 * (1.0 - trace.busy_s() / (t1 - t0))
