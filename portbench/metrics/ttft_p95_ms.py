"""95th percentile of the time to first token of every request admitted
in the window: from its wave's start, when it was due, to the end of its
admission (host clock)."""
import numpy as np


def read(run):
    ttft = [r["first"] - r["due"] for r in run.requests if r["inside"]]
    return float(np.percentile(ttft, 95)) * 1e3 if ttft else None
