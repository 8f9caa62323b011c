"""The training steps' share of the card's bfloat16 peak: the FLOPs a
step's inputs need (``harness/flops.py::train_step_flops``: forward and
backward of the layers at every position, of the tied head at the
positions the loss predicts, and of causal attention, without the
recomputation) of every step of the window, over the window's seconds."""
from portbench.harness import flops


def read(run):
    if not run.steps or run.device != "cuda":
        return None
    t0, t1 = run.window
    rows, seq = run.traffic["rows"], run.traffic["seq"]
    work = run.steps * flops.train_step_flops(run.dims, rows, seq)
    return 100.0 * work / (t1 - t0) / flops.PEAK_BF16_FLOPS
