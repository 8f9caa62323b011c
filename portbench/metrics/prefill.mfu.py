"""The prefills' share of the card's bfloat16 peak: the FLOPs the
window's prompts need (``harness/flops.py::prefill_flops``: projections and
MLP at every position, causal attention at the pairs the mask keeps, the
head at the last position) over the summed seconds of their admissions."""
from portbench.harness import flops


def read(run):
    inside = [r for r in run.requests if r["inside"]]
    secs = sum(r["first"] - r["start"] for r in inside)
    if not secs or run.device != "cuda":
        return None
    work = sum(flops.prefill_flops(run.dims, r["n"]) for r in inside)
    return 100.0 * work / secs / flops.PEAK_BF16_FLOPS
