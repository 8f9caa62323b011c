"""K2's (``kernels/csrc/flash_attention.cu``) share of its roofline in the
traced window: the summed least time of its launches (each prefill's
layers at that prompt's length, ``harness/flops.py::attention_bound_s``)
over their summed device time in the profiler's trace.  Nothing where the
trace's count of K2's kernels is not the program's count of launches."""
from portbench.harness import flops

KERNEL = "flash_fwd"


def read(run):
    trace = run.device_trace
    if trace is None:
        return None
    ops = [b - a for name, a, b in trace.ops if KERNEL in name]
    if not ops or len(ops) != run.counters.get("k2_launches"):
        return None
    bound = sum(run.dims.n_layers * flops.attention_bound_s(run.dims, r["n"])
                for r in run.requests if r["inside"])
    return 100.0 * bound / sum(ops)
