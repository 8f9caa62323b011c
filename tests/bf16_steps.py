"""Distance between two bfloat16 tensors in bfloat16 steps (a helper of the
RMSNorm tests on the CPU and on the card; imports torch alone)."""
import torch


def bf16_steps(a, b):
    """The largest distance in bfloat16 steps between two bf16 tensors, and
    the share of equal elements."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    d = (ordered(a) - ordered(b)).abs()
    return int(d.max()), float((d == 0).float().mean())
