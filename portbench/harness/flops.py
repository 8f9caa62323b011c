"""The yardstick's arithmetic: the chip's published peaks and the
operations and bytes that the inputs of each measured step need.  Counted
from shapes alone, never from the program; the rooflines and utilisations
divide these by measured times."""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12


def layer_params(dims) -> int:
    """Weights of one decoder layer's projections and MLP (the norms do no
    matrix work)."""
    d, hd = dims.d_model, dims.head_dim
    return d * (dims.n_heads + 2 * dims.n_kv_heads) * hd + dims.n_heads * hd * d + 3 * d * dims.d_ff


def causal_pairs(n: int) -> int:
    """(query, key) pairs a causal mask keeps over ``n`` positions."""
    return n * (n + 1) // 2


def attention_flops(dims, n: int, rows: int = 1) -> int:
    """One layer's causal attention forward: q·k and p·v, 2 FLOPs a
    multiply-add, at the pairs the mask keeps."""
    return 4 * rows * dims.n_heads * dims.head_dim * causal_pairs(n)


def prefill_flops(dims, n: int) -> int:
    """One request's prefill of ``n`` prompt positions: projections and MLP
    at every position, causal attention, the head at the last position."""
    return (2 * n * dims.n_layers * layer_params(dims) + dims.n_layers * attention_flops(dims, n)
            + 2 * dims.d_model * dims.vocab)


def attention_bound_s(dims, n: int, rows: int = 1) -> float:
    """Least time of one causal attention launch over ``n`` positions in
    bfloat16: its FLOPs at the peak, or q, k and v read once and the output
    written once at the memory's rate, whichever is longer."""
    nbytes = 2 * rows * n * dims.head_dim * (2 * dims.n_heads + 2 * dims.n_kv_heads)
    return max(attention_flops(dims, n, rows) / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S)


def train_step_flops(dims, rows: int, seq: int) -> int:
    """One training step over ``rows`` sequences of ``seq`` positions (the
    prefix included): forward and backward (3 × the forward) of the layers
    at every position, of the head at the positions the loss predicts, and
    of causal attention; the recomputation is not counted."""
    predicted = rows * (seq - dims.n_prefix - 1)
    return (6 * rows * seq * dims.n_layers * layer_params(dims)
            + 6 * predicted * dims.d_model * dims.vocab
            + 3 * dims.n_layers * attention_flops(dims, seq, rows))
