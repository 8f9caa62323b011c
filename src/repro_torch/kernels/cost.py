"""Counting a step's work: FLOPs, bytes and live memory, by aten op.

The port's counterpart of XLA's cost analysis (``lowered.cost_analysis()``
and ``compiled.memory_analysis()`` in the reference's
``launch/dryrun.py``).  :class:`CostCounter` is a ``TorchDispatchMode``
that sees every aten op a step issues, once, whatever device the tensors
are on — ``meta`` (no memory, no arithmetic), the CPU or the card — and
counts:

* **FLOPs** — matrix products by ``torch.utils.flop_counter``'s registered
  formulas (2·m·n·k); elementwise arithmetic one per output element, as
  XLA's ``HloCostAnalysis`` counts it (a few composite kernels, such as
  softmax or the tanh GELU, count the elementwise ops XLA would see in
  their decomposition); reductions one per input element; a cast between
  dtypes one per element (XLA's ``convert``).  Transcendentals (exp, log,
  sqrt, rsqrt, tanh, sigmoid, erf, sin, cos, pow) are counted apart and
  kept out of ``flops``, as XLA keeps them out.
* **bytes** — the bytes of each op's tensor inputs (the distinct elements
  a strided view reaches: a broadcast input is read once) plus those of
  its outputs.  An op that returns a view, and a bare allocation, count 0.
  A gather counts its output twice and its indices, and a scatter its
  updates twice and its indices, as XLA counts them: neither touches the
  rest of the table.
* **uncounted** — ops with no FLOP rule, by name and calls, so nothing
  vanishes silently (their bytes are counted).
* **live bytes** — the peak of the bytes of live storages, the caller's
  arguments counted as live, each storage tracked by a weak reference to
  it (``StorageWeakRef``), so the counter keeps nothing alive.

The hand-written kernels are pybind calls that no dispatch mode sees.  Each
kernel wrapper therefore counts its work by formula through
:func:`region`, which adds a count and suspends op counting inside, on
every device: the kernel on the card, the plain version on the CPU or
``meta``.  So a step counts the same on ``meta``, the CPU and the card.
Without an active counter a region is a shared null context.

Use::

    with CostCounter(params, opt_state, batch) as c:
        step(params, opt_state, batch)
    c.result()   # {"flops": ..., "bytes": ..., "live_peak_bytes": ..., ...}
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

#: The counters that are active, innermost last; a region counts into the last.
_ACTIVE: list = []
_NULL = contextlib.nullcontext()

#: Elementwise ops whose every output element is one transcendental (XLA's
#: exp, log, logistic, tanh, sqrt, rsqrt, power, sin, cos, erf, ...).
TRANSCENDENTAL = frozenset({
    "exp", "exp_", "exp2", "exp2_", "expm1", "log", "log_", "log2", "log10", "log1p",
    "sigmoid", "sigmoid_", "tanh", "tanh_", "sqrt", "sqrt_", "rsqrt", "rsqrt_", "sin",
    "cos", "tan", "erf", "erfinv", "atan2", "pow", "pow_",
})

#: Composite elementwise kernels: (FLOPs, transcendentals) per element of
#: their first tensor input, as XLA counts the decomposition the reference
#: lowers (``jax.nn.silu`` = x·logistic(x), the tanh GELU, ``logaddexp``
#: softplus, softmax = max, sub, exp, sum, div, and their gradients).
COMPOSITE = {
    "silu": (1, 1), "silu_": (1, 1), "silu_backward": (4, 1),
    "gelu": (7, 1), "gelu_backward": (12, 1),
    "softplus": (5, 2), "softplus_backward": (3, 1),
    "sigmoid_backward": (3, 0), "tanh_backward": (3, 0),
    "_softmax": (4, 1), "_softmax_backward_data": (4, 0),
    "_log_softmax": (4, 1), "_log_softmax_backward_data": (3, 1),
    "logsumexp": (3, 1),
    "addcmul": (2, 0), "addcmul_": (2, 0), "addcdiv": (2, 0), "addcdiv_": (2, 0),
    "lerp": (2, 0), "lerp_": (2, 0), "threshold_backward": (1, 0),
}

#: Reductions: one FLOP per input element (``mean`` also divides each output).
REDUCTION = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin", "any",
    "all", "cumsum", "cumprod", "cummax", "cummin", "linalg_vector_norm", "norm",
    "nansum", "logcumsumexp",
})

#: Scatter-adds: one FLOP per element added (XLA's scatter with an add).
SCATTER_ADD = frozenset({
    "index_add", "index_add_", "scatter_add", "scatter_add_", "embedding_dense_backward",
    "index_put", "index_put_", "_index_put_impl_", "scatter_reduce", "scatter_reduce_",
})

#: Data movement and allocation: no FLOPs.  A cast is counted apart.
MOVEMENT = frozenset({
    "clone", "copy", "copy_", "cat", "stack", "index", "index_select", "gather",
    "scatter", "scatter_", "masked_fill", "masked_fill_", "constant_pad_nd", "repeat",
    "repeat_interleave", "flip", "roll", "contiguous", "fill", "fill_", "zero", "zero_",
    "zeros", "zeros_like", "ones", "ones_like", "full", "full_like", "new_zeros",
    "new_ones", "new_full", "new_empty", "new_empty_strided", "empty", "empty_like",
    "empty_strided", "arange", "scalar_tensor", "lift_fresh", "lift_fresh_copy",
    "_to_copy", "tril", "triu", "slice_scatter", "select_scatter", "diagonal_scatter",
    "as_strided_scatter", "_unsafe_index", "index_fill", "index_fill_", "one_hot",
    "sort", "topk", "argsort", "nonzero", "unique", "_unique2", "bernoulli_",
    "normal_", "uniform_", "randn", "rand", "randint", "embedding", "narrow_copy",
    "split_with_sizes_copy", "unbind_copy", "_local_scalar_dense", "masked_scatter",
    "masked_select", "view_copy", "expand_copy", "permute_copy", "t_copy",
    "select_backward", "slice_backward", "index_select_backward",
})

#: Elementwise arithmetic without the ``pointwise`` tag: one FLOP per output element.
ARITHMETIC = frozenset({"floor_divide", "floor_divide_", "remainder", "fmod"})

#: Gathers read what they return (XLA's gather: the output twice and the
#: indices), not the whole table they index; scatters likewise write and
#: read only the elements they update.
GATHER = frozenset({"index", "index_select", "gather", "embedding", "_unsafe_index", "take"})
SCATTER = frozenset({
    "index_put", "index_put_", "_index_put_impl_", "index_add", "index_add_", "scatter",
    "scatter_", "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_",
    "index_copy", "index_copy_",
})

#: No work at all: allocations and metadata (no bytes either).
FREE = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "record_stream", "detach", "detach_", "_local_scalar_dense", "is_same_size",
    "set_", "resize_", "_has_compatible_shallow_copy_type", "sym_size", "sym_stride",
    "sym_numel", "sym_storage_offset", "lift_fresh", "_unsafe_view", "promote_types",
})


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _reach_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a (strided) tensor reaches."""
    if t.numel() == 0:
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class CostCounter(TorchDispatchMode):
    """Counts every aten op issued inside it; ``live`` are the caller's
    arguments (any tree of tensors), counted as live storage throughout."""

    def __init__(self, *live: Any) -> None:
        super().__init__()
        self._live_args = live
        self.flops = 0
        self.bytes = 0
        self.transcendentals = 0
        self.ops = 0
        self.by_op: Dict[str, list] = {}          # name → [calls, flops, bytes]
        self.uncounted: Dict[str, int] = {}
        self.regions: Dict[str, list] = {}        # name → [calls, flops, bytes]
        self._suspend = 0
        self._live: Dict[int, tuple] = {}        # storage cdata → (weak ref, bytes)
        self._upper = 0                          # live bytes, frees not yet seen
        self.live_peak_bytes = 0
        self.argument_bytes = 0

    # -- entering and leaving -------------------------------------------------
    def __enter__(self):
        for t in _tensors(self._live_args):
            self._track(t)
        self.argument_bytes = self._upper
        self.live_peak_bytes = self._upper
        self._live_args = None
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    # -- live storage ---------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        if self._upper + n > self.live_peak_bytes:
            self._scan()
        self._live[key] = (StorageWeakRef(st), n)
        self._upper += n
        self.live_peak_bytes = max(self.live_peak_bytes, self._upper)

    def _scan(self) -> None:
        """Drop the storages that died, so ``_upper`` is the exact live sum.
        Between scans it only overstates, so a scan is needed only where an
        allocation could set a new peak."""
        dead = [k for k, (ref, _) in self._live.items() if ref.expired()]
        for k in dead:
            self._upper -= self._live.pop(k)[1]

    # -- counting ---------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._suspend:
            self._count(func, args, kwargs, out)
        for t in _tensors(out):
            if t.layout == torch.strided:
                self._track(t)
        return out

    def _flops(self, func, name: str, args, kwargs, out) -> tuple:
        """→ (FLOPs, transcendentals), or None where no rule applies."""
        packet = func.overloadpacket
        if packet in flop_registry:
            return int(flop_registry[packet](*args, **kwargs, out_val=out)), 0
        if name in ("mv", "addmv"):
            m, n = (args[1] if name == "addmv" else args[0]).shape
            return 2 * m * n, 0
        if name == "dot":
            return 2 * args[0].numel(), 0
        first = next(_tensors(args), None)
        n_in = first.numel() if first is not None else 0
        outs = list(_tensors(out))
        n_out = outs[0].numel() if outs else 0
        if name in COMPOSITE:
            f, tr = COMPOSITE[name]
            return f * n_in, tr * n_in
        if name in REDUCTION:
            return n_in + (n_out if name == "mean" else 0), 0
        if name in SCATTER_ADD:
            if name in ("index_put", "index_put_", "_index_put_impl_"):
                accumulate = args[3] if len(args) > 3 else kwargs.get("accumulate", False)
                return (args[2].numel() if accumulate else 0), 0
            src = list(_tensors(args))[-1]
            return src.numel(), 0
        if name in ("_to_copy", "copy_", "copy"):
            src = args[1] if name != "_to_copy" else args[0]
            dst_dtype = outs[0].dtype if outs else src.dtype
            return (n_out if src.dtype != dst_dtype else 0), 0
        if name in MOVEMENT:
            return 0, 0
        if name in ("pow", "pow_") and len(args) > 1 and isinstance(args[1], (int, float)):
            e = float(args[1])
            if e.is_integer() and 1 <= e <= 4:   # XLA multiplies out an integer power
                return int(e - 1) * n_out, 0
        if name in TRANSCENDENTAL:
            return 0, n_out
        if torch.Tag.pointwise in func.tags or name in ARITHMETIC:
            alpha = kwargs.get("alpha", 1)
            extra = 1 if name in ("add", "add_", "sub", "sub_") and alpha != 1 else 0
            return (1 + extra) * n_out, 0
        return None

    def _count(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        self.ops += 1
        if name in FREE or _is_view(func):
            return
        fl = self._flops(func, name, args, kwargs, out)
        if fl is None:
            self.uncounted[name] = self.uncounted.get(name, 0) + 1
            fl = (0, 0)
        ins = list(_tensors((args, kwargs)))
        if name in GATHER:            # output written and read, and the indices
            nbytes = (sum(_reach_bytes(t) for t in ins[1:])
                      + 2 * sum(t.numel() * t.element_size() for t in _tensors(out)))
        elif name in SCATTER:         # the indices, and the updates read and written
            nbytes = sum(_reach_bytes(t) for t in ins[1:]) + _reach_bytes(ins[-1])
        else:
            nbytes = (sum(_reach_bytes(t) for t in ins)
                      + sum(t.numel() * t.element_size() for t in _tensors(out)))
        self.flops += fl[0]
        self.transcendentals += fl[1]
        self.bytes += nbytes
        rec = self.by_op.setdefault(name, [0, 0, 0])
        rec[0] += 1
        rec[1] += fl[0]
        rec[2] += nbytes

    def hold(self) -> None:
        """Stop counting ops (regions nest)."""
        self._suspend += 1

    def release(self) -> None:
        self._suspend -= 1

    def add_region(self, name: str, flops: int, bytes_: int) -> None:
        if self._suspend:
            return
        self.flops += int(flops)
        self.bytes += int(bytes_)
        rec = self.regions.setdefault(name, [0, 0, 0])
        rec[0] += 1
        rec[1] += int(flops)
        rec[2] += int(bytes_)

    def result(self) -> dict:
        return {
            "flops": self.flops, "bytes": self.bytes,
            "transcendentals": self.transcendentals, "ops": self.ops,
            "uncounted": dict(sorted(self.uncounted.items())),
            "regions": {k: dict(calls=v[0], flops=v[1], bytes=v[2])
                        for k, v in sorted(self.regions.items())},
            "live_peak_bytes": self.live_peak_bytes,
            "argument_bytes": self.argument_bytes,
        }


class _Region:
    __slots__ = ("counter",)

    def __init__(self, counter: CostCounter) -> None:
        self.counter = counter

    def __enter__(self):
        self.counter.hold()
        return self

    def __exit__(self, *exc):
        self.counter.release()
        return False


def region(name: str, flops, bytes_):
    """Count ``flops`` and ``bytes_`` under ``name`` in the active counter,
    and suspend op counting inside (allocations are still tracked).  A
    shared null context when no counter is active; inside another region
    it adds nothing."""
    if not _ACTIVE:
        return _NULL
    counter = _ACTIVE[-1]
    counter.add_region(name, flops, bytes_)
    return _Region(counter)


def formula_region(name: str, formula, *args):
    """:func:`region` of ``formula(*args)`` → (FLOPs, bytes), the formula
    evaluated only when a counter is active, so that a kernel wrapper's
    region costs next to nothing without one."""
    return region(name, *formula(*args)) if _ACTIVE else _NULL


def active() -> bool:
    return bool(_ACTIVE)


def current():
    """The innermost active counter, or None."""
    return _ACTIVE[-1] if _ACTIVE else None

