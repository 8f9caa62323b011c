"""Roofline accounting of a step: the reference's formulas at the card's
own constants.

The port's counterpart of XLA's cost analysis is ``kernels/cost.py``: it
counts a step's FLOPs, bytes and live memory by aten op, on ``meta``
tensors as on the card.  What the reference's ``launch/hlo_analysis.py``
builds on those counts is kept here unchanged — the wire-byte model of a
collective (``_wire_bytes``, ``Collective``, ``CollectiveReport``), the
roofline terms (``RooflineTerms``), ``model_flops_estimate`` and the mamba
time scan's ``ssm_scan_addendum`` — so they give the reference's numbers
on the same inputs.

The TPU v5e constants become one record per card, :class:`Chip`, keyed by
the name ``nvidia-smi`` prints; :func:`roofline_terms` takes one.  The
reference's HLO-text parser (``parse_collectives`` and its replica-group
helpers) is not carried: no torch program produces XLA's partitioned HLO.
Its counterpart is :func:`counting_collectives`, a context in which every
collective the port issues through ``distributed/collectives.py`` (the
expert-parallel MoE block's and the reassembly of its output, and the
sharded model's, on real ranks or on a recording mesh's ``meta``
tensors) adds one :class:`Collective` to a :class:`CollectiveReport`,
under XLA's name for its kind (``all-gather``, ``all-reduce``,
``reduce-scatter``, ``all-to-all``), with its group's size, its result's
bytes and whether its group spans the ``pod`` axis (``crosses_pod``, the
reference's replica-group test).

Wire-byte model per participating device (ring algorithms):
  all-gather: R·(g−1)/g   all-reduce: 2·M·(g−1)/g   reduce-scatter: S·(g−1)
  all-to-all: R·(g−1)/g   collective-permute: R
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple


@dataclass(frozen=True)
class Chip:
    """One card's peaks: dense bf16 tensor-core FLOP/s, HBM bytes/s, the
    device-to-device link's bytes/s per direction, and the bytes/s of the
    network between hosts per card; float32 and float64 vector FLOP/s."""

    name: str
    peak_bf16_flop_s: float
    hbm_bytes_s: float
    link_bytes_s: float
    dcn_bytes_s: float
    peak_f32_flop_s: float
    peak_f64_flop_s: float


#: H100 SXM5 (NVIDIA H100 Tensor Core GPU data sheet): 989 TFLOP/s dense
#: bf16, 3.35 TB/s HBM3, NVLink 4 at 900 GB/s both ways (450 GB/s each
#: way), 67 TFLOP/s float32 and 34 TFLOP/s float64 vector; between hosts
#: one 400 Gb/s NIC per card (the DGX H100's layout).
H100_SXM = Chip(
    name="NVIDIA H100 80GB HBM3",
    peak_bf16_flop_s=989e12,
    hbm_bytes_s=3.35e12,
    link_bytes_s=450e9,
    dcn_bytes_s=50e9,
    peak_f32_flop_s=67e12,
    peak_f64_flop_s=34e12,
)

#: Chip records by the name ``nvidia-smi`` (and ``torch.cuda.get_device_name``) prints.
CHIPS: Dict[str, Chip] = {H100_SXM.name: H100_SXM}


def chip_named(name: str) -> Chip:
    """The record of the card ``name``; a ``KeyError`` for a card without
    one, so that no share is computed against another card's peaks."""
    if name not in CHIPS:
        raise KeyError(f"no chip record for {name!r}; known: {sorted(CHIPS)}")
    return CHIPS[name]


@dataclass
class Collective:
    kind: str
    result_bytes: int
    group: int
    trips: int
    wire_bytes: float
    path: str
    crosses_pod: bool = False


@dataclass
class CollectiveReport:
    ops: List[Collective] = field(default_factory=list)

    def total_wire_bytes(
        self,
        max_group: Optional[int] = None,
        min_group: int = 0,
        dcn: Optional[bool] = None,
    ) -> float:
        return sum(
            c.wire_bytes * c.trips
            for c in self.ops
            if (max_group is None or c.group <= max_group)
            and c.group > min_group
            and (dcn is None or c.crosses_pod == dcn)
        )

    def by_kind(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for c in self.ops:
            out[c.kind] = out.get(c.kind, 0.0) + c.wire_bytes * c.trips
        return out

    def count(self) -> int:
        return len(self.ops)


_reports: List[CollectiveReport] = []


@contextlib.contextmanager
def counting_collectives() -> Iterator[CollectiveReport]:
    """While active, every collective issued through
    ``distributed/collectives.py`` on a group of more than one rank appends
    one op (trips 1) to the report it yields, in issue order; nested
    contexts each see it."""
    report = CollectiveReport()
    _reports.append(report)
    try:
        yield report
    finally:
        _reports.remove(report)


def record_collective(kind: str, result_bytes: int, group: int, path: str,
                      crosses_pod: bool = False) -> None:
    """Count one collective in every active :func:`counting_collectives`;
    ``crosses_pod``: its group spans the ``pod`` axis, so its wire bytes
    go over the network between pods (the reference derives the same from
    the replica groups)."""
    for report in _reports:
        report.ops.append(Collective(kind, int(result_bytes), group, 1,
                                     _wire_bytes(kind, result_bytes, group), path,
                                     crosses_pod))


def _wire_bytes(kind: str, result_bytes: int, g: int) -> float:
    if g <= 1:
        return 0.0
    if kind == "all-gather":
        return result_bytes * (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)
    if kind == "all-to-all":
        return result_bytes * (g - 1) / g
    return float(result_bytes)  # collective-permute


# ---------------------------------------------------------------------------
# Roofline terms
# ---------------------------------------------------------------------------


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_ici_s: float
    collective_dcn_s: float
    hlo_flops_global: float
    hlo_bytes_global: float
    wire_bytes_ici: float
    wire_bytes_dcn: float
    model_flops: float
    chips: int
    chip: Chip = H100_SXM

    @property
    def collective_s(self) -> float:
        return self.collective_ici_s + self.collective_dcn_s

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        return self.model_flops / self.hlo_flops_global if self.hlo_flops_global else 0.0

    @property
    def roofline_fraction(self) -> float:
        """(useful compute time) / (achievable step time lower bound)."""
        useful_s = self.model_flops / (self.chips * self.chip.peak_bf16_flop_s)
        t = self.step_time_lower_bound_s
        return useful_s / t if t > 0 else 0.0

    def to_dict(self) -> Dict[str, float]:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_ici_s": self.collective_ici_s,
            "collective_dcn_s": self.collective_dcn_s,
            "hlo_flops_global": self.hlo_flops_global,
            "hlo_bytes_global": self.hlo_bytes_global,
            "wire_bytes_ici": self.wire_bytes_ici,
            "wire_bytes_dcn": self.wire_bytes_dcn,
            "model_flops": self.model_flops,
            "chips": self.chips,
            "dominant": self.dominant,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


def roofline_terms(
    hlo_flops_global: float,
    hlo_bytes_global: float,
    collectives: CollectiveReport,
    chips: int,
    model_flops: float,
    intra_pod: int = 256,
    chip: Chip = H100_SXM,
) -> RooflineTerms:
    wire_ici = collectives.total_wire_bytes(dcn=False)
    wire_dcn = collectives.total_wire_bytes(dcn=True)
    return RooflineTerms(
        compute_s=hlo_flops_global / (chips * chip.peak_bf16_flop_s),
        memory_s=hlo_bytes_global / (chips * chip.hbm_bytes_s),
        collective_ici_s=wire_ici / chip.link_bytes_s,
        collective_dcn_s=wire_dcn / chip.dcn_bytes_s,
        hlo_flops_global=hlo_flops_global,
        hlo_bytes_global=hlo_bytes_global,
        wire_bytes_ici=wire_ici,
        wire_bytes_dcn=wire_dcn,
        model_flops=model_flops,
        chips=chips,
        chip=chip,
    )


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D for training, 2·N_active·D for a forward-only
    step (prefill), 2·N_active per token for decode."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    # decode: one token per sequence in the batch
    return 2.0 * n_active * shape.global_batch


def ssm_scan_addendum(cfg, shape, accum_trips: int = 1) -> Tuple[float, float]:
    """(flops, bytes) of the mamba time-scan interior that loop-once HLO
    accounting misses.  Per step & channel & state: ~6 flops (exp, 2 mul-add
    into h, mul-add into y) on [B, d_in, N] f32."""
    if cfg.family not in ("ssm", "hybrid"):
        return 0.0, 0.0
    n_mamba = sum(1 for l in range(cfg.n_layers) if not cfg.is_attn_layer(l))
    if shape.kind == "decode":
        steps = 1
        bsz = shape.global_batch
    else:
        steps = shape.seq_len
        bsz = shape.global_batch
    per_step = bsz * cfg.d_inner * cfg.ssm_state
    flops = 6.0 * per_step * steps * n_mamba
    fwd_bwd = 3.0 if shape.kind == "train" else 1.0
    flops *= fwd_bwd
    bytes_ = 4.0 * 4 * per_step * steps * n_mamba * fwd_bwd  # h rw + inputs
    return flops, bytes_
