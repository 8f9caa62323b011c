"""Distribution: sharding rules, activation constraints, gradient
compression, and the cross-pod DCN sync (the pod all-reduce and its BASS
bookkeeping).  MoE's expert-parallel all-to-all is not ported
(ROADMAP.md §1 item 7)."""
from .dcn import CrossPodSync, StepFlow, cross_pod_allreduce
from .sharding import (
    ACT_RULES_DECODE,
    ACT_RULES_TRAIN,
    PARAM_RULES,
    NamedSharding,
    cache_shardings,
    param_shardings,
    replication_report,
    spec_for,
)

__all__ = [
    "ACT_RULES_DECODE",
    "ACT_RULES_TRAIN",
    "PARAM_RULES",
    "CrossPodSync",
    "NamedSharding",
    "StepFlow",
    "cache_shardings",
    "cross_pod_allreduce",
    "param_shardings",
    "replication_report",
    "spec_for",
]
