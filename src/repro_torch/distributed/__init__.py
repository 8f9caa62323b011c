"""Distribution: sharding rules, activation constraints, gradient
compression, the cross-pod DCN sync (the pod all-reduce and its BASS
bookkeeping), the counted collectives of the expert-parallel MoE block and
the sharded dense model, forward and backward (``collectives``), and a
launcher of ``torch.distributed`` ranks (``ranks``)."""
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
