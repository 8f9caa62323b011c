"""The paper's contribution: BASS bandwidth-aware scheduling with an SDN-style
global fabric view and Time-Slot bandwidth allocation, with the planning
scan bound to ``repro_torch.kernels.ts_plan``.

This package carries the scheduling core's numpy modules unchanged; only
the kernel seam (``kernels/``) is PyTorch and CUDA, and importing this
package imports neither.

Public API:

``Fabric``/``TimeSlotLedger``   — the controller's network view + TS ledger
``ClusterController``           — the online event loop (multi-job streams)
``ClusterState``/``POLICIES``   — shared world + pluggable per-event policies
``schedule_bass``               — Algorithm 1 (offline wrapper)
``replay``/``replay_online``/``evaluate_mapreduce`` — verification + metrics
"""
from .topology import (
    Fabric,
    UnroutableError,
    paper_fig2_fabric,
    storage_hosts,
    tpu_dcn_fabric,
    two_tier_fabric,
)
from .timeslot import TimeSlotLedger, TransferPlan
from .tasks import (
    Assignment,
    BackgroundFlow,
    Instance,
    Schedule,
    Task,
    completion_time,
    execution_time,
    movement_time,
)
from .controller import (
    POLICIES,
    BarPolicy,
    BassPolicy,
    ClusterController,
    ClusterState,
    HdsPolicy,
    PreBassPolicy,
    RetryPolicy,
    SchedulingPolicy,
    run_policy,
)
from .bass import schedule_bass
from .simulator import JobMetrics, ReplayReport, evaluate_mapreduce, replay, replay_online

__all__ = [
    "Assignment",
    "BackgroundFlow",
    "BarPolicy",
    "BassPolicy",
    "ClusterController",
    "ClusterState",
    "Fabric",
    "HdsPolicy",
    "Instance",
    "JobMetrics",
    "POLICIES",
    "PreBassPolicy",
    "ReplayReport",
    "RetryPolicy",
    "Schedule",
    "SchedulingPolicy",
    "Task",
    "TimeSlotLedger",
    "TransferPlan",
    "UnroutableError",
    "completion_time",
    "evaluate_mapreduce",
    "execution_time",
    "movement_time",
    "paper_fig2_fabric",
    "replay",
    "replay_online",
    "run_policy",
    "schedule_bass",
    "storage_hosts",
    "tpu_dcn_fabric",
    "two_tier_fabric",
]
