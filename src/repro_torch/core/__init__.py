"""The paper's contribution: BASS bandwidth-aware scheduling with an SDN-style
global fabric view, Time-Slot bandwidth allocation, the HDS/BAR baselines,
Pre-BASS prefetching, QoS queueing, and the evaluation simulator, with the
planning scan bound to ``repro_torch.kernels.ts_plan``.

This package carries the scheduling core's numpy modules unchanged; only
the kernel seam (``kernels/``) is PyTorch and CUDA, and importing this
package imports neither.

Public API:

``Fabric``/``TimeSlotLedger``   — the controller's network view + TS ledger
``ClusterController``           — the online event loop (multi-job streams)
``ClusterState``/``POLICIES``   — shared world + pluggable per-event policies
``schedule_bass``               — Algorithm 1 (offline wrapper)
``schedule_hds``/``schedule_bar`` — paper baselines (offline wrappers)
``schedule_prebass``            — Discussion-2 prefetching variant
``QosPort``                     — Discussion-3 OpenFlow queue model
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
from .faults import FaultPlan, HostCrash, LinkFlap, StragglerOnset
from .bass import schedule_bass
from .baselines import schedule_bar, schedule_hds
from .prebass import schedule_prebass
from .qos import Flow, QosPort, QueueSpec, example3_port, shuffle_vs_default, single_queue_port
from .simulator import JobMetrics, ReplayReport, evaluate_mapreduce, replay, replay_online

SCHEDULERS = {
    "bass": schedule_bass,
    "hds": schedule_hds,
    "bar": schedule_bar,
    "prebass": schedule_prebass,
}

__all__ = [
    "Assignment",
    "BackgroundFlow",
    "BarPolicy",
    "BassPolicy",
    "ClusterController",
    "ClusterState",
    "Fabric",
    "FaultPlan",
    "Flow",
    "HostCrash",
    "LinkFlap",
    "StragglerOnset",
    "HdsPolicy",
    "Instance",
    "JobMetrics",
    "POLICIES",
    "PreBassPolicy",
    "QosPort",
    "QueueSpec",
    "ReplayReport",
    "RetryPolicy",
    "SCHEDULERS",
    "Schedule",
    "SchedulingPolicy",
    "Task",
    "TimeSlotLedger",
    "TransferPlan",
    "UnroutableError",
    "completion_time",
    "evaluate_mapreduce",
    "example3_port",
    "execution_time",
    "movement_time",
    "paper_fig2_fabric",
    "replay",
    "replay_online",
    "run_policy",
    "schedule_bar",
    "schedule_bass",
    "schedule_hds",
    "schedule_prebass",
    "shuffle_vs_default",
    "single_queue_port",
    "storage_hosts",
    "tpu_dcn_fabric",
    "two_tier_fabric",
]
