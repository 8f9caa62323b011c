"""Distribution: cross-pod DCN sync bookkeeping (:class:`StepFlow`,
:class:`CrossPodSync`).  The sharding rules, gradient compression and the
cross-pod all-reduce wait for ROADMAP.md §1 item 7."""
from .dcn import CrossPodSync, StepFlow

__all__ = ["CrossPodSync", "StepFlow"]
