"""The paper's worked Example 1 / Discussion 1 / Example 2 instance (Fig. 2/3).

Fig. 3 is an image; the per-task replica map is not fully written out in
prose, so we derived one consistent with *every* number in §IV (see
DESIGN.md §3): the HDS trace (N1:{2,3,7} N2:{1,6} N3:{4} N4:{5,8,9}, 39 s),
BAR's TK9→N3 move (38 s), BASS's TK1→N1 at ΥC=17 s with slots TS4..TS8 on
Link1+Link2 and makespan 35 s via TK9 on N1, and Pre-BASS's 34 s with TK8
the last finisher.

Units: capacity in Mbps, size in Mbit.  The paper rounds 64 MB @ 100 Mbps
(5.12 s) to TM = 5 s; we use SZ = 500 Mbit so the arithmetic is exact.
"""
from __future__ import annotations

from typing import Dict, Tuple

from .tasks import Instance, Task
from .topology import paper_fig2_fabric

# Replica placement derived in DESIGN.md §3.
REPLICAS: Dict[int, Tuple[str, str]] = {
    1: ("N2", "N3"),
    2: ("N1", "N4"),
    3: ("N1", "N2"),
    4: ("N3", "N1"),
    5: ("N4", "N2"),
    6: ("N2", "N3"),
    7: ("N1", "N3"),
    8: ("N4", "N1"),
    9: ("N3", "N1"),
}

INITIAL_IDLE = {"N1": 3.0, "N2": 9.0, "N3": 20.0, "N4": 7.0}
TP = 9.0          # task computation time (homogeneous nodes), §IV Example 1
SIZE = 500.0      # Mbit → TM = 5 s at 100 Mbps, paper's rounded figure
LINK_MBPS = 100.0
SLOT = 1.0        # "We set each time slot TS_k to be 1s in this paper"


def example1_instance() -> Instance:
    fabric = paper_fig2_fabric(LINK_MBPS)
    tasks = [
        Task(tid=i, size=SIZE, compute=TP, replicas=REPLICAS[i])
        for i in range(1, 10)
    ]
    return Instance(
        fabric=fabric,
        workers=["N1", "N2", "N3", "N4"],
        idle=dict(INITIAL_IDLE),
        tasks=tasks,
        slot_duration=SLOT,
    )


# Ground-truth figures from the paper text (§IV, Fig. 4).
PAPER_MAKESPAN = {"BASS": 35.0, "BAR": 38.0, "HDS": 39.0, "Pre-BASS": 34.0}
PAPER_TK1 = {"node": "N1", "completion": 17.0, "slots": (4, 5, 6, 7, 8)}
PAPER_HDS_ALLOC = {
    "N1": {2, 3, 7},
    "N2": {1, 6},
    "N3": {4},
    "N4": {5, 8, 9},
}
