"""Failure-aware rerouting, end to end — the paper's SDN story made runnable
(the PyTorch/CUDA port's).

A Table-I Sort workload (600 MB, 64 MB blocks, 100 Mbps links, background
cross-traffic) is scheduled by multipath BASS on a 2-leaf/2-spine Clos —
the same worker set as the paper's testbed, but with real path diversity.
Mid-run one spine link is killed: the controller releases every affected
transfer's unconsumed time slots, replans the remaining bytes on the best
surviving candidate path, rewrites the flow tables, and retimes the node
queues.  The reroute log below is the whole story.

    PYTHONPATH=src python examples/failover_demo_torch.py                    # on the card
    PYTHONPATH=src python examples/failover_demo_torch.py --backend numpy    # on a CPU

The planning scan runs on ``--backend`` (default ``cuda``: the kernel,
which needs a card).
"""
import argparse

from repro_torch.core.controller import BassPolicy, ClusterController
from repro_torch.core.workloads import SORT, make_instance
from repro_torch.kernels import ts_plan
from repro_torch.net import oversubscribed_leaf_spine


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--backend", default="cuda", choices=["cuda", "torch", "numpy"],
                    help="the planning scan's backend (kernels/ts_plan.py): the kernel on "
                         "the card, its plain PyTorch version, or numpy")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    ts_plan.set_backend(_args(argv).backend)
    # Table-I Sort @ 600 MB → 10 map tasks over workers H0..H5 with
    # background flows; re-homed onto a 2-spine Clos (same host names).
    inst, _reduce, _sz = make_instance(SORT, 600.0, seed=5)
    fabric = oversubscribed_leaf_spine(
        n_leaves=2, n_spines=2, hosts_per_leaf=3,
        host_mbps=100.0, spine_mbps=100.0,
    )
    ctrl = ClusterController(
        fabric, inst.workers, BassPolicy(multipath=True),
        idle=inst.idle, background=inst.background,
    )
    ctrl.submit(inst.tasks, at=0.0)
    ctrl.run_until(0.0)

    moved = [a for a in ctrl.jobs[0].assignments if a.transfer is not None
             and a.transfer.slot_fracs]
    print(f"[1] placed {len(inst.tasks)} Sort map tasks "
          f"({len(moved)} with TS-reserved transfers)")
    for a in moved:
        links = ctrl.state.ledger.link_names(a.transfer.links)
        print(f"    TK{a.tid}: {a.source} -> {a.node}  "
              f"window {a.transfer.start:.1f}-{a.transfer.end:.1f} s  "
              f"via {'/'.join(links)}")
    print(f"    flow rules installed: {ctrl.dataplane.tables.n_rules()}")

    # Kill a spine link carried by an in-flight transfer (cross-leaf
    # transfers traverse ls/L<leaf>S<spine> hops).
    victim, t_fail = "ls/L0S0", 5.0
    for a in moved:
        spine_hops = [n for n in ctrl.state.ledger.link_names(a.transfer.links)
                      if n.startswith("ls/")]
        if spine_hops:
            victim = spine_hops[0]
            t_fail = (a.transfer.start + a.transfer.end) / 2.0
            break
    print(f"\n[2] spine link {victim} fails at t={t_fail:.1f} s")
    ctrl.fail_link(victim, at=t_fail)
    ctrl.recover_link(victim, at=t_fail + 60.0)
    ctrl.run()

    print(f"\n[3] reroute log ({len(ctrl.reroute_log)} entries)")
    for rec in ctrl.reroute_log:
        print(f"    {rec}")
    if not ctrl.reroute_log:
        print("    (no transfer was crossing the dead link — rerun with "
              "another seed)")

    m = ctrl.job_metrics(0)
    print(f"\n[4] job completed: JT={m.jt:.1f} s  MT={m.mt:.1f} s  "
          f"LR={m.lr:.2f}  rerouted transfers={m.rerouted}")
    assert (ctrl.state.ledger.reserved <= 1.0 + 1e-6).all()


if __name__ == "__main__":
    main()
