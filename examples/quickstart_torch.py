"""Quickstart — the paper in 60 seconds (the PyTorch/CUDA port's).

Reproduces Example 1 / Discussion 1 / Example 2 (the exact numbers from
§IV), shows the TS ledger state, then runs the same scheduler as the
training fleet's shard-placement control plane.

    PYTHONPATH=src python examples/quickstart_torch.py                    # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --backend numpy    # on a CPU

The planning scan runs on ``--backend`` (default ``cuda``: the kernel,
which needs a card).
"""
import argparse

from repro_torch.core import SCHEDULERS, replay
from repro_torch.core.examples_fig import PAPER_MAKESPAN, example1_instance
from repro_torch.core.topology import tpu_dcn_fabric
from repro_torch.data import plan_epoch, uniform_shards
from repro_torch.kernels import ts_plan


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--backend", default="cuda", choices=["cuda", "torch", "numpy"],
                    help="the planning scan's backend (kernels/ts_plan.py): the kernel on "
                         "the card, its plain PyTorch version, or numpy")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    ts_plan.set_backend(_args(argv).backend)
    print("=" * 64)
    print("BASS — Bandwidth-Aware Scheduling with SDN (Qin et al., 2014)")
    print("=" * 64)

    print("\n[1] Paper Example 1 / Fig. 4 — 9 tasks, 4 nodes, 100 Mbps:")
    for name, label in [("hds", "HDS"), ("bar", "BAR"), ("bass", "BASS"),
                        ("prebass", "Pre-BASS")]:
        inst = example1_instance()
        sched = SCHEDULERS[name](inst)
        ok = replay(inst, sched).ok
        print(f"    {label:9s} makespan {sched.makespan:5.1f} s "
              f"(paper: {PAPER_MAKESPAN[label]:.0f} s)  "
              f"LR {sched.locality_ratio:.0%}  replay={'OK' if ok else 'FAIL'}")

    inst = example1_instance()
    sched = SCHEDULERS["bass"](inst)
    a1 = next(a for a in sched.assignments if a.tid == 1)
    print(f"\n[2] TK1 detail: runs on {a1.node}, completes at {a1.finish:.0f} s,"
          f" transfer reserved slots TS{a1.transfer.slots[0]}..TS{a1.transfer.slots[-1]}"
          f" on {', '.join(sched.ledger.link_names(a1.transfer.links))}")
    print(f"    ledger utilization: {sched.ledger.utilization():.2%} of link-slots")

    print("\n[3] Same scheduler, TPU fleet: place 64 input shards on 16 hosts")
    fabric = tpu_dcn_fabric(n_pods=2, hosts_per_pod=8)
    hosts = [f"pod{p}/host{h}" for p in range(2) for h in range(8)]
    shards = uniform_shards(64, hosts, size_bytes=512e6, replication=3)
    assigns, plan = plan_epoch(fabric, hosts, {h: 0.0 for h in hosts}, shards)
    local = sum(1 for a in assigns if a.source is None)
    remote = len(assigns) - local
    print(f"    {local} local reads, {remote} bandwidth-reserved remote "
          f"fetches, epoch ingest makespan {plan.makespan:.2f} s")
    print("\nNext: examples/train_e2e_torch.py, examples/serve_batch_torch.py, "
          "examples/bass_cluster_demo_torch.py")


if __name__ == "__main__":
    main()
