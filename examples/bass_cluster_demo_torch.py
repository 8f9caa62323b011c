"""BASS as a fleet control plane — the paper's algorithm running every
DCN-visible traffic class of a 2-pod training job on one shared ledger:

  Q1  cross-pod gradient sync   (reserved a step ahead, Pre-BASS style)
  Q2  input-shard prefetches    (locality + bandwidth-aware placement)
  Q3  checkpoint pushes         (background; yields to Q1/Q2)

plus ProgressRate straggler detection (§V.A) triggering speculative
re-dispatch through Case 2 (the PyTorch/CUDA port's).

    PYTHONPATH=src python examples/bass_cluster_demo_torch.py                    # on the card
    PYTHONPATH=src python examples/bass_cluster_demo_torch.py --backend numpy    # on a CPU

The planning scan runs on ``--backend`` (default ``cuda``: the kernel,
which needs a card).
"""
import argparse

import numpy as np

from repro_torch.core.qos import Flow, QosPort, QueueSpec
from repro_torch.core.topology import tpu_dcn_fabric
from repro_torch.data import plan_epoch, prefetch_epoch, uniform_shards
from repro_torch.distributed.dcn import CrossPodSync
from repro_torch.kernels import ts_plan
from repro_torch.runtime import ProgressTracker


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--backend", default="cuda", choices=["cuda", "torch", "numpy"],
                    help="the planning scan's backend (kernels/ts_plan.py): the kernel on "
                         "the card, its plain PyTorch version, or numpy")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    ts_plan.set_backend(_args(argv).backend)
    n_pods, hosts_per_pod = 2, 16
    fabric = tpu_dcn_fabric(n_pods, hosts_per_pod)
    hosts = [f"pod{p}/host{h}" for p in range(n_pods) for h in range(hosts_per_pod)]

    print("[1] Q1 — cross-pod grad sync (12 B-param model, bf16 grads/pod)")
    sync = CrossPodSync(fabric, n_pods, hosts_per_pod,
                        grad_bytes=12e9 * 2, compress=False)
    flow = sync.reserve_step(step=1, not_before=0.0)
    print(f"    uncompressed: {sync.wire_bytes()/1e9:6.1f} GB over DCN, "
          f"window {flow.plan.start:.2f}–{flow.plan.end:.2f} s")
    sync_c = CrossPodSync(fabric, n_pods, hosts_per_pod,
                          grad_bytes=12e9 * 2, compress=True)
    flow_c = sync_c.reserve_step(step=1, not_before=0.0)
    print(f"    int8+error-feedback: {sync_c.wire_bytes()/1e9:6.1f} GB, "
          f"window {flow_c.plan.start:.2f}–{flow_c.plan.end:.2f} s  (4× less wire)")

    print("\n[2] Q2 — epoch shard placement on the same fabric")
    shards = uniform_shards(96, hosts, size_bytes=512e6, replication=3, seed=7)
    backlog = {h: float(np.random.default_rng(0).uniform(0, 0.5)) for h in hosts}
    assigns, plan = plan_epoch(fabric, hosts, backlog, shards)
    local = sum(1 for a in assigns if a.source is None)
    print(f"    BASS:     {local}/{len(assigns)} local, ingest makespan "
          f"{plan.makespan:.2f} s")
    assigns_p, plan_p = prefetch_epoch(fabric, hosts, backlog, shards)
    print(f"    Pre-BASS: ingest makespan {plan_p.makespan:.2f} s "
          f"(prefetched into reserved slots)")

    print("\n[3] Q3 — checkpoint pushes behind grad sync (QoS port model)")
    port = QosPort(400.0, [QueueSpec("grad", 300.0, 0),
                           QueueSpec("data", 80.0, 1),
                           QueueSpec("ckpt", 20.0, 2)])
    done = port.simulate([
        Flow("grad_sync", 100 * 8, "grad"),
        Flow("ckpt_push", 400 * 8, "ckpt"),
    ])
    print(f"    grad sync finishes {done['grad_sync']:.2f} s; checkpoint "
          f"drains at {done['ckpt_push']:.2f} s without delaying it")

    print("\n[4] ProgressRate straggler detection (§V.A)")
    tr = ProgressTracker(straggler_factor=2.0)
    for i, score in enumerate([0.6, 0.55, 0.62, 0.58, 0.07]):
        tr.start(i, hosts[i], now=0.0)
        tr.update(i, score, now=30.0)
    stragglers = tr.stragglers(now=30.0)
    idle = tr.worker_idle_times(now=30.0)
    worst = max(idle, key=idle.get)
    print(f"    straggler tasks: {stragglers} on {worst} "
          f"(ΥI={idle[worst]:.0f} s vs median ~20 s) → speculative "
          f"re-dispatch via BASS Case 2")


if __name__ == "__main__":
    main()
