"""The port's scheduling slice held against the JAX package end to end.

The port's ``ClusterController`` (plain PyTorch backend on the CPU, ledger
mirror on a CPU device) is fed the reference's instances through ``repro_torch.convert``
and must emit byte-identical schedules and reroute logs (floats compared
via ``float.hex``).  Also pinned here: the paper's Example 1, the fabric
converter, and the port's import boundary.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from benchmarks.bench_sched_scale import fleet_instance
from repro.core.controller import ClusterController as RefController
from repro.core.tasks import Task as RefTask
from repro.core.topology import storage_hosts as ref_storage_hosts
from repro.net.fattree import fat_tree_fabric as ref_fat_tree
from repro_torch import convert
from repro_torch.core.controller import ClusterController
from repro_torch.kernels import ts_plan, ts_plan_device

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
SRC = os.path.join(ROOT, "src")


@pytest.fixture(params=["torch", "numpy"])
def backend(request):
    prev = ts_plan.get_backend()
    ts_plan.set_backend(request.param)
    yield request.param
    ts_plan.set_backend(prev)


def _stream(ctrl, tasks, batch=1024):
    for i in range(0, len(tasks), batch):
        ctrl.submit(tasks[i:i + batch], at=0.0)
        ctrl.run_until(0.0)
    return ctrl


@pytest.mark.parametrize("n_tasks", [600, 3000])
def test_fleet_slice_identical(backend, n_tasks):
    inst = fleet_instance(2, 32, n_tasks)
    ref = _stream(RefController.from_instance(inst), inst.tasks)
    port_inst = convert.instance_from_reference(inst)
    waves = ts_plan.calls["wave_scan"]
    port = _stream(ClusterController.from_instance(port_inst), port_inst.tasks)
    assert ts_plan.calls["wave_scan"] > waves  # the slice went through the scan
    assert convert.canon(port.schedule().assignments) == convert.canon(
        ref.schedule().assignments
    )
    assert np.array_equal(port.state.ledger.reserved, ref.state.ledger.reserved)


def _midstream_run(pkg_controller, pkg_task, fab, hosts):
    """Three jobs with a link killed under an in-flight transfer — the
    reference's mid-stream failure scenario, on either package."""
    rng = np.random.default_rng(7)
    idle = {h: float(rng.uniform(0, 30)) for h in hosts}
    ctl = pkg_controller(fab, hosts, "bass", idle=idle, slot_duration=1.0)
    for jid in range(3):
        tasks = [
            pkg_task(tid=jid * 100 + i, size=float(rng.uniform(100, 900)),
                     compute=float(rng.uniform(1, 8)),
                     replicas=tuple(rng.choice(hosts, 3, replace=False)))
            for i in range(8)
        ]
        ctl.submit(tasks, at=float(jid) * 3.0)
    ctl.run_until(3.9)
    victim = max(
        (a for rec in ctl.jobs.values() for a in rec.assignments
         if a.transfer is not None and a.transfer.slot_fracs),
        key=lambda a: (a.transfer.end, a.tid),
    )
    dead = ctl.state.ledger.link_names(victim.transfer.links)[1]
    ctl.fail_link(dead, at=4.0)
    ctl.recover_link(dead, at=9.0)
    ctl.run()
    return ctl


def _reroute_canon(log):
    return [
        (r.flow, r.old_path, r.new_path, float(r.delivered).hex(),
         float(r.remaining).hex(), float(r.new_end).hex())
        for r in log
    ]


def test_midstream_failure_identical(backend):
    from repro_torch.core.tasks import Task

    ref_fab = ref_fat_tree(4)
    ref = _midstream_run(RefController, RefTask, ref_fab, ref_storage_hosts(ref_fab))
    fab = convert.fabric_from_reference(ref_fab)
    cols = ts_plan.calls["col_scan"]
    port = _midstream_run(ClusterController, Task, fab, ref_storage_hosts(ref_fab))
    assert ts_plan.calls["col_scan"] > cols  # reroute went through the scan
    assert convert.canon(port.schedule().assignments) == convert.canon(
        ref.schedule().assignments
    )
    assert len(port.reroute_log) == len(ref.reroute_log) > 0
    assert _reroute_canon(port.reroute_log) == _reroute_canon(ref.reroute_log)


def _multipath_run(pkg_policy, pkg_controller, pkg_task, fab, hosts):
    """Cross-pod shards on a k=4 fat-tree under multipath BASS: the
    wavefront scores every (replica, path) pair and picks each task's
    winner with ``wave_select``."""
    rng = np.random.default_rng(11)
    sources, workers = hosts[: len(hosts) // 2], hosts[len(hosts) // 2:]
    idle = {w: float(rng.uniform(0, 2.0)) for w in workers}
    ctl = pkg_controller(fab, workers, pkg_policy(multipath=True, k_paths=3),
                         idle=idle, slot_duration=0.1)
    tasks = [
        pkg_task(tid=i, size=float(rng.uniform(100, 700)), compute=0.05,
                 replicas=tuple(rng.choice(sources, 3, replace=False)))
        for i in range(120)
    ]
    ctl.submit(tasks, at=0.0)
    ctl.run()
    return ctl


def test_multipath_wave_select_identical(backend):
    from repro.core.controller import BassPolicy as RefBass
    from repro_torch.core.controller import BassPolicy
    from repro_torch.core.tasks import Task

    ref_fab = ref_fat_tree(4)
    hosts = ref_storage_hosts(ref_fab)
    ref = _multipath_run(RefBass, RefController, RefTask, ref_fab, hosts)
    selects = ts_plan.calls["wave_select"]
    port = _multipath_run(BassPolicy, ClusterController, Task,
                          convert.fabric_from_reference(ref_fab), hosts)
    assert ts_plan.calls["wave_select"] > selects
    assert convert.canon(port.schedule().assignments) == convert.canon(
        ref.schedule().assignments
    )


def test_paper_example1_makespan_35(backend):
    from repro.core.examples_fig import example1_instance as ref_example1
    from repro_torch.core.bass import schedule_bass
    from repro_torch.core.examples_fig import PAPER_MAKESPAN, example1_instance

    s = schedule_bass(example1_instance())
    assert s.makespan == pytest.approx(35.0) == PAPER_MAKESPAN["BASS"]
    conv = schedule_bass(convert.instance_from_reference(ref_example1()))
    assert convert.canon(conv.assignments) == convert.canon(s.assignments)


# -- the fabric converter ------------------------------------------------------


def _ref_fabrics():
    from repro.core.topology import paper_fig2_fabric, tpu_dcn_fabric, two_tier_fabric
    from repro.net.fattree import oversubscribed_leaf_spine

    return {
        "tpu_dcn": tpu_dcn_fabric(n_pods=2, hosts_per_pod=8),
        "fig2": paper_fig2_fabric(),
        "two_tier": two_tier_fabric(2, 4, 100.0, 100.0),
        "fat_tree": ref_fat_tree(4),
        "leaf_spine": oversubscribed_leaf_spine(4, 2, 3),
    }


@pytest.mark.parametrize("name", ["tpu_dcn", "fig2", "two_tier", "fat_tree", "leaf_spine"])
def test_fabric_from_reference_preserves_construction(name):
    ref = _ref_fabrics()[name]
    fab = convert.fabric_from_reference(ref)
    assert fab.nodes == ref.nodes
    assert [fab.role(n) for n in fab.nodes] == [ref.role(n) for n in ref.nodes]
    assert list(fab.links) == list(ref.links)
    for lname, link in ref.links.items():
        got = fab.link(lname)
        assert (got.a, got.b, got.capacity) == (link.a, link.b, link.capacity)
    for n in ref.nodes:
        assert fab.incident_links(n) == ref.incident_links(n)
        assert fab.parent_chain(n) == ref.parent_chain(n)
    assert fab.tree_routing_ok() == ref.tree_routing_ok()
    rng = np.random.default_rng(len(name))
    nodes = ref.nodes
    for _ in range(40):
        a, b = (nodes[i] for i in rng.integers(0, len(nodes), size=2))
        assert fab.path(a, b) == ref.path(a, b)


def test_ledger_from_reference_copies_state():
    from repro.core.timeslot import TimeSlotLedger as RefLedger
    from repro.core.timeslot import TransferPlan as RefPlan

    ref_fab = ref_fat_tree(4)
    led = RefLedger(ref_fab, 0.5, 32)
    rows = led.path_rows(*ref_storage_hosts(ref_fab)[:2])
    led.commit(RefPlan(tuple(rows), 1.0, 3.0, ((2, 0.375), (5, 0.75))))
    led.retire_to(2)
    port = convert.ledger_from_reference(led, convert.fabric_from_reference(ref_fab))
    assert np.array_equal(port.reserved, led.reserved)
    assert np.array_equal(port.capacity, led.capacity)
    assert (port.base_slot, port.slot_duration) == (led.base_slot, led.slot_duration)
    assert port.residual_fraction(rows, 5) == led.residual_fraction(rows, 5)


# -- the import boundary -------------------------------------------------------


def test_core_imports_neither_torch_nor_jax_nor_reference():
    code = (
        "import sys\n"
        "import repro_torch.core, repro_torch.net, repro_torch.convert\n"
        "import repro_torch.kernels.ts_plan\n"
        "bad = [m for m in sys.modules if m in ('torch', 'jax', 'repro')\n"
        "       or m.startswith(('torch.', 'jax.', 'repro.'))]\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": SRC}, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("modules", [
    "repro_torch.models, repro_torch.models.model",
    "repro_torch.serving, repro_torch.serving.router, repro_torch.serving.engine",
    "repro_torch.launch.serve, repro_torch.kernels.ops",
    "repro_torch.launch.train, repro_torch.launch.inputs, repro_torch.data, "
    "repro_torch.checkpoint, repro_torch.distributed, repro_torch.distributed.actctx",
])
def test_serving_path_imports_neither_jax_nor_reference(modules):
    code = (
        "import sys\n"
        f"import {modules}\n"
        "bad = [m for m in sys.modules if m in ('jax', 'repro')\n"
        "       or m.startswith(('jax.', 'repro.'))]\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": SRC}, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_port_sources_import_nothing_of_jax_or_the_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro|benchmarks)(\.|\s|$)")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, names in os.walk(os.path.join(SRC, "repro_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    offenders = []
    for path in files:
        with open(path, encoding="utf-8") as fh:
            offenders += [
                f"{path}:{i}" for i, line in enumerate(fh, 1) if pat.match(line)
            ]
    assert offenders == []


def _port_imports():
    """Every import in ``src/repro_torch/**.py``, lazy ones inside
    functions included, as ``(file:line, absolute module, names)``, with
    relative imports resolved against the file's package."""
    import ast

    root = os.path.join(SRC, "repro_torch")
    for dirpath, _dirs, names in os.walk(root):
        for name in sorted(n for n in names if n.endswith(".py")):
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, SRC)[:-3].split(os.sep)
            package = rel[:-1] if rel[-1] != "__init__" else rel[:-1]
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read(), path)
            where = os.path.relpath(path, ROOT)
            for node in ast.walk(tree):
                if isinstance(node, ast.ImportFrom):
                    if node.level:
                        base = package[: len(package) - (node.level - 1)]
                        mod = ".".join(base + ([node.module] if node.module else []))
                    else:
                        mod = node.module
                    yield f"{where}:{node.lineno}", mod, [a.name for a in node.names]
                elif isinstance(node, ast.Import):
                    for a in node.names:
                        yield f"{where}:{node.lineno}", a.name, []


def test_port_imports_resolve_to_port_modules():
    """Every relative import of the port (and every absolute import of
    ``repro_torch``) names a module the port carries, or a name that its
    package defines: a port module can never name a module only the
    reference has, even in a lazy import that no test reaches."""
    import importlib
    import importlib.util

    seen, missing = 0, []
    for where, mod, names in _port_imports():
        if not mod.startswith("repro_torch"):
            continue
        seen += 1
        spec = importlib.util.find_spec(mod)
        if spec is None:
            missing.append(f"{where}: {mod}")
            continue
        is_package = spec.submodule_search_locations is not None
        for name in names:
            if name == "*" or (is_package and importlib.util.find_spec(f"{mod}.{name}")):
                continue
            if not hasattr(importlib.import_module(mod), name):
                missing.append(f"{where}: {mod}.{name}")
    assert seen > 100
    assert missing == []


def test_import_guard_sees_lazy_imports():
    """The controller's lazy imports of the journal, the telemetry plane
    and the runtime are among the resolved imports the guard checks."""
    mods = {(w.split(":")[0], m) for w, m, _n in _port_imports()}
    ctl = os.path.join("src", "repro_torch", "core", "controller.py")
    for mod in ("repro_torch.core.journal", "repro_torch.net.telemetry",
                "repro_torch.runtime.ft"):
        assert (ctl, mod) in mods
