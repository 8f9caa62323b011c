"""The port's offline schedulers, workloads and schedule dump held against
the JAX package.

The port's ``SCHEDULERS`` (BASS, Pre-BASS, HDS, BAR) must give the paper's
Example-1 makespans and, on the Fig. 2 and Table-I instances, schedules
byte-identical (``float.hex``) to the reference's; its ``make_instance``
must build the reference's instances; and its dump tool
(``python -m repro_torch.tools.dump_schedules``) must write the reference
tool's bytes in every section that runs at a CPU-sized scale.  The port
runs on the ``torch`` (ledger mirror on a CPU device) and ``numpy``
backends.
"""
import functools
import io

import pytest

import benchmarks.tools.dump_schedules as ref_dump
from repro.core import SCHEDULERS as REF_SCHEDULERS
from repro.core.examples_fig import example1_instance as ref_example1
from repro.core.simulator import evaluate_mapreduce as ref_evaluate
from repro.core.simulator import replay as ref_replay
from repro.core.workloads import SORT as REF_SORT
from repro.core.workloads import WORDCOUNT as REF_WORDCOUNT
from repro.core.workloads import make_instance as ref_make_instance
from repro_torch import convert
from repro_torch.core import SCHEDULERS
from repro_torch.core.examples_fig import PAPER_MAKESPAN, example1_instance
from repro_torch.core.simulator import evaluate_mapreduce, replay
from repro_torch.core.workloads import DATA_SIZES_MB, SORT, WORDCOUNT, make_instance
from repro_torch.kernels import ts_plan
from repro_torch.tools import dump_schedules as port_dump


@pytest.fixture(params=["torch", "numpy"])
def backend(request):
    prev = ts_plan.get_backend()
    ts_plan.set_backend(request.param)
    yield request.param
    ts_plan.set_backend(prev)


PAPER_NAMES = {"bass": "BASS", "bar": "BAR", "hds": "HDS", "prebass": "Pre-BASS"}
JOBS = {"wordcount": (WORDCOUNT, REF_WORDCOUNT), "sort": (SORT, REF_SORT)}
TABLE1 = [(job, mb, seed) for job in JOBS for mb in (150, 600) for seed in (0, 1)]


def _instances(case):
    """(port instance, reference instance, port extras, reference extras)."""
    if case == "fig2":
        return example1_instance(), ref_example1(), None, None
    job, mb, seed = case
    port, ref = JOBS[job]
    inst, rtasks, shuf = make_instance(port, mb, seed=seed)
    rinst, rrtasks, rshuf = ref_make_instance(ref, mb, seed=seed)
    return inst, rinst, (rtasks, shuf), (rrtasks, rshuf)


def _task_canon(tasks):
    return [(t.tid, float(t.size).hex(), float(t.compute).hex(), tuple(t.replicas), t.kind)
            for t in tasks]


def _instance_canon(inst):
    fab = inst.fabric
    return dict(
        nodes=list(fab.nodes),
        links=[(n, l.a, l.b, float(l.capacity).hex()) for n, l in fab.links.items()],
        workers=list(inst.workers),
        idle={k: float(v).hex() for k, v in inst.idle.items()},
        tasks=_task_canon(inst.tasks),
        slot=float(inst.slot_duration).hex(),
        background=[(b.src, b.dst, float(b.fraction).hex(), float(b.start).hex(),
                     float(b.end).hex()) for b in inst.background],
    )


def _metrics_canon(m):
    return {k: float(v).hex() for k, v in m.to_dict().items()}


def _report_canon(rep):
    return (float(rep.makespan).hex(),
            {k: float(v).hex() for k, v in sorted(rep.finish.items())},
            list(rep.violations))


def test_exports_match_reference():
    import repro.core as ref_core
    import repro.net as ref_net
    import repro.runtime as ref_runtime
    import repro_torch.core as core
    import repro_torch.net as net
    import repro_torch.runtime as runtime

    assert core.__all__ == ref_core.__all__
    assert net.__all__ == ref_net.__all__
    assert sorted(SCHEDULERS) == sorted(REF_SCHEDULERS)
    for mod, ref in ((core, ref_core), (net, ref_net)):
        assert all(hasattr(mod, name) for name in ref.__all__)
    public = [n for n in dir(ref_runtime) if not n.startswith("_")]
    assert all(hasattr(runtime, n) for n in public)


def test_paper_makespans(backend):
    inst = example1_instance()
    got = {PAPER_NAMES[k]: f(inst).makespan for k, f in SCHEDULERS.items()}
    assert got == PAPER_MAKESPAN == {"BASS": 35.0, "BAR": 38.0, "HDS": 39.0,
                                     "Pre-BASS": 34.0}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
@pytest.mark.parametrize("case", ["fig2"] + TABLE1, ids=str)
def test_schedule_matches_reference(backend, case, name):
    inst, rinst, _, _ = _instances(case)
    got = SCHEDULERS[name](inst)
    want = REF_SCHEDULERS[name](rinst)
    assert convert.canon(got.assignments) == convert.canon(want.assignments)
    assert got.ledger.reserved.tobytes() == want.ledger.reserved.tobytes()
    assert _report_canon(replay(inst, got)) == _report_canon(ref_replay(rinst, want))
    assert replay(inst, got).ok


@pytest.mark.parametrize("case", TABLE1, ids=str)
def test_make_instance_matches_reference(case):
    inst, rinst, (rtasks, shuf), (rrtasks, rshuf) = _instances(case)
    assert _instance_canon(inst) == _instance_canon(rinst)
    assert _task_canon(rtasks) == _task_canon(rrtasks)
    assert float(shuf).hex() == float(rshuf).hex()


def test_data_sizes_match_reference():
    from repro.core.workloads import DATA_SIZES_MB as REF_SIZES

    assert DATA_SIZES_MB == REF_SIZES


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
@pytest.mark.parametrize("case", TABLE1, ids=str)
def test_evaluate_mapreduce_matches_reference(backend, case, name):
    inst, rinst, (rtasks, shuf), (rrtasks, rshuf) = _instances(case)
    got = evaluate_mapreduce(inst, SCHEDULERS[name], rtasks, shuf)
    want = ref_evaluate(rinst, REF_SCHEDULERS[name], rrtasks, rshuf)
    assert _metrics_canon(got) == _metrics_canon(want)


# -- the dump tool ---------------------------------------------------------------


def _ref_fig2(out):
    for name in ("bass", "prebass", "hds", "bar"):
        ref_dump.dump_schedule(out, f"fig2_{name}", REF_SCHEDULERS[name](ref_example1()))


def _ref_table1(out):
    for jobname, job in (("wordcount", REF_WORDCOUNT), ("sort", REF_SORT)):
        for mb in (150, 600):
            for seed in (0, 1):
                inst, _, _ = ref_make_instance(job, mb, seed=seed)
                for name in ("bass", "prebass", "hds", "bar"):
                    ref_dump.dump_schedule(out, f"table1_{jobname}_{mb}_{seed}_{name}",
                                           REF_SCHEDULERS[name](inst))


#: section → (the port tool's writer, the reference tool's writer).  The
#: fleet sections (up to 40 000 tasks) are too slow for the CPU and the
#: ``backend_*`` sections differ by design (``numpy`` vs ``cuda`` here,
#: ``numpy`` vs ``pallas`` there).
SECTIONS = {
    "fig2": (port_dump.dump_fig2, _ref_fig2),
    "table1": (port_dump.dump_table1, _ref_table1),
    "failstorm_batched": (lambda o: port_dump.dump_failure_storm(o, "batched"),
                          lambda o: ref_dump.dump_failure_storm(o, "batched")),
    "failstorm_sequential": (lambda o: port_dump.dump_failure_storm(o, "sequential"),
                             lambda o: ref_dump.dump_failure_storm(o, "sequential")),
    "compaction": (port_dump.dump_compaction, ref_dump.dump_compaction),
    "failstorm_compacted": (
        lambda o: port_dump.dump_failure_storm(o, "batched", stride=4,
                                               label="failstorm_compacted"),
        lambda o: ref_dump.dump_failure_storm(o, "batched", stride=4,
                                              label="failstorm_compacted")),
    "faultstorm_batched": (lambda o: port_dump.dump_fault_storm(o, "batched"),
                           lambda o: ref_dump.dump_fault_storm(o, "batched")),
    "faultstorm_sequential": (lambda o: port_dump.dump_fault_storm(o, "sequential"),
                              lambda o: ref_dump.dump_fault_storm(o, "sequential")),
    "recovery": (port_dump.dump_recovery, ref_dump.dump_recovery),
    "hierarchy": (port_dump.dump_hierarchy, ref_dump.dump_hierarchy),
}


@functools.lru_cache(maxsize=None)
def _ref_section(name):
    out = io.StringIO()
    SECTIONS[name][1](out)
    return out.getvalue()


@pytest.mark.parametrize("section", sorted(SECTIONS))
def test_dump_section_matches_reference(backend, section):
    out = io.StringIO()
    SECTIONS[section][0](out)
    got = out.getvalue()
    assert got.startswith("== ") and got.count("\n") > 4
    assert got == _ref_section(section)


def test_dump_backend_section_needs_a_card():
    import torch

    out = io.StringIO()
    port_dump.dump_backend_parity(out)
    if torch.cuda.is_available():
        assert "== backend_cuda_fig2_bass\n" in out.getvalue()
    else:
        assert out.getvalue() == "== backend_parity_skipped_no_cuda\n"


def test_dump_builders_are_the_references():
    """The copies of the benchmarks' fleet and storm builders build the
    reference builders' workloads."""
    from benchmarks.bench_failover_scale import storm_setup as ref_failover
    from benchmarks.bench_faults import MTTR, SEED, SLOW, T0, T1
    from benchmarks.bench_faults import storm_setup as ref_faults
    from benchmarks.bench_sched_scale import CONFIGS, fleet_instance

    assert port_dump.CONFIGS == CONFIGS
    assert (port_dump.SEED, port_dump.T0, port_dump.T1, port_dump.MTTR,
            port_dump.SLOW) == (SEED, T0, T1, MTTR, SLOW)
    assert _instance_canon(port_dump.fleet_instance(2, 8, 50)) == _instance_canon(
        fleet_instance(2, 8, 50))
    fab, workers, tasks = port_dump.fault_storm_setup(4, 24)
    rfab, rworkers, rtasks = ref_faults(4, 24)
    assert (workers, _task_canon(tasks)) == (rworkers, _task_canon(rtasks))
    assert list(fab.links) == list(rfab.links)
    fab, workers, tasks, idle = port_dump.failover_storm_setup(4, 24)
    rfab, rworkers, rtasks, ridle = ref_failover(4, 24)
    assert (workers, _task_canon(tasks), idle) == (rworkers, _task_canon(rtasks), ridle)


def test_dump_cli_writes_the_sections(tmp_path, monkeypatch):
    """``main`` sets the backend it is given and writes every section in
    the reference tool's order (the fleet configurations cut to a CPU size
    here)."""
    monkeypatch.setattr(port_dump, "CONFIGS", [(2, 4, 30)] * 3)
    monkeypatch.setattr(port_dump, "dump_failure_storm",
                        lambda out, engine, stride=256, label=None:
                        out.write(f"== {label or 'failstorm_' + engine}\n"))
    prev = ts_plan.get_backend()
    try:
        port_dump.main([str(tmp_path / "dump.txt"), "--backend", "numpy"])
        assert ts_plan.get_backend() == "numpy"
    finally:
        ts_plan.set_backend(prev)
    heads = [line[3:] for line in (tmp_path / "dump.txt").read_text().splitlines()
             if line.startswith("== ")]
    assert heads[:4] == ["fig2_bass", "fig2_prebass", "fig2_hds", "fig2_bar"]
    assert "fleet_8h_30t_bass" in heads
    assert heads[-1] == "hierarchy_tpu_dcn_cross_pod_sharded"
    assert heads.index("faultstorm_batched") < heads.index("recovery_uncrashed")
