"""The dry run's collectives: one rank's program on ``meta`` tensors over a
recording mesh (``launch/dryrun.py::rank_program``), on the CPU.

For every arch × shape of ``configs.all_cells()`` at full width, its depth
cut to the smallest unit (2 layers, an 8-layer period for jamba, 2
encoder layers for whisper), under ``baseline`` and ``opt`` and on both
production meshes, the ops the rank program counts equal
``launch/sharded.py::sharded_collectives`` op for op (without the
launcher's greedy pick), and an op counts as crossing pods exactly where
its group spans ``pod``.  A train cell runs one microbatch here, for the
file's time; three cells run the dry run's 8 (the accumulation path).  The parameter, moment and cache blocks at full depth hold what
``memory_per_device`` gives the cell's arguments less its batch, to the
byte.  Rank 0 and the last rank count the same ops.  A recording marker
refuses a tensor off ``meta``, and a process group a ``meta`` tensor.  One
8-rank gloo run of ``launch/sharded.py::run`` (the (2, 4) cell of
``tests/test_torch_sharded.py`` at smoke width, float32) issues on every
rank exactly the ops the ``meta`` program counts: a prefill, a loss, a
train step of 2 microbatches and two decode ticks.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import all_cells, get_config
from repro_torch.distributed import collectives
from repro_torch.distributed.ranks import run_ranks
from repro_torch.distributed.sharding import decode_rules
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, make_production_mesh, mesh_device_count, recording_mesh

MESHES = {"pod256": False, "pod512": True}
POLICIES = ["baseline", "opt"]
SWEEP_ACCUM = 1
#: Group sizes on (2, 16, 16) that only a group spanning ``pod`` has:
#: pod, pod × data or pod × model, and every axis.
POD_GROUPS = {2, 32, 512}


def _cut(cfg):
    """The smallest unit of depth: 2 layers, one 8-layer period of a hybrid,
    2 encoder layers."""
    return cfg.with_(n_layers=cfg.attn_period if cfg.family == "hybrid" else 2,
                     n_enc_layers=min(cfg.n_enc_layers, 2))


def _ops(report):
    return [(c.kind, c.result_bytes, c.group, c.path) for c in report.ops]


def _program(arch, shape, multi, policy, accum=SWEEP_ACCUM, rank=0):
    mesh = make_production_mesh(multi_pod=multi)
    cfg, b, s, s_max = dryrun.cell_step(arch, shape, mesh, policy)
    prog = dryrun.rank_program(_cut(cfg), shape.kind, b, s, mesh.shape, policy, accum=accum,
                               s_max=s_max, rank=rank)
    want = dryrun.formula_ops(prog["cfg"], shape.kind, b, s, mesh.shape, prog["param_rules"],
                              prog["rules"], accum, s_max)
    return prog, want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch,shape", all_cells(), ids=[f"{a}-{s.name}" for a, s in all_cells()])
def test_rank_program_counts_the_formula(arch, shape, policy, mesh):
    prog, want = _program(arch, shape, MESHES[mesh], policy)
    got = _ops(prog["report"])
    assert dryrun.first_difference(got, want) is None, dryrun.first_difference(got, want)
    assert len(got) > 0
    report = prog["report"]
    for c in report.ops:
        assert c.crosses_pod == (MESHES[mesh] and c.group in POD_GROUPS), c
    dcn = sum(c.wire_bytes for c in report.ops if MESHES[mesh] and c.group in POD_GROUPS)
    assert report.total_wire_bytes(dcn=True) == dcn
    assert (report.total_wire_bytes(dcn=True) > 0) == (dcn > 0)


@pytest.mark.parametrize("arch,policy,mesh", [("mistral-nemo-12b", "baseline", "pod512"),
                                              ("whisper-base", "opt", "pod256"),
                                              ("whisper-base", "opt", "pod512")])
def test_train_cell_at_the_dry_runs_microbatches(arch, policy, mesh):
    """The dry run's 8 microbatches, each gathering the layer blocks again;
    whisper's ``opt`` cell is small-DP, whose 32 rows a microbatch split
    over neither 256 nor 512 ranks: its batch lies over ``data`` alone."""
    spec = next(s for a, s in all_cells() if (a, s.name) == (arch, "train_4k"))
    prog, want = _program(arch, spec, MESHES[mesh], policy, accum=dryrun.TRAIN_ACCUM)
    assert _ops(prog["report"]) == want
    layer = [op for op in want if op[3] == "layer"]
    assert len(layer) == 2 * dryrun.TRAIN_ACCUM * (policy == "baseline")
    if policy == "opt":
        assert prog["rules"]["batch"] == [("pod", "data", "model"), ("data", "model"), ("data",)]
        assert {op[2] for op in want} == {16, 256 * (1 + MESHES[mesh])}   # data; every axis


def test_pod512_cells_cross_pods_where_a_group_spans_pod():
    """A train cell's gradient sums span ``pod`` (wire bytes over the
    network between pods); a dense prefill issues nothing over ``pod``."""
    spec = {s.name: s for a, s in all_cells() if a == "mistral-nemo-12b"}
    train, _ = _program("mistral-nemo-12b", spec["train_4k"], True, "baseline")
    prefill, _ = _program("mistral-nemo-12b", spec["prefill_32k"], True, "baseline")
    single, _ = _program("mistral-nemo-12b", spec["train_4k"], False, "baseline")
    assert train["report"].total_wire_bytes(dcn=True) > 0
    assert {c.path for c in train["report"].ops if c.crosses_pod} >= {"grads", "grad_norm"}
    assert prefill["report"].total_wire_bytes(dcn=True) == 0
    assert single["report"].total_wire_bytes(dcn=True) == 0


@pytest.mark.parametrize("arch,shape,policy", [("mistral-nemo-12b", "train_4k", "baseline"),
                                               ("moonshot-v1-16b-a3b", "prefill_32k", "opt"),
                                               ("jamba-v0.1-52b", "decode_32k", "baseline"),
                                               ("whisper-base", "prefill_32k", "opt"),
                                               ("falcon-mamba-7b", "long_500k", "baseline"),
                                               ("internvl2-1b", "train_4k", "opt")])
def test_first_and_last_rank_count_alike(arch, shape, policy):
    spec = next(s for a, s in all_cells() if (a, s.name) == (arch, shape))
    last = mesh_device_count(make_production_mesh(multi_pod=True)) - 1
    first, _ = _program(arch, spec, True, policy)
    other, _ = _program(arch, spec, True, policy, rank=last)
    assert _ops(first["report"]) == _ops(other["report"])
    assert first["block_bytes"] == other["block_bytes"]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch,shape", all_cells(), ids=[f"{a}-{s.name}" for a, s in all_cells()])
def test_blocks_hold_the_cells_arguments_less_the_batch(arch, shape, policy, mesh):
    """At full depth: the rank's parameter, moment and cache blocks hold
    ``memory_per_device``'s argument bytes less the batch's (tokens,
    vision embeddings, frames; a tick's token and position), exactly."""
    prod = make_production_mesh(multi_pod=MESHES[mesh])
    cell = dryrun.build_cell(arch, shape, prod, policy)
    batch_at = (1, 2) if shape.kind == "decode" else (len(cell["args"]) - 1,)
    batch = sum(dryrun._device_bytes(cell["args"][i], cell["in_shardings"][i], prod)
                for i in batch_at)
    cfg, b, s, s_max = dryrun.cell_step(arch, shape, prod, policy)
    rec = recording_mesh(prod.axis_sizes, prod.axis_names, rank=7)
    cfg, param_rules, rules = dryrun.rank_rules(cfg, shape.kind, b, s, rec, policy)
    _, _, nbytes = dryrun.rank_step(cfg, shape.kind, b, s, rec, param_rules, rules, s_max=s_max)
    assert nbytes == dryrun.memory_per_device(cell, prod)["argument"] - batch


def test_recording_marker_refuses_a_tensor_off_meta():
    mesh = recording_mesh((2, 4), ("data", "model"))
    with pytest.raises(ValueError, match="meta"):
        collectives.all_gather(torch.ones(4, 2), mesh, "model", 0, "x")
    with pytest.raises(ValueError, match="meta"):
        collectives.psum(torch.ones(4), mesh, ("data", "model"), "x")
    out = collectives.reduce_scatter(torch.empty(8, 3, device="meta"), mesh, "model", 0, "x")
    assert out.shape == (2, 3) and out.device.type == "meta"


def test_process_group_refuses_a_meta_tensor():
    """A real group never takes the recording route: the group object is
    refused before any ``torch.distributed`` call."""
    mesh = Mesh(("data",), (2,), None, 0, {("data",): object()})
    with pytest.raises(ValueError, match="meta"):
        collectives.all_gather(torch.empty(4, device="meta"), mesh, "data", 0, "x")


def test_recording_mesh_is_a_rank_mesh_on_meta():
    mesh = recording_mesh((2, 16, 16), ("pod", "data", "model"), rank=511)
    assert mesh.is_rank_mesh and mesh.device == torch.device("meta")
    assert mesh.coords == {"pod": 1, "data": 15, "model": 15}
    assert mesh.group(("model", "pod")).axes == ("pod", "model")
    with pytest.raises(ValueError):
        recording_mesh((2, 2), ("data", "model"), rank=4)


# -- one gloo run against the meta program -------------------------------------------

ARCH = "mistral-nemo-12b"
F32 = dict(param_dtype="float32", compute_dtype="float32")
BASE = {"batch": ("data",), "seq": "model", "vocab": "model"}
MESH, B, S, ACCUM, TICKS = (2, 4), 4, 16, 2, 2


@pytest.fixture(scope="module")
def gloo_ranks():
    rng = np.random.default_rng(3)
    case = dict(mesh=MESH, rules=BASE, seed=0,
                train=dict(tokens=rng.integers(0, 256, (B, S)), accum=ACCUM, host=[]),
                prefill=dict(tokens=rng.integers(0, 256, (B, S))),
                decode=[dict(tokens=rng.integers(0, 256, (B, TICKS)))],
                loss=dict(tokens=rng.integers(0, 256, (B, S))))
    return run_ranks("repro_torch.launch.sharded:run", 8,
                     dict(device="cpu", arch=ARCH, smoke=True, cfg=F32, cases=[case]),
                     timeout_s=240)


@pytest.mark.parametrize("step", ["train", "prefill", "loss", "decode"])
def test_gloo_ranks_issue_what_the_meta_program_counts(gloo_ranks, step):
    cfg = get_config(ARCH, smoke=True).with_(**F32)
    shape = dict(data=MESH[0], model=MESH[1])
    if step == "decode":
        rules = (None, decode_rules(Mesh(tuple(shape), MESH)))
        prog = dryrun.rank_program(cfg, "decode", B, S, shape, rules, s_max=S)
    else:
        prog = dryrun.rank_program(cfg, step, B, S, shape, (None, BASE), accum=ACCUM)
    want = _ops(prog["report"])
    assert want
    for r in gloo_ranks:
        res = r[0][step]
        if step == "decode":
            assert len(res[0]["ops"]) == TICKS
            for tick in res[0]["ops"]:
                assert [op for op in tick if op[3] != "decode/greedy"] == want
        else:
            assert res["ops"] == want
