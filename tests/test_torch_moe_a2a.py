"""The port's expert-parallel MoE dispatch (``moe_impl="a2a"``) on gloo
ranks, against the reference's ``_moe_block_a2a`` on forced host devices.

One subprocess runs the reference's block under ``jax.make_mesh`` meshes of
8 (``(2, 4)``) and 4 (``(1, 4)``, ``(2, 2)``) host devices, as
``tests/test_moe_a2a.py`` does, on the reference's ``init_params`` and a
numpy ``x`` from a seed, and writes ``y``, ``aux`` and the compiled
module's collectives.  The port runs the same blocks on 8 and 4 spawned
gloo ranks (``distributed/ranks.py``), each rank holding its shards of the
same parameters (``convert.shard_moe_params``).  Checked: ``y`` and
``aux`` against the reference's a2a within 1e-5 in float32, without drops
(capacity factor 8.0) and with them (1.25), and against the port's own
one-rank gather within 1e-4 where nothing drops; the sharding variants
(no ``"seq"`` rule, a batch the data axis does not divide, both
``mlp_kind``s); the body's collectives against the compiled module's:
``all-to-all`` count and wire bytes exactly, ``all-gather`` and
``all-reduce`` wire bytes by kind (XLA combines the three sums into one
tuple all-reduce), and every op against ``launch/expert.py``'s formula;
the rank mesh's order against ``jax.make_mesh``'s; the parameter shards
and the sharded initialisation; a 2-layer model prefill on 4 ranks
against the one-rank gather prefill (1e-5); the gather fallbacks; and a
failing rank failing the run without a hang.

The reference's ``parse_collectives`` matches only array-shaped results:
on the CPU the all-to-alls and the combined all-reduce have tuple results,
which it skips.  Those lines are read here with its own helpers
(``_shape_bytes``, ``_group_info``, ``_wire_bytes``), their elements'
bytes summed, and added to its report.

Each multi-rank run has a wall-clock limit (``run_ranks``' ``timeout_s``)
and every group a 60 s timeout, so a failing rank fails the test.
"""
import json
import os
import re
import subprocess
import sys
import textwrap
import time
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.launch.hlo_analysis import _group_info, _shape_bytes, _wire_bytes, parse_collectives
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, shard_moe_params
from repro_torch.distributed import actctx
from repro_torch.distributed.ranks import RankFailure, run_ranks
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.expert import a2a_collectives
from repro_torch.models import moe
from repro_torch.models.model import Model

SRC = str(Path(__file__).resolve().parents[1] / "src")
ARCH = "moonshot-v1-16b-a3b"          # smoke: d 64, 8 experts, top-2, swiglu
SEQ = {"batch": ("data",), "seq": "model"}
NOSEQ = {"batch": ("data",)}
TOL = 1e-5          # port against the reference's a2a, float32
GATHER_TOL = 1e-4   # a2a against the gather dispatch (tests/test_moe_a2a.py's)
RANK_LIMIT = 240    # seconds for one multi-rank run

# name: (mesh, rules, x shape, config overrides)
CASES = {
    "nodrop": ((2, 4), SEQ, (4, 8), dict(capacity_factor=8.0)),
    "drops": ((2, 4), SEQ, (4, 64), dict(capacity_factor=1.25)),
    "noseq_1x4": ((1, 4), NOSEQ, (4, 8), dict(capacity_factor=8.0)),
    "noseq_2x2": ((2, 2), NOSEQ, (4, 8), dict(capacity_factor=8.0)),
    "dp_undivided_2x2": ((2, 2), SEQ, (3, 8), dict(capacity_factor=8.0)),
    "seq_1x4": ((1, 4), SEQ, (2, 8), dict(capacity_factor=8.0)),
    "gelu_1x4": ((1, 4), SEQ, (2, 8), dict(capacity_factor=8.0, mlp_kind="gelu")),
    "gelu_2x2": ((2, 2), SEQ, (4, 8), dict(capacity_factor=1.25, mlp_kind="gelu")),
}
NO_DROP = [n for n, c in CASES.items() if c[3]["capacity_factor"] == 8.0]

REF_SCRIPT = textwrap.dedent(
    """
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_config
    from repro.distributed.actctx import activation_sharding
    from repro.launch.mesh import _make_mesh
    from repro.models.moe import moe_block, moe_defs
    from repro.models.params import init_params

    cases, out = json.loads(sys.argv[1]), sys.argv[2]
    res = {"mesh_2x4": np.vectorize(lambda d: d.id)(_make_mesh((2, 4), ("data", "model"))
                                                   .devices).tolist()}
    arrays = {}
    for name, (shape, rules, xs, over) in cases.items():
        cfg = get_config("%s", smoke=True).with_(moe_impl="a2a", **over)
        n = shape[0] * shape[1]
        mesh = (_make_mesh(shape, ("data", "model")) if n == 8 else
                Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model")))
        rules = {k: tuple(v) if isinstance(v, list) else v for k, v in rules.items()}
        p = init_params(moe_defs(cfg), jax.random.PRNGKey(0), jnp.float32)
        x = np.random.default_rng(1).standard_normal(tuple(xs) + (cfg.d_model,)
                                                     ).astype(np.float32)
        with mesh, activation_sharding(mesh, rules):
            f = jax.jit(lambda p, x: moe_block(p, x, cfg))
            y, aux = f(p, x)
            text = f.lower(p, x).compile().as_text()
        res[name] = {"aux": float(aux), "text": text, "world": n}
        arrays[name + "/y"] = np.asarray(y)
        arrays[name + "/x"] = x
        for k, v in p.items():
            arrays[name + "/p/" + k] = np.asarray(v)
    np.savez(out + ".npz", **arrays)
    with open(out + ".json", "w") as fh:
        json.dump(res, fh)
    """ % ARCH
)

_TUPLE_RE = re.compile(
    r"=\s+\(([^)]*)\)\s+(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\("
)


def _reference_ops(text, world):
    """(kind, result bytes, group) of every collective of a compiled
    module over more than one device: ``parse_collectives``' ops, then the
    tuple-shaped ones it skips, each with its elements' bytes summed.  (XLA
    keeps a sum over a one-device group, which moves no byte; the port
    issues nothing there.)"""
    ops = [(c.kind, c.result_bytes, c.group) for c in parse_collectives(text, {}, world).ops]
    for line in text.splitlines():
        m = _TUPLE_RE.search(line)
        if m:
            nbytes = sum(_shape_bytes(dt, dims)
                         for dt, dims in re.findall(r"(\w+)\[([\d,]*)\]", m.group(1)))
            ops.append((m.group(2), nbytes, _group_info(line, world, 256)[0]))
    return [op for op in ops if op[2] > 1]


def _wire_by_kind(ops):
    out = Counter()
    for kind, nbytes, group in ops:
        out[kind] += _wire_bytes(kind, nbytes, group)
    return dict(out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ref") / "ref")
    env = {**os.environ, "PYTHONPATH": SRC}
    proc = subprocess.run([sys.executable, "-c", REF_SCRIPT, json.dumps(CASES), out],
                          capture_output=True, text=True, env=env, timeout=400)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out + ".json") as fh:
        res = json.load(fh)
    arrays = np.load(out + ".npz")
    for name in CASES:
        res[name]["y"] = arrays[name + "/y"]
        res[name]["x"] = arrays[name + "/x"]
        res[name]["p"] = {k.split("/p/")[1]: arrays[k] for k in arrays.files
                          if k.startswith(name + "/p/")}
    return res


def _cfg(name):
    return get_config(ARCH, smoke=True).with_(moe_impl="a2a", **CASES[name][3])


@pytest.fixture(scope="module")
def port(ref):
    """The port's block for every case on its ranks → {name: [per rank]}."""
    out = {}
    for world in (8, 4):
        names = [n for n, c in CASES.items() if c[0][0] * c[0][1] == world]
        cases = [dict(mesh=CASES[n][0], rules=CASES[n][1], arch=ARCH, smoke=True,
                      cfg=CASES[n][3], params=ref[n]["p"], x=ref[n]["x"]) for n in names]
        t0 = time.monotonic()
        res = run_ranks("repro_torch.launch.expert:block", world,
                        {"device": "cpu", "cases": cases}, timeout_s=RANK_LIMIT)
        assert time.monotonic() - t0 < RANK_LIMIT
        for i, n in enumerate(names):
            out[n] = [r[i] for r in res]
    return out


def _gather(name, ref):
    cfg = _cfg(name).with_(moe_impl="gather")
    p = params_from_jax(ref[name]["p"], "cpu")
    with torch.no_grad():
        return moe.moe_block(p, torch.from_numpy(ref[name]["x"]), cfg)


@pytest.mark.parametrize("name", list(CASES))
def test_a2a_matches_reference(name, ref, port):
    """Every rank returns the whole ``y``: the reference's within 1e-5, and
    the same aux loss on every rank."""
    for r in port[name]:
        np.testing.assert_allclose(r["y"].numpy(), ref[name]["y"], atol=TOL, rtol=0)
        assert abs(r["aux"] - ref[name]["aux"]) <= TOL
        assert r["y"].dtype == torch.float32


@pytest.mark.parametrize("name", NO_DROP)
def test_a2a_matches_gather_without_drops(name, ref, port):
    y, aux = _gather(name, ref)
    for r in port[name]:
        assert r["drops"] == 0.0
        np.testing.assert_allclose(r["y"].numpy(), y.numpy(), atol=GATHER_TOL, rtol=0)
        assert abs(r["aux"] - float(aux)) <= GATHER_TOL


def test_capacity_1_25_drops_on_some_rank(port):
    """At capacity factor 1.25 (``c_e`` 12 for 32 local tokens a rank, each
    choosing 2 of 8 experts) entries drop on some rank, and the outputs
    still agree with the reference's (``test_a2a_matches_reference``)."""
    assert [r["c_e"] for r in port["drops"]] == [12] * 8
    assert max(r["drops"] for r in port["drops"]) > 0, [r["drops"] for r in port["drops"]]
    assert all(r["drops"] == 0 for r in port["nodrop"])


@pytest.mark.parametrize("name", list(CASES))
def test_collectives_match_compiled_module(name, ref, port):
    """The body's collectives (the reassembly excluded: the reference
    leaves ``y`` sharded) against the compiled module's, and every op,
    reassembly included, against the formula."""
    want = _reference_ops(ref[name]["text"], ref[name]["world"])
    shape, rules, xs, _ = CASES[name]
    cfg = _cfg(name)
    formula = a2a_collectives(cfg, dict(data=shape[0], model=shape[1]), rules, *xs, 4, 4)
    for r in port[name]:
        assert r["ops"] == formula
        body = [op[:3] for op in r["ops"] if op[3] != "moe_a2a/reassemble"]
        a2a = sorted(op for op in body if op[0] == "all-to-all")
        assert a2a == sorted(op for op in want if op[0] == "all-to-all")
        assert len(a2a) == 2
        got, exp = _wire_by_kind(body), _wire_by_kind(want)
        assert got == exp
        # The all-gathers XLA keeps apart match one for one.
        assert (Counter(op for op in body if op[0] == "all-gather")
                == Counter(op for op in want if op[0] == "all-gather"))


def test_rank_mesh_order_is_make_mesh_order(ref, port):
    """Rank ``di · 4 + mi`` is the device at ``(di, mi)`` of the reference's
    ``_make_mesh((2, 4))``."""
    ids = np.asarray(ref["mesh_2x4"])
    for rank, r in enumerate(port["nodrop"]):
        di, mi = (int(v[0]) for v in np.nonzero(ids == rank))
        assert r["coords"] == {"data": di, "model": mi} == {"data": rank // 4, "model": rank % 4}


def _one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            world_size=1, rank=0)


def test_make_mesh_raises_on_world_mismatch_and_one_rank_falls_back(tmp_path, ref):
    """A world of one rank: a (2, 2) mesh raises; a (1, 1) rank mesh and a
    production mesh take the gather path (the same bits as ``"gather"``)."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    _one_rank_group(tmp_path)
    try:
        with pytest.raises(ValueError, match="needs 4 ranks"):
            mesh_mod._make_mesh((2, 2), ("data", "model"))
        one = mesh_mod._make_mesh((1, 1), ("data", "model"), "cpu")
        assert one.is_rank_mesh and one.coords == {"data": 0, "model": 0}
        assert one.device == torch.device("cpu")
        cfg = _cfg("nodrop")
        p = params_from_jax(ref["nodrop"]["p"], "cpu")
        x = torch.from_numpy(ref["nodrop"]["x"])
        with torch.no_grad():
            yg, auxg = moe.moe_block(p, x, cfg.with_(moe_impl="gather"))
            for mesh in (one, mesh_mod.make_production_mesh()):
                assert not moe._a2a_applicable(cfg, mesh)
                with actctx.activation_sharding(mesh, SEQ):
                    y, aux = moe.moe_block(p, x, cfg)
                assert torch.equal(y, yg) and torch.equal(aux, auxg)
    finally:
        dist.destroy_process_group()


def _fake_rank_mesh(shape, rank):
    return mesh_mod.Mesh(("data", "model"), shape, None, rank, {})


@pytest.mark.parametrize("shape", [(2, 4), (1, 4), (2, 2)])
def test_shard_moe_params_round_trip(shape, ref):
    """The shards of every rank put back together are the whole block, and
    the same in a model tree, whose other leaves stay whole."""
    whole = ref["nodrop"]["p"]
    meshes = [_fake_rank_mesh(shape, r) for r in range(shape[0] * shape[1])]
    shards = [shard_moe_params(whole, m, m.coords) for m in meshes]
    grid = lambda k: [[shards[di * shape[1] + mi][k] for mi in range(shape[1])]  # noqa: E731
                      for di in range(shape[0])]
    np.testing.assert_array_equal(np.block(grid("router")), whole["router"])
    for k, ax in (("w_gate", 1), ("w_up", 1), ("w_down", 2)):
        rows = [np.concatenate(row, 0) for row in grid(k)]   # experts over model
        np.testing.assert_array_equal(np.concatenate(rows, ax), whole[k])
    tree = {"embed": whole["router"], "stack": {"moe": {k: v[None] for k, v in whole.items()}}}
    cut = shard_moe_params(tree, meshes[0], meshes[0].coords)
    assert cut["embed"] is tree["embed"]
    for k, v in shards[0].items():
        np.testing.assert_array_equal(cut["stack"]["moe"][k][0], v)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_sharded_init_holds_the_whole_trees_numbers(shape):
    """``Model.init(shard=moe.rank_shard(...))`` on each rank gives that
    rank's blocks of the whole initialisation from the same seed."""
    cfg = get_config(ARCH, smoke=True).with_(moe_impl="a2a", n_layers=2)
    whole = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    for r in range(shape[0] * shape[1]):
        mesh = _fake_rank_mesh(shape, r)
        part = Model(cfg).init(torch.Generator().manual_seed(0), "cpu",
                               shard=moe.rank_shard(cfg, mesh))
        want = shard_moe_params(whole, mesh, mesh.coords)
        assert torch.equal(part["embed"], whole["embed"])
        for k, v in want["stack"]["moe"].items():
            assert part["stack"]["moe"][k].shape == v.shape
            assert torch.equal(part["stack"]["moe"][k], v)
    assert moe.rank_shard(cfg.with_(moe_impl="gather"), _fake_rank_mesh(shape, 0)) is None


def test_prefill_on_4_ranks_matches_one_rank_gather():
    """A 2-layer moonshot smoke model, float32, capacity factor 8.0: the
    last position's logits and every attention cache of a prefill on a
    (2, 2) rank mesh equal the one-rank gather prefill's within 1e-5."""
    over = dict(n_layers=2, capacity_factor=8.0, param_dtype="float32",
                compute_dtype="float32", attn_impl="xla")
    tokens = np.random.default_rng(3).integers(0, 256, (2, 16))
    res = run_ranks("repro_torch.launch.expert:prefill", 4,
                    dict(device="cpu", mesh=(2, 2), rules=SEQ, arch=ARCH, smoke=True,
                         cfg=over, seed=0, tokens=tokens), timeout_s=RANK_LIMIT)
    cfg = get_config(ARCH, smoke=True).with_(moe_impl="gather", **over)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        logits, caches = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, 16)
    for r in res:
        assert max(r["drops"]) == 0.0 and len(r["drops"]) == 2
        np.testing.assert_allclose(r["logits"].numpy(), logits.numpy(), atol=TOL, rtol=0)
        for k in ("k", "v"):
            np.testing.assert_allclose(r["caches"][k].numpy(), caches[k].numpy(),
                                       atol=TOL, rtol=0)
        per_layer = a2a_collectives(cfg, {"data": 2, "model": 2}, SEQ, 2, 16, 4, 4)
        assert r["ops"] == per_layer * 2


FAIL_MODULE = textwrap.dedent(
    """
    import torch.distributed as dist

    def fail_one(payload):
        if dist.get_rank() == 1:
            raise RuntimeError("rank 1 fails")
        dist.barrier()
    """
)


def test_a_failing_rank_fails_the_run_without_a_hang(tmp_path):
    (tmp_path / "rank_fail_target.py").write_text(FAIL_MODULE)
    t0 = time.monotonic()
    with pytest.raises(RankFailure, match="rank 1 fails"):
        run_ranks("rank_fail_target:fail_one", 3, {}, timeout_s=RANK_LIMIT,
                  env={"PYTHONPATH": str(tmp_path)})
    assert time.monotonic() - t0 < 45    # under the group's 60 s timeout
