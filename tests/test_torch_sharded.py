"""The port's sharded dense model on gloo ranks, against the reference's
partitioned cell on forced host devices.

One subprocess runs the reference on 8 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``): mistral-nemo-12b
at smoke width in float32 (2 layers, d 64, 4/2 heads of 16, d_ff 192,
vocab 256), its parameters from the reference's ``init_params``, tokens
from a numpy seed.  It runs ``launch/dryrun.py::build_cell``'s prefill
cell on a (2, 4) mesh under the baseline policy, as ``run_cell`` does
(inside ``with mesh, activation_sharding(mesh, act_rules)``), and
``make_eval_step``'s loss jitted with ``param_shardings`` and
``train_inputs``' batch shardings, and writes their outputs, the compiled
prefill's text, every parameter's addressable shards, ``lax.psum_scatter``
over the mesh's axes, and ``NamedSharding``'s index maps for a few specs.

The port runs the same model on 8 spawned gloo ranks as a (2, 4) rank mesh
and on 4 ranks in every 4-rank case at once (``distributed/ranks.py``,
``launch/sharded.py``), each rank holding its blocks of the reference's
parameters (``convert.shard_params``).  Checked: the 8-rank prefill's
logits and caches (each rank's blocks in the decode layout of the cell's
``out_shardings``: ``kv_seq`` over ``model``, every kv head) and its loss
within 1e-5 of the reference's cell; the
(1, 4) and (2, 2) meshes and the layouts ``spec_for`` degrades — 2 kv
heads on a model axis of 4 (whole on every rank), a sequence or a batch
the axis does not divide, rules without ``"seq"`` — within 1e-5 of the
port's one-rank model; every rank's counted collectives equal to
``launch/sharded.py::sharded_collectives``; the port's wire bytes a
prefill against the compiled cell's (by the rule below, fixed before the
first run); the parameter blocks against ``param_shardings``' addressable
shards and the sharded initialisation against the whole tree's numbers;
``collectives.reduce_scatter`` against ``psum_scatter``.

The reference's ``parse_collectives`` matches only array-shaped results;
tuple-shaped ones are read with its own helpers (``_shape_bytes``,
``_group_info``, ``_wire_bytes``), as ``tests/test_torch_moe_a2a.py``
does, each op multiplied by the trip counts of its scan scopes.

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

from repro.launch.hlo_analysis import _group_info, _shape_bytes, _wire_bytes, parse_collectives
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, shard_params
from repro_torch.distributed import actctx, sharding
from repro_torch.distributed.collectives import reduce_scatter
from repro_torch.distributed.ranks import run_ranks
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.sharded import assemble_logits, sharded_collectives
from repro_torch.models.attention import local_kv_heads
from repro_torch.models.model import Model
from repro_torch.models.params import flatten, param_axes

SRC = str(Path(__file__).resolve().parents[1] / "src")
ARCH = "mistral-nemo-12b"
F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = 1e-5          # tests/test_torch_moe_a2a.py's, float32
RANK_LIMIT = 240    # seconds for one multi-rank run
BASE = {"batch": ("data",), "seq": "model", "vocab": "model"}   # policy_rules, baseline
NOSEQ = {"batch": ("data",), "vocab": "model"}
B8, S8 = 4, 16      # the 8-rank cell: batch over data 2, sequence over model 4
# The rule for the wire bytes, fixed before the test first ran: GSPMD picks
# its own ops, so only the total is bounded, by this factor.
WIRE_FACTOR = 2.0

# name: (mesh, rules, batch, sequence) — the 4-rank cases
CASES4 = {
    "1x4": ((1, 4), BASE, 2, 16),            # kv heads 2 on model 4: whole on every rank
    "2x2": ((2, 2), BASE, 4, 16),            # kv heads split, one a rank
    "seq_undivided_1x4": ((1, 4), BASE, 2, 18),
    "batch_undivided_2x2": ((2, 2), BASE, 3, 16),
    "noseq_2x2": ((2, 2), NOSEQ, 4, 16),
    "loss_mask_2x2": ((2, 2), BASE, 4, 16),  # the loss over loss_mask's positions
}
CASES = dict(CASES4, cell_2x4=((2, 4), BASE, B8, S8))
STEPS = ("prefill", "loss")

# (shape, logical axes, rules) whose placement on the (2, 4) mesh the
# port's block_index must reproduce: tuple axes, a candidate list, a
# dimension that does not divide, an axis the mesh lacks.
INDEX_SPECS = [
    ((8, 6), ("batch", None), {"batch": ("data", "model")}),
    ((8, 6), ("batch", None), sharding.ACT_RULES_SMALL_DP),
    ((4, 6), ("batch", "d_ff"), {"batch": [("data", "model"), ("data",)], "d_ff": "model"}),
    ((6, 8), ("heads", "vocab"), {"heads": "model", "vocab": "model"}),
    ((4, 8), ("batch", "vocab"), {"batch": ("pod", "data"), "vocab": "model"}),
]
# (axes, dim) of psum_scatter on the (2, 4) mesh, each rank's x [8, 12]
SCATTERS = [("model", 0), ("model", 1), ("data", 1), (("data", "model"), 0)]

REF_SCRIPT = textwrap.dedent(
    """
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as PS
    from repro.configs import get_config
    from repro.configs.base import ShapeSpec
    from repro.distributed.actctx import activation_sharding
    from repro.distributed.sharding import param_shardings, spec_for
    from repro.launch import dryrun as rd
    from repro.launch.inputs import train_inputs
    from repro.launch.mesh import _make_mesh
    from repro.launch.steps import make_eval_step
    from repro.models.model import Model
    from repro.models.moe import _shard_map

    arch, b, s, index_specs, scatters, out = json.loads(sys.argv[1])
    f32 = lambda a, smoke=False: get_config(a, True).with_(param_dtype="float32",
                                                          compute_dtype="float32")
    rd.get_config = f32
    cfg = f32(arch)
    model = Model(cfg)
    mesh = _make_mesh((2, 4), ("data", "model"))
    params = model.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    arrays = {"tokens": tokens}
    res = {}

    shape = ShapeSpec("smoke", "prefill", s, b)
    fn, _args, trips, _ = rd.build_cell(arch, shape, mesh)
    _, _, act = rd.policy_rules(arch, shape, mesh, "baseline")
    with mesh, activation_sharding(mesh, act):
        logits, caches = fn(params, {"tokens": tokens})
        res["prefill_text"] = fn.lower(params, {"tokens": tokens}).compile().as_text()
    res["trips"] = trips
    res["act_rules"] = {k: list(v) if isinstance(v, tuple) else v for k, v in act.items()}
    arrays["logits"] = np.asarray(logits)
    arrays["k"], arrays["v"] = np.asarray(caches["k"]), np.asarray(caches["v"])

    tshape = ShapeSpec("smoke", "train", s, b)
    _, _, act_t = rd.policy_rules(arch, tshape, mesh, "baseline")
    _, batch_sh = train_inputs(cfg, tshape, mesh)
    param_sh = param_shardings(model.defs(), mesh)
    ev = jax.jit(make_eval_step(model), in_shardings=(param_sh, batch_sh))
    with mesh, activation_sharding(mesh, act_t):
        m = ev(params, {"tokens": tokens})
    res["loss"] = {k: float(v) for k, v in m.items()}

    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    flat_sh = jax.tree_util.tree_leaves(param_sh)
    pos = {d.id: i for i, d in enumerate(mesh.devices.flat)}
    for (path, leaf), sh in zip(flat, flat_sh):
        name = "/".join(k.key for k in path)
        arrays["p/" + name] = np.asarray(leaf)
        for shard in jax.device_put(leaf, sh).addressable_shards:
            arrays["shard/%s/%d" % (name, pos[shard.device.id])] = np.asarray(shard.data)

    res["index"] = []
    for shp, axes, rules in index_specs:
        rules = {k: ([tuple(c) for c in v] if v and isinstance(v[0], list) else tuple(v))
                 if isinstance(v, list) else v for k, v in rules.items()}
        spec = spec_for(tuple(shp), tuple(axes), mesh, rules)
        idx = NamedSharding(mesh, spec).devices_indices_map(tuple(shp))
        res["index"].append({pos[d.id]: [[sl.start, sl.stop] for sl in ix]
                             for d, ix in idx.items()})

    x = np.random.default_rng(5).standard_normal((8, 8, 12)).astype(np.float32)
    arrays["scatter_x"] = x
    for i, (axes, dim) in enumerate(scatters):
        axes = tuple(axes) if isinstance(axes, list) else axes
        f = _shard_map()(lambda t: jax.lax.psum_scatter(t[0], axes, scatter_dimension=dim,
                                                     tiled=True)[None],
                      mesh=mesh, in_specs=PS(("data", "model")), out_specs=PS(("data", "model")))
        arrays["scatter/%d" % i] = np.asarray(jax.jit(f)(x))
    np.savez(out + ".npz", **arrays)
    with open(out + ".json", "w") as fh:
        json.dump(res, fh)
    """
)

SCATTER_MODULE = textwrap.dedent(
    """
    import torch
    from repro_torch.distributed.collectives import reduce_scatter
    from repro_torch.launch.mesh import _make_mesh

    def scatter(payload):
        mesh = _make_mesh((2, 4), ("data", "model"), "cpu")
        x = torch.from_numpy(payload["x"][mesh.rank])
        return [reduce_scatter(x, mesh, axes, dim) for axes, dim in payload["scatters"]]
    """
)

_TUPLE_RE = re.compile(
    r"=\s+\(([^)]*)\)\s+(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\("
)
_OPNAME_RE = re.compile(r'op_name="([^"]*)"')


def _reference_ops(text, world, trips):
    """(kind, result bytes, group, trips) of every collective of a
    compiled module over more than one device: ``parse_collectives``' ops,
    then the tuple-shaped ones it skips, each with its elements' bytes
    summed and its scan scopes' trip counts."""
    ops = [(c.kind, c.result_bytes, c.group, c.trips)
           for c in parse_collectives(text, trips, world).ops]
    for line in text.splitlines():
        m = _TUPLE_RE.search(line)
        if m:
            nbytes = sum(_shape_bytes(dt, dims)
                         for dt, dims in re.findall(r"(\w+)\[([\d,]*)\]", m.group(1)))
            onm = _OPNAME_RE.search(line)
            n = 1
            for label, t in trips.items():
                n *= t ** (onm.group(1) if onm else "").count(label)
            ops.append((m.group(2), nbytes, _group_info(line, world, 256)[0], n))
    return [op for op in ops if op[2] > 1]


def _wire_by_kind(ops):
    """Wire bytes by kind of ``(kind, result bytes, group, trips)`` ops."""
    out = Counter()
    for kind, nbytes, group, trips in ops:
        out[kind] += _wire_bytes(kind, nbytes, group) * trips
    return dict(out)


def _cfg():
    return get_config(ARCH, smoke=True).with_(**F32)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ref") / "ref")
    env = {**os.environ, "PYTHONPATH": SRC}
    arg = json.dumps([ARCH, B8, S8, INDEX_SPECS, SCATTERS, out])
    proc = subprocess.run([sys.executable, "-c", REF_SCRIPT, arg], capture_output=True,
                          text=True, env=env, timeout=400)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out + ".json") as fh:
        res = json.load(fh)
    arrays = dict(np.load(out + ".npz"))
    params = {}
    for key, val in arrays.items():
        if key.startswith("p/"):
            node = params
            *head, last = key[2:].split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = val
    res.update(arrays=arrays, params=params)
    return res


def _case(name, ref):
    mesh, rules, b, s = CASES[name]
    tokens, mask = _tokens(name, ref), _loss_mask(name)
    loss = dict(tokens=tokens) if mask is None else dict(tokens=tokens, loss_mask=mask)
    return dict(mesh=mesh, rules=rules, prefill=dict(tokens=tokens), loss=loss)


def _tokens(name, ref):
    if name == "cell_2x4":
        return ref["arrays"]["tokens"]
    _, _, b, s = CASES[name]
    return np.random.default_rng(7).integers(0, 256, (b, s))


def _loss_mask(name):
    """The case's ``loss_mask`` (about 60 % of positions), or None."""
    if not name.startswith("loss_mask"):
        return None
    _, _, b, s = CASES[name]
    return (np.random.default_rng(11).random((b, s)) < 0.6).astype(np.float32)


@pytest.fixture(scope="module")
def port(ref):
    """Every case on its ranks, one ``run_ranks`` call per world size →
    {name: [per rank]}."""
    out = {}
    common = dict(device="cpu", arch=ARCH, smoke=True, cfg=F32, params=ref["params"])
    for world, names in ((8, ["cell_2x4"]), (4, list(CASES4))):
        cases = [_case(n, ref) for n in names]
        t0 = time.monotonic()
        res = run_ranks("repro_torch.launch.sharded:run", world,
                        dict(common, cases=cases), timeout_s=RANK_LIMIT)
        assert time.monotonic() - t0 < RANK_LIMIT
        for i, n in enumerate(names):
            out[n] = [r[i] for r in res]
    return out


def _one_rank(name, ref):
    """The port's one-rank model on the whole parameters → (logits, caches,
    loss) of the case's tokens."""
    model = Model(_cfg())
    p = params_from_jax(ref["params"], "cpu")
    tokens = torch.from_numpy(_tokens(name, ref)).long()
    batch = {"tokens": tokens}
    if _loss_mask(name) is not None:
        batch["loss_mask"] = torch.from_numpy(_loss_mask(name))
    with torch.no_grad():
        logits, caches = model.prefill(p, {"tokens": tokens}, tokens.shape[1])
        loss, metrics = model.loss(p, batch)
    return logits.numpy(), {k: v.numpy() for k, v in caches.items()}, float(loss)


def _check(name, ranks, logits, caches, loss):
    """Each rank's block of the logits, its blocks of the caches in the
    decode layout the reference's prefill cell writes (``kv_seq`` over
    ``model``, every kv head: ``sharding.decode_rules``), and the loss."""
    np.testing.assert_allclose(assemble_logits(ranks, *logits.shape).numpy(), logits,
                               atol=TOL, rtol=0)
    cache_axes = param_axes(Model(_cfg()).cache_defs(*caches["k"].shape[1:3]))
    for rank, r in enumerate(ranks):
        rows, cols = slice(*r["prefill"]["rows"]), slice(*r["prefill"]["cols"])
        np.testing.assert_allclose(r["prefill"]["logits"].numpy(), logits[rows, cols],
                                   atol=TOL, rtol=0)
        mesh = _fake_rank_mesh(CASES[name][0], rank)
        want = shard_params(caches, cache_axes, mesh, mesh.coords, sharding.decode_rules(mesh))
        for k in ("k", "v"):
            np.testing.assert_allclose(r["prefill"]["caches"][k].numpy(), want[k],
                                       atol=TOL, rtol=0)
        assert abs(r["loss"]["loss"] - loss) <= TOL
        assert r["loss"]["aux"] == 0.0


def test_prefill_and_loss_on_8_ranks_match_reference_cell(ref, port):
    """The (2, 4) rank mesh against ``build_cell``'s prefill and the
    jitted ``make_eval_step`` on 8 host devices: every rank's block of the
    logits, its caches and the loss within 1e-5."""
    a = ref["arrays"]
    assert ref["act_rules"] == {k: list(v) if isinstance(v, tuple) else v
                                for k, v in BASE.items()}
    _check("cell_2x4", port["cell_2x4"], a["logits"], {"k": a["k"], "v": a["v"]},
           ref["loss"]["loss"])
    for r in port["cell_2x4"]:
        assert abs(r["loss"]["ce"] - ref["loss"]["ce"]) <= TOL
        assert r["prefill"]["logits"].shape == (B8 // 2, 256 // 4)


@pytest.mark.parametrize("name", list(CASES))
def test_cases_match_one_rank_model(name, ref, port):
    """Every case against the port's one-rank model on the same
    parameters and tokens, within 1e-5."""
    _check(name, port[name], *_one_rank(name, ref))


def test_degraded_layouts_degrade_as_spec_for(port):
    """Kv heads whole where they do not split (2 on 4), and each rank's q
    heads read theirs; the sequence and the batch whole where they do not
    divide; the embedding's and head's blocks where the vocabulary splits."""
    assert [r["kv_heads"] for r in port["1x4"]] == [[0], [0], [1], [1]]
    assert [r["kv_heads"] for r in port["2x2"]] == [[0], [1], [0], [1]]
    assert all(r["prefill"]["logits"].shape == (3, 128) for r in port["batch_undivided_2x2"])
    for name in ("seq_undivided_1x4", "noseq_2x2"):
        assert not any(op[0] == "reduce-scatter" for r in port[name]
                       for op in r["prefill"]["ops"])


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("name", list(CASES))
def test_collectives_equal_formula(name, step, port):
    mesh, rules, b, s = CASES[name]
    want = sharded_collectives(_cfg(), dict(data=mesh[0], model=mesh[1]), rules, b, s, 4, 4,
                               step)
    for r in port[name]:
        assert r[step]["ops"] == want
        assert r["route"]["backend"] == "gloo" and r["route"]["host_staged"] == 0


def test_prefill_wire_bytes_within_twice_the_compiled_cell(ref, port):
    """Total wire bytes a prefill on a rank against the compiled cell's
    per device (by kind reported in the message; GSPMD picks its own ops)."""
    xla = _reference_ops(ref["prefill_text"], 8, ref["trips"])
    got = _wire_by_kind([op[:3] + (1,) for op in port["cell_2x4"][0]["prefill"]["ops"]])
    exp = _wire_by_kind(xla)
    print("wire bytes a prefill, port", got, "compiled cell", exp)
    assert sum(got.values()) <= WIRE_FACTOR * sum(exp.values()), (got, exp)
    assert sum(got.values()) > 0 and sum(exp.values()) > 0


@pytest.mark.parametrize("leaf", ["/".join(p) for p, _ in flatten(Model(
    get_config(ARCH, smoke=True)).defs())])
def test_param_blocks_equal_addressable_shards(leaf, ref):
    """``convert.shard_params`` on each rank of the (2, 4) mesh gives the
    data of the device at its coordinates under ``param_shardings``."""
    cfg = _cfg()
    axes = dict(flatten(Model(cfg).axes()))[tuple(leaf.split("/"))]
    whole = ref["arrays"]["p/" + leaf]
    for r in range(8):
        mesh = _fake_rank_mesh((2, 4), r)
        block = shard_params(whole, axes, mesh, mesh.coords)
        np.testing.assert_array_equal(block, ref["arrays"][f"shard/{leaf}/{r}"])


def _fake_rank_mesh(shape, rank):
    return mesh_mod.Mesh(("data", "model"), shape, None, rank, {})


@pytest.mark.parametrize("shape", [(2, 4), (1, 4), (2, 2)])
def test_sharded_init_holds_the_whole_trees_numbers(shape):
    """``Model.init(shard=sharding.rank_shard(mesh))`` on each rank gives
    that rank's blocks of the whole initialisation from the same seed."""
    cfg = _cfg()
    model = Model(cfg)
    whole = model.init(torch.Generator().manual_seed(0), "cpu")
    for r in range(shape[0] * shape[1]):
        mesh = _fake_rank_mesh(shape, r)
        part = model.init(torch.Generator().manual_seed(0), "cpu",
                          shard=sharding.rank_shard(mesh))
        want = dict(flatten(shard_params(whole, model.axes(), mesh, mesh.coords)))
        for path, got in flatten(part):
            assert got.shape == want[path].shape and torch.equal(got, want[path]), path


@pytest.mark.parametrize("i", range(len(INDEX_SPECS)))
def test_block_index_equals_named_sharding(i, ref):
    shape, axes, rules = INDEX_SPECS[i]
    spec_mesh = mesh_mod.Mesh(("data", "model"), (2, 4))
    spec = sharding.spec_for(shape, axes, spec_mesh, rules)
    for r, want in ref["index"][i].items():
        coords = _fake_rank_mesh((2, 4), int(r)).coords
        got = sharding.block_index(shape, spec, spec_mesh.shape, coords)
        assert [list(sl.indices(n)[:2]) for sl, n in zip(got, shape)] == [
            [0 if a is None else a, n if b is None else b] for (a, b), n in zip(want, shape)]


def test_reduce_scatter_matches_psum_scatter(ref, tmp_path):
    """On 8 gloo ranks as a (2, 4) mesh: over ``model``, ``data`` and
    both, along either dimension, each rank's block equals
    ``lax.psum_scatter(..., tiled=True)``'s in ``shard_map``."""
    (tmp_path / "scatter_target.py").write_text(SCATTER_MODULE)
    x = ref["arrays"]["scatter_x"]
    res = run_ranks("scatter_target:scatter", 8, {"x": x, "scatters": SCATTERS},
                    timeout_s=RANK_LIMIT, env={"PYTHONPATH": str(tmp_path)})
    for i in range(len(SCATTERS)):
        want = ref["arrays"][f"scatter/{i}"]
        for rank, got in enumerate(res):
            np.testing.assert_allclose(got[i].numpy(), want[rank], atol=1e-6, rtol=0)


def test_reduce_scatter_rejects_an_undivided_dimension():
    mesh = mesh_mod.Mesh(("data", "model"), (1, 4), None, 0, {("model",): object()})
    with pytest.raises(ValueError, match="over 4 ranks"):
        reduce_scatter(torch.zeros(2, 6), mesh, "model", 1)


def test_local_kv_heads_map_each_q_head_to_its_kv_head():
    """Against GQA's map j → j // (nq / nkv), grouped as the attention
    reshapes them, for every block of q heads on a model axis."""
    for nq, nkv in ((4, 2), (32, 8), (12, 4), (8, 1), (6, 6)):
        for n_model in (1, 2, 3, 4, 6, 8, 16):
            if nq % n_model:
                continue
            nq_loc = nq // n_model
            for mi in range(n_model):
                kv = local_kv_heads(nq, nkv, mi * nq_loc, nq_loc)
                g = nq_loc // len(kv)
                assert g * len(kv) == nq_loc
                assert [kv[j // g] for j in range(nq_loc)] == [
                    (mi * nq_loc + j) // (nq // nkv) for j in range(nq_loc)]


def test_rank_layout_reads_the_rules():
    """The residual stream's layout by ``spec_for``, and the policies whose
    layout is not ported raise; off a rank mesh there is none."""
    mesh = _fake_rank_mesh((2, 4), 6)
    with actctx.activation_sharding(mesh, BASE):
        lay = actctx.rank_layout(4, 16, 64)
        assert (lay.batch, lay.seq_sharded, lay.b0, lay.b_loc, lay.s0, lay.s_loc) == (
            ("data",), True, 2, 2, 8, 4)
        x = torch.zeros(2, 4, 64)
        assert actctx.constrain(x, ("batch", "seq", None)) is x
    with actctx.activation_sharding(mesh, sharding.ACT_RULES_SMALL_DP):
        with pytest.raises(NotImplementedError):
            actctx.rank_layout(8, 16, 64)
    with actctx.activation_sharding(mesh_mod.make_production_mesh(), BASE):
        assert actctx.rank_layout(4, 16, 64) is None
    assert actctx.rank_layout(4, 16, 64) is None
