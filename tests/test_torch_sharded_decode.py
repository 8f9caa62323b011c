"""The port's sharded decode over a ``kv_seq``-sharded cache on gloo ranks,
against the reference's compiled decode cell on forced host devices.

One subprocess runs the reference on 8 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``): mistral-nemo-12b
at smoke width in float32 (2 layers, d 64, 4/2 heads of 16, d_ff 192,
vocab 256), its parameters from the reference's ``init_params``.  It
compiles ``launch/dryrun.py::build_cell``'s decode cell for
``ShapeSpec("smoke", "decode", 32, 4)`` on a (2, 4) mesh (batch over
``data``, the caches' 32 positions over ``model`` in blocks of 8, the
vocabulary over ``model``: ``ACT_RULES_DECODE``) and runs it inside ``with
mesh, activation_sharding(mesh, act_rules)``, as ``run_cell`` does, on
caches drawn from a numpy seed at ``pos`` 0 (block 0 writes, blocks 1–3
wholly masked), 19 (block 2 writes, block 3 wholly masked) and 31 (block
3 writes).  It writes the logits, the new caches and the compiled text.

The port runs the same ticks on 8 spawned gloo ranks as a (2, 4) rank mesh
(``launch/sharded.py``'s ``"decode"`` entries, each rank holding its
blocks of the parameters and of the caches), and more cases on 4 and 8
ranks against the port's one-rank model: (1, 4), where 2 kv heads on 4
stay whole on every rank; (2, 2); 30 positions, which ``model`` 4 does
not divide (every rank holds the whole cache); a batch of 3 on ``data``
2 (every rank holds every row); a ``pos`` past the cache's end (the write
clamped to the last position); a (2, 2, 2) ``("pod", "data", "model")``
mesh; a tied head (the embedding's vocab-parallel block as the head); and
the serve handoff on (2, 2) and (1, 4) — the sharded prefill's
caches, already in the decode layout, then 3 teacher-forced ticks —
against one rank's prefill and ticks.  Checked: logits and caches within
1e-5; every rank's counted collectives equal to
``launch/sharded.py::sharded_collectives(step="decode")``; the port's wire
bytes a tick against the compiled cell's (by the rule below, fixed before
the first run); ``collectives.pmax`` against the maximum; the decode
layout's blocks against ``spec_for``.

Each multi-rank run has a wall-clock limit (``run_ranks``' ``timeout_s``)
and every group a 60 s timeout, so a failing rank fails the test.
"""
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, shard_params
from repro_torch.distributed import actctx, sharding
from repro_torch.distributed.ranks import run_ranks
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.sharded import assemble_tick, sharded_collectives
from repro_torch.models.model import Model
from repro_torch.models.params import param_axes
from test_torch_sharded import ARCH, F32, SRC, TOL, _reference_ops, _wire_by_kind

RANK_LIMIT = 240    # seconds for one multi-rank run
S_MAX, B8 = 32, 4   # the reference's cell: ShapeSpec("smoke", "decode", 32, 4)
POS = (0, 19, 31)   # block 0 writes; block 2 writes, 3 masked; block 3 writes
# The rule for the wire bytes, fixed before the test first ran: GSPMD picks
# its own ops, so only a tick's total is bounded, by this factor (the
# launcher's greedy pick, which the cell does not make, left out).
WIRE_FACTOR = 2.0

# name: (mesh, batch, s_max, [pos of each entry]) — one-rank comparisons
CASES = {
    "1x4": ((1, 4), 2, S_MAX, [0, 19, 31]),      # 2 kv heads on model 4: whole
    "2x2": ((2, 2), 4, S_MAX, [0, 19, 31]),      # kv heads split, one a rank
    "kv_undivided_1x4": ((1, 4), 2, 30, [17]),   # 30 positions on model 4: whole
    "batch_undivided_2x2": ((2, 2), 3, S_MAX, [19]),
    "clamped_2x2": ((2, 2), 4, S_MAX, [40]),     # written at 31
    "pod_2x2x2": ((2, 2, 2), 4, S_MAX, [19]),
    "tied_2x2": ((2, 2), 4, S_MAX, [19]),         # the head is the embedding's block
}
TIED = {"tied_2x2"}
# name: (mesh, batch, prompt length, ticks) — prefill, then teacher-forced ticks
HANDOFF = {"handoff_2x2": ((2, 2), 4, 12, 3), "handoff_1x4": ((1, 4), 2, 12, 3)}
WORLD = {1: [], 4: [], 8: ["cell_2x4"]}
for _n, (_m, *_) in {**CASES, **HANDOFF}.items():
    WORLD[int(np.prod(_m))].append(_n)

REF_SCRIPT = textwrap.dedent(
    """
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config
    from repro.configs.base import ShapeSpec
    from repro.distributed.actctx import activation_sharding
    from repro.launch import dryrun as rd
    from repro.launch.mesh import _make_mesh
    from repro.models.model import Model

    arch, b, s_max, positions, out = json.loads(sys.argv[1])
    f32 = lambda a, smoke=False: get_config(a, True).with_(param_dtype="float32",
                                                          compute_dtype="float32")
    rd.get_config = f32
    cfg = f32(arch)
    model = Model(cfg)
    mesh = _make_mesh((2, 4), ("data", "model"))
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(21)
    shape = (cfg.n_layers, b, s_max, cfg.n_kv_heads, cfg.resolved_head_dim)
    arrays = {"k": rng.standard_normal(shape).astype(np.float32),
              "v": rng.standard_normal(shape).astype(np.float32),
              "token": rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)}
    res = {}
    cell = ShapeSpec("smoke", "decode", s_max, b)
    fn, _args, trips, _ = rd.build_cell(arch, cell, mesh)
    _, _, act = rd.policy_rules(arch, cell, mesh, "baseline")
    with mesh, activation_sharding(mesh, act):
        for pos in positions:
            caches = {k: jnp.asarray(arrays[k]) for k in ("k", "v")}
            logits, new = fn(params, jnp.asarray(arrays["token"]), jnp.int32(pos), caches)
            arrays["logits/%d" % pos] = np.asarray(logits)
            for k in ("k", "v"):
                arrays["%s/%d" % (k, pos)] = np.asarray(new[k])
        caches = {k: jnp.asarray(arrays[k]) for k in ("k", "v")}
        res["text"] = fn.lower(params, jnp.asarray(arrays["token"]), jnp.int32(0),
                               caches).compile().as_text()
    res["trips"] = trips
    res["act_rules"] = {k: list(v) if isinstance(v, tuple) else v for k, v in act.items()}
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    for path, leaf in flat:
        arrays["p/" + "/".join(k.key for k in path)] = np.asarray(leaf)
    np.savez(out + ".npz", **arrays)
    with open(out + ".json", "w") as fh:
        json.dump(res, fh)
    """
)

PMAX_MODULE = textwrap.dedent(
    """
    import torch
    from repro_torch.distributed.collectives import pmax
    from repro_torch.launch.mesh import _make_mesh

    def pmax_target(payload):
        mesh = _make_mesh(payload["mesh"], ("data", "model"), "cpu")
        x = torch.from_numpy(payload["x"][mesh.rank])
        out = [pmax(x, mesh, axes) for axes in payload["axes"]]
        y = x.clone().requires_grad_()
        try:
            pmax(y, mesh, "model").sum().backward()
            raised = False
        except NotImplementedError:
            raised = True
        return out, raised
    """
)


def _cfg(name=None):
    cfg = get_config(ARCH, smoke=True).with_(**F32)
    return cfg.with_(tie_embeddings=True) if name in TIED else cfg


def _params(name, ref):
    """The case's whole parameters: the reference's, without ``lm_head``
    for a tied head."""
    return {k: v for k, v in ref["params"].items() if not (name in TIED and k == "lm_head")}


def _decode_rules(mesh_shape):
    return sharding.decode_rules(mesh_mod.Mesh(tuple(mesh_shape), tuple(mesh_shape.values())))


def _mesh_shape(mesh):
    return dict(zip(("pod", "data", "model")[-len(mesh):], mesh))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ref") / "ref")
    env = {**os.environ, "PYTHONPATH": SRC}
    arg = json.dumps([ARCH, B8, S_MAX, list(POS), out])
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


def _caches(b, s_max, seed=31):
    cfg = _cfg()
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, b, s_max, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {k: rng.standard_normal(shape).astype(np.float32) for k in ("k", "v")}


def _token(b, n=1, seed=37):
    return np.random.default_rng(seed).integers(0, 256, (b, n))


def _case(name, ref):
    """A ``launch/sharded.py:run`` case (baseline policy: the decode rules
    from ``policy_rules``)."""
    a = ref["arrays"]
    if name == "cell_2x4":
        caches = {k: a[k] for k in ("k", "v")}
        return dict(mesh=(2, 4), decode=[dict(tokens=a["token"], caches=caches, pos=p,
                                              host_caches=True) for p in POS])
    if name in HANDOFF:
        mesh, b, s, ticks = HANDOFF[name]
        return dict(mesh=mesh, prefill=dict(tokens=_token(b, s, 41), s_max=S_MAX),
                    decode=[dict(tokens=_token(b, ticks, 43), host_caches=True)])
    mesh, b, s_max, positions = CASES[name]
    case = dict(mesh=mesh, decode=[dict(tokens=_token(b), caches=_caches(b, s_max), pos=p,
                                        host_caches=True) for p in positions])
    if name in TIED:
        case.update(cfg=dict(F32, tie_embeddings=True), params=_params(name, ref))
    return case


@pytest.fixture(scope="module")
def port(ref):
    """Every case on its ranks, one ``run_ranks`` call per world size →
    {name: [per rank]}."""
    out = {}
    common = dict(device="cpu", arch=ARCH, smoke=True, cfg=F32, params=ref["params"])
    for world, names in WORLD.items():
        if not names:
            continue
        t0 = time.monotonic()
        res = run_ranks("repro_torch.launch.sharded:run", world,
                        dict(common, cases=[_case(n, ref) for n in names]),
                        timeout_s=RANK_LIMIT)
        assert time.monotonic() - t0 < RANK_LIMIT
        for i, n in enumerate(names):
            out[n] = [r[i] for r in res]
    return out


def _one_rank(name, ref):
    """The port's one-rank model on the whole parameters → per entry, per
    tick (logits, caches after the tick) as numpy."""
    model = Model(_cfg(name))
    p = params_from_jax(_params(name, ref), "cpu")
    case = _case(name, ref)
    out = []
    with torch.no_grad():
        caches = None
        if "prefill" in case:
            tokens = torch.from_numpy(case["prefill"]["tokens"]).long()
            _, caches = model.prefill(p, {"tokens": tokens}, S_MAX)
            pos = tokens.shape[1]
        for entry in case["decode"]:
            if "caches" in entry:
                caches = {k: torch.from_numpy(v.copy()) for k, v in entry["caches"].items()}
                pos = entry["pos"]
            ticks = []
            for t in range(entry["tokens"].shape[1]):
                tok = torch.from_numpy(entry["tokens"][:, t:t + 1]).long()
                logits, caches = model.decode(p, tok, pos, caches)
                ticks.append((logits.numpy(), {k: v.numpy().copy() for k, v in caches.items()}))
                pos += 1
            out.append(ticks)
    return out


def _check_rank(r, mesh, logits, caches, tick=-1):
    """One rank's decode entry result against whole logits and caches."""
    rows, cols = slice(*r["rows"]), slice(*r["cols"])
    np.testing.assert_allclose(r["logits"][tick].numpy(), logits[rows, cols], atol=TOL, rtol=0)
    b, s_max = caches["k"].shape[1:3]
    fake = mesh_mod.Mesh(tuple(mesh), tuple(mesh.values()), None, r["rank"], {})
    axes = param_axes(Model(_cfg()).cache_defs(b, s_max))
    want = shard_params(caches, axes, fake, fake.coords, _decode_rules(mesh))
    for k in ("k", "v"):
        np.testing.assert_allclose(r["caches"][k].numpy(), want[k], atol=TOL, rtol=0)


def _with_rank(ranks, i):
    return [dict(r["decode"][i], rank=n) for n, r in enumerate(ranks)]


@pytest.mark.parametrize("pos", POS)
def test_8_ranks_match_reference_cell(pos, ref, port):
    """The (2, 4) rank mesh against ``build_cell``'s decode cell on 8 host
    devices: every rank's block of the logits and of the new caches within
    1e-5, at each ``pos``."""
    a = ref["arrays"]
    assert ref["act_rules"] == {"batch": ["data"], "kv_seq": "model", "d_inner": "model",
                                "vocab": "model"}
    i = POS.index(pos)
    caches = {k: a[f"{k}/{pos}"] for k in ("k", "v")}
    for r in _with_rank(port["cell_2x4"], i):
        assert r["logits"][0].shape == (B8 // 2, 256 // 4)
        assert r["kv"][1] - r["kv"][0] == S_MAX // 4
        _check_rank(r, dict(data=2, model=4), a[f"logits/{pos}"], caches)
    whole = assemble_tick(port["cell_2x4"], i, 0, B8, 256).numpy()
    np.testing.assert_allclose(whole, a[f"logits/{pos}"], atol=TOL, rtol=0)


def test_masked_blocks_add_nothing_and_stay_unwritten(ref, port):
    """A block wholly after ``pos`` is neither written nor lets a NaN in:
    at each ``pos`` the ranks whose positions all lie after it hold the
    input caches bitwise, and every logit is finite."""
    a = ref["arrays"]
    for i, pos in enumerate(POS):
        for r in _with_rank(port["cell_2x4"], i):
            assert torch.isfinite(r["logits"][0]).all()
            if r["kv"][0] > pos:
                fake = mesh_mod.Mesh(("data", "model"), (2, 4), None, r["rank"], {})
                axes = param_axes(Model(_cfg()).cache_defs(B8, S_MAX))
                want = shard_params({k: a[k] for k in ("k", "v")}, axes, fake, fake.coords,
                                    _decode_rules(dict(data=2, model=4)))
                for k in ("k", "v"):
                    assert np.array_equal(r["caches"][k].numpy(), want[k])
    assert [r["decode"][1]["kv"] for r in port["cell_2x4"]][:4] == [
        (0, 8), (8, 16), (16, 24), (24, 32)]


@pytest.mark.parametrize("name", list(CASES) + list(HANDOFF))
def test_cases_match_one_rank_model(name, ref, port):
    """Every tick of every case against the port's one-rank model on the
    same parameters, tokens and caches, within 1e-5: each rank's block of
    the logits at every tick, and of the caches after the entry."""
    mesh = _mesh_shape(_case(name, ref)["mesh"])
    for i, ticks in enumerate(_one_rank(name, ref)):
        for r in _with_rank(port[name], i):
            for t, (logits, _) in enumerate(ticks):
                rows, cols = slice(*r["rows"]), slice(*r["cols"])
                np.testing.assert_allclose(r["logits"][t].numpy(), logits[rows, cols],
                                           atol=TOL, rtol=0)
            _check_rank(r, mesh, *ticks[-1])


@pytest.mark.parametrize("name", list(HANDOFF))
def test_prefill_hands_its_caches_to_decode(name, ref, port):
    """The sharded prefill's caches are this rank's blocks of the one-rank
    prefill's (padded to ``s_max``) in the decode layout: its rows, its
    block of positions, every kv head."""
    mesh, b, s, _ = HANDOFF[name]
    model = Model(_cfg())
    tokens = torch.from_numpy(_token(b, s, 41)).long()
    with torch.no_grad():
        _, caches = model.prefill(params_from_jax(ref["params"], "cpu"), {"tokens": tokens},
                                  S_MAX)
    shape = _mesh_shape(mesh)
    axes = param_axes(model.cache_defs(b, S_MAX))
    for rank, r in enumerate(port[name]):
        fake = mesh_mod.Mesh(tuple(shape), tuple(shape.values()), None, rank, {})
        want = shard_params({k: v.numpy() for k, v in caches.items()}, axes, fake, fake.coords,
                            _decode_rules(shape))
        for k in ("k", "v"):
            got = r["prefill"]["caches"][k].numpy()
            assert got.shape[3] == 2 and got.shape[2] == S_MAX // shape["model"]
            np.testing.assert_allclose(got, want[k], atol=TOL, rtol=0)


@pytest.mark.parametrize("name", ["cell_2x4"] + list(CASES) + list(HANDOFF))
def test_collectives_equal_formula(name, ref, port):
    """Every tick's collectives on every rank, op for op, against
    ``sharded_collectives(step="decode")`` under the decode rules (and the
    handoff's prefill against ``step="prefill"``)."""
    case = _case(name, ref)
    shape = _mesh_shape(case["mesh"])
    for i, entry in enumerate(case["decode"]):
        tokens = entry["tokens"]
        s_max = entry["caches"]["k"].shape[2] if "caches" in entry else S_MAX
        want = sharded_collectives(_cfg(name), shape, _decode_rules(shape), tokens.shape[0], 1,
                                   4, 4, "decode", s_max=s_max)
        for r in port[name]:
            assert all(ops == want for ops in r["decode"][i]["ops"])
            assert r["route"]["backend"] == "gloo" and r["route"]["host_staged"] == 0
    if "prefill" in case:
        rules = {"batch": ("data",), "seq": "model", "vocab": "model"}
        want = sharded_collectives(_cfg(), shape, rules, *case["prefill"]["tokens"].shape, 4, 4,
                                   "prefill", s_max=S_MAX)
        assert any(op[3] == "prefill/cache" for op in want)
        assert all(r["prefill"]["ops"] == want for r in port[name])


def test_decode_wire_bytes_within_twice_the_compiled_cell(ref, port):
    """Total wire bytes a tick on a rank against the compiled cell's per
    device (by kind reported in the message; GSPMD picks its own ops)."""
    xla = _reference_ops(ref["text"], 8, ref["trips"])
    ops = [op for op in port["cell_2x4"][0]["decode"][0]["ops"][0] if op[3] != "decode/greedy"]
    got = _wire_by_kind([op[:3] + (1,) for op in ops])
    exp = _wire_by_kind(xla)
    print("wire bytes a tick, port", got, "compiled cell", exp)
    assert sum(got.values()) <= WIRE_FACTOR * sum(exp.values()), (got, exp)
    assert sum(got.values()) > 0 and sum(exp.values()) > 0


def test_greedy_tokens_are_the_whole_logits_argmax(ref, port):
    """The launcher's greedy pick over the vocabulary-split logits equals
    the argmax of the assembled logits, on every rank's rows."""
    for name in ("cell_2x4", "2x2", "pod_2x2x2"):
        ranks = port[name]
        b = _case(name, ref)["decode"][0]["tokens"].shape[0]
        whole = assemble_tick(ranks, 0, 0, b, 256).argmax(-1)
        for r in ranks:
            r0, r1 = r["decode"][0]["rows"]
            assert torch.equal(r["decode"][0]["tokens"][0], whole[r0:r1])


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)])
def test_pmax_is_the_maximum_and_has_no_backward(mesh, tmp_path):
    (tmp_path / "pmax_target.py").write_text(PMAX_MODULE)
    x = np.random.default_rng(5).standard_normal((4, 3, 5)).astype(np.float32)
    axes = ["model", "data", ["data", "model"]]
    res = run_ranks("pmax_target:pmax_target", 4, {"x": x, "mesh": mesh, "axes": axes},
                    timeout_s=RANK_LIMIT, env={"PYTHONPATH": str(tmp_path)})
    grid = x.reshape(mesh + x.shape[1:])
    for rank, (got, raised) in enumerate(res):
        d, m = divmod(rank, mesh[1])
        want = [grid[d].max(0), grid[:, m].max(0), grid.max((0, 1))]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
        assert raised == (mesh[1] > 1)


@pytest.mark.parametrize("s_max,b,kv", [(32, 4, (16, 24)), (30, 4, (0, 30)), (32, 3, (16, 24))])
def test_cache_layout_reads_the_decode_rules(s_max, b, kv):
    """The decode layout's block of positions and rows by ``spec_for``:
    rank 6 of (2, 4) holds positions 16–23 of 32, every position of 30
    (undivided), every row of a batch of 3 (undivided)."""
    mesh = mesh_mod.Mesh(("data", "model"), (2, 4), None, 6, {})
    rules = sharding.decode_rules(mesh)
    with actctx.activation_sharding(mesh, rules):
        lay = actctx.rank_layout(b, 1, 64)
        lay = actctx.cache_layout(lay, Model(_cfg()).cache_defs(b, s_max)["k"], rules)
    assert (lay.kv0, lay.kv0 + lay.kv_loc) == kv and lay.kv_sharded == (s_max % 4 == 0)
    assert (lay.b0, lay.b_loc) == ((2, 2) if b == 4 else (0, 3))
    assert not lay.seq_sharded


def test_decode_on_a_rank_mesh_refuses_what_it_cannot_place():
    """Without ``s_max``, with caches that are not the rank's blocks, or
    with caches whose batch would lie otherwise than the residual
    stream's, the sharded decode raises before any collective (a tied
    head decodes: ``tied_2x2``)."""
    mesh = mesh_mod.Mesh(("data", "model"), (2, 4), None, 6, {})
    rules = sharding.decode_rules(mesh)
    model = Model(_cfg())
    token = torch.zeros(4, 1, dtype=torch.long)
    whole = model.init_caches(4, S_MAX, "cpu")
    with torch.no_grad(), actctx.activation_sharding(mesh, rules):
        with pytest.raises(ValueError, match="s_max"):
            model.decode({}, token, 3, whole)
        with pytest.raises(ValueError, match="not this rank's"):
            model.decode({}, token, 3, whole, S_MAX)
    pod = mesh_mod.Mesh(("pod", "data", "model"), (2, 2, 2), None, 3, {})
    with actctx.activation_sharding(pod, {"batch": ("data",), "vocab": "model"}):
        lay = actctx.rank_layout(4, 1, 64)
        with pytest.raises(NotImplementedError, match="caches"):
            actctx.cache_layout(lay, model.cache_defs(4, S_MAX)["k"], sharding.decode_rules(pod))
