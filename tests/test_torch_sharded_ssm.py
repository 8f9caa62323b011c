"""The port's sharded SSM family on gloo ranks, against the reference's
compiled cells on forced host devices, and the tied head on a rank mesh.

One subprocess runs the reference on 8 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``): falcon-mamba-7b
at smoke width in float32 (2 layers, d 64, ``d_inner`` 128, N 4, dt_rank
8, vocabulary 256, tied head), its parameters from the reference's
``init_params``, tokens and states from a numpy seed.  On a (2, 4) mesh,
inside ``with mesh, activation_sharding(mesh, act_rules)`` as ``run_cell``
does, it runs ``launch/dryrun.py::build_cell``'s prefill cell (its states
written under ``ACT_RULES_DECODE``: ``d_inner`` over ``model``),
``make_eval_step``'s loss jitted with ``param_shardings``, the train cell
(accum 2) under ``baseline``, ``opt`` as it stands (small-DP at smoke
width) and ``opt`` with ``rd.SMALL_MODEL_PARAMS = 0``
(``ACT_RULES_TRAIN_OPT``), and the decode cell for two chained ticks at
batch 4 and for one ``long_500k``-style tick at batch 1 (which ``data``
2 does not divide) at ``pos`` 524 287.  It writes every output and each
cell's compiled text.

The port runs the same cells on 8 spawned gloo ranks as a (2, 4) rank mesh
(``launch/sharded.py``, each rank holding its blocks of the reference's
parameters), and more cases on 4 and 8 ranks against the port's one-rank
model: (1, 4) and (2, 2), a (2, 2, 2) ``("pod", "data", "model")`` mesh,
``d_inner`` 126 on ``model`` 4 (every rank holds every channel), a batch
of 3 on ``data`` 2 (whose ticks keep the weights' ``d_model`` blocks in
place, as the batch-1 cell's do), each as a prefill whose states feed 3
teacher-forced decode ticks, and the loss;
the eval through ``ssm_impl="pallas"`` (K4's plain version on the CPU)
against the time loop; the train step on (1, 4), (2, 2), (2, 2) without
``remat`` and the pod mesh; and mistral-nemo-12b at smoke width with a
tied head (prefill, loss, train step).  Checked: values within 1e-5 (the
moments also within 1e-4 of each leaf's largest, as in
``tests/test_torch_sharded_train.py``); every rank's counted collectives
equal to ``launch/sharded.py::sharded_collectives``; each cell's wire
bytes a step against the compiled cell's (by the rule below, fixed before
the first run).

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
from repro_torch.launch.sharded import (
    assemble_logits,
    assemble_tick,
    cache_slab,
    seeded_caches,
    sharded_collectives,
)
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import Model
from repro_torch.models.params import flatten, param_axes
from repro_torch.optim import AdamW, warmup_cosine
from test_torch_sharded import F32, SRC, TOL, _reference_ops, _wire_by_kind
from test_torch_sharded_train import THRESHOLD_MODULE

ARCH = "falcon-mamba-7b"
DENSE = "mistral-nemo-12b"
REL = 1e-4          # of each leaf's largest |m| or |v|
RANK_LIMIT = 240    # seconds for one multi-rank run
B8, S8 = 4, 16      # the prefill and loss cell: batch over data 2, sequence over model 4
S_MAX = 32          # the one-rank comparisons' prefill (the tied dense model's caches)
BT, ACCUM = 16, 2   # the train cell: each microbatch of 8 rows splits over data × model
TICKS = [("b4", 4, 2, S8), ("long", 1, 1, 524_287)]   # (name, batch, ticks, pos)
# The rule for the wire bytes, fixed before the test first ran: GSPMD picks
# its own ops (and may gather weights where the port gathers activations),
# so only a step's total is bounded, by this factor (the launcher's greedy
# pick, which the decode cell does not make, left out).
WIRE_FACTOR = 2.0
# (policy, SMALL_MODEL_PARAMS) of each reference train cell; None keeps 2e8
POLICIES = {"baseline": ("baseline", None), "small_dp": ("opt", None), "opt": ("opt", 0)}
BASE = {"batch": ("data",), "seq": "model", "vocab": "model"}
UNDIVIDED = dict(d_model=63)     # d_inner 126 on model 4
TIED = dict(tie_embeddings=True)

# the one-rank comparisons: name → (mesh, arch, cfg overrides, batch, steps);
# "serve" runs a prefill, 3 teacher-forced ticks from its states and the
# loss; "pallas" the loss through K4's path; "train" a train step (accum 2)
CASES = {
    "1x4": ((1, 4), ARCH, {}, 2, "serve"),
    "2x2": ((2, 2), ARCH, {}, 4, "serve"),
    "pod_2x2x2": ((2, 2, 2), ARCH, {}, 4, "serve"),
    "di_undivided_1x4": ((1, 4), ARCH, UNDIVIDED, 2, "serve"),
    "batch_undivided_2x2": ((2, 2), ARCH, {}, 3, "serve"),   # decode keeps d_model blocks
    "pallas_2x2": ((2, 2), ARCH, {"ssm_impl": "pallas"}, 4, "pallas"),
    "train_1x4": ((1, 4), ARCH, {}, 4, "train"),
    "train_2x2": ((2, 2), ARCH, {}, 8, "train"),
    "train_noremat_2x2": ((2, 2), ARCH, {"remat": False}, 8, "train"),
    "train_pod_2x2x2": ((2, 2, 2), ARCH, {}, 8, "train"),
    "tied_dense_2x2": ((2, 2), DENSE, TIED, 4, "serve"),
    "tied_dense_train_2x2": ((2, 2), DENSE, TIED, 8, "train"),
}
CELLS = ["cell_2x4"] + [f"train_{p}" for p in POLICIES]
WORLD = {8: list(CELLS), 4: []}
for _n, (_m, *_) in CASES.items():
    WORLD[int(np.prod(_m))].append(_n)

REF_SCRIPT = textwrap.dedent(
    """
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config
    from repro.configs.base import ShapeSpec
    from repro.distributed.actctx import activation_sharding
    from repro.distributed.sharding import param_shardings
    from repro.launch import dryrun as rd
    from repro.launch.inputs import train_inputs
    from repro.launch.mesh import _make_mesh
    from repro.launch.steps import make_eval_step
    from repro.models.model import Model
    from repro.optim.adamw import AdamW

    arch, b, s, bt, accum, policies, ticks, out = json.loads(sys.argv[1])
    f32 = lambda a, smoke=False: get_config(a, True).with_(param_dtype="float32",
                                                          compute_dtype="float32")
    rd.get_config = f32
    cfg = f32(arch)
    model = Model(cfg)
    mesh = _make_mesh((2, 4), ("data", "model"))
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    arrays = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
              "train_tokens": rng.integers(0, cfg.vocab_size, (bt, s)).astype(np.int32)}
    res = {"texts": {}, "trips": {}, "act": {}}

    def save(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            arrays[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)

    def cell(name, shape, policy="baseline"):
        fn, _args, trips, _ = rd.build_cell(arch, shape, mesh, accum=accum, policy=policy)
        res["trips"][name] = trips
        res["act"][name] = json.loads(json.dumps(rd.policy_rules(arch, shape, mesh, policy)[2]))
        return fn, rd.policy_rules(arch, shape, mesh, policy)[2]

    save("p/", params)
    fn, act = cell("prefill", ShapeSpec("smoke", "prefill", s, b))
    batch = {"tokens": arrays["tokens"]}
    with mesh, activation_sharding(mesh, act):
        logits, caches = fn(params, batch)
        res["texts"]["prefill"] = fn.lower(params, batch).compile().as_text()
    arrays["prefill/logits"] = np.asarray(logits)
    save("prefill/caches/", caches)

    tshape = ShapeSpec("smoke", "train", s, b)
    act_t = rd.policy_rules(arch, tshape, mesh, "baseline")[2]
    ev = jax.jit(make_eval_step(model), in_shardings=(param_shardings(model.defs(), mesh),
                                                      train_inputs(cfg, tshape, mesh)[1]))
    with mesh, activation_sharding(mesh, act_t):
        res["loss"] = {k: float(v) for k, v in ev(params, batch).items()}

    for name, (policy, threshold) in policies.items():
        rd.SMALL_MODEL_PARAMS = 2e8 if threshold is None else threshold
        fn, act = cell("train/" + name, ShapeSpec("smoke", "train", s, bt), policy)
        state = AdamW().init(params)
        tb = {"tokens": arrays["train_tokens"]}
        with mesh, activation_sharding(mesh, act):
            compiled = fn.lower(params, state, tb).compile()
            new_p, new_s, metrics = compiled(*jax.device_put((params, state, tb),
                                                             compiled.input_shardings[0]))
        res["texts"]["train/" + name] = compiled.as_text()
        res["train/" + name] = {k: float(v) for k, v in metrics.items()}
        for tree, t in (("params", new_p), ("m", new_s.m), ("v", new_s.v)):
            save("train/%s/%s/" % (name, tree), t)
    rd.SMALL_MODEL_PARAMS = 2e8

    L, k, d_in, n = cfg.n_layers, cfg.ssm_conv, cfg.d_inner, cfg.ssm_state
    for name, bd, n_ticks, pos in ticks:
        fn, act = cell("decode/" + name, ShapeSpec("smoke", "decode", s, bd))
        states = {"conv": rng.standard_normal((L, bd, k - 1, d_in)).astype(np.float32),
                  "h": rng.standard_normal((L, bd, d_in, n)).astype(np.float32)}
        tok = rng.integers(0, cfg.vocab_size, (bd, n_ticks)).astype(np.int32)
        arrays["decode/%s/tokens" % name] = tok
        save("decode/%s/caches/" % name, states)
        cur = {key: jnp.asarray(v) for key, v in states.items()}
        with mesh, activation_sharding(mesh, act):
            res["texts"]["decode/" + name] = fn.lower(
                params, jnp.asarray(tok[:, :1]), jnp.int32(pos), cur).compile().as_text()
            for t in range(n_ticks):
                logits, cur = fn(params, jnp.asarray(tok[:, t:t + 1]), jnp.int32(pos + t), cur)
                arrays["decode/%s/logits/%d" % (name, t)] = np.asarray(logits)
        save("decode/%s/after/" % name, cur)
    np.savez(out + ".npz", **arrays)
    with open(out + ".json", "w") as fh:
        json.dump(res, fh)
    """
)


def _cfg(arch=ARCH, **over):
    return get_config(arch, smoke=True).with_(**F32, **over)


def _tree(arrays, prefix):
    out = {}
    for key, val in arrays.items():
        if key.startswith(prefix):
            node = out
            *head, last = key[len(prefix):].split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = val
    return out


def _mesh_shape(mesh):
    return dict(zip(("pod", "data", "model")[-len(mesh):], mesh))


def _fake(shape, rank):
    return mesh_mod.Mesh(("pod", "data", "model")[-len(shape):], shape, None, rank, {})


def _decode_rules(shape):
    return sharding.decode_rules(mesh_mod.Mesh(tuple(shape), tuple(shape.values())))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ref_ssm") / "ref")
    env = {**os.environ, "PYTHONPATH": SRC}
    arg = json.dumps([ARCH, B8, S8, BT, ACCUM, POLICIES, TICKS, out])
    proc = subprocess.run([sys.executable, "-c", REF_SCRIPT, arg], capture_output=True,
                          text=True, env=env, timeout=400)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out + ".json") as fh:
        res = json.load(fh)
    res["arrays"] = dict(np.load(out + ".npz"))
    res["params"] = _tree(res["arrays"], "p/")
    return res


def _whole_params(name, ref):
    """The whole parameters (numpy) a case runs on: the reference's for
    falcon-mamba-7b at the cell's width, else the port's from seed 0."""
    _, arch, over, _, _ = CASES.get(name, (None, ARCH, {}, None, None))
    if arch == ARCH and not set(over) & {"d_model", "tie_embeddings"}:
        return ref["params"]
    p = Model(_cfg(arch, **over)).init(torch.Generator().manual_seed(0), "cpu")
    return {k: v for k, v in _numpy(p).items()}


def _numpy(tree):
    return {k: _numpy(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.numpy()


def _tokens(b, n=S8, seed=7):
    return np.random.default_rng(seed).integers(0, 256, (b, n))


def _case(name, ref):
    """A ``launch/sharded.py:run`` case (the baseline policy unless named)."""
    a = ref["arrays"]
    if name == "cell_2x4":
        decode = [dict(tokens=a[f"decode/{t}/tokens"], caches=_tree(a, f"decode/{t}/caches/"),
                       pos=pos, host_caches=True) for t, _, _, pos in TICKS]
        return dict(mesh=(2, 4), prefill=dict(tokens=a["tokens"]), decode=decode,
                    loss=dict(tokens=a["tokens"]))
    if name in CELLS:
        policy, threshold = POLICIES[name[len("train_"):]]
        return dict(mesh=(2, 4), policy=policy, small_model_params=threshold,
                    train=dict(tokens=a["train_tokens"], accum=ACCUM))
    mesh, arch, over, b, kind = CASES[name]
    case = dict(mesh=mesh, arch=arch, cfg=dict(F32, **over), params=_whole_params(name, ref))
    if kind == "serve":
        case.update(prefill=dict(tokens=_tokens(b), s_max=S_MAX), loss=dict(tokens=_tokens(b)),
                    decode=[dict(tokens=_tokens(b, 3, 43), host_caches=True)])
    elif kind == "pallas":
        case["loss"] = dict(tokens=_tokens(b))
    else:
        case["train"] = dict(tokens=_tokens(b), accum=ACCUM)
    return case


@pytest.fixture(scope="module")
def port(ref, tmp_path_factory):
    """Every case on its ranks, one ``run_ranks`` call per world size →
    {name: [per rank]}."""
    mod_dir = tmp_path_factory.mktemp("threshold_target_ssm")
    (mod_dir / "threshold_target.py").write_text(THRESHOLD_MODULE)
    common = dict(device="cpu", arch=ARCH, smoke=True, cfg=F32, params=ref["params"])
    out = {}
    for world, names in WORLD.items():
        t0 = time.monotonic()
        res = run_ranks("threshold_target:run", world,
                        dict(common, cases=[_case(n, ref) for n in names]),
                        timeout_s=RANK_LIMIT, env={"PYTHONPATH": str(mod_dir)})
        assert time.monotonic() - t0 < RANK_LIMIT
        for i, n in enumerate(names):
            out[n] = [r[i] for r in res]
    return out


def _one_rank(name, ref):
    """The port's one-rank model on the case's whole parameters: the
    prefill's logits and states, each tick's logits and the states after
    the last, the loss (through the time loop); or the train step's."""
    mesh, arch, over, b, kind = CASES[name]
    cfg = _cfg(arch, **over)
    model = Model(cfg.with_(ssm_impl="xla"))
    p = params_from_jax(_whole_params(name, ref), "cpu")
    case = _case(name, ref)
    if kind == "train":
        opt = AdamW(lr=warmup_cosine(3e-4, 2000, 100_000))
        new_p, state, metrics = make_train_step(Model(cfg), opt, accum=ACCUM)(
            p, opt.init(p), {"tokens": torch.as_tensor(case["train"]["tokens"])})
        return dict(params=_numpy(new_p), m=_numpy(state.m), v=_numpy(state.v),
                    loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]))
    out = {}
    with torch.no_grad():
        out["loss"] = float(model.loss(p, {"tokens": torch.as_tensor(case["loss"]["tokens"])})[0])
        if kind == "pallas":
            return out
        tokens = torch.as_tensor(case["prefill"]["tokens"])
        logits, caches = model.prefill(p, {"tokens": tokens}, S_MAX)
        out.update(logits=logits.numpy(), caches={k: v.numpy().copy() for k, v in caches.items()})
        fed, pos, ticks = case["decode"][0]["tokens"], S8, []
        for t in range(fed.shape[1]):
            lg, caches = model.decode(p, torch.as_tensor(fed[:, t:t + 1]), pos + t, caches)
            ticks.append(lg.numpy())
        out.update(ticks=ticks, after={k: v.numpy() for k, v in caches.items()})
    return out


def _check_caches(got, whole, shape, rank, b):
    """One rank's host caches against its blocks of the whole ones under
    the decode rules."""
    fake = _fake(tuple(shape.values()), rank)
    axes = param_axes(Model(_cfg(ARCH if "h" in whole else DENSE)).cache_defs(b, S_MAX))
    want = shard_params(whole, axes, fake, fake.coords, _decode_rules(shape))
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), w, atol=TOL, rtol=0)


def _check_train(ranks, want, shape, arch=ARCH, over=None):
    """Every rank's loss, grad norm and blocks of the new parameters, ``m``
    and ``v`` against ``want`` (whole trees)."""
    axes = Model(_cfg(arch, **(over or {}))).axes()
    for rank, r in enumerate(ranks):
        t = r["train"]
        assert abs(t["loss"][0] - want["loss"]) <= TOL
        assert abs(t["grad_norm"][0] - want["grad_norm"]) <= TOL
        mesh = _fake(shape, rank)
        for tree in ("params", "m", "v"):
            blocks = dict(flatten(shard_params(want[tree], axes, mesh, mesh.coords,
                                               r["param_rules"])))
            for path, got in flatten(t[tree]):
                exp = blocks[path]
                assert got.shape == exp.shape, (tree, path)
                err = float(np.abs(got.numpy() - exp).max())
                bound = TOL if tree == "params" else min(TOL, REL * float(np.abs(exp).max()))
                assert err <= bound, (rank, tree, "/".join(path), err, bound)


def test_prefill_and_loss_on_8_ranks_match_reference_cell(ref, port):
    """The (2, 4) rank mesh against ``build_cell``'s prefill and the jitted
    ``make_eval_step``: every rank's block of the logits, its block of the
    states (its rows, ``d_inner`` over ``model``) and the loss within
    1e-5."""
    a, ranks = ref["arrays"], port["cell_2x4"]
    assert ref["act"]["prefill"] == {k: list(v) if isinstance(v, tuple) else v
                                     for k, v in BASE.items()}
    np.testing.assert_allclose(assemble_logits(ranks, B8, 256).numpy(), a["prefill/logits"],
                               atol=TOL, rtol=0)
    for rank, r in enumerate(ranks):
        assert r["prefill"]["logits"].shape == (B8 // 2, 256 // 4)
        assert r["prefill"]["caches"]["h"].shape == (2, B8 // 2, 128 // 4, 4)
        _check_caches(r["prefill"]["caches"], _tree(a, "prefill/caches/"),
                      dict(data=2, model=4), rank, B8)
        assert abs(r["loss"]["loss"] - ref["loss"]["loss"]) <= TOL
        assert abs(r["loss"]["ce"] - ref["loss"]["ce"]) <= TOL


@pytest.mark.parametrize("name", [t[0] for t in TICKS])
def test_decode_on_8_ranks_matches_reference_cell(name, ref, port):
    """The decode cell under ``ACT_RULES_DECODE``: two chained ticks at
    batch 4 (rows over ``data``), and a ``long_500k``-style tick at batch 1
    (every rank holds the row) at ``pos`` 524 287: each tick's logits and
    the states after the last within 1e-5."""
    a = ref["arrays"]
    i, (_, b, n, _) = next((i, t) for i, t in enumerate(TICKS) if t[0] == name)
    assert ref["act"][f"decode/{name}"]["d_inner"] == "model"
    ranks = port["cell_2x4"]
    for t in range(n):
        np.testing.assert_allclose(assemble_tick(ranks, i, t, b, 256).numpy(),
                                   a[f"decode/{name}/logits/{t}"], atol=TOL, rtol=0)
    for rank, r in enumerate(ranks):
        entry = r["decode"][i]
        assert entry["kv"][1] - entry["kv"][0] == 128 // 4
        assert entry["rows"][1] - entry["rows"][0] == (b // 2 if b % 2 == 0 else b)
        _check_caches(entry["caches"], _tree(a, f"decode/{name}/after/"),
                      dict(data=2, model=4), rank, b)


@pytest.mark.parametrize("name", list(POLICIES))
def test_train_on_8_ranks_matches_reference_cell(name, ref, port):
    """The (2, 4) rank mesh's train step against ``build_cell``'s compiled
    train cell (accum 2) under the policy: loss, grad norm and every
    rank's block of the new parameters, ``m`` and ``v``."""
    want = dict(ref[f"train/{name}"],
                **{t: _tree(ref["arrays"], f"train/{name}/{t}/") for t in ("params", "m", "v")})
    _check_train(port[f"train_{name}"], want, (2, 4))
    canon = json.loads(json.dumps(port[f"train_{name}"][0]["rules"]))
    assert canon == ref["act"][f"train/{name}"]


@pytest.mark.parametrize("name", list(CASES))
def test_cases_match_one_rank_model(name, ref, port):
    """Every other layout against the port's one-rank model on the same
    parameters and tokens, within 1e-5: the prefill's logits and its
    states (already the decode layout's blocks), each tick fed from them
    and the states after, the loss; the eval through K4's path against
    the time loop; the train step."""
    mesh, arch, over, b, kind = CASES[name]
    want, ranks, shape = _one_rank(name, ref), port[name], _mesh_shape(mesh)
    if kind == "train":
        _check_train(ranks, want, mesh, arch, over)
        return
    for r in ranks:
        assert abs(r["loss"]["loss"] - want["loss"]) <= TOL
    if kind == "pallas":
        return
    np.testing.assert_allclose(assemble_logits(ranks, b, 256).numpy(), want["logits"],
                               atol=TOL, rtol=0)
    for t, lg in enumerate(want["ticks"]):
        np.testing.assert_allclose(assemble_tick(ranks, 0, t, b, 256).numpy(), lg,
                                   atol=TOL, rtol=0)
    for rank, r in enumerate(ranks):
        if arch == ARCH:
            _check_caches(r["prefill"]["caches"], want["caches"], shape, rank, b)
        _check_caches(r["decode"][0]["caches"], want["after"], shape, rank, b)


def test_states_lie_as_the_decode_rules_place_them(port):
    """``d_inner`` over ``model`` where it divides (32 channels a rank on
    (1, 4)), whole where it does not (126 on 4); the prefill's states move
    no bytes (no ``prefill/cache`` op)."""
    assert [r["decode"][0]["kv"] for r in port["1x4"]] == [(0, 32), (32, 64), (64, 96),
                                                           (96, 128)]
    assert all(r["decode"][0]["kv"] == (0, 126) for r in port["di_undivided_1x4"])
    assert all(r["prefill"]["caches"]["conv"].shape == (2, 2, 3, 126)
               for r in port["di_undivided_1x4"])
    for name in ("1x4", "2x2", "pod_2x2x2", "di_undivided_1x4", "cell_2x4"):
        assert not any(op[3] == "prefill/cache" for r in port[name] for op in r["prefill"]["ops"])
    assert all(r["kv_heads"] is None for r in port["1x4"])


def test_ticks_of_an_unsplit_batch_gather_no_weights(port):
    """Where the batch does not split over ``data`` (1 row, or 3 on 2) a
    tick keeps every ``d_model`` block in place: it gathers no weights,
    only rows' activations, while a tick whose batch splits gathers each
    layer's."""
    ticks = [port["cell_2x4"][0]["decode"][1], port["batch_undivided_2x2"][0]["decode"][0]]
    for entry in ticks:
        ops = [op for tick in entry["ops"] for op in tick]
        assert not any(op[3] in ("embed", "layer", "head") and op[0] == "all-gather"
                       for op in ops)
        assert {"mamba/in", "mamba/data", "embed/data"} <= {op[3] for op in ops}
    split = port["cell_2x4"][0]["decode"][0]["ops"][0]
    assert sum(op[3] == "layer" for op in split) == 2


def _steps(name, ref):
    """The case, and (step, cfg, mesh shape, batch, sequence) of each of
    its counted train, prefill and loss steps, for the formula."""
    case = _case(name, ref)
    shape = _mesh_shape(case["mesh"])
    cfg = _cfg(case.get("arch", ARCH), **{k: v for k, v in case.get("cfg", {}).items()
                                         if k not in F32})
    out = []
    for step in ("train", "prefill", "loss"):
        if step in case:
            b, s = case[step]["tokens"].shape
            out.append((step, cfg, shape, b, s))
    return case, out


@pytest.mark.parametrize("name", CELLS + list(CASES))
def test_collectives_equal_formula(name, ref, port):
    """Every rank's counted collectives of every step — the train step's
    backward and sums included, each decode tick — against
    ``sharded_collectives``, op for op."""
    case, steps = _steps(name, ref)
    for r in port[name]:
        for step, cfg, shape, b, s in steps:
            want = sharded_collectives(cfg, shape, r["rules"], b, s, 4, 4, step,
                                       case.get("train", {}).get("accum", 1),
                                       r["param_rules"], s_max=S_MAX)
            assert r[step]["ops"] == want, step
        for i, entry in enumerate(case.get("decode", [])):
            b = entry["tokens"].shape[0]
            want = sharded_collectives(steps[0][1], _mesh_shape(case["mesh"]),
                                       _decode_rules(_mesh_shape(case["mesh"])), b, 1, 4, 4,
                                       "decode", s_max=S_MAX)
            assert all(ops == want for ops in r["decode"][i]["ops"])
        assert r["route"]["backend"] == "gloo" and r["route"]["host_staged"] == 0


@pytest.mark.parametrize("cell", ["prefill", "decode/b4", "decode/long"]
                         + [f"train/{p}" for p in POLICIES])
def test_wire_bytes_within_factor_of_compiled_cell(cell, ref, port):
    """Total wire bytes a step on a rank against the compiled cell's per
    device (by kind in the message; GSPMD picks its own ops)."""
    xla = _reference_ops(ref["texts"][cell], 8, ref["trips"][cell])
    if cell.startswith("train/"):
        ops = port["train_" + cell[len("train/"):]][0]["train"]["ops"]
    elif cell.startswith("decode/"):
        i = [t[0] for t in TICKS].index(cell[len("decode/"):])
        ops = [op for op in port["cell_2x4"][0]["decode"][i]["ops"][0]
               if op[3] != "decode/greedy"]
    else:
        ops = port["cell_2x4"][0]["prefill"]["ops"]
    got = _wire_by_kind([op[:3] + (1,) for op in ops])
    exp = _wire_by_kind(xla)
    print(f"wire bytes ({cell}), port", got, "compiled cell", exp,
          "ratio", sum(got.values()) / sum(exp.values()))
    assert sum(got.values()) <= WIRE_FACTOR * sum(exp.values()), (got, exp)
    assert sum(got.values()) > 0 and sum(exp.values()) > 0


def test_ssm_ops_by_the_formula():
    """A mamba layer's collectives on (2, 4) under the baseline: the
    layer's gather over ``data``, the sequence's over ``model``, one
    float32 sum of the ``[b, S, dt_rank + 2N]`` partial products, the
    output's reduce-scatter; none of them where ``d_inner`` stays whole
    but the two gathers; the tied head gathers the embedding."""
    cfg = _cfg()
    shape = dict(data=2, model=4)
    ops = sharded_collectives(cfg, shape, BASE, 4, 16, 4, 4, "loss")
    layer = [op for op in ops if op[3].startswith(("layer", "mamba/"))][:4]
    assert [op[3] for op in layer] == ["layer", "mamba/in", "mamba/dtbc", "mamba/out"]
    assert layer[2] == ("all-reduce", 2 * 16 * (8 + 2 * 4) * 4, 4, "mamba/dtbc")
    head = [op for op in ops if op[3] == "head"]
    assert head == [("all-gather", (64 + 256 // 4 * 64) * 4, 2, "head")]
    whole = sharded_collectives(cfg.with_(d_model=63), dict(data=1, model=4), BASE, 2, 16, 4,
                                4, "loss")
    assert not any(op[3] in ("mamba/dtbc", "mamba/out") for op in whole)


@pytest.mark.parametrize("b,small_dp", [(4, False), (3, False), (4, True)])
def test_cache_layout_places_the_states(b, small_dp):
    """Rank 5 of (2, 4) under the decode rules: its rows (every row of 3),
    channels 32–63 of 128; with ``d_inner`` whole in the parameter rules
    (small-DP's) the states' split raises, since the layer runs on the
    parameters' block."""
    mesh = _fake((2, 4), 5)
    rules = sharding.decode_rules(mesh)
    model = Model(_cfg())
    param_rules = sharding.PARAM_RULES_SMALL_DP if small_dp else sharding.PARAM_RULES
    with actctx.activation_sharding(mesh, rules, param_rules):
        lay = actctx.rank_layout(b, 1, 64)
        if small_dp:
            with pytest.raises(NotImplementedError, match="caches"):
                model.cache_layout(lay, 0, rules)
            return
        lay = model.cache_layout(lay, 0, rules)
    assert (lay.di0, lay.di_loc, lay.di_sharded) == (32, 32, True)
    assert (lay.b0, lay.b_loc) == ((2, 2) if b == 4 else (0, 3))


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_seeded_states_are_the_whole_states_blocks(shape):
    """``seeded_caches`` of an SSM (``conv`` in the compute dtype, ``h`` in
    float32) on each rank: its blocks of the whole draw, each slab a
    function of (seed, layer, leaf) alone."""
    model = Model(_cfg().with_(compute_dtype="bfloat16"))
    whole = seeded_caches(model, 4, 0, 5, "cpu")
    assert whole["conv"].dtype == torch.bfloat16 and whole["h"].dtype == torch.float32
    assert torch.equal(whole["h"][1], cache_slab(model.cfg, 4, 0, 5, 1, "h", "cpu"))
    axes = param_axes(model.cache_defs(4, 0))
    for rank in range(4):
        mesh = _fake(shape, rank)
        rules = sharding.decode_rules(mesh)
        part = seeded_caches(model, 4, 0, 5, "cpu", mesh, rules)
        want = shard_params(whole, axes, mesh, mesh.coords, rules)
        for k in ("conv", "h"):
            assert torch.equal(part[k], want[k]), k
