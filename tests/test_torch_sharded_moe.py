"""The port's sharded MoE family on gloo ranks, against the reference's
compiled cells on forced host devices.

A subprocess for each config runs the reference on 8 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``), for two MoE
models at smoke width in float32: moonshot-v1-16b-a3b (2 layers, d 64, 4
heads, 8 experts, top-2, ``d_ff`` 64, vocabulary 256) and phi3.5-moe (4
experts, 2 kv heads, which do not divide ``model`` 4), their parameters
from the reference's ``init_params``, tokens and caches from a numpy seed.
On a (2, 4) mesh, inside ``with mesh, activation_sharding(mesh,
act_rules)`` as ``run_cell`` does, it runs ``launch/dryrun.py::
build_cell``'s prefill cell under the baseline policy (GSPMD's gather
dispatch) and under ``opt`` (the a2a dispatch; caches under
``ACT_RULES_DECODE``), ``make_eval_step``'s loss, the train cell (accum
2) under ``baseline``, ``opt`` as it stands (small-DP at smoke width) and
``opt`` with ``rd.SMALL_MODEL_PARAMS = 0`` (``ACT_RULES_TRAIN_OPT`` with
the a2a dispatch), and the decode cell for two chained ticks under each
of ``baseline`` and ``opt``.  It writes every output and each cell's
compiled text.

The port runs the same cells on 8 spawned gloo ranks as a (2, 4) rank
mesh (``launch/sharded.py``, each rank holding its blocks of the
reference's parameters), and more cases on 4 and 8 ranks against the
port's one-rank model: (1, 4), (2, 2), phi3.5-moe on (2, 2), a (2, 2, 2)
``("pod", "data", "model")`` mesh, 6 experts on ``model`` 4 (each rank
holds every expert's ``d_ff`` block), a batch of 3 on ``data`` 2, and the
a2a dispatch at a capacity that drops nothing (where it equals the gather
dispatch), each as a prefill whose caches feed 3 teacher-forced ticks,
and the loss; the train step on (1, 4), (2, 2), (2, 2) without
``remat``, the pod mesh, 6 experts, the a2a dispatch under both ``opt``
rules (and where small-DP's residual stream and the a2a lay the batch out
apart), and with ``aux_loss_weight`` raised.  Checked: values within 1e-5
(the moments also within 1e-4 of each leaf's largest, as in
``tests/test_torch_sharded_train.py``); the routing of every prefill and
loss (``moe.recording()``: each rank's expert ids and kept entries) equal
to the one-rank model's, a flip allowed only at a near tie
(``NEAR_TIE``); every rank's counted collectives equal to
``launch/sharded.py::sharded_collectives``; each cell's wire bytes a step
against the compiled cell's (by the rule below, fixed before the first
run).

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
from repro_torch.distributed import sharding
from repro_torch.distributed.ranks import run_ranks
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.sharded import assemble_logits, assemble_tick, sharded_collectives
from repro_torch.launch.steps import make_train_step
from repro_torch.models import moe
from repro_torch.models.model import Model
from repro_torch.models.params import flatten, param_axes
from repro_torch.optim import AdamW, warmup_cosine
from test_torch_sharded import F32, SRC, TOL, _reference_ops, _wire_by_kind
from test_torch_sharded_train import THRESHOLD_MODULE

MOON = "moonshot-v1-16b-a3b"
PHI = "phi3.5-moe-42b-a6.6b"
ARCHS = {"moon": MOON, "phi": PHI}
REL = 1e-4          # of each leaf's largest |m| or |v|
RANK_LIMIT = 240    # seconds for one multi-rank run
NEAR_TIE = 2.0 ** -7    # tests/test_torch_models.py's
B8, S8 = 4, 16      # the prefill and loss cell: batch over data 2, sequence over model 4
S_MAX = 32          # the caches' length: the prefills' and the decode cell's
BT, ACCUM = 16, 2   # the train cell: each microbatch of 8 rows splits over data × model
DEC_B, DEC_POS, DEC_TICKS = 4, 19, 2
# The rule for the wire bytes, fixed before the test first ran: GSPMD picks
# its own ops (and may gather weights where the port gathers activations),
# so only a step's total is bounded, by this factor (the launcher's greedy
# pick, which the decode cell does not make, left out).
WIRE_FACTOR = 2.0
# (policy, SMALL_MODEL_PARAMS) of each reference train cell; None keeps 2e8
POLICIES = {"baseline": ("baseline", None), "small_dp": ("opt", None), "opt": ("opt", 0)}
SERVE_POLICIES = ("baseline", "opt")
NO_DROP = dict(capacity_factor=8.0)     # the a2a dispatch's per-rank capacity drops nothing
AUX = dict(aux_loss_weight=10.0)        # the balance term's gradient well above the tolerance

# the one-rank comparisons: name → (mesh, arch, cfg overrides, batch, kind,
# policy, SMALL_MODEL_PARAMS); "serve" runs a prefill, 3 teacher-forced
# ticks from its caches and the loss ("prefill" the first two only, under
# opt: its loss cell is a train cell), "train" a train step (accum 2)
CASES = {
    "1x4": ((1, 4), MOON, {}, 2, "serve", "baseline", None),
    "2x2": ((2, 2), MOON, {}, 4, "serve", "baseline", None),
    "phi_2x2": ((2, 2), PHI, {}, 4, "serve", "baseline", None),
    "pod_2x2x2": ((2, 2, 2), MOON, {}, 4, "serve", "baseline", None),
    "experts_undivided_1x4": ((1, 4), MOON, dict(n_experts=6), 2, "serve", "baseline", None),
    "batch_undivided_2x2": ((2, 2), MOON, {}, 3, "serve", "baseline", None),
    "a2a_2x2": ((2, 2), MOON, NO_DROP, 4, "prefill", "opt", None),
    "a2a_phi_1x4": ((1, 4), PHI, NO_DROP, 2, "prefill", "opt", None),
    "train_1x4": ((1, 4), MOON, {}, 4, "train", "baseline", None),
    "train_2x2": ((2, 2), MOON, {}, 8, "train", "baseline", None),
    "train_noremat_2x2": ((2, 2), MOON, dict(remat=False), 8, "train", "baseline", None),
    "train_pod_2x2x2": ((2, 2, 2), MOON, {}, 8, "train", "baseline", None),
    "train_experts_undivided_2x2": ((2, 2), MOON, dict(n_experts=6), 8, "train", "baseline",
                                    None),
    "train_phi_1x4": ((1, 4), PHI, {}, 4, "train", "baseline", None),
    "train_aux_2x2": ((2, 2), MOON, AUX, 8, "train", "baseline", None),
    "train_a2a_small_dp_2x2": ((2, 2), MOON, NO_DROP, 8, "train", "opt", None),
    "train_a2a_opt_2x2": ((2, 2), MOON, NO_DROP, 8, "train", "opt", 0),
    # microbatches of 2 rows: small-DP's stream over data, the a2a's whole
    "train_a2a_small_dp_layouts_differ_2x2": ((2, 2), MOON, NO_DROP, 4, "train", "opt", None),
}
CELLS = [f"{c}_{a}" for a in ARCHS for c in ("cell", "cell_opt", *(f"train_{p}" for p in POLICIES))]
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

    archs, b, s, bt, accum, s_max, dec, policies, out = json.loads(sys.argv[1])
    f32 = lambda a, smoke=False: get_config(a, True).with_(param_dtype="float32",
                                                          compute_dtype="float32")
    rd.get_config = f32
    mesh = _make_mesh((2, 4), ("data", "model"))
    arrays, res = {}, {"texts": {}, "trips": {}, "act": {}}
    for tag, arch in archs.items():
        cfg = f32(arch)
        model = Model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        rng = np.random.default_rng(3)
        arrays[tag + "/tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
        arrays[tag + "/train_tokens"] = rng.integers(0, cfg.vocab_size, (bt, s)).astype(np.int32)

        def save(prefix, tree):
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
                arrays[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)

        def cell(name, shape, policy="baseline"):
            fn, _args, trips, _ = rd.build_cell(arch, shape, mesh, accum=accum, policy=policy)
            act = rd.policy_rules(arch, shape, mesh, policy)[2]
            res["trips"][tag + "/" + name] = trips
            res["act"][tag + "/" + name] = json.loads(json.dumps(act))
            return fn, act

        save(tag + "/p/", params)
        batch = {"tokens": arrays[tag + "/tokens"]}
        for policy in ("baseline", "opt"):
            fn, act = cell("prefill/" + policy, ShapeSpec("smoke", "prefill", s, b), policy)
            with mesh, activation_sharding(mesh, act):
                logits, caches = fn(params, batch)
                text = fn.lower(params, batch).compile().as_text()
            res["texts"][tag + "/prefill/" + policy] = text
            arrays[tag + "/prefill/%s/logits" % policy] = np.asarray(logits)
            save(tag + "/prefill/%s/caches/" % policy, caches)

        tshape = ShapeSpec("smoke", "train", s, b)
        act_t = rd.policy_rules(arch, tshape, mesh, "baseline")[2]
        ev = jax.jit(make_eval_step(model), in_shardings=(param_shardings(model.defs(), mesh),
                                                          train_inputs(cfg, tshape, mesh)[1]))
        with mesh, activation_sharding(mesh, act_t):
            res[tag + "/loss"] = {k: float(v) for k, v in ev(params, batch).items()}

        for name, (policy, threshold) in policies.items():
            rd.SMALL_MODEL_PARAMS = 2e8 if threshold is None else threshold
            fn, act = cell("train/" + name, ShapeSpec("smoke", "train", s, bt), policy)
            state = AdamW().init(params)
            tb = {"tokens": arrays[tag + "/train_tokens"]}
            with mesh, activation_sharding(mesh, act):
                compiled = fn.lower(params, state, tb).compile()
                new_p, new_s, metrics = compiled(*jax.device_put((params, state, tb),
                                                                 compiled.input_shardings[0]))
            res["texts"][tag + "/train/" + name] = compiled.as_text()
            res[tag + "/train/" + name] = {k: float(v) for k, v in metrics.items()}
            for tree, t in (("params", new_p), ("m", new_s.m), ("v", new_s.v)):
                save(tag + "/train/%s/%s/" % (name, tree), t)
        rd.SMALL_MODEL_PARAMS = 2e8

        bd, pos, n_ticks = dec
        shape = (cfg.n_layers, bd, s_max, cfg.n_kv_heads, cfg.resolved_head_dim)
        caches = {k: rng.standard_normal(shape).astype(np.float32) for k in ("k", "v")}
        tok = rng.integers(0, cfg.vocab_size, (bd, n_ticks)).astype(np.int32)
        arrays[tag + "/decode/tokens"] = tok
        save(tag + "/decode/caches/", caches)
        for policy in ("baseline", "opt"):
            fn, act = cell("decode/" + policy, ShapeSpec("smoke", "decode", s_max, bd), policy)
            cur = {key: jnp.asarray(v) for key, v in caches.items()}
            with mesh, activation_sharding(mesh, act):
                res["texts"][tag + "/decode/" + policy] = fn.lower(
                    params, jnp.asarray(tok[:, :1]), jnp.int32(pos), cur).compile().as_text()
                for t in range(n_ticks):
                    logits, cur = fn(params, jnp.asarray(tok[:, t:t + 1]), jnp.int32(pos + t),
                                     cur)
                    arrays[tag + "/decode/%s/logits/%d" % (policy, t)] = np.asarray(logits)
            save(tag + "/decode/%s/after/" % policy, cur)
    np.savez(out + ".npz", **arrays)
    with open(out + ".json", "w") as fh:
        json.dump(res, fh)
    """
)


def _cfg(arch=MOON, **over):
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


def _tag(arch):
    return next(t for t, a in ARCHS.items() if a == arch)


@pytest.fixture(scope="module")
def ref_procs(tmp_path_factory):
    """The reference's cells of both configs, one subprocess each, started
    at once → (their output directory, {tag: process})."""
    tmp = tmp_path_factory.mktemp("ref_moe")
    env = {**os.environ, "PYTHONPATH": SRC}
    procs = {}
    for tag, arch in ARCHS.items():
        arg = json.dumps([{tag: arch}, B8, S8, BT, ACCUM, S_MAX, [DEC_B, DEC_POS, DEC_TICKS],
                          POLICIES, str(tmp / tag)])
        procs[tag] = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, arg], env=env,
                                      stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                                      text=True)
    yield tmp, procs
    for proc in procs.values():
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def target(tmp_path_factory):
    """A directory holding the rank target that sets ``SMALL_MODEL_PARAMS``
    per case."""
    mod_dir = tmp_path_factory.mktemp("threshold_target_moe")
    (mod_dir / "threshold_target.py").write_text(THRESHOLD_MODULE)
    return str(mod_dir)


def _run(world, names, ref, target):
    """The cases ``names`` on ``world`` ranks → {name: [per rank]}."""
    t0 = time.monotonic()
    res = run_ranks("threshold_target:run", world,
                    dict(device="cpu", smoke=True, cfg=F32,
                         cases=[_case(n, ref) for n in names]),
                    timeout_s=RANK_LIMIT, env={"PYTHONPATH": target})
    assert time.monotonic() - t0 < RANK_LIMIT
    return {n: [r[i] for r in res] for i, n in enumerate(names)}


@pytest.fixture(scope="module")
def port4(ref_procs, target):
    """The 4-rank cases (the port's own parameters), run while the
    reference compiles."""
    return _run(4, WORLD[4], None, target)


@pytest.fixture(scope="module")
def ref(ref_procs, port4):
    tmp, procs = ref_procs
    res = {"texts": {}, "trips": {}, "act": {}, "arrays": {}}
    for tag, proc in procs.items():
        _, err = proc.communicate(timeout=400)
        assert proc.returncode == 0, err[-3000:]
        with open(tmp / f"{tag}.json") as fh:
            part = json.load(fh)
        for key, val in part.items():
            if key in ("texts", "trips", "act"):
                res[key].update(val)
            else:
                res[key] = val
        res["arrays"].update(np.load(tmp / f"{tag}.npz"))
    res["params"] = {t: _tree(res["arrays"], f"{t}/p/") for t in ARCHS}
    return res


def _whole_params(name):
    """The whole parameters (numpy) a one-rank comparison runs on: the
    port's, from seed 0."""
    _, arch, over, *_ = CASES[name]
    return _numpy(Model(_cfg(arch, **over)).init(torch.Generator().manual_seed(0), "cpu"))


def _numpy(tree):
    return {k: _numpy(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.numpy()


def _tokens(b, n=S8, seed=7):
    return np.random.default_rng(seed).integers(0, 256, (b, n))


def _case(name, ref=None):
    """A ``launch/sharded.py:run`` case (a cell's needs ``ref``)."""
    if name in CELLS:
        a = ref["arrays"]
        kind, tag = name.rsplit("_", 1)
        common = dict(mesh=(2, 4), arch=ARCHS[tag], params=ref["params"][tag])
        if kind.startswith("train_"):
            policy, threshold = POLICIES[kind[len("train_"):]]
            return dict(common, policy=policy, small_model_params=threshold,
                        train=dict(tokens=a[f"{tag}/train_tokens"], accum=ACCUM))
        policy = "opt" if kind == "cell_opt" else "baseline"
        decode = [dict(tokens=a[f"{tag}/decode/tokens"], caches=_tree(a, f"{tag}/decode/caches/"),
                       pos=DEC_POS, host_caches=True)]
        case = dict(common, policy=policy, decode=decode,
                    prefill=dict(tokens=a[f"{tag}/tokens"], routing=True))
        if policy == "baseline":
            case["loss"] = dict(tokens=a[f"{tag}/tokens"], routing=True)
        return case
    mesh, arch, over, b, kind, policy, threshold = CASES[name]
    case = dict(mesh=mesh, arch=arch, cfg=dict(F32, **over), params=_whole_params(name),
                policy=policy, small_model_params=threshold)
    if kind == "train":
        case["train"] = dict(tokens=_tokens(b), accum=ACCUM)
        return case
    case.update(prefill=dict(tokens=_tokens(b), s_max=S_MAX, routing=True),
                decode=[dict(tokens=_tokens(b, 3, 43), host_caches=True)])
    if kind == "serve":
        case["loss"] = dict(tokens=_tokens(b), routing=True)
    return case


@pytest.fixture(scope="module")
def port(ref, port4, target):
    """Every case on its ranks → {name: [per rank]}."""
    return dict(port4, **_run(8, WORLD[8], ref, target))


def _one_rank(name):
    """The port's one-rank model (the gather dispatch) on the case's whole
    parameters: the prefill's logits, caches and routing, each tick's
    logits and the caches after the last, the loss and its routing; or
    the train step's."""
    mesh, arch, over, b, kind, policy, threshold = CASES[name]
    cfg = _cfg(arch, **over)
    model = Model(cfg)
    p = params_from_jax(_whole_params(name), "cpu")
    case = _case(name)
    if kind == "train":
        opt = AdamW(lr=warmup_cosine(3e-4, 2000, 100_000))
        new_p, state, metrics = make_train_step(model, opt, accum=ACCUM)(
            p, opt.init(p), {"tokens": torch.as_tensor(case["train"]["tokens"])})
        return dict(params=_numpy(new_p), m=_numpy(state.m), v=_numpy(state.v),
                    loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]))
    out = {}
    with torch.no_grad():
        if kind == "serve":
            with moe.recording() as rec:
                out["loss"] = float(model.loss(p, {"tokens": torch.as_tensor(
                    case["loss"]["tokens"])})[0])
            out["loss_routing"] = _whole_routing(rec)
        tokens = torch.as_tensor(case["prefill"]["tokens"])
        with moe.recording() as rec:
            logits, caches = model.prefill(p, {"tokens": tokens}, S_MAX)
        out["prefill_routing"] = _whole_routing(rec)
        out.update(logits=logits.numpy(), caches={k: v.numpy().copy() for k, v in caches.items()})
        fed, ticks = case["decode"][0]["tokens"], []
        for t in range(fed.shape[1]):
            lg, caches = model.decode(p, torch.as_tensor(fed[:, t:t + 1]), S8 + t, caches)
            ticks.append(lg.numpy())
        out.update(ticks=ticks, after={k: v.numpy() for k, v in caches.items()})
    return out


def _whole_routing(records):
    """Each one-rank MoE call's probabilities, expert ids and kept entries
    over its ``[B·S]`` tokens."""
    return [dict(moe.routing(r), probs=r["probs"].numpy()) for r in records]


def _check_routing(got, want, b, rows, positions):
    """A rank's routing of each MoE call (its tokens: ``rows`` of the batch
    of ``b``, ``positions`` of the sequence) against the one-rank model's:
    the expert ids equal but at near ties in the one-rank probabilities,
    and, where no id differs, the same entries kept."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        pick = lambda x: x.reshape(b, -1, *x.shape[1:])[rows[0]:rows[1],  # noqa: E731
                                                        positions[0]:positions[1]]
        ids, want_ids, probs = g["gate_idx"].numpy(), pick(w["gate_idx"].numpy()), pick(w["probs"])
        ids = ids.reshape(want_ids.shape)
        for i in zip(*np.nonzero(ids != want_ids)):
            a, c = probs[i[:2]][want_ids[i]], probs[i[:2]][ids[i]]
            assert abs(a - c) <= NEAR_TIE * max(a, c), (i, a, c)
        if (ids == want_ids).all() and "kept" in w:
            assert np.array_equal(g["kept"].numpy().reshape(ids.shape), pick(w["kept"].numpy()))


def _check_caches(got, whole, shape, rank, b, arch):
    """One rank's host caches against its blocks of the whole ones under
    the decode rules."""
    fake = _fake(tuple(shape.values()), rank)
    axes = param_axes(Model(_cfg(arch)).cache_defs(b, S_MAX))
    want = shard_params(whole, axes, fake, fake.coords, _decode_rules(shape))
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), w, atol=TOL, rtol=0)


def _check_train(ranks, want, shape, arch=MOON, over=None):
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


def _token_block(r, step, b, s, policy, shape):
    """(rows, positions) of the tokens a rank routes in ``step``: its rows
    over the whole sequence under the gather dispatch, its block of the
    residual stream under the a2a dispatch."""
    rows = r["prefill"]["rows"] if step == "prefill" else None
    if rows is None:
        n_batch = shape.get("pod", 1) * shape["data"]
        rows = ((r["coords"].get("pod", 0) * shape["data"] + r["coords"]["data"]) * (b // n_batch),
                (r["coords"].get("pod", 0) * shape["data"] + r["coords"]["data"] + 1)
                * (b // n_batch)) if b % n_batch == 0 else (0, b)
    if policy == "opt" and s % shape["model"] == 0:
        n = s // shape["model"]
        return rows, (r["coords"]["model"] * n, (r["coords"]["model"] + 1) * n)
    return rows, (0, s)


@pytest.mark.parametrize("tag", list(ARCHS))
@pytest.mark.parametrize("policy", SERVE_POLICIES)
def test_prefill_and_loss_on_8_ranks_match_reference_cell(tag, policy, ref, port):
    """The (2, 4) rank mesh against ``build_cell``'s prefill under the
    policy (GSPMD's gather dispatch, or the a2a dispatch on each device's
    block) and, under the baseline, the jitted ``make_eval_step``: every
    rank's block of the logits, its blocks of the caches and the loss
    within 1e-5."""
    a = ref["arrays"]
    ranks = port[("cell_" if policy == "baseline" else "cell_opt_") + tag]
    np.testing.assert_allclose(assemble_logits(ranks, B8, 256).numpy(),
                               a[f"{tag}/prefill/{policy}/logits"], atol=TOL, rtol=0)
    for rank, r in enumerate(ranks):
        assert r["prefill"]["logits"].shape == (B8 // 2, 256 // 4)
        _check_caches(r["prefill"]["caches"], _tree(a, f"{tag}/prefill/{policy}/caches/"),
                      dict(data=2, model=4), rank, B8, ARCHS[tag])
        if policy == "baseline":
            assert abs(r["loss"]["loss"] - ref[f"{tag}/loss"]["loss"]) <= TOL
            assert abs(r["loss"]["ce"] - ref[f"{tag}/loss"]["ce"]) <= TOL


@pytest.mark.parametrize("tag", list(ARCHS))
@pytest.mark.parametrize("policy", SERVE_POLICIES)
def test_decode_on_8_ranks_matches_reference_cell(tag, policy, ref, port):
    """The decode cell under ``ACT_RULES_DECODE`` and the policy: two
    chained ticks at batch 4 from ``pos`` 19 of numpy-seeded caches, each
    tick's logits and the caches after the last within 1e-5."""
    a = ref["arrays"]
    ranks = port[("cell_" if policy == "baseline" else "cell_opt_") + tag]
    for t in range(DEC_TICKS):
        np.testing.assert_allclose(assemble_tick(ranks, 0, t, DEC_B, 256).numpy(),
                                   a[f"{tag}/decode/{policy}/logits/{t}"], atol=TOL, rtol=0)
    for rank, r in enumerate(ranks):
        _check_caches(r["decode"][0]["caches"], _tree(a, f"{tag}/decode/{policy}/after/"),
                      dict(data=2, model=4), rank, DEC_B, ARCHS[tag])


@pytest.mark.parametrize("tag", list(ARCHS))
@pytest.mark.parametrize("name", list(POLICIES))
def test_train_on_8_ranks_matches_reference_cell(tag, name, ref, port):
    """The (2, 4) rank mesh's train step against ``build_cell``'s compiled
    train cell (accum 2) under the policy: loss, grad norm and every
    rank's block of the new parameters, ``m`` and ``v``."""
    want = dict(ref[f"{tag}/train/{name}"],
                **{t: _tree(ref["arrays"], f"{tag}/train/{name}/{t}/")
                   for t in ("params", "m", "v")})
    _check_train(port[f"train_{name}_{tag}"], want, (2, 4), ARCHS[tag])
    canon = json.loads(json.dumps(port[f"train_{name}_{tag}"][0]["rules"]))
    assert canon == ref["act"][f"{tag}/train/{name}"]


@pytest.mark.parametrize("tag", list(ARCHS))
def test_routing_on_8_ranks_equals_one_rank(tag, ref, port):
    """The (2, 4) cells' routing (every prefill and loss, both dispatches)
    against the port's one-rank model on the same parameters and tokens:
    the gather dispatch's expert ids and kept entries, the a2a dispatch's
    expert ids in the first layer (it keeps by a per-rank capacity, so
    the later layers' inputs differ from the gather dispatch's)."""
    p = params_from_jax(ref["params"][tag], "cpu")
    model = Model(_cfg(ARCHS[tag]))
    tokens = torch.as_tensor(ref["arrays"][f"{tag}/tokens"])
    with torch.no_grad(), moe.recording() as rec:
        model.prefill(p, {"tokens": tokens}, S_MAX)
    want = _whole_routing(rec)
    shape = dict(data=2, model=4)
    for policy in SERVE_POLICIES:
        for r in port[("cell_" if policy == "baseline" else "cell_opt_") + tag]:
            rows, pos = _token_block(r, "prefill", B8, S8, policy, shape)
            # the a2a dispatch keeps by a per-rank capacity: its first
            # layer's inputs alone are the gather dispatch's
            w = want if policy == "baseline" else [
                {k: v for k, v in want[0].items() if k != "kept"}]
            if policy == "opt":
                r = dict(r, prefill=dict(r["prefill"], routing=r["prefill"]["routing"][:1]))
            _check_routing(r["prefill"]["routing"], w, B8, rows, pos)
            if policy == "baseline":
                _check_routing(r["loss"]["routing"], want, B8, rows, pos)


@pytest.mark.parametrize("name", list(CASES))
def test_cases_match_one_rank_model(name, port):
    """Every other layout against the port's one-rank model on the same
    parameters and tokens, within 1e-5: the prefill's logits, caches and
    routing, each tick fed from its caches and the caches after, the loss
    and its routing; the train step."""
    mesh, arch, over, b, kind, policy, _ = CASES[name]
    want, ranks, shape = _one_rank(name), port[name], _mesh_shape(mesh)
    if kind == "train":
        _check_train(ranks, want, mesh, arch, over)
        return
    np.testing.assert_allclose(assemble_logits(ranks, b, 256).numpy(), want["logits"],
                               atol=TOL, rtol=0)
    for t, lg in enumerate(want["ticks"]):
        np.testing.assert_allclose(assemble_tick(ranks, 0, t, b, 256).numpy(), lg,
                                   atol=TOL, rtol=0)
    for rank, r in enumerate(ranks):
        _check_caches(r["prefill"]["caches"], want["caches"], shape, rank, b, arch)
        _check_caches(r["decode"][0]["caches"], want["after"], shape, rank, b, arch)
        rows, pos = _token_block(r, "prefill", b, S8, policy, shape)
        _check_routing(r["prefill"]["routing"], want["prefill_routing"], b, rows, pos)
        if kind == "serve":
            assert abs(r["loss"]["loss"] - want["loss"]) <= TOL
            _check_routing(r["loss"]["routing"], want["loss_routing"], b,
                           *_token_block(r, "loss", b, S8, policy, shape))


def test_aux_loss_gradient_on_ranks_counts_once(port):
    """With ``aux_loss_weight`` 10 the balance term moves the router's
    first moment (its gradient × 0.1) by far more than the tolerance, and
    the (2, 2) ranks' router moments equal one rank's within 1e-5: the
    term held alike on every rank seeds its cotangent as shares, so its
    gradient counts once, not once per rank."""
    name = "train_aux_2x2"
    want = _one_rank(name)
    p = params_from_jax(_whole_params(name), "cpu")
    opt = AdamW(lr=warmup_cosine(3e-4, 2000, 100_000))
    tokens = torch.as_tensor(_case(name)["train"]["tokens"])
    _, state0, _ = make_train_step(Model(_cfg(**dict(AUX, aux_loss_weight=0.0))), opt,
                                   accum=ACCUM)(p, opt.init(p), {"tokens": tokens})
    router = want["m"]["stack"]["moe"]["router"]
    assert np.abs(router - state0.m["stack"]["moe"]["router"].numpy()).max() > 100 * TOL
    for rank, r in enumerate(port[name]):
        mesh = _fake((2, 2), rank)
        block = shard_params({"r": router}, {"r": ("layers", "d_model", "experts")}, mesh,
                             mesh.coords, r["param_rules"])["r"]
        got = r["train"]["m"]["stack"]["moe"]["router"].numpy()
        assert got.shape == block.shape
        assert np.abs(got - block).max() <= TOL


def test_layouts_route_the_rank_tokens(port):
    """The gather dispatch routes a rank's rows over the whole sequence
    (every position of its 2 of 4 rows on (2, 2)), the a2a dispatch the
    stream's block; each rank of (1, 4) holds every row; 6 experts on
    ``model`` 4 split no expert, so the router is not gathered."""
    r = port["2x2"][0]
    assert r["prefill"]["routing"][0]["gate_idx"].shape == (2 * S8, 2)
    r = port["a2a_2x2"][1]
    assert r["prefill"]["routing"][0]["gate_idx"].shape == (2 * S8 // 2, 2)
    assert all(x["prefill"]["rows"] == (0, 2) for x in port["1x4"])
    ops = port["experts_undivided_1x4"][0]["prefill"]["ops"]
    assert not any(op[3] == "moe/router" for op in ops)
    assert any(op[3] == "moe/out" for op in ops)      # each rank's d_ff block: a partial sum


def _policy_cfg(cfg, policy):
    return cfg.with_(moe_impl="a2a") if policy == "opt" else cfg


def _steps(name, ref):
    """The case, its cfg as its policy transforms it, and (step, mesh
    shape, batch, sequence) of each of its counted train, prefill and loss
    steps, for the formula."""
    case = _case(name, ref)
    shape = _mesh_shape(case["mesh"])
    over = {k: v for k, v in case.get("cfg", {}).items() if k not in F32}
    cfg = _policy_cfg(_cfg(case["arch"], **over), case.get("policy", "baseline"))
    out = []
    for step in ("train", "prefill", "loss"):
        if step in case:
            b, s = case[step]["tokens"].shape
            out.append((step, shape, b, s))
    return case, cfg, out


@pytest.mark.parametrize("name", CELLS + list(CASES))
def test_collectives_equal_formula(name, ref, port):
    """Every rank's counted collectives of every step — the train step's
    backward, recomputation and sums included, each decode tick — against
    ``sharded_collectives``, op for op."""
    case, cfg, steps = _steps(name, ref)
    for r in port[name]:
        for step, shape, b, s in steps:
            want = sharded_collectives(cfg, shape, r["rules"], b, s, 4, 4, step,
                                       case.get("train", {}).get("accum", 1),
                                       r["param_rules"], case[step].get("s_max", s))
            assert r[step]["ops"] == want, step
        for i, entry in enumerate(case.get("decode", [])):
            shape = _mesh_shape(case["mesh"])
            b = entry["tokens"].shape[0]
            want = sharded_collectives(cfg, shape, _decode_rules(shape), b, 1, 4, 4,
                                       "decode", s_max=S_MAX)
            assert all(ops == want for ops in r["decode"][i]["ops"])
        assert r["route"]["backend"] == "gloo" and r["route"]["host_staged"] == 0


@pytest.mark.parametrize("tag", list(ARCHS))
@pytest.mark.parametrize("cell", [f"prefill/{p}" for p in SERVE_POLICIES]
                         + [f"decode/{p}" for p in SERVE_POLICIES]
                         + [f"train/{p}" for p in POLICIES])
def test_wire_bytes_within_factor_of_compiled_cell(tag, cell, ref, port):
    """Total wire bytes a step on a rank against the compiled cell's per
    device (by kind in the message; GSPMD picks its own ops)."""
    key = f"{tag}/{cell}"
    xla = _reference_ops(ref["texts"][key], 8, ref["trips"][key])
    kind, policy = cell.split("/")
    if kind == "train":
        ops = port[f"train_{policy}_{tag}"][0]["train"]["ops"]
    else:
        r = port[("cell_" if policy == "baseline" else "cell_opt_") + tag][0]
        ops = (r["prefill"]["ops"] if kind == "prefill" else
               [op for op in r["decode"][0]["ops"][0] if op[3] != "decode/greedy"])
    got = _wire_by_kind([op[:3] + (1,) for op in ops])
    exp = _wire_by_kind(xla)
    print(f"wire bytes ({key}), port", got, "compiled cell", exp,
          "ratio", sum(got.values()) / sum(exp.values()))
    assert sum(got.values()) <= WIRE_FACTOR * sum(exp.values()), (got, exp)
    assert sum(got.values()) > 0 and sum(exp.values()) > 0


def test_moe_ops_by_the_formula():
    """An MoE layer's collectives on (2, 4) under the baseline: the
    layer's gather over ``data``, the attention's, the sequence's gather
    over ``model``, the router's, the balance sums and counts over
    ``data``, the per-choice outputs' reduce-scatter; under the a2a
    dispatch the body's, and the layer's gather without the ``moe``
    leaves."""
    cfg = _cfg()
    shape = dict(data=2, model=4)
    base = {"batch": ("data",), "seq": "model", "vocab": "model"}
    ops = sharded_collectives(cfg, shape, base, 4, 16, 4, 4, "loss")
    layer = [op[3] for op in ops if op[3].startswith(("layer", "attn/", "moe"))][:8]
    assert layer == ["layer", "attn/in", "attn/out", "moe/in", "moe/router", "moe/aux",
                     "moe/counts", "moe/out"]
    out = next(op for op in ops if op[3] == "moe/out")
    assert out == ("reduce-scatter", 2 * 4 * 2 * 64 * 4, 4, "moe/out")
    a2a = sharded_collectives(cfg.with_(moe_impl="a2a"), shape, base, 4, 16, 4, 4, "loss")
    paths = [op[3] for op in a2a]
    assert "moe/out" not in paths and "moe_a2a/dispatch" in paths
    assert "moe_a2a/reassemble" not in paths
    gathered = [op[1] for op in a2a if op[3] == "layer"][0]
    assert gathered < [op[1] for op in ops if op[3] == "layer"][0]


def test_whole_leaves_under_small_dp_give_the_a2a_blocks():
    """Under small-DP's rules the layer holds whole ``moe`` leaves; the a2a
    body takes this rank's blocks of them (``A2A_PARAM_SPECS``) with no
    collective, the blocks ``PARAM_RULES`` would give it."""
    cfg = _cfg()
    defs = moe.moe_defs(cfg)
    mesh = _fake((2, 4), 6)
    whole = {n: torch.arange(np.prod(p.shape), dtype=torch.float32).view(p.shape)
             for n, p in defs.items()}
    for n, w in whole.items():
        block = w[moe.shard_index(n, w.shape, mesh.shape, mesh.coords)]
        want = w[sharding.rank_index(defs[n].shape, defs[n].axes, mesh, mesh.coords)]
        assert torch.equal(block, want), n
