"""The port's sharded hybrid family on gloo ranks, against the reference's
compiled cells on forced host devices.

A subprocess runs the reference on 8 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``) for
jamba-v0.1-52b at smoke width in float32 (one period of 8 layers: mamba
on 7 slots, attention on slot 4, MoE on the odd slots; d 64, 4 heads, 2
kv heads, which do not divide ``model`` 4, 4 experts top-2, ``d_inner``
128, vocabulary 256), its parameters from the reference's
``init_params``, tokens and caches from a numpy seed.  On a (2, 4) mesh,
inside ``with mesh, activation_sharding(mesh, act_rules)`` as
``run_cell`` does, it runs ``launch/dryrun.py::build_cell``'s prefill
cell under the baseline policy and under ``opt`` (caches under
``ACT_RULES_DECODE``), ``make_eval_step``'s loss, the train cell (accum
2) under ``baseline``, ``opt`` as it stands (small-DP at smoke width) and
``opt`` with ``rd.SMALL_MODEL_PARAMS = 0`` (``ACT_RULES_TRAIN_OPT`` with
the a2a dispatch), and the decode cell for two chained ticks at batch 4
and two at batch 1 (which ``data`` 2 does not divide: the stationary
tick) under each of ``baseline`` and ``opt``, on nested caches of both
kinds.  It writes every output and each cell's compiled text.

The port runs the same cells on 8 spawned gloo ranks as a (2, 4) rank
mesh (``launch/sharded.py``, each rank holding its blocks of the
reference's parameters), and more cases on 4 and 8 ranks against the
port's one-rank model: (1, 4), (2, 2), a (2, 2, 2) ``("pod", "data",
"model")`` mesh, a batch of 3 on ``data`` 2 and a batch of 1 (whose ticks
keep every ``d_model`` block in place), a model of two periods (16
layers), and the a2a dispatch at a capacity that drops nothing (where it
equals the gather dispatch), each as a prefill whose caches feed
teacher-forced ticks, and the loss; the train step on (1, 4), (2, 2),
(2, 2) without ``remat``, the pod mesh and two periods.  A 4-rank target
also runs each slot of a period at batch 1 in its stationary form and in
its gathered form on the same input.  Checked: values within 1e-5 (the
moments also within 1e-4 of each leaf's largest, as in
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
from repro_torch.models import moe
from repro_torch.models.model import Model
from repro_torch.models.params import flatten, param_axes
from repro_torch.optim import AdamW, warmup_cosine
from test_torch_sharded import F32, SRC, TOL, _reference_ops, _wire_by_kind
from test_torch_sharded_train import THRESHOLD_MODULE

ARCH = "jamba-v0.1-52b"
REL = 1e-4          # of each leaf's largest |m| or |v|
RANK_LIMIT = 240    # seconds for one multi-rank run
NEAR_TIE = 2.0 ** -7    # tests/test_torch_models.py's
B8, S8 = 4, 16      # the prefill and loss cell: batch over data 2, sequence over model 4
S_MAX = 32          # the caches' length: the decode cell's and the one-rank comparisons'
BT, ACCUM = 16, 2   # the train cell: each microbatch of 8 rows splits over data × model
# the decode cell: (name, batch, ticks, pos); batch 1 does not split over data 2
TICKS = [("b4", 4, 2, 19), ("b1", 1, 2, 29)]
# The rule for the wire bytes, fixed before the test first ran: GSPMD picks
# its own ops (and may gather weights where the port gathers activations),
# so only a step's total is bounded, by this factor (the launcher's greedy
# pick, which the decode cell does not make, left out).
WIRE_FACTOR = 2.0
# (policy, SMALL_MODEL_PARAMS) of each reference train cell; None keeps 2e8
POLICIES = {"baseline": ("baseline", None), "small_dp": ("opt", None), "opt": ("opt", 0)}
SERVE_POLICIES = ("baseline", "opt")
NO_DROP = dict(capacity_factor=8.0)     # the a2a dispatch's per-rank capacity drops nothing
TWO = dict(n_layers=16)                 # two periods

# the one-rank comparisons: name → (mesh, cfg overrides, batch, kind, policy);
# "serve" runs a prefill, 3 teacher-forced ticks from its caches and the
# loss, "prefill" the first two, "train" a train step (accum 2)
CASES = {
    "1x4": ((1, 4), {}, 2, "serve", "baseline"),
    "2x2": ((2, 2), {}, 4, "serve", "baseline"),
    "pod_2x2x2": ((2, 2, 2), {}, 4, "serve", "baseline"),
    "batch_undivided_2x2": ((2, 2), {}, 3, "serve", "baseline"),   # stationary ticks
    "batch_one_2x2": ((2, 2), {}, 1, "serve", "baseline"),         # stationary ticks
    "two_periods_2x2": ((2, 2), TWO, 4, "serve", "baseline"),
    "a2a_2x2": ((2, 2), NO_DROP, 4, "prefill", "opt"),
    "train_1x4": ((1, 4), {}, 4, "train", "baseline"),
    "train_2x2": ((2, 2), {}, 8, "train", "baseline"),
    "train_noremat_2x2": ((2, 2), dict(remat=False), 8, "train", "baseline"),
    "train_pod_2x2x2": ((2, 2, 2), {}, 8, "train", "baseline"),
    "train_two_periods_2x2": ((2, 2), TWO, 8, "train", "baseline"),
}
CELLS = ["cell", "cell_opt", *(f"train_{p}" for p in POLICIES)]
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

    arch, b, s, bt, accum, s_max, ticks, policies, out = json.loads(sys.argv[1])
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
        act = rd.policy_rules(arch, shape, mesh, policy)[2]
        res["trips"][name] = trips
        res["act"][name] = json.loads(json.dumps(act))
        return fn, act

    save("p/", params)
    batch = {"tokens": arrays["tokens"]}
    for policy in ("baseline", "opt"):
        fn, act = cell("prefill/" + policy, ShapeSpec("smoke", "prefill", s, b), policy)
        with mesh, activation_sharding(mesh, act):
            logits, caches = fn(params, batch)
            res["texts"]["prefill/" + policy] = fn.lower(params, batch).compile().as_text()
        arrays["prefill/%s/logits" % policy] = np.asarray(logits)
        save("prefill/%s/caches/" % policy, caches)

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

    for name, bd, n_ticks, pos in ticks:
        caches = {slot: {k: rng.standard_normal(d.shape).astype(np.float32)
                         for k, d in leaves.items()}
                  for slot, leaves in model.cache_defs(bd, s_max).items()}
        tok = rng.integers(0, cfg.vocab_size, (bd, n_ticks)).astype(np.int32)
        arrays["decode/%s/tokens" % name] = tok
        save("decode/%s/caches/" % name, caches)
        for policy in ("baseline", "opt"):
            key = "decode/%s/%s" % (policy, name)
            fn, act = cell(key, ShapeSpec("smoke", "decode", s_max, bd), policy)
            cur = jax.tree_util.tree_map(jnp.asarray, caches)
            with mesh, activation_sharding(mesh, act):
                res["texts"][key] = fn.lower(params, jnp.asarray(tok[:, :1]), jnp.int32(pos),
                                             cur).compile().as_text()
                for t in range(n_ticks):
                    logits, cur = fn(params, jnp.asarray(tok[:, t:t + 1]), jnp.int32(pos + t),
                                     cur)
                    arrays["%s/logits/%d" % (key, t)] = np.asarray(logits)
            save("%s/after/" % key, cur)
    np.savez(out + ".npz", **arrays)
    with open(out + ".json", "w") as fh:
        json.dump(res, fh)
    """
)

# Each slot of a period at batch 1 on a (2, 2) rank mesh under the decode
# rules: its stationary form (RankLayout.stationary) and its gathered form
# (the slot's weights gathered over data, transformer.gather_layer) on the
# same input and the same seeded caches.
SLOT_MODULE = textwrap.dedent(
    """
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import actctx
    from repro_torch.distributed.sharding import decode_rules, rank_shard
    from repro_torch.launch.expert import _host, _ops
    from repro_torch.launch.hlo_analysis import counting_collectives
    from repro_torch.launch.mesh import _make_mesh
    from repro_torch.launch.sharded import seeded_caches
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import Model

    def run(payload):
        cfg = get_config(payload["arch"], smoke=True).with_(**payload["cfg"])
        model = Model(cfg)
        mesh = _make_mesh(tuple(payload["mesh"]), ("data", "model"), torch.device("cpu"))
        rules = decode_rules(mesh)
        params = model.init(torch.Generator().manual_seed(0), "cpu", shard=rank_shard(mesh))
        x = torch.randn(1, 1, cfg.d_model, generator=torch.Generator().manual_seed(1))
        out = []
        with torch.no_grad(), actctx.activation_sharding(mesh, rules):
            lay = model.cache_layout(actctx.rank_layout(1, 1, cfg.d_model), payload["s_max"],
                                     rules)
            forms = {"stationary": lay, "gathered": dataclasses.replace(lay, stationary=False)}
            for key, mixer, ffn in tf._units(cfg)[1]:
                res = dict(slot=key, mixer=mixer, ffn=ffn, stationary=lay.stationary)
                for form, fl in forms.items():
                    lp = tf._index_tree(params["stack"][key], 0)
                    caches = seeded_caches(model, 1, payload["s_max"], 5, "cpu", mesh, rules)
                    cc = tf._index_tree(caches[key], 0)
                    with counting_collectives() as report:
                        if not fl.stationary:
                            lp = tf.gather_layer(cfg, lp, tf._one_layer_defs(cfg, mixer, ffn),
                                                 fl, ffn)
                        y = tf._apply_layer_decode(lp, x, cfg, None, mixer, ffn, cc,
                                                   payload["pos"], fl)
                    res[form] = dict(y=y.clone(), caches=_host(cc), ops=_ops(report))
                out.append(res)
        return out
    """
)


def _cfg(**over):
    return get_config(ARCH, smoke=True).with_(**F32, **over)


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
def ref_proc(tmp_path_factory):
    """The reference's cells, in a subprocess started at once → (its output
    path, the process)."""
    out = str(tmp_path_factory.mktemp("ref_hybrid") / "ref")
    env = {**os.environ, "PYTHONPATH": SRC}
    arg = json.dumps([ARCH, B8, S8, BT, ACCUM, S_MAX, TICKS, POLICIES, out])
    proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, arg], env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    yield out, proc
    proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def target(tmp_path_factory):
    """A directory holding the rank targets: the one that sets
    ``SMALL_MODEL_PARAMS`` per case, and the slot forms'."""
    mod_dir = tmp_path_factory.mktemp("targets_hybrid")
    (mod_dir / "threshold_target.py").write_text(THRESHOLD_MODULE)
    (mod_dir / "slot_target.py").write_text(SLOT_MODULE)
    return str(mod_dir)


def _run(world, names, ref, target):
    """The cases ``names`` on ``world`` ranks → {name: [per rank]}."""
    t0 = time.monotonic()
    res = run_ranks("threshold_target:run", world,
                    dict(device="cpu", arch=ARCH, smoke=True, cfg=F32,
                         cases=[_case(n, ref) for n in names]),
                    timeout_s=RANK_LIMIT, env={"PYTHONPATH": target})
    assert time.monotonic() - t0 < RANK_LIMIT
    return {n: [r[i] for r in res] for i, n in enumerate(names)}


@pytest.fixture(scope="module")
def port4(ref_proc, target):
    """The 4-rank cases (the port's own parameters), run while the
    reference compiles."""
    return _run(4, WORLD[4], None, target)


@pytest.fixture(scope="module")
def slots(ref_proc, target):
    """Each slot's stationary and gathered forms on a (2, 2) rank mesh."""
    t0 = time.monotonic()
    res = run_ranks("slot_target:run", 4, dict(arch=ARCH, cfg=F32, mesh=(2, 2), s_max=S_MAX,
                                                pos=29),
                    timeout_s=RANK_LIMIT, env={"PYTHONPATH": target})
    assert time.monotonic() - t0 < RANK_LIMIT
    return res


@pytest.fixture(scope="module")
def ref(ref_proc, port4):
    out, proc = ref_proc
    _, err = proc.communicate(timeout=400)
    assert proc.returncode == 0, err[-3000:]
    with open(out + ".json") as fh:
        res = json.load(fh)
    res["arrays"] = dict(np.load(out + ".npz"))
    res["params"] = _tree(res["arrays"], "p/")
    return res


def _whole_params(name):
    """The whole parameters (numpy) a one-rank comparison runs on: the
    port's, from seed 0."""
    over = CASES[name][1]
    return _numpy(Model(_cfg(**over)).init(torch.Generator().manual_seed(0), "cpu"))


def _numpy(tree):
    return {k: _numpy(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.numpy()


def _tokens(b, n=S8, seed=7):
    return np.random.default_rng(seed).integers(0, 256, (b, n))


def _case(name, ref=None):
    """A ``launch/sharded.py:run`` case (a cell's needs ``ref``)."""
    if name in CELLS:
        a = ref["arrays"]
        common = dict(mesh=(2, 4), params=ref["params"])
        if name.startswith("train_"):
            policy, threshold = POLICIES[name[len("train_"):]]
            return dict(common, policy=policy, small_model_params=threshold,
                        train=dict(tokens=a["train_tokens"], accum=ACCUM))
        policy = "opt" if name == "cell_opt" else "baseline"
        decode = [dict(tokens=a[f"decode/{t}/tokens"], caches=_tree(a, f"decode/{t}/caches/"),
                       pos=pos, host_caches=True) for t, _, _, pos in TICKS]
        case = dict(common, policy=policy, decode=decode,
                    prefill=dict(tokens=a["tokens"], routing=True))
        if policy == "baseline":
            case["loss"] = dict(tokens=a["tokens"], routing=True)
        return case
    mesh, over, b, kind, policy = CASES[name]
    case = dict(mesh=mesh, cfg=dict(F32, **over), params=_whole_params(name), policy=policy)
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
    mesh, over, b, kind, policy = CASES[name]
    model = Model(_cfg(**over))
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
        out.update(logits=logits.numpy(), caches=_numpy(caches))
        out["caches"] = {k: {n: v.copy() for n, v in c.items()} for k, c in out["caches"].items()}
        fed, ticks = case["decode"][0]["tokens"], []
        for t in range(fed.shape[1]):
            lg, caches = model.decode(p, torch.as_tensor(fed[:, t:t + 1]), S8 + t, caches)
            ticks.append(lg.numpy())
        out.update(ticks=ticks, after=_numpy(caches))
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


def _check_caches(got, whole, shape, rank, b, over=None):
    """One rank's host caches (a tree of both kinds, slot by slot) against
    its blocks of the whole ones under the decode rules."""
    fake = _fake(tuple(shape.values()), rank)
    axes = param_axes(Model(_cfg(**(over or {}))).cache_defs(b, S_MAX))
    want = dict(flatten(shard_params(whole, axes, fake, fake.coords, _decode_rules(shape))))
    got = dict(flatten(got))
    assert set(got) == set(want)
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        np.testing.assert_allclose(got[path].numpy(), w, atol=TOL, rtol=0, err_msg=str(path))


def _check_train(ranks, want, shape, over=None):
    """Every rank's loss, grad norm and blocks of the new parameters, ``m``
    and ``v`` against ``want`` (whole trees)."""
    axes = Model(_cfg(**(over or {}))).axes()
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
        i = r["coords"].get("pod", 0) * shape["data"] + r["coords"]["data"]
        rows = (i * (b // n_batch), (i + 1) * (b // n_batch)) if b % n_batch == 0 else (0, b)
    if policy == "opt" and s % shape["model"] == 0:
        n = s // shape["model"]
        return rows, (r["coords"]["model"] * n, (r["coords"]["model"] + 1) * n)
    return rows, (0, s)


@pytest.mark.parametrize("policy", SERVE_POLICIES)
def test_prefill_and_loss_on_8_ranks_match_reference_cell(policy, ref, port):
    """The (2, 4) rank mesh against ``build_cell``'s prefill under the
    policy and, under the baseline, the jitted ``make_eval_step``: every
    rank's block of the logits, its blocks of the nested caches (the
    attention slot's positions, the mamba slots' channels) and the loss
    within 1e-5."""
    a = ref["arrays"]
    ranks = port["cell" if policy == "baseline" else "cell_opt"]
    np.testing.assert_allclose(assemble_logits(ranks, B8, 256).numpy(),
                               a[f"prefill/{policy}/logits"], atol=TOL, rtol=0)
    for rank, r in enumerate(ranks):
        assert r["prefill"]["logits"].shape == (B8 // 2, 256 // 4)
        assert r["prefill"]["caches"]["slot4"]["k"].shape == (1, B8 // 2, S8 // 4, 2, 16)
        assert r["prefill"]["caches"]["slot0"]["h"].shape == (1, B8 // 2, 128 // 4, 4)
        _check_caches(r["prefill"]["caches"], _tree(a, f"prefill/{policy}/caches/"),
                      dict(data=2, model=4), rank, B8)
        if policy == "baseline":
            assert abs(r["loss"]["loss"] - ref["loss"]["loss"]) <= TOL
            assert abs(r["loss"]["ce"] - ref["loss"]["ce"]) <= TOL


@pytest.mark.parametrize("name", [t[0] for t in TICKS])
@pytest.mark.parametrize("policy", SERVE_POLICIES)
def test_decode_on_8_ranks_matches_reference_cell(name, policy, ref, port):
    """The decode cell under ``ACT_RULES_DECODE`` and the policy: two
    chained ticks at batch 4 (rows over ``data``) from ``pos`` 19, and two
    at batch 1 (every rank holds the row, every ``d_model`` block stays in
    place) from ``pos`` 29, on numpy-seeded nested caches: each tick's
    logits and the caches after the last within 1e-5."""
    a = ref["arrays"]
    i, (_, b, n, _) = next((i, t) for i, t in enumerate(TICKS) if t[0] == name)
    ranks = port["cell" if policy == "baseline" else "cell_opt"]
    for t in range(n):
        np.testing.assert_allclose(assemble_tick(ranks, i, t, b, 256).numpy(),
                                   a[f"decode/{policy}/{name}/logits/{t}"], atol=TOL, rtol=0)
    for rank, r in enumerate(ranks):
        entry = r["decode"][i]
        assert entry["stationary"] == (b == 1)
        assert entry["kv"][1] - entry["kv"][0] == S_MAX // 4
        assert entry["di"][1] - entry["di"][0] == 128 // 4
        _check_caches(entry["caches"], _tree(a, f"decode/{policy}/{name}/after/"),
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


def test_routing_on_8_ranks_equals_one_rank(ref, port):
    """The (2, 4) cells' routing (every prefill and loss, both dispatches)
    against the port's one-rank model on the same parameters and tokens:
    the gather dispatch's expert ids and kept entries in each of the
    period's 4 MoE slots, the a2a dispatch's expert ids in the first (it
    keeps by a per-rank capacity, so the later slots' inputs differ from
    the gather dispatch's)."""
    p = params_from_jax(ref["params"], "cpu")
    model = Model(_cfg())
    tokens = torch.as_tensor(ref["arrays"]["tokens"])
    with torch.no_grad(), moe.recording() as rec:
        model.prefill(p, {"tokens": tokens}, S8)
    want = _whole_routing(rec)
    assert len(want) == 4
    shape = dict(data=2, model=4)
    for policy in SERVE_POLICIES:
        for r in port["cell" if policy == "baseline" else "cell_opt"]:
            rows, pos = _token_block(r, "prefill", B8, S8, policy, shape)
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
    mesh, over, b, kind, policy = CASES[name]
    want, ranks, shape = _one_rank(name), port[name], _mesh_shape(mesh)
    if kind == "train":
        _check_train(ranks, want, mesh, over)
        return
    np.testing.assert_allclose(assemble_logits(ranks, b, 256).numpy(), want["logits"],
                               atol=TOL, rtol=0)
    for t, lg in enumerate(want["ticks"]):
        np.testing.assert_allclose(assemble_tick(ranks, 0, t, b, 256).numpy(), lg,
                                   atol=TOL, rtol=0)
    for rank, r in enumerate(ranks):
        _check_caches(r["prefill"]["caches"], want["caches"], shape, rank, b, over)
        _check_caches(r["decode"][0]["caches"], want["after"], shape, rank, b, over)
        assert r["decode"][0]["stationary"] == (b % shape["data"] != 0)
        rows, pos = _token_block(r, "prefill", b, S8, policy, shape)
        _check_routing(r["prefill"]["routing"], want["prefill_routing"], b, rows, pos)
        if kind == "serve":
            assert abs(r["loss"]["loss"] - want["loss"]) <= TOL
            _check_routing(r["loss"]["routing"], want["loss_routing"], b,
                           *_token_block(r, "loss", b, S8, policy, shape))


@pytest.mark.parametrize("slot", range(8))
def test_stationary_slot_equals_gathered_slot(slot, slots):
    """Each slot of a period at batch 1 on (2, 2) — attention at slot 4,
    mamba elsewhere, the MLP on the even slots, MoE on the odd — in its
    stationary form (every ``d_model`` block in place) against the same
    slot with its weights gathered over ``data``: the output within 1e-5,
    the caches after within 1e-5, and no ``layer`` gather among the
    stationary form's ops, only the gathered form's."""
    for r in slots:
        res = r[slot]
        assert res["slot"] == f"slot{slot}" and res["stationary"]
        st, ga = res["stationary"], res["gathered"]
        np.testing.assert_allclose(st["y"].numpy(), ga["y"].numpy(), atol=TOL, rtol=0)
        for (path, a), (_, b) in zip(flatten(st["caches"]), flatten(ga["caches"])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=0, err_msg=str(path))
        paths = {op[3] for op in st["ops"]}
        assert "layer" not in paths and any(op[3] == "layer" for op in ga["ops"])
        mixer, ffn = res["mixer"], res["ffn"]
        assert {f"{mixer}/in", f"{mixer}/data", f"{ffn}/data"} <= paths
        if ffn == "moe":
            assert "moe/route" in paths


def _policy_cfg(cfg, policy):
    return cfg.with_(moe_impl="a2a") if policy == "opt" else cfg


def _steps(name, ref):
    """The case, its cfg as its policy transforms it, and (step, mesh
    shape, batch, sequence) of each of its counted train, prefill and loss
    steps, for the formula."""
    case = _case(name, ref)
    shape = _mesh_shape(case["mesh"])
    over = {k: v for k, v in case.get("cfg", {}).items() if k not in F32}
    cfg = _policy_cfg(_cfg(**over), case.get("policy", "baseline"))
    out = []
    for step in ("train", "prefill", "loss"):
        if step in case:
            b, s = case[step]["tokens"].shape
            out.append((step, shape, b, s))
    return case, cfg, out


@pytest.mark.parametrize("name", CELLS + list(CASES))
def test_collectives_equal_formula(name, ref, port):
    """Every rank's counted collectives of every step — the train step's
    backward, the period's recomputation and sums included, each decode
    tick — against ``sharded_collectives``, op for op."""
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


@pytest.mark.parametrize("cell", [f"prefill/{p}" for p in SERVE_POLICIES]
                         + [f"decode/{p}/{t[0]}" for p in SERVE_POLICIES for t in TICKS]
                         + [f"train/{p}" for p in POLICIES])
def test_wire_bytes_within_factor_of_compiled_cell(cell, ref, port):
    """Total wire bytes a step on a rank against the compiled cell's per
    device (by kind in the message; GSPMD picks its own ops)."""
    xla = _reference_ops(ref["texts"][cell], 8, ref["trips"][cell])
    kind, policy = cell.split("/")[:2]
    if kind == "train":
        ops = port[f"train_{policy}"][0]["train"]["ops"]
    else:
        r = port["cell" if policy == "baseline" else "cell_opt"][0]
        if kind == "prefill":
            ops = r["prefill"]["ops"]
        else:
            i = [t[0] for t in TICKS].index(cell.split("/")[2])
            ops = [op for op in r["decode"][i]["ops"][0] if op[3] != "decode/greedy"]
    got = _wire_by_kind([op[:3] + (1,) for op in ops])
    exp = _wire_by_kind(xla)
    print(f"wire bytes ({cell}), port", got, "compiled cell", exp,
          "ratio", sum(got.values()) / sum(exp.values()))
    assert sum(got.values()) <= WIRE_FACTOR * sum(exp.values()), (got, exp)
    assert sum(got.values()) > 0 and sum(exp.values()) > 0


def test_period_ops_by_the_formula():
    """A period's collectives on (2, 4) under the baseline: each slot's own
    gather over ``data`` (8 a period, each of that slot's leaves alone)
    and its family's ops in slot order; the train step's recomputation
    issues every slot's but the last slot's ``moe/out``, whose transpose
    comes first."""
    cfg = _cfg()
    shape = dict(data=2, model=4)
    base = {"batch": ("data",), "seq": "model", "vocab": "model"}
    ops = sharded_collectives(cfg, shape, base, 4, 16, 4, 4, "loss")
    paths = [op[3] for op in ops]
    assert paths.count("layer") == 8 and paths.count("moe/out") == 4
    assert paths.count("mamba/dtbc") == 7 and paths.count("attn/out") == 1
    gathers = [op[1] for op in ops if op[3] == "layer"]
    assert gathers[1] > gathers[0]          # an MoE slot's leaves against an MLP slot's
    train = sharded_collectives(cfg, shape, base, 8, 16, 4, 4, "train", 2)
    bwd = [op[3] for op in train if op[3].endswith("/bwd")]
    assert bwd.count("layer/bwd") == 2 * 2 * 8          # recomputed and reduce-scattered
    assert bwd.count("moe/out/bwd") == 2 * 4 + 2 * 3    # transposes, and three recomputed


@pytest.mark.parametrize("b,stationary", [(4, False), (3, True), (1, True)])
def test_cache_layout_places_both_kinds(b, stationary):
    """Rank 5 of (2, 4) under the decode rules: the attention caches'
    positions 8–15 of 32 and the mamba states' channels 32–63 of 128, one
    ``actctx.cache_layout`` call for each kind composed; every ``d_model``
    block in place where the batch does not split over ``data``, and the
    expert stacks' in place under the gather dispatch."""
    mesh = _fake((2, 4), 5)
    rules = sharding.decode_rules(mesh)
    with actctx.activation_sharding(mesh, rules):
        lay = Model(_cfg()).cache_layout(actctx.rank_layout(b, 1, 64), S_MAX, rules)
    assert (lay.kv0, lay.kv_loc, lay.kv_sharded) == (8, 8, True)
    assert (lay.di0, lay.di_loc, lay.di_sharded) == (32, 32, True)
    assert lay.stationary == stationary and lay.experts_stationary


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_seeded_caches_are_the_whole_caches_blocks(shape):
    """``seeded_caches`` of a hybrid (k, v and conv in the compute dtype,
    h in float32) on each rank: its blocks of the whole draw, slot by
    slot, each slab a function of (seed, absolute layer, leaf) alone."""
    model = Model(_cfg(**TWO).with_(compute_dtype="bfloat16"))
    whole = seeded_caches(model, 2, 8, 5, "cpu")
    assert whole["slot4"]["k"].dtype == torch.bfloat16
    assert whole["slot1"]["h"].dtype == torch.float32
    assert torch.equal(whole["slot4"]["v"][1].float(),
                       cache_slab(model.cfg, 2, 8, 5, 12, "v", "cpu").bfloat16().float())
    axes = param_axes(model.cache_defs(2, 8))
    for rank in range(4):
        mesh = _fake(shape, rank)
        rules = sharding.decode_rules(mesh)
        part = dict(flatten(seeded_caches(model, 2, 8, 5, "cpu", mesh, rules)))
        want = dict(flatten(shard_params(whole, axes, mesh, mesh.coords, rules)))
        assert set(part) == set(want)
        for path, w in want.items():
            assert torch.equal(part[path], w), path
