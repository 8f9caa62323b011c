"""The port's sharded dense train step on gloo ranks, against the
reference's compiled train cell on forced host devices.

One subprocess runs the reference on 8 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``): mistral-nemo-12b
at smoke width in float32 (2 layers, d 64, 4/2 heads of 16, d_ff 192,
vocab 256), its parameters from the reference's ``init_params``, a batch
of 16 × 16 tokens from a numpy seed.  For each of three policies it
compiles ``launch/dryrun.py::build_cell``'s train cell (``accum=2``) on a
(2, 4) mesh inside ``with mesh, activation_sharding(mesh, act_rules)``,
as ``run_cell`` lowers it, and runs one step from AdamW's initial state:
``baseline``; ``opt`` as it stands (at smoke width every config is under
``SMALL_MODEL_PARAMS``, so ``opt`` gives small-DP); and ``opt`` with
``rd.SMALL_MODEL_PARAMS = 0`` (``ACT_RULES_TRAIN_OPT``).  It writes the
step's loss, grad norm, new parameters, ``m`` and ``v``, the compiled
module's text and ``policy_rules``' activation rules.

The port runs the same step on 8 spawned gloo ranks as a (2, 4) rank mesh
(``launch/sharded.py``'s ``"train"`` entry, the rules from the port's
``policy_rules`` of the case's ``policy``), each rank holding its blocks
of the reference's parameters, and on 4 ranks in every 4-rank case at
once.  Checked: the (2, 4) step under each policy, and with ``accum=1``,
within 1e-5 of the reference's cell — loss, grad norm, and every leaf of
``m``, ``v`` and the new parameters, each rank's block.  One step moves a
parameter by about 1e-7 (``build_cell``'s warm-up learning rate), which
would hide a wrong gradient, so the moments, which carry the clipped
gradient, are also held to 1e-4 of each leaf's largest value.  The (1, 4)
(2 kv heads on a model axis of 4: whole on every rank), (2, 2), (2, 2)
without ``"seq"`` (sums where the sequence is whole) and (2, 2, 2)
``pod`` layouts, and (2, 2) without ``remat``, within the same bounds of
the port's one-rank ``make_train_step``; every rank's counted
collectives, backward included, equal to
``launch/sharded.py::sharded_collectives(step="train")``; the wire bytes
a step against the compiled cell's (by the rule below, fixed before the
first run); ``Model._layout`` under autograd on a rank mesh for every
family (the VLM's the layout of its stream, vision prefix included).

Each multi-rank run has a wall-clock limit (``run_ranks``' ``timeout_s``)
and every group a 60 s timeout, so a rank that fails or waits on a
collective another rank never issues fails the test.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, shard_params
from repro_torch.distributed import actctx, sharding
from repro_torch.distributed.ranks import run_ranks
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.sharded import sharded_collectives
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import Model
from repro_torch.models.params import flatten
from repro_torch.optim import AdamW, warmup_cosine
from test_torch_sharded import ARCH, F32, NOSEQ, SRC, TOL, _reference_ops, _wire_by_kind

REL = 1e-4          # of each leaf's largest |m| or |v|
ACCUM = 2
B8, S8 = 16, 16     # the 8-rank cell: each microbatch of 8 rows splits over data × model
RANK_LIMIT = 240    # seconds for one multi-rank run
# The rule for the wire bytes, fixed before the test first ran: GSPMD picks
# its own ops (and may hoist or merge them), so only a step's total is
# bounded, by this factor, under each policy.
WIRE_FACTOR = 2.0
# (policy, SMALL_MODEL_PARAMS) of each reference cell; None keeps 2e8
POLICIES = {"baseline": ("baseline", None), "small_dp": ("opt", None), "opt": ("opt", 0)}
# the 8-rank cases: each reference cell, the baseline at accum 1, and a pod mesh
CASES8 = {**{n: ((2, 4), pol, thr, ACCUM, B8) for n, (pol, thr) in POLICIES.items()},
          "accum1": ((2, 4), "baseline", None, 1, B8),
          "pod_2x2x2": ((2, 2, 2), "baseline", None, ACCUM, 8)}
# the 4-rank cases, against the one-rank step: (mesh, rules (None: the
# policy's), batch, config overrides)
CASES4 = {"1x4": ((1, 4), None, 4, {}), "2x2": ((2, 2), None, 8, {}),
          "noseq_2x2": ((2, 2), NOSEQ, 8, {}), "noremat_2x2": ((2, 2), None, 8, {"remat": False})}

REF_SCRIPT = textwrap.dedent(
    """
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    from repro.configs import get_config
    from repro.configs.base import ShapeSpec
    from repro.distributed.actctx import activation_sharding
    from repro.launch import dryrun as rd
    from repro.launch.mesh import _make_mesh
    from repro.models.model import Model
    from repro.optim.adamw import AdamW

    arch, b, s, accum, policies, out = json.loads(sys.argv[1])
    f32 = lambda a, smoke=False: get_config(a, True).with_(param_dtype="float32",
                                                          compute_dtype="float32")
    rd.get_config = f32
    cfg = f32(arch)
    model = Model(cfg)
    mesh = _make_mesh((2, 4), ("data", "model"))
    params = model.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    arrays = {"tokens": tokens}
    names = lambda tree: ["/".join(k.key for k in path)
                          for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    for name, leaf in zip(names(params), jax.tree_util.tree_leaves(params)):
        arrays["p/" + name] = np.asarray(leaf)
    res = {}
    for name, (policy, threshold) in policies.items():
        rd.SMALL_MODEL_PARAMS = 2e8 if threshold is None else threshold
        shape = ShapeSpec("smoke", "train", s, b)
        fn, _args, trips, _ = rd.build_cell(arch, shape, mesh, accum=accum, policy=policy)
        _, _, act = rd.policy_rules(arch, shape, mesh, policy)
        state = AdamW().init(params)
        with mesh, activation_sharding(mesh, act):
            compiled = fn.lower(params, state, {"tokens": tokens}).compile()
            args = jax.device_put((params, state, {"tokens": tokens}),
                                  compiled.input_shardings[0])
            new_p, new_s, metrics = compiled(*args)
        res[name] = dict(text=compiled.as_text(), trips=trips,
                         act=json.loads(json.dumps(act)),
                         **{k: float(v) for k, v in metrics.items()})
        for tree, t in (("params", new_p), ("m", new_s.m), ("v", new_s.v)):
            for leaf_name, leaf in zip(names(t), jax.tree_util.tree_leaves(t)):
                arrays["%s/%s/%s" % (name, tree, leaf_name)] = np.asarray(leaf)
    np.savez(out + ".npz", **arrays)
    with open(out + ".json", "w") as fh:
        json.dump(res, fh)
    """
)

# A rank target that sets the port's SMALL_MODEL_PARAMS per case, as the
# reference script sets the reference's, then runs the case.
THRESHOLD_MODULE = textwrap.dedent(
    """
    from repro_torch.launch import dryrun, sharded

    def run(payload):
        out = []
        for case in payload["cases"]:
            threshold = case.pop("small_model_params", None)
            dryrun.SMALL_MODEL_PARAMS = 2e8 if threshold is None else threshold
            out += sharded.run(dict(payload, cases=[case]))
        return out
    """
)


def _cfg():
    return get_config(ARCH, smoke=True).with_(**F32)


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


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ref_train") / "ref")
    env = {**os.environ, "PYTHONPATH": SRC}
    arg = json.dumps([ARCH, B8, S8, ACCUM, POLICIES, out])
    proc = subprocess.run([sys.executable, "-c", REF_SCRIPT, arg], capture_output=True,
                          text=True, env=env, timeout=400)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out + ".json") as fh:
        res = json.load(fh)
    arrays = dict(np.load(out + ".npz"))
    res.update(arrays=arrays, params=_tree(arrays, "p/"))
    for name in POLICIES:
        res[name].update({t: _tree(arrays, f"{name}/{t}/") for t in ("params", "m", "v")})
    return res


def _tokens(b, seed=7):
    return np.random.default_rng(seed).integers(0, 256, (b, S8))


def _case8(name, ref):
    mesh, policy, threshold, accum, b = CASES8[name]
    tokens = ref["arrays"]["tokens"] if b == B8 else _tokens(b)
    return dict(mesh=mesh, policy=policy, small_model_params=threshold,
                train=dict(tokens=tokens, accum=accum))


def _case4(name):
    mesh, rules, b, cfg = CASES4[name]
    case = dict(mesh=mesh, cfg=dict(F32, **cfg), train=dict(tokens=_tokens(b), accum=ACCUM))
    return case if rules is None else dict(case, rules=rules)


@pytest.fixture(scope="module")
def port(ref, tmp_path_factory):
    """Every case on its ranks, one ``run_ranks`` call per world size →
    {name: [per rank]}."""
    mod_dir = tmp_path_factory.mktemp("threshold_target")
    (mod_dir / "threshold_target.py").write_text(THRESHOLD_MODULE)
    common = dict(device="cpu", arch=ARCH, smoke=True, cfg=F32, params=ref["params"])
    out = {}
    runs = ((8, list(CASES8), lambda n: _case8(n, ref)), (4, list(CASES4), _case4))
    for world, names, make in runs:
        res = run_ranks("threshold_target:run", world,
                        dict(common, cases=[make(n) for n in names]), timeout_s=RANK_LIMIT,
                        env={"PYTHONPATH": str(mod_dir)})
        for i, n in enumerate(names):
            out[n] = [r[i] for r in res]
    return out


def _one_rank(ref, tokens, accum):
    """The port's one-rank train step on the whole parameters → (new
    params, state, metrics)."""
    model = Model(_cfg())
    params = params_from_jax(ref["params"], "cpu")
    opt = AdamW(lr=warmup_cosine(3e-4, 2000, 100_000))
    step = make_train_step(model, opt, accum=accum)
    new_p, state, metrics = step(params, opt.init(params), {"tokens": torch.as_tensor(tokens)})
    def to_np(t):
        return {k: to_np(v) for k, v in t.items()} if isinstance(t, dict) else t.numpy()

    return dict(params=to_np(new_p), m=to_np(state.m), v=to_np(state.v),
                loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]))


def _mesh(shape, rank):
    return mesh_mod.Mesh(("pod", "data", "model")[-len(shape):], shape, None, rank, {})


def _check(ranks, want, shape):
    """Every rank's loss, grad norm and blocks of the new parameters, ``m``
    and ``v`` against ``want`` (whole trees)."""
    axes = Model(_cfg()).axes()
    for rank, r in enumerate(ranks):
        t = r["train"]
        assert abs(t["loss"][0] - want["loss"]) <= TOL
        assert abs(t["grad_norm"][0] - want["grad_norm"]) <= TOL
        mesh = _mesh(shape, rank)
        for tree in ("params", "m", "v"):
            blocks = dict(flatten(shard_params(want[tree], axes, mesh, mesh.coords,
                                               r["param_rules"])))
            for path, got in flatten(t[tree]):
                exp = blocks[path]
                assert got.shape == exp.shape, (tree, path)
                err = float(np.abs(got.numpy() - exp).max())
                bound = TOL if tree == "params" else min(TOL, REL * float(np.abs(exp).max()))
                assert err <= bound, (rank, tree, "/".join(path), err, bound)


@pytest.mark.parametrize("name", list(CASES8)[:4])
def test_8_rank_step_matches_reference_cell(name, ref, port):
    """The (2, 4) rank mesh against ``build_cell``'s compiled train cell
    (accum 2) under the case's policy; ``accum1`` runs the baseline with
    one microbatch against the same cell (equal microbatches: the same
    mean)."""
    cell = ref["baseline" if name == "accum1" else name]
    _check(port[name], cell, (2, 4))


@pytest.mark.parametrize("name", ["pod_2x2x2"] + list(CASES4))
def test_cases_match_one_rank_step(name, ref, port):
    """Every other layout against the port's one-rank ``make_train_step``
    on the same parameters and tokens."""
    if name in CASES8:
        shape, accum, tokens = CASES8[name][0], CASES8[name][3], _tokens(CASES8[name][4])
    else:
        shape, accum, tokens = CASES4[name][0], ACCUM, _tokens(CASES4[name][2])
    _check(port[name], _one_rank(ref, tokens, accum), shape)


def test_policies_take_the_references_rules(ref, port):
    """The port's ``policy_rules`` on the rank mesh give each cell the
    activation rules the reference's gave it, and small-DP its parameter
    rules (every leaf whole) and a layout without parameter gathers."""
    canon = lambda rules: json.loads(json.dumps(rules))  # noqa: E731
    for name in POLICIES:
        for r in port[name]:
            assert canon(r["rules"]) == ref[name]["act"], name
    assert all(r["param_rules"] == sharding.PARAM_RULES_SMALL_DP for r in port["small_dp"])
    assert all(r["param_rules"] is None for r in port["baseline"] + port["opt"])
    assert not any(op[3].startswith(("layer", "embed", "head"))
                   for r in port["small_dp"] for op in r["train"]["ops"])


@pytest.mark.parametrize("name", list(CASES8) + list(CASES4))
def test_collectives_equal_formula(name, port):
    """Every rank's counted collectives of one step — forward, backward
    (the transposes, each layer's recomputation), the sums of replicated
    leaves and the grad norm's — in order."""
    cfg = _cfg()
    if name in CASES8:
        shape, b, accum = CASES8[name][0], CASES8[name][4], CASES8[name][3]
    else:
        shape, b, accum = CASES4[name][0], CASES4[name][2], ACCUM
        cfg = cfg.with_(**CASES4[name][3])
    mesh_shape = dict(zip(("pod", "data", "model")[-len(shape):], shape))
    for r in port[name]:
        want = sharded_collectives(cfg, mesh_shape, r["rules"], b, S8, 4, 4, "train",
                                   accum, r["param_rules"])
        assert r["train"]["ops"] == want
        assert any(op[3].endswith("/bwd") for op in want)
        assert r["train"]["k2_launches"] == 0      # the train step takes no kernel
        assert r["route"]["backend"] == "gloo" and r["route"]["host_staged"] == 0


@pytest.mark.parametrize("name", list(POLICIES))
def test_wire_bytes_within_factor_of_compiled_cell(name, ref, port):
    """Total wire bytes a step on a rank against the compiled cell's per
    device (by kind in the message; GSPMD picks its own ops)."""
    xla = _reference_ops(ref[name]["text"], 8, ref[name]["trips"])
    got = _wire_by_kind([op[:3] + (1,) for op in port[name][0]["train"]["ops"]])
    exp = _wire_by_kind(xla)
    print(f"wire bytes a step ({name}), port", got, "compiled cell", exp)
    assert sum(got.values()) <= WIRE_FACTOR * sum(exp.values()), (got, exp)
    assert sum(got.values()) > 0 and sum(exp.values()) > 0


def _fake_rank_mesh(shape=(1, 2), rank=0):
    return mesh_mod.Mesh(("data", "model"), shape, None, rank, {})


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "jamba-v0.1-52b", "whisper-base",
                                  "falcon-mamba-7b", "internvl2-1b", "tied-dense"])
def test_loss_under_autograd_on_ranks_raises_off_the_sharded_families(arch):
    """A rank mesh's context with autograd on: no family raises any more.
    The SSM, MoE and hybrid families, a dense model with a tied head and
    the encoder-decoder take the sharded path's layout of their tokens
    (the encoder-decoder its decoder's; its encoder takes one of its own),
    the VLM the layout of its whole stream, ``n_vision_tokens`` positions
    before the tokens' (their train steps on ranks:
    ``tests/test_torch_sharded_ssm.py``, ``tests/test_torch_sharded_moe.py``,
    ``tests/test_torch_sharded_hybrid.py``,
    ``tests/test_torch_sharded_encdec.py``,
    ``tests/test_torch_sharded_vlm.py``)."""
    if arch == "tied-dense":
        cfg = get_config(ARCH, smoke=True).with_(tie_embeddings=True)
    else:
        cfg = get_config(arch, smoke=True)
    model = Model(cfg)
    batch = {"tokens": torch.zeros(2, 8, dtype=torch.long)}
    with actctx.activation_sharding(_fake_rank_mesh(), {"batch": ("data",), "seq": "model"}):
        with torch.enable_grad():
            lay = model._layout(batch)
    s = 8 + (cfg.n_vision_tokens if arch == "internvl2-1b" else 0)
    assert (lay.batch, lay.seq_sharded, lay.b_loc, lay.s, lay.s_loc) == (
        ("data",), True, 2, s, s // 2)


@pytest.mark.parametrize("shape", [(2, 4), (1, 4), (2, 2, 2)])
def test_replicated_axes_are_the_axes_a_leaf_is_not_split_over(shape):
    """Under ``PARAM_RULES``: the norms along ``model``, kv heads along
    ``model`` where they do not divide it, every leaf along ``pod``; under
    small-DP's rules every leaf along every axis."""
    mesh = _mesh(shape, 0)
    n_model = mesh.shape["model"]
    pod = ("pod",) if "pod" in mesh.shape else ()
    for path, p in flatten(Model(_cfg()).defs()):
        name = path[-1]
        model_whole = name in ("ln_f", "ln1", "ln2") or (
            name in ("w_k", "w_v") and _cfg().n_kv_heads % n_model)
        want = pod + (("model",) if model_whole else ())
        assert actctx.replicated_axes(p, mesh, sharding.PARAM_RULES) == want, path
        assert actctx.replicated_axes(p, mesh, sharding.PARAM_RULES_SMALL_DP) == tuple(
            a for a in mesh.axis_names if mesh.shape[a] > 1)


def test_rank_layout_takes_small_dp_and_pod():
    """Small-DP's rules with its parameter rules: the batch over every axis
    it divides, the sequence whole; with ``PARAM_RULES`` the batch over
    ``model`` raises.  A ``pod`` mesh: the batch over ``("pod", "data")``."""
    mesh = _fake_rank_mesh((2, 4), 5)
    small = sharding.ACT_RULES_SMALL_DP
    with actctx.activation_sharding(mesh, small, sharding.PARAM_RULES_SMALL_DP):
        lay = actctx.rank_layout(16, 16, 64)
        assert (lay.batch, lay.seq_sharded, lay.b0, lay.b_loc, lay.param_rules) == (
            ("data", "model"), False, 10, 2, {})
        assert actctx.rank_params() == (mesh, {})
    with actctx.activation_sharding(mesh, small), pytest.raises(NotImplementedError):
        actctx.rank_layout(16, 16, 64)
    pod = _mesh((2, 2, 2), 6)
    with actctx.activation_sharding(pod, {"batch": ("pod", "data"), "seq": "model"}):
        lay = actctx.rank_layout(8, 16, 64)
        assert (lay.batch, lay.seq_sharded, lay.b0, lay.b_loc, lay.s0) == (
            ("pod", "data"), True, 6, 2, 0)
        assert lay.param_rules == sharding.PARAM_RULES


@pytest.mark.parametrize("accum", [1, 2])
def test_donated_step_equals_the_plain_step(accum):
    """``make_train_step(donate=True)`` updates the parameters and the
    optimizer state in place, to the same numbers as the plain step."""
    model = Model(_cfg().with_(n_layers=1))
    opt = AdamW(lr=warmup_cosine(3e-4, 2000, 100_000))
    batch = {"tokens": torch.as_tensor(_tokens(4))}
    params = model.init(torch.Generator().manual_seed(1), "cpu")
    want_p, want_s, want_m = make_train_step(model, opt, accum)(params, opt.init(params), batch)
    state = opt.init(params)
    got_p, got_s, got_m = make_train_step(model, opt, accum, donate=True)(params, state, batch)
    for (path, got), (_, want) in zip(flatten(got_p), flatten(want_p)):
        assert got is dict(flatten(params))[path] and torch.equal(got, want), path
    for tree in ("m", "v"):
        for (path, got), (_, want) in zip(flatten(getattr(got_s, tree)),
                                          flatten(getattr(want_s, tree))):
            assert got is dict(flatten(getattr(state, tree)))[path] and torch.equal(got, want)
    assert all(torch.equal(got_m[k], want_m[k]) for k in ("loss", "grad_norm"))
