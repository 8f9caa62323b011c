"""The port's sharded VLM family on gloo ranks, against the reference's
compiled cells on forced host devices.

A subprocess runs the reference on 8 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``) for internvl2-1b
at smoke width in float32 (2 layers, d 64, 4 heads of 16, 2 kv heads,
which do not divide ``model`` 4, swiglu ``d_ff`` 128, vocabulary 256 tied
to the embedding, 8 vision tokens), its parameters from the reference's
``init_params``, tokens, vision embeddings and caches from a numpy seed.
On a (2, 4) mesh, inside ``with mesh, activation_sharding(mesh,
act_rules)`` as ``run_cell`` does, it runs ``launch/dryrun.py::
build_cell``'s prefill cell of a stream of 8 vision embeddings and 16
tokens under the baseline policy and under ``opt`` (caches under
``ACT_RULES_DECODE``), ``make_eval_step``'s loss, the train cell (accum
2) under ``baseline``, ``opt`` as it stands (small-DP at smoke width) and
``opt`` with ``rd.SMALL_MODEL_PARAMS = 0`` (``ACT_RULES_TRAIN_OPT``), and
the decode cell for two chained ticks at batch 4 and two at batch 1
(which ``data`` 2 does not divide) under each of ``baseline`` and
``opt``.  It writes every output and each cell's compiled text.

The port runs the same cells on 8 spawned gloo ranks as a (2, 4) rank
mesh (``launch/sharded.py``, each rank holding its blocks of the
reference's parameters), and more cases on 4 and 8 ranks against the
port's one-rank model: (1, 4) (the kv heads whole), (2, 2), a (2, 2, 2)
``("pod", "data", "model")`` mesh, a batch of 3 on ``data`` 2 and a batch
of 1, a ``loss_mask``, and the full width's divisibility at smoke size (6
heads, whole on ``model`` 4, and a vocabulary of 255, whole: internvl2-1b
has 14 heads and 151 655 tokens), each as a prefill whose caches feed
teacher-forced ticks, and the loss; the train step on (1, 4), (2, 2),
(2, 2) without ``remat`` and the pod mesh.  Checked: values within 1e-5
(the moments also within 1e-4 of each leaf's largest, as in
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
from repro_torch.launch.sharded import assemble_logits, assemble_tick, sharded_collectives
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import Model
from repro_torch.models.params import flatten, param_axes
from repro_torch.optim import AdamW, warmup_cosine
from test_torch_sharded import F32, SRC, TOL, _reference_ops, _wire_by_kind
from test_torch_sharded_train import THRESHOLD_MODULE

ARCH = "internvl2-1b"
REL = 1e-4          # of each leaf's largest |m| or |v|
RANK_LIMIT = 240    # seconds for one multi-rank run
B8, S8 = 4, 16      # the prefill and loss cell's tokens: the stream of 8 + 16 over model 4
S_MAX = 32          # the caches' length: the decode cell's and the one-rank comparisons'
BT, ACCUM = 16, 2   # the train cell: each microbatch of 8 rows splits over data × model
# the decode cell: (name, batch, ticks, pos); batch 1 does not split over data 2
TICKS = [("b4", 4, 2, 27), ("b1", 1, 2, 29)]
# The rule for the wire bytes, fixed before the test first ran: GSPMD picks
# its own ops (and may gather weights where the port gathers activations),
# so only a step's total is bounded, by this factor (the launcher's greedy
# pick, which the decode cell does not make, left out).
WIRE_FACTOR = 2.0
# (policy, SMALL_MODEL_PARAMS) of each reference train cell; None keeps 2e8
POLICIES = {"baseline": ("baseline", None), "small_dp": ("opt", None), "opt": ("opt", 0)}
SERVE_POLICIES = ("baseline", "opt")
WHOLE = dict(n_heads=6, vocab_size=255)     # heads and vocabulary whole on model 4

# the one-rank comparisons: name → (mesh, cfg overrides, batch, kind); "serve"
# runs a prefill, 3 teacher-forced ticks from its caches and the loss,
# "mask" the same with a loss_mask, "train" a train step (accum 2)
CASES = {
    "1x4": ((1, 4), {}, 2, "serve"),
    "2x2": ((2, 2), {}, 4, "serve"),
    "pod_2x2x2": ((2, 2, 2), {}, 4, "serve"),
    "batch_undivided_2x2": ((2, 2), {}, 3, "serve"),
    "batch_one_2x2": ((2, 2), {}, 1, "serve"),
    "loss_mask_2x2": ((2, 2), {}, 4, "mask"),
    "heads_vocab_whole_1x4": ((1, 4), WHOLE, 2, "serve"),
    "train_1x4": ((1, 4), {}, 4, "train"),
    "train_2x2": ((2, 2), {}, 8, "train"),
    "train_noremat_2x2": ((2, 2), dict(remat=False), 8, "train"),
    "train_pod_2x2x2": ((2, 2, 2), {}, 8, "train"),
}
CELLS = ["cell", "cell_opt", *(f"train_{p}" for p in POLICIES)]
WORLD = {8: list(CELLS), 4: []}
for _n, (_m, *_) in CASES.items():
    WORLD[int(np.prod(_m))].append(_n)

# The reference's cells for either family: a VLM's stream holds its vision
# embeddings before the tokens, an encoder-decoder's batch its frames; an
# encoder-decoder's ticks run the reference's one-device Model.decode from
# its compiled prefill's caches (its decode cell does not lower:
# tests/test_torch_sharded_encdec.py).
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
    stream = s + (cfg.n_vision_tokens if cfg.family == "vlm" else 0)
    arrays = {}
    res = {"texts": {}, "trips": {}, "act": {}}

    def draw(prefix, rows):
        arrays[prefix + "tokens"] = rng.integers(0, cfg.vocab_size, (rows, s)).astype(np.int32)
        if cfg.family == "vlm":
            arrays[prefix + "vision_embeds"] = rng.standard_normal(
                (rows, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
        if cfg.family == "encdec":
            arrays[prefix + "frames"] = rng.standard_normal(
                (rows, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)
                and k[len(prefix):] in ("tokens", "vision_embeds", "frames")}

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
    batch = draw("", b)
    train_batch = draw("train_", bt)
    for policy in ("baseline", "opt"):
        fn, act = cell("prefill/" + policy, ShapeSpec("smoke", "prefill", stream, b), policy)
        with mesh, activation_sharding(mesh, act):
            logits, caches = fn(params, batch)
            res["texts"]["prefill/" + policy] = fn.lower(params, batch).compile().as_text()
        arrays["prefill/%s/logits" % policy] = np.asarray(logits)
        save("prefill/%s/caches/" % policy, caches)

    tshape = ShapeSpec("smoke", "train", stream, b)
    act_t = rd.policy_rules(arch, tshape, mesh, "baseline")[2]
    ev = jax.jit(make_eval_step(model), in_shardings=(param_shardings(model.defs(), mesh),
                                                      train_inputs(cfg, tshape, mesh)[1]))
    with mesh, activation_sharding(mesh, act_t):
        res["loss"] = {k: float(v) for k, v in ev(params, batch).items()}

    for name, (policy, threshold) in policies.items():
        rd.SMALL_MODEL_PARAMS = 2e8 if threshold is None else threshold
        fn, act = cell("train/" + name, ShapeSpec("smoke", "train", stream, bt), policy)
        state = AdamW().init(params)
        with mesh, activation_sharding(mesh, act):
            compiled = fn.lower(params, state, train_batch).compile()
            new_p, new_s, metrics = compiled(*jax.device_put((params, state, train_batch),
                                                             compiled.input_shardings[0]))
        res["texts"]["train/" + name] = compiled.as_text()
        res["train/" + name] = {k: float(v) for k, v in metrics.items()}
        for tree, t in (("params", new_p), ("m", new_s.m), ("v", new_s.v)):
            save("train/%s/%s/" % (name, tree), t)
    rd.SMALL_MODEL_PARAMS = 2e8

    for name, bd, n_ticks, pos in ticks:
        tok = rng.integers(0, cfg.vocab_size, (bd, n_ticks)).astype(np.int32)
        arrays["decode/%s/tokens" % name] = tok
        if cfg.family == "encdec":      # the baseline prefill's caches, k and v padded
            caches = {}
            for k in ("k", "v", "ek", "ev"):
                c = arrays["prefill/baseline/caches/" + k]
                pad = np.zeros(c.shape[:2] + (s_max - c.shape[2],) + c.shape[3:], c.dtype)
                caches[k] = np.concatenate([c, pad], 2) if k in ("k", "v") else c
            save("decode/%s/caches/" % name, caches)
            step = jax.jit(model.decode)
            cur = jax.tree_util.tree_map(jnp.asarray, caches)
            for t in range(n_ticks):
                logits, cur = step(params, jnp.asarray(tok[:, t:t + 1]), jnp.int32(pos + t), cur)
                arrays["decode/one/%s/logits/%d" % (name, t)] = np.asarray(logits)[:, 0]
            save("decode/one/%s/after/" % name, cur)
            continue
        caches = {k: rng.standard_normal(d.shape).astype(np.float32)
                  for k, d in model.cache_defs(bd, s_max).items()}
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


def start_reference(tmp_path_factory, arch, ticks):
    """The reference's cells of ``arch``, in a subprocess started at once
    → (its output path, the process)."""
    out = str(tmp_path_factory.mktemp("ref_" + arch) / "ref")
    env = {**os.environ, "PYTHONPATH": SRC}
    arg = json.dumps([arch, B8, S8, BT, ACCUM, S_MAX, ticks, POLICIES, out])
    return out, subprocess.Popen([sys.executable, "-c", REF_SCRIPT, arg], env=env,
                                 stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


def load_reference(out, proc):
    _, err = proc.communicate(timeout=400)
    assert proc.returncode == 0, err[-3000:]
    with open(out + ".json") as fh:
        res = json.load(fh)
    res["arrays"] = dict(np.load(out + ".npz"))
    res["params"] = _tree(res["arrays"], "p/")
    return res


@pytest.fixture(scope="module")
def ref_proc(tmp_path_factory):
    out, proc = start_reference(tmp_path_factory, ARCH, TICKS)
    yield out, proc
    proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def target(tmp_path_factory):
    """A directory holding the rank target that sets
    ``SMALL_MODEL_PARAMS`` per case."""
    mod_dir = tmp_path_factory.mktemp("targets_vlm")
    (mod_dir / "threshold_target.py").write_text(THRESHOLD_MODULE)
    return str(mod_dir)


def run_cases(world, cases, arch, target):
    """``cases`` ({name: case}) on ``world`` ranks → {name: [per rank]}."""
    t0 = time.monotonic()
    res = run_ranks("threshold_target:run", world,
                    dict(device="cpu", arch=arch, smoke=True, cfg=F32,
                         cases=list(cases.values())),
                    timeout_s=RANK_LIMIT, env={"PYTHONPATH": target})
    assert time.monotonic() - t0 < RANK_LIMIT
    return {n: [r[i] for r in res] for i, n in enumerate(cases)}


def numpy_tree(tree):
    return ({k: numpy_tree(v) for k, v in tree.items()} if isinstance(tree, dict)
            else tree.numpy())


def whole_params(cfg):
    """The whole parameters (numpy) a one-rank comparison runs on: the
    port's, from seed 0."""
    return numpy_tree(Model(cfg).init(torch.Generator().manual_seed(0), "cpu"))


def inputs(cfg, b, n=S8, seed=7):
    """A batch of ``b`` rows of ``n`` tokens from a numpy seed, with the
    family's vision embeddings or frames."""
    rng = np.random.default_rng(seed)
    out = dict(tokens=rng.integers(0, cfg.vocab_size, (b, n)))
    if cfg.family == "vlm":
        out["vision_embeds"] = rng.standard_normal(
            (b, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


def cell_inputs(a, prefix=""):
    return {k: a[prefix + k] for k in ("tokens", "vision_embeds", "frames") if prefix + k in a}


def one_rank_case(mesh, over, b, kind, arch):
    """A ``launch/sharded.py:run`` case against the one-rank model."""
    cfg = _cfg(arch, **over)
    case = dict(mesh=mesh, cfg=dict(F32, **over), params=whole_params(cfg))
    if kind == "train":
        case["train"] = dict(inputs(cfg, b), accum=ACCUM)
        return case
    batch = inputs(cfg, b)
    case.update(prefill=dict(batch, s_max=S_MAX),
                decode=[dict(tokens=inputs(cfg, b, 3, 43)["tokens"], host_caches=True)],
                loss=dict(batch))
    if kind == "mask":
        case["loss"]["loss_mask"] = (np.random.default_rng(11).random(batch["tokens"].shape)
                                     < 0.6).astype(np.float32)
    return case


def _case(name, ref=None):
    """A ``launch/sharded.py:run`` case (a cell's needs ``ref``)."""
    if name not in CELLS:
        return one_rank_case(*CASES[name], ARCH)
    a = ref["arrays"]
    common = dict(mesh=(2, 4), params=ref["params"])
    if name.startswith("train_"):
        policy, threshold = POLICIES[name[len("train_"):]]
        return dict(common, policy=policy, small_model_params=threshold,
                    train=dict(cell_inputs(a, "train_"), accum=ACCUM))
    policy = "opt" if name == "cell_opt" else "baseline"
    decode = [dict(tokens=a[f"decode/{t}/tokens"], caches=_tree(a, f"decode/{t}/caches/"),
                   pos=pos, host_caches=True) for t, _, _, pos in TICKS]
    case = dict(common, policy=policy, decode=decode, prefill=cell_inputs(a))
    if policy == "baseline":
        case["loss"] = cell_inputs(a)
    return case


@pytest.fixture(scope="module")
def port4(ref_proc, target):
    """The 4-rank cases (the port's own parameters), run while the
    reference compiles."""
    return run_cases(4, {n: _case(n) for n in WORLD[4]}, ARCH, target)


@pytest.fixture(scope="module")
def ref(ref_proc, port4):
    return load_reference(*ref_proc)


@pytest.fixture(scope="module")
def port(ref, port4, target):
    """Every case on its ranks → {name: [per rank]}."""
    return dict(port4, **run_cases(8, {n: _case(n, ref) for n in WORLD[8]}, ARCH, target))


def one_rank(case, arch):
    """The port's one-rank model on a case's whole parameters: the
    prefill's logits and caches, each tick's logits and the caches after
    the last, the loss; or the train step's."""
    model = Model(_cfg(arch, **{k: v for k, v in case["cfg"].items() if k not in F32}))
    p = params_from_jax(case["params"], "cpu")
    if "train" in case:
        opt = AdamW(lr=warmup_cosine(3e-4, 2000, 100_000))
        batch = {k: torch.as_tensor(v) for k, v in case["train"].items() if k != "accum"}
        new_p, state, metrics = make_train_step(model, opt, accum=ACCUM)(p, opt.init(p), batch)
        return dict(params=numpy_tree(new_p), m=numpy_tree(state.m), v=numpy_tree(state.v),
                    loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]))
    out = {}
    with torch.no_grad():
        loss = {k: torch.as_tensor(v) for k, v in case["loss"].items()}
        out["loss"] = float(model.loss(p, loss)[0])
        batch = {k: torch.as_tensor(v) for k, v in case["prefill"].items() if k != "s_max"}
        logits, caches = model.prefill(p, batch, S_MAX)
        out.update(logits=logits.numpy(), caches={k: v.numpy().copy() for k, v in caches.items()})
        fed, ticks = case["decode"][0]["tokens"], []
        pos = model._n_prefix() + batch["tokens"].shape[1]
        for t in range(fed.shape[1]):
            lg, caches = model.decode(p, torch.as_tensor(fed[:, t:t + 1]), pos + t, caches)
            ticks.append(lg.numpy())
        out.update(ticks=ticks, after=numpy_tree(caches))
    return out


def check_caches(got, whole, shape, rank, b, cfg):
    """One rank's host caches against its blocks of the whole ones under
    the decode rules."""
    fake = _fake(tuple(shape.values()), rank)
    axes = param_axes(Model(cfg).cache_defs(b, S_MAX))
    want = dict(flatten(shard_params(whole, axes, fake, fake.coords, _decode_rules(shape))))
    got = dict(flatten(got))
    assert set(got) == set(want)
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        np.testing.assert_allclose(got[path].numpy(), w, atol=TOL, rtol=0, err_msg=str(path))


def check_train(ranks, want, shape, cfg):
    """Every rank's loss, grad norm and blocks of the new parameters, ``m``
    and ``v`` against ``want`` (whole trees)."""
    axes = Model(cfg).axes()
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


def check_one_rank(name, spec, ranks, arch):
    """A case of ``CASES``-like ``spec`` against the port's one-rank model
    on the same parameters and inputs, within 1e-5: the prefill's logits
    and caches, each tick fed from its caches and the caches after, the
    loss; the train step."""
    mesh, over, b, kind = spec
    cfg, shape = _cfg(arch, **over), _mesh_shape(mesh)
    want = one_rank(one_rank_case(mesh, over, b, kind, arch), arch)
    if kind == "train":
        check_train(ranks, want, mesh, cfg)
        return
    v = cfg.vocab_size
    np.testing.assert_allclose(assemble_logits(ranks, b, v).numpy(), want["logits"], atol=TOL,
                               rtol=0)
    for t, lg in enumerate(want["ticks"]):
        np.testing.assert_allclose(assemble_tick(ranks, 0, t, b, v).numpy(), lg, atol=TOL, rtol=0)
    for rank, r in enumerate(ranks):
        check_caches(r["prefill"]["caches"], want["caches"], shape, rank, b, cfg)
        check_caches(r["decode"][0]["caches"], want["after"], shape, rank, b, cfg)
        assert abs(r["loss"]["loss"] - want["loss"]) <= TOL, name


def check_formula(case, ranks, cfg, s_max=S_MAX):
    """Every rank's counted collectives of every step — the train step's
    backward, recomputation and sums included, each decode tick — against
    ``sharded_collectives``, op for op."""
    shape = _mesh_shape(case["mesh"])
    for r in ranks:
        for step in ("train", "prefill", "loss"):
            if step in case:
                b, s = case[step]["tokens"].shape
                want = sharded_collectives(cfg, shape, r["rules"], b, s, 4, 4, step,
                                           case[step].get("accum", 1), r["param_rules"],
                                           case[step].get("s_max"))
                assert r[step]["ops"] == want, step
        for i, entry in enumerate(case.get("decode", [])):
            want = sharded_collectives(cfg, shape, _decode_rules(shape),
                                       entry["tokens"].shape[0], 1, 4, 4, "decode", s_max=s_max)
            assert all(ops == want for ops in r["decode"][i]["ops"])
        assert r["route"]["backend"] == "gloo" and r["route"]["host_staged"] == 0


def check_wire(ops, xla, label):
    """Total wire bytes a step on a rank against the compiled cell's per
    device (by kind in the message; GSPMD picks its own ops)."""
    got = _wire_by_kind([op[:3] + (1,) for op in ops if op[3] != "decode/greedy"])
    exp = _wire_by_kind(xla)
    print(f"wire bytes ({label}), port", got, "compiled cell", exp,
          "ratio", sum(got.values()) / sum(exp.values()))
    assert sum(got.values()) <= WIRE_FACTOR * sum(exp.values()), (got, exp)
    assert sum(got.values()) > 0 and sum(exp.values()) > 0


@pytest.mark.parametrize("policy", SERVE_POLICIES)
def test_prefill_and_loss_on_8_ranks_match_reference_cell(policy, ref, port):
    """The (2, 4) rank mesh against ``build_cell``'s prefill of the stream
    (8 vision embeddings, 16 tokens) under the policy and, under the
    baseline, the jitted ``make_eval_step``: every rank's block of the
    logits, its blocks of the caches (6 positions of the 24 on each rank's
    block before the decode layout, 6 of them after it) and the loss
    within 1e-5."""
    a = ref["arrays"]
    ranks = port["cell" if policy == "baseline" else "cell_opt"]
    np.testing.assert_allclose(assemble_logits(ranks, B8, 256).numpy(),
                               a[f"prefill/{policy}/logits"], atol=TOL, rtol=0)
    stream = S8 + 8
    for rank, r in enumerate(ranks):
        assert r["prefill"]["logits"].shape == (B8 // 2, 256 // 4)
        assert r["prefill"]["caches"]["k"].shape == (2, B8 // 2, stream // 4, 2, 16)
        shape = dict(data=2, model=4)
        fake = _fake((2, 4), rank)
        axes = param_axes(Model(_cfg()).cache_defs(B8, stream))
        want = dict(flatten(shard_params(_tree(a, f"prefill/{policy}/caches/"), axes, fake,
                                         fake.coords, _decode_rules(shape))))
        for path, got in flatten(r["prefill"]["caches"]):
            np.testing.assert_allclose(got.numpy(), want[path], atol=TOL, rtol=0)
        if policy == "baseline":
            assert abs(r["loss"]["loss"] - ref["loss"]["loss"]) <= TOL
            assert abs(r["loss"]["ce"] - ref["loss"]["ce"]) <= TOL


@pytest.mark.parametrize("name", [t[0] for t in TICKS])
@pytest.mark.parametrize("policy", SERVE_POLICIES)
def test_decode_on_8_ranks_matches_reference_cell(name, policy, ref, port):
    """The decode cell under ``ACT_RULES_DECODE`` and the policy: two
    chained ticks at batch 4 (rows over ``data``) from ``pos`` 27, and two
    at batch 1 (every rank holds the row) from ``pos`` 29, on numpy-seeded
    caches: each tick's logits and the caches after the last within
    1e-5."""
    a = ref["arrays"]
    i, (_, b, n, _) = next((i, t) for i, t in enumerate(TICKS) if t[0] == name)
    ranks = port["cell" if policy == "baseline" else "cell_opt"]
    for t in range(n):
        np.testing.assert_allclose(assemble_tick(ranks, i, t, b, 256).numpy(),
                                   a[f"decode/{policy}/{name}/logits/{t}"], atol=TOL, rtol=0)
    for rank, r in enumerate(ranks):
        entry = r["decode"][i]
        assert entry["kv"][1] - entry["kv"][0] == S_MAX // 4
        check_caches(entry["caches"], _tree(a, f"decode/{policy}/{name}/after/"),
                     dict(data=2, model=4), rank, b, _cfg())


@pytest.mark.parametrize("name", list(POLICIES))
def test_train_on_8_ranks_matches_reference_cell(name, ref, port):
    """The (2, 4) rank mesh's train step against ``build_cell``'s compiled
    train cell (accum 2) under the policy: loss, grad norm and every
    rank's block of the new parameters, ``m`` and ``v``."""
    want = dict(ref[f"train/{name}"],
                **{t: _tree(ref["arrays"], f"train/{name}/{t}/") for t in ("params", "m", "v")})
    check_train(port[f"train_{name}"], want, (2, 4), _cfg())
    canon = json.loads(json.dumps(port[f"train_{name}"][0]["rules"]))
    assert canon == ref["act"][f"train/{name}"]


@pytest.mark.parametrize("name", list(CASES))
def test_cases_match_one_rank_model(name, port):
    """Every other layout against the port's one-rank model on the same
    parameters and inputs (``check_one_rank``)."""
    check_one_rank(name, CASES[name], port[name], ARCH)


@pytest.mark.parametrize("name", CELLS + list(CASES))
def test_collectives_equal_formula(name, ref, port):
    """Every rank's counted collectives against ``sharded_collectives``
    (``check_formula``), the stream of the vision prefix and the tokens."""
    case = _case(name, ref)
    over = {k: v for k, v in case.get("cfg", {}).items() if k not in F32}
    check_formula(case, port[name], _cfg(**over))


@pytest.mark.parametrize("cell", [f"prefill/{p}" for p in SERVE_POLICIES]
                         + [f"decode/{p}/{t[0]}" for p in SERVE_POLICIES for t in TICKS]
                         + [f"train/{p}" for p in POLICIES])
def test_wire_bytes_within_factor_of_compiled_cell(cell, ref, port):
    """Total wire bytes a step on a rank against the compiled cell's per
    device."""
    xla = _reference_ops(ref["texts"][cell], 8, ref["trips"][cell])
    kind, policy = cell.split("/")[:2]
    if kind == "train":
        ops = port[f"train_{policy}"][0]["train"]["ops"]
    else:
        r = port["cell" if policy == "baseline" else "cell_opt"][0]
        if kind == "prefill":
            ops = r["prefill"]["ops"]
        else:
            ops = r["decode"][[t[0] for t in TICKS].index(cell.split("/")[2])]["ops"][0]
    check_wire(ops, xla, cell)


@pytest.mark.parametrize("rank", range(4))
def test_stream_layout_holds_the_prefix(rank):
    """On (1, 4) the stream of 8 vision embeddings and 16 tokens splits 6
    positions a rank: rank 1 holds the prefix's last two positions and the
    first four tokens' (``Model._layout``); the prefill's caches then hold
    24 positions."""
    mesh = _fake((1, 4), rank)
    with actctx.activation_sharding(mesh, {"batch": ("data",), "seq": "model"}):
        lay = Model(_cfg())._layout({"tokens": torch.zeros(2, S8, dtype=torch.long)})
    assert (lay.s, lay.s0, lay.s_loc, lay.seq_sharded) == (S8 + 8, 6 * rank, 6, True)
