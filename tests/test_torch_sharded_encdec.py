"""The port's sharded encoder-decoder family on gloo ranks, against the
reference's compiled cells on forced host devices.

A subprocess runs the reference on 8 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``) for whisper-base
at smoke width in float32 (2 encoder and 2 decoder layers, d 64, 4 heads
of 16 with 4 kv heads, gelu ``d_ff`` 128, vocabulary 256, 32 encoder
positions), its parameters from the reference's ``init_params``, tokens
and frames from a numpy seed (``tests/test_torch_sharded_vlm.py``'s
script).  On a (2, 4) mesh, inside ``with mesh, activation_sharding(mesh,
act_rules)`` as ``run_cell`` does, it runs ``launch/dryrun.py::
build_cell``'s prefill cell of 16 tokens under the baseline policy and
under ``opt`` (caches under ``ACT_RULES_DECODE``), ``make_eval_step``'s
loss, and the train cell (accum 2) under ``baseline``, ``opt`` as it
stands (small-DP at smoke width) and ``opt`` with ``rd.SMALL_MODEL_PARAMS
= 0`` (``ACT_RULES_TRAIN_OPT``).

The reference's decode cell of this family does not lower: its
``encdec.decode_step`` returns logits ``[B, 1, V]``, and ``build_cell``
gives them the out-sharding of ``(batch, vocab)``, two-dimensional, so
JAX raises ``ValueError`` at ``lower``.  So the ticks start from the
compiled prefill's caches (``k`` and ``v`` padded to 32 positions) and are
held against the reference's one-device ``Model.decode(...)[:, 0]``; their
wire bytes are reported against the formula only.

The port runs the same cells on 8 spawned gloo ranks as a (2, 4) rank
mesh (``launch/sharded.py``; its prefill's caches feed two ticks), and
more cases on 4 and 8 ranks against the port's one-rank model: (1, 4),
(2, 2), a (2, 2, 2) ``("pod", "data", "model")`` mesh, a batch of 3 on
``data`` 2 and a batch of 1, a ``loss_mask``, and the full width's
divisibility at smoke size (a vocabulary of 255, whole, as whisper-base's
51 865; 30 encoder positions, whose sequence stays whole on ``model`` 4
while the decoder's splits), each as a prefill whose caches feed
teacher-forced ticks, and the loss; the train step on (1, 4), (2, 2),
(2, 2) without ``remat`` and the pod mesh.  Checked: values within 1e-5
(the moments also within 1e-4 of each leaf's largest); every rank's
counted collectives equal to ``launch/sharded.py::sharded_collectives``;
each cell's wire bytes a step against the compiled cell's (by the rule of
``tests/test_torch_sharded_vlm.py``, fixed before the first run).
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.distributed import actctx, sharding
from repro_torch.launch.expert import report_of
from repro_torch.launch.sharded import (
    assemble_logits,
    assemble_tick,
    cache_slab,
    seeded_caches,
    sharded_collectives,
)
from repro_torch.models.model import Model
from test_torch_sharded import F32, TOL, _reference_ops
from test_torch_sharded_train import THRESHOLD_MODULE
from test_torch_sharded_vlm import (
    ACCUM,
    B8,
    POLICIES,
    S8,
    S_MAX,
    SERVE_POLICIES,
    _cfg,
    _decode_rules,
    _fake,
    _tree,
    cell_inputs,
    check_caches,
    check_formula,
    check_one_rank,
    check_train,
    check_wire,
    load_reference,
    one_rank_case,
    run_cases,
    start_reference,
)

ARCH = "whisper-base"
# the ticks from the prefill cell's caches: (name, batch, ticks, pos)
TICKS = [("b4", B8, 2, S8)]
WHOLE = dict(vocab_size=255, enc_seq=30)    # the vocabulary and the encoder's sequence whole

CASES = {
    "1x4": ((1, 4), {}, 2, "serve"),
    "2x2": ((2, 2), {}, 4, "serve"),
    "pod_2x2x2": ((2, 2, 2), {}, 4, "serve"),
    "batch_undivided_2x2": ((2, 2), {}, 3, "serve"),
    "batch_one_2x2": ((2, 2), {}, 1, "serve"),
    "loss_mask_2x2": ((2, 2), {}, 4, "mask"),
    "vocab_enc_whole_1x4": ((1, 4), WHOLE, 2, "serve"),
    "train_1x4": ((1, 4), {}, 4, "train"),
    "train_2x2": ((2, 2), {}, 8, "train"),
    "train_noremat_2x2": ((2, 2), dict(remat=False), 8, "train"),
    "train_pod_2x2x2": ((2, 2, 2), {}, 8, "train"),
}
CELLS = ["cell", "cell_opt", *(f"train_{p}" for p in POLICIES)]
WORLD = {8: list(CELLS), 4: []}
for _n, (_m, *_) in CASES.items():
    WORLD[int(np.prod(_m))].append(_n)


@pytest.fixture(scope="module")
def ref_proc(tmp_path_factory):
    out, proc = start_reference(tmp_path_factory, ARCH, TICKS)
    yield out, proc
    proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def target(tmp_path_factory):
    mod_dir = tmp_path_factory.mktemp("targets_encdec")
    (mod_dir / "threshold_target.py").write_text(THRESHOLD_MODULE)
    return str(mod_dir)


def _case(name, ref=None):
    """A ``launch/sharded.py:run`` case (a cell's needs ``ref``): a cell's
    prefill writes caches of ``S_MAX`` positions, which its ticks take."""
    if name not in CELLS:
        return one_rank_case(*CASES[name], ARCH)
    a = ref["arrays"]
    common = dict(mesh=(2, 4), params=ref["params"])
    if name.startswith("train_"):
        policy, threshold = POLICIES[name[len("train_"):]]
        return dict(common, policy=policy, small_model_params=threshold,
                    train=dict(cell_inputs(a, "train_"), accum=ACCUM))
    policy = "opt" if name == "cell_opt" else "baseline"
    case = dict(common, policy=policy, prefill=dict(cell_inputs(a), s_max=S_MAX),
                decode=[dict(tokens=a[f"decode/{t}/tokens"], host_caches=True)
                        for t, *_ in TICKS])
    if policy == "baseline":
        case["loss"] = cell_inputs(a)
    return case


@pytest.fixture(scope="module")
def port4(ref_proc, target):
    return run_cases(4, {n: _case(n) for n in WORLD[4]}, ARCH, target)


@pytest.fixture(scope="module")
def ref(ref_proc, port4):
    return load_reference(*ref_proc)


@pytest.fixture(scope="module")
def port(ref, port4, target):
    return dict(port4, **run_cases(8, {n: _case(n, ref) for n in WORLD[8]}, ARCH, target))


@pytest.mark.parametrize("policy", SERVE_POLICIES)
def test_prefill_and_loss_on_8_ranks_match_reference_cell(policy, ref, port):
    """The (2, 4) rank mesh against ``build_cell``'s prefill under the
    policy and, under the baseline, the jitted ``make_eval_step``: every
    rank's block of the logits (the rows over ``data``, the vocabulary
    over ``model``), its blocks of the caches (``k`` and ``v`` its 8 of
    the 32 positions, the cell's 16 and 16 of zeros; ``ek`` and ``ev``
    every encoder position and head on its rows) and the loss within
    1e-5."""
    a = ref["arrays"]
    ranks = port["cell" if policy == "baseline" else "cell_opt"]
    np.testing.assert_allclose(assemble_logits(ranks, B8, 256).numpy(),
                               a[f"prefill/{policy}/logits"], atol=TOL, rtol=0)
    whole = _tree(a, "decode/b4/caches/")       # the baseline cell's, k and v padded
    for key in ("k", "v", "ek", "ev"):
        np.testing.assert_allclose(whole[key][:, :, :S8] if key in ("k", "v") else whole[key],
                                   a[f"prefill/{policy}/caches/{key}"], atol=TOL, rtol=0)
    for rank, r in enumerate(ranks):
        caches = r["prefill"]["caches"]
        assert r["prefill"]["logits"].shape == (B8 // 2, 256 // 4)
        assert caches["k"].shape == (2, B8 // 2, S_MAX // 4, 4, 16)
        assert caches["ek"].shape == (2, B8 // 2, 32, 4, 16)
        check_caches(caches, whole, dict(data=2, model=4), rank, B8, _cfg(ARCH))
        if policy == "baseline":
            assert abs(r["loss"]["loss"] - ref["loss"]["loss"]) <= TOL
            assert abs(r["loss"]["ce"] - ref["loss"]["ce"]) <= TOL


@pytest.mark.parametrize("policy", SERVE_POLICIES)
def test_ticks_from_prefill_match_reference_one_device_decode(policy, ref, port):
    """Two ticks on the (2, 4) rank mesh under the decode rules, from the
    sharded prefill's caches, against the reference's one-device
    ``Model.decode(...)[:, 0]`` from its compiled prefill's caches (its
    decode cell does not lower: module docstring): each tick's logits and
    the caches after the last within 1e-5."""
    a = ref["arrays"]
    ranks = port["cell" if policy == "baseline" else "cell_opt"]
    name, b, n, pos = TICKS[0]
    for t in range(n):
        np.testing.assert_allclose(assemble_tick(ranks, 0, t, b, 256).numpy(),
                                   a[f"decode/one/{name}/logits/{t}"], atol=TOL, rtol=0)
    for rank, r in enumerate(ranks):
        entry = r["decode"][0]
        assert list(entry["pos"]) == list(range(pos, pos + n))
        assert entry["kv"][0] == r["coords"]["model"] * S_MAX // 4
        assert entry["kv"][1] - entry["kv"][0] == S_MAX // 4
        check_caches(entry["caches"], _tree(a, f"decode/one/{name}/after/"),
                     dict(data=2, model=4), rank, b, _cfg(ARCH))


@pytest.mark.parametrize("name", list(POLICIES))
def test_train_on_8_ranks_matches_reference_cell(name, ref, port):
    """The (2, 4) rank mesh's train step against ``build_cell``'s compiled
    train cell (accum 2) under the policy: loss, grad norm and every
    rank's block of the new parameters (the encoder's, ``enc_in``, the
    decoder's with its cross-attention, the untied head), ``m`` and
    ``v``."""
    want = dict(ref[f"train/{name}"],
                **{t: _tree(ref["arrays"], f"train/{name}/{t}/") for t in ("params", "m", "v")})
    check_train(port[f"train_{name}"], want, (2, 4), _cfg(ARCH))
    canon = json.loads(json.dumps(port[f"train_{name}"][0]["rules"]))
    assert canon == ref["act"][f"train/{name}"]


@pytest.mark.parametrize("name", list(CASES))
def test_cases_match_one_rank_model(name, port):
    """Every other layout against the port's one-rank model on the same
    parameters and inputs, within 1e-5: the prefill's logits and caches,
    each tick fed from its caches and the caches after, the loss; the
    train step."""
    check_one_rank(name, CASES[name], port[name], ARCH)


@pytest.mark.parametrize("name", CELLS + list(CASES))
def test_collectives_equal_formula(name, ref, port):
    """Every rank's counted collectives against ``sharded_collectives``:
    the encoder's section (``enc/in``, its layers, ``enc/out``) before the
    decoder's, whose layers hold the cross-attention's ops; the prefill's
    ``prefill/xcache``; the train step's transposes and recomputation of
    both stacks."""
    case = _case(name, ref)
    over = {k: v for k, v in case.get("cfg", {}).items() if k not in F32}
    check_formula(case, port[name], _cfg(ARCH, **over))


@pytest.mark.parametrize("cell", [f"prefill/{p}" for p in SERVE_POLICIES]
                         + [f"train/{p}" for p in POLICIES])
def test_wire_bytes_within_factor_of_compiled_cell(cell, ref, port):
    """Total wire bytes a step on a rank against the compiled cell's per
    device."""
    xla = _reference_ops(ref["texts"][cell], 8, ref["trips"][cell])
    kind, policy = cell.split("/")
    if kind == "train":
        ops = port[f"train_{policy}"][0]["train"]["ops"]
    else:
        ops = port["cell" if policy == "baseline" else "cell_opt"][0]["prefill"]["ops"]
    check_wire(ops, xla, cell)


def test_tick_wire_bytes_against_the_formula(ref, port):
    """A tick's wire bytes, which no compiled cell gives (module
    docstring): every rank's equal the formula's, reported by kind."""
    shape = dict(data=2, model=4)
    want = sharded_collectives(_cfg(ARCH), shape, _decode_rules(shape), B8, 1, 4, 4, "decode",
                               s_max=S_MAX)
    wire = report_of(want).by_kind()
    print("tick wire bytes by kind (formula)", wire)
    for r in port["cell"]:
        assert all(report_of(ops).by_kind() == wire for ops in r["decode"][0]["ops"])
    assert {op[3] for op in want} >= {"xattn/out", "attn/qkv", "attn/pv", "layer"}


@pytest.mark.parametrize("b", [4, 3, 1])
def test_encoder_and_decoder_layouts(b):
    """Rank 5 of (2, 4): the decoder's layout of its 16 tokens and the
    encoder's of its 32 positions, one ``rank_layout`` call each, share the
    batch's axes; with 30 encoder positions the encoder's sequence stays
    whole while the decoder's splits.  The decode layout composes the
    self-attention caches' block of positions with the cross caches',
    every position and head (``actctx.cache_layout``)."""
    mesh = _fake((2, 4), 5)
    base = {"batch": ("data",), "seq": "model", "vocab": "model"}
    with actctx.activation_sharding(mesh, base):
        dec = Model(_cfg(ARCH))._layout({"tokens": torch.zeros(b, S8, dtype=torch.long)})
        enc = actctx.rank_layout(b, 32, 64)
        whole = actctx.rank_layout(b, 30, 64)
    assert dec.batch == enc.batch == whole.batch == (("data",) if b % 2 == 0 else ())
    assert (dec.seq_sharded, enc.seq_sharded, whole.seq_sharded) == (True, True, False)
    assert (enc.s0, enc.s_loc) == (8, 8)
    rules = sharding.decode_rules(mesh)
    with actctx.activation_sharding(mesh, rules):
        lay = Model(_cfg(ARCH)).cache_layout(actctx.rank_layout(b, 1, 64), S_MAX, rules)
    assert (lay.kv0, lay.kv_loc, lay.kv_sharded) == (8, 8, True)
    assert not lay.stationary and lay.b_loc == (b // 2 if b % 2 == 0 else b)


def test_seeded_caches_hold_the_cross_caches():
    """``seeded_caches`` of whisper: ``ek`` and ``ev`` of ``enc_seq``
    positions, each layer's slab a function of (seed, layer, leaf) alone,
    apart from ``k`` and ``v``'s; on (2, 2) each rank's rows of every
    position and head."""
    model = Model(_cfg(ARCH))
    whole = seeded_caches(model, 2, 8, 5, "cpu")
    assert whole["ek"].shape == (2, 2, 32, 4, 16) and whole["k"].shape == (2, 2, 8, 4, 16)
    assert torch.equal(whole["ev"][1], cache_slab(model.cfg, 2, 8, 5, 1, "ev", "cpu"))
    assert not torch.equal(whole["ek"][1, :, :8], whole["k"][1])
    mesh = _fake((2, 2), 3)
    part = seeded_caches(model, 2, 8, 5, "cpu", mesh, sharding.decode_rules(mesh))
    assert torch.equal(part["ek"], whole["ek"][:, 1:2])
    assert torch.equal(part["k"], whole["k"][:, 1:2, 4:8])
