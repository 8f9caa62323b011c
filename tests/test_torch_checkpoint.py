"""The port's checkpointing against the JAX package's, on the CPU.

The reference's checkpoint tests on torch trees (roundtrip with bf16 and
int32 scalars, ``latest`` and gc, async then ``wait``); a crash mid-write
leaves the previous ``LATEST`` intact; the two packages write the same
bytes for the same tree, and a params-and-AdamW checkpoint that the
reference wrote restores through the port equal to ``params_from_jax`` of
the same tree; ``test_checkpoint_restart_bit_exact`` on ``TINY`` in the
port; and the launcher: a ``--resume`` run equals an uninterrupted one.
"""
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.configs import get_config as ref_get_config
from repro.models.model import Model as RefModel
from repro.optim import AdamW as RefAdamW
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint import checkpointer as ckpt_mod
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import TINY
from repro_torch.models.model import Model
from repro_torch.models.params import flatten
from repro_torch.optim import AdamW, AdamWState, constant


def _bits(t):
    t = t.detach()
    if t.is_floating_point():
        t = t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
    return t


def _assert_same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(_bits(a), _bits(b))


def _leaves(tree):
    return [leaf for _, leaf in ckpt_mod._flat_with_paths(tree)]


def _tree():
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b": {"c": torch.ones((2, 2), dtype=torch.bfloat16) * 1.5},
        "count": torch.tensor(7, dtype=torch.int32),
    }


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    ck = Checkpointer(tmp_path)
    ck.save(5, tree, blocking=True)
    step, restored = ck.restore(tree)
    assert step == 5
    assert set(restored) == set(tree) and set(restored["b"]) == {"c"}
    for a, b in zip(_leaves(tree), _leaves(restored), strict=True):
        _assert_same(a, b)


def test_checkpoint_latest_and_gc(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    tree = {"x": torch.zeros(3)}
    for s in [1, 2, 3, 4]:
        ck.save(s, tree, blocking=True)
    assert ck.latest_step() == 4
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert steps == ["step_000000003", "step_000000004"]


def test_checkpoint_async_then_wait(tmp_path):
    ck = Checkpointer(tmp_path)
    tree = {"x": torch.arange(1000, dtype=torch.float32)}
    ck.save(1, tree, blocking=False)
    tree["x"].add_(1.0)  # the snapshot was taken before save returned
    ck.wait()
    assert ck.latest_step() == 1
    _, restored = ck.restore(tree)
    _assert_same(restored["x"], torch.arange(1000, dtype=torch.float32))
    assert len(ck.write_s) == 1


def test_restore_places_leaves_and_checks_shapes(tmp_path):
    from repro_torch.distributed import NamedSharding
    from repro_torch.launch.mesh import make_smoke_mesh

    tree = _tree()
    ck = Checkpointer(tmp_path)
    ck.save(2, tree, blocking=True)
    mesh = make_smoke_mesh(device="cpu")
    shardings = {"a": NamedSharding(mesh, ()), "b": {"c": "cpu"},
                 "count": torch.device("cpu")}
    _, restored = ck.restore(tree, shardings=shardings)
    assert all(t.device.type == "cpu" for t in _leaves(restored))
    with pytest.raises(ValueError, match="stored shape"):
        ck.restore(dict(tree, a=torch.zeros(4, 3)))
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "none").restore(tree)


@pytest.mark.parametrize("blocking", [True, False])
def test_crash_mid_write_keeps_previous_latest(tmp_path, monkeypatch, blocking):
    ck = Checkpointer(tmp_path)
    ck.save(1, {"x": torch.ones(4)}, blocking=True)

    def crash(path, **arrays):  # a partial file, then the writer dies
        with open(path, "wb") as fh:
            fh.write(b"PK\x03\x04 partial")
        raise OSError("disk went away")

    monkeypatch.setattr(ckpt_mod.np, "savez", crash)
    with pytest.raises(OSError, match="disk went away"):
        ck.save(2, {"x": torch.full((4,), 2.0)}, blocking=blocking)
        ck.wait()
    assert ck.latest_step() == 1
    assert (tmp_path / ".tmp_step_000000002").exists()
    assert not (tmp_path / "step_000000002").exists()
    step, restored = ck.restore({"x": torch.zeros(4)})
    assert step == 1 and torch.equal(restored["x"], torch.ones(4))
    monkeypatch.undo()
    ck.save(3, {"x": torch.full((4,), 3.0)}, blocking=True)  # the next save recovers
    assert ck.latest_step() == 3


# -- across the packages ----------------------------------------------------------


def _members(root, step):
    d = root / f"step_{step:09d}"
    with zipfile.ZipFile(d / "shard_host0.npz") as zf:
        members = {n: zf.read(n) for n in zf.namelist()}
    return members, (d / "manifest.json").read_text(), (root / "LATEST").read_text()


def _model_and_state(seed=0):
    """A smoke model's bf16 params and a reference AdamW state with m, v
    and count moved off their initial values."""
    cfg = ref_get_config("internvl2-1b", smoke=True)
    jp = RefModel(cfg).init(jax.random.PRNGKey(seed))
    opt = RefAdamW(lr=1e-3)
    grads = jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 0.01, jnp.float32), jp)
    _, js, _ = opt.update(grads, opt.init(jp), jp)
    return jp, js


def test_both_packages_write_the_same_bytes(tmp_path):
    jp, js = _model_and_state()
    RefCheckpointer(tmp_path / "ref").save(3, (jp, js), blocking=True)
    np_tree = jax.tree_util.tree_map(np.asarray, (jp, js._asdict()))
    tp = params_from_jax(np_tree[0], device="cpu")
    tstate = params_from_jax(np_tree[1], device="cpu")
    ts = AdamWState(tstate["m"], tstate["v"], tstate["count"])
    Checkpointer(tmp_path / "port").save(3, (tp, ts), blocking=True)
    ref, port = _members(tmp_path / "ref", 3), _members(tmp_path / "port", 3)
    assert port[0].keys() == ref[0].keys()
    assert "1/.m/embed.npy" in port[0] and "1/.count.npy" in port[0]
    assert all(port[0][k] == ref[0][k] for k in ref[0])
    assert json.loads(port[1]) == json.loads(ref[1]) and port[1:] == ref[1:]


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jp, js = _model_and_state(seed=1)
    RefCheckpointer(tmp_path).save(9, (jp, js), blocking=True)
    model = Model(get_config("internvl2-1b", smoke=True))
    template = model.init(torch.Generator().manual_seed(0), "cpu")
    step, (tp, ts) = Checkpointer(tmp_path).restore((template, AdamW().init(template)))
    assert step == 9 and isinstance(ts, AdamWState)
    want_p = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    want_s = params_from_jax(jax.tree_util.tree_map(np.asarray, js._asdict()), device="cpu")
    for (path, got), (wpath, want) in zip(flatten(tp), flatten(want_p), strict=True):
        assert path == wpath
        _assert_same(got, want)
    for got_tree, key in ((ts.m, "m"), (ts.v, "v")):
        for (_, got), (_, want) in zip(flatten(got_tree), flatten(want_s[key]), strict=True):
            _assert_same(got, want)
    _assert_same(ts.count, want_s["count"])
    assert int(ts.count) == 1 and ts.m["embed"].dtype == torch.float32


# -- restart ---------------------------------------------------------------------


def _run_steps(model, params, opt, opt_state, source, n, start=0):
    step_fn = make_train_step(model, opt)
    for s in range(start, start + n):
        batch = {k: torch.as_tensor(v) for k, v in source.batch(s).items()}
        params, opt_state, _ = step_fn(params, opt_state, batch)
    return params, opt_state


def test_checkpoint_restart_bit_exact(tmp_path):
    """Stop at step 6, restore, continue — must equal the uninterrupted run
    (fault-tolerance requirement: restart is invisible)."""
    model = Model(TINY)
    params0 = model.init(torch.Generator().manual_seed(2), "cpu")
    opt = AdamW(lr=constant(1e-3))
    src = SyntheticLM(DataConfig(seq_len=64, global_batch=4, vocab_size=TINY.vocab_size,
                                 seed=2))
    p_ref, o_ref = _run_steps(model, params0, opt, opt.init(params0), src, 12)
    p_a, o_a = _run_steps(model, params0, opt, opt.init(params0), src, 6)
    ck = Checkpointer(tmp_path)
    ck.save(6, (p_a, o_a), blocking=True)
    step, (p_b, o_b) = ck.restore((p_a, o_a))
    assert step == 6
    p_fin, o_fin = _run_steps(model, p_b, opt, o_b, src, 6, start=6)
    for a, b in zip(_leaves((p_ref, o_ref)), _leaves((p_fin, o_fin)), strict=True):
        _assert_same(a, b)


def test_launcher_resume_equals_uninterrupted_run(tmp_path, capsys):
    base = ["--device", "cpu", "--batch", "4", "--seq", "64", "--log-every", "1",
            "--ckpt-every", "100"]
    straight = train.main(base + ["--steps", "6", "--ckpt-dir", str(tmp_path / "a")])
    first = train.main(base + ["--steps", "3", "--ckpt-dir", str(tmp_path / "b")])
    resumed = train.main(base + ["--steps", "6", "--ckpt-dir", str(tmp_path / "b"),
                                 "--resume"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert (straight["resumed_from"], first["resumed_from"], resumed["resumed_from"]) == (0, 0, 3)
    assert straight["losses"] == first["losses"] + resumed["losses"]
    assert straight["grad_norms"] == first["grad_norms"] + resumed["grad_norms"]
    for a, b in zip(_leaves((straight["params"], straight["opt_state"])),
                    _leaves((resumed["params"], resumed["opt_state"])), strict=True):
        _assert_same(a, b)
    a, b = _members(tmp_path / "a", 6), _members(tmp_path / "b", 6)
    assert a == b
