"""The port's five example scripts (``examples/*_torch.py``) against the
reference's, on the CPU.

Scheduler scripts (quickstart, bass_cluster_demo, failover_demo): the
reference's stdout, run in a subprocess, equals the port's under
``--backend numpy`` and ``--backend torch`` line for line, but for the
"Next:" line, which names the port's files.  ``serve_batch``: the routing
decisions and finished requests the reference prints equal the port's
with ``--device cpu`` (timings excluded), and the port's generated tokens
equal the reference's engines' on the port's parameters up to where a
request's two bf16 engines part at a near tie (``NEAR_TIE``).  ``train_e2e``:
both run ``--steps 20`` from the same parameters (the reference's
checkpoint at step 0, restored by each with ``--resume``), and their
losses agree.  Every example's defaults raise without a card, and none
imports ``jax`` or ``repro``.
"""
import importlib
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
SRC = str(ROOT / "src")
SCHEDULER_SCRIPTS = ["quickstart", "bass_cluster_demo", "failover_demo"]
ALL_SCRIPTS = SCHEDULER_SCRIPTS + ["serve_batch", "train_e2e"]
LOSS_RTOL = 1e-5    # tests/test_torch_launch.py's
#: The bf16 trainer's later steps: the two frameworks round the bf16
#: activations apart and the updates carry it (3.2e-5 at step 19, measured).
BF16_LOSS_RTOL = 1e-4
#: Two bf16 engines' greedy tokens may part where the two candidates' logits
#: lie closer than this: ``tests/test_torch_serve.py``'s bf16 logits
#: tolerance (the partings measured at the defaults: 0.0040 and 0.0015).
NEAR_TIE = 2e-2


def _env(**kw):
    return {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu", **kw}


def _reference(script: str, *args: str) -> str:
    res = subprocess.run([sys.executable, str(EXAMPLES / f"{script}.py"), *args],
                         capture_output=True, text=True, env=_env(), timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def _port(script: str):
    sys.path.insert(0, str(EXAMPLES))
    try:
        return importlib.import_module(f"{script}_torch")
    finally:
        sys.path.remove(str(EXAMPLES))


@pytest.fixture(scope="module")
def reference_out():
    return {s: _reference(s) for s in SCHEDULER_SCRIPTS}


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("script", SCHEDULER_SCRIPTS)
def test_scheduler_script_prints_the_references(script, backend, reference_out, capsys):
    from repro_torch.kernels import ts_plan

    prev = ts_plan.get_backend()
    try:
        _port(script).main(["--backend", backend])
    finally:
        ts_plan.set_backend(prev)
    got, want = capsys.readouterr().out.splitlines(), reference_out[script].splitlines()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w.startswith("Next:"):
            assert g == w.replace(".py", "_torch.py")
        else:
            assert g == w


def test_serve_batch_routes_and_generates_like_the_reference(capsys):
    from repro.launch.train import TINY as REF_TINY
    from repro.models.model import Model as RefModel
    from repro.serving import BassRouter as RefRouter
    from repro.serving import Request as RefRequest
    from repro.serving import ServeEngine as RefEngine
    from repro_torch.kernels import ts_plan
    from repro_torch.launch import serve as serve_launch

    want = _reference("serve_batch")
    mod = _port("serve_batch")
    prev = ts_plan.get_backend()
    try:
        got = mod.main(mod.ARGV + ["--device", "cpu"])
    finally:
        ts_plan.set_backend(prev)
    out = capsys.readouterr().out

    def decisions(text):
        return [line for line in text.splitlines() if not line.startswith("served ")]

    assert decisions(out) == decisions(want) and len(decisions(out)) > 10
    assert out.count("finished on") == 10
    n = int(mod.ARGV[mod.ARGV.index("--replicas") + 1])
    slots = int(mod.ARGV[mod.ARGV.index("--slots") + 1])
    s_max = int(mod.ARGV[mod.ARGV.index("--s-max") + 1])
    assert got["cfg"].name == REF_TINY.name
    ref_model = RefModel(REF_TINY.with_(remat=False))
    jp = _to_jax(got["params"])
    names = [f"pod0/host{i}" for i in range(n)]
    engines = {h: RefEngine(ref_model, jp, slots, s_max, name=h) for h in names}
    reqs = [RefRequest(rid=r.rid, prompt=r.prompt, max_new=r.max_new,
                       prefix_hash=r.prefix_hash) for r in got["requests"]]
    serve_launch.drive(engines, RefRouter(names), reqs, log=None)
    assert all(len(r.tokens_out) == r.max_new for r in got["requests"])
    ties = 0
    for mine, ref in zip(got["requests"], reqs):
        if mine.tokens_out != ref.tokens_out:
            ties += 1
            _assert_near_tie(got["cfg"], got["params"], mine, ref.tokens_out)
    assert ties <= 2, f"{ties} of 10 requests part at a near tie"


def _assert_near_tie(cfg, params, mine, ref_tokens):
    """Where two bf16 engines' greedy tokens part, the two tokens' float32
    logits (the port's model in float32 on the same parameters, over the
    prompt and the tokens both chose) lie within ``NEAR_TIE`` of each other:
    the engines' bf16 roundings may order them either way."""
    from repro_torch.models.model import Model

    i = next(i for i, (a, b) in enumerate(zip(mine.tokens_out, ref_tokens)) if a != b)
    seq = list(mine.prompt) + mine.tokens_out[:i]
    f32 = _tree_map(lambda t: t.float(), params)
    model = Model(cfg.with_(param_dtype="float32", compute_dtype="float32"))
    logits = model.prefill(f32, {"tokens": torch.tensor([seq])}, len(seq))[0][0]
    a, b = float(logits[mine.tokens_out[i]]), float(logits[ref_tokens[i]])
    assert abs(a - b) < NEAR_TIE, (mine.rid, i, a, b)
    assert max(a, b) >= float(logits.max()) - NEAR_TIE


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _to_jax(tree):
    """The reference's parameter tree from the port's, bit for bit."""
    import jax.numpy as jnp
    import ml_dtypes

    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if tree.dtype == torch.bfloat16:
        return jnp.asarray(tree.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
    return jnp.asarray(tree.numpy())


def _losses(text: str):
    return [float(m) for m in re.findall(r"^step +\d+ loss +([-\d.]+)", text, re.M)]


def test_train_e2e_losses_match_the_reference_from_one_start(tmp_path):
    """Both trainers restore the reference's step-0 checkpoint (its
    initialisation) and run 20 steps of the default batch: every logged loss
    agrees with the reference's printed one, the first at ``LOSS_RTOL``
    (the same parameters and batch), all at ``BF16_LOSS_RTOL``."""
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    _reference("train_e2e", "--steps", "0", "--ckpt-dir", str(ref_dir))
    shutil.copytree(ref_dir, port_dir)
    args = ["--steps", "20", "--resume", "--log-every", "1"]
    want = _losses(_reference("train_e2e", *args, "--ckpt-dir", str(ref_dir)))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # a step of TINY is too small to split
    try:
        got = _port("train_e2e").main(args + ["--ckpt-dir", str(port_dir), "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    losses = [loss for _, loss in got["losses"]]
    assert got["resumed_from"] == 0 and len(losses) == len(want) == 20
    # the reference prints 4 decimals: half a unit of the last is the print's own error
    np.testing.assert_allclose(losses[0], want[0], rtol=LOSS_RTOL, atol=5e-5)
    np.testing.assert_allclose(losses, want, rtol=BF16_LOSS_RTOL, atol=5e-5)
    assert (port_dir / "step_000000020").exists()


@pytest.mark.parametrize("script", ALL_SCRIPTS)
def test_defaults_raise_without_a_card(script, tmp_path, monkeypatch):
    """No fallback: each example's defaults (the ``cuda`` backend, the
    ``cuda`` device) raise on a machine without a card, before a
    checkpoint is written."""
    from repro_torch.kernels import ts_plan

    if torch.cuda.device_count():
        pytest.skip("a card is present: the defaults are usable")
    mod = _port(script)
    if script == "train_e2e":
        ckpt = tmp_path / "ck"
        monkeypatch.setattr(mod, "ARGV", [a if a != mod.ARGV[-1] else str(ckpt)
                                          for a in mod.ARGV])
    prev = ts_plan.get_backend()
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main([])
    finally:
        ts_plan.set_backend(prev)
    if script == "train_e2e":
        assert not ckpt.exists()


def test_examples_import_neither_jax_nor_the_reference():
    code = ("import sys; sys.path.insert(0, 'examples'); "
            + "; ".join(f"import {s}_torch" for s in ALL_SCRIPTS)
            + "; bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]; "
              "assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
