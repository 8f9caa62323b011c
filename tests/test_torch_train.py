"""The port's training path against the JAX package's, on the CPU.

``Model.loss`` (falcon-mamba-7b smoke on both scan paths, a dense and a
VLM smoke config, with and without ``loss_mask``), the LR schedules,
``global_norm``, AdamW's update, and ``make_train_step`` — one step of the
port against one step of the reference's ``jax.jit(make_train_step(...))``
on the same parameters (``params_from_jax``) and batch, in float32.  Loss
and grad norm at rtol 1e-5; the moments m and v at rtol 1e-4 over an
absolute floor of 1e-5 of the leaf's largest value (an element whose
gradient is noise-sized carries the two frameworks' different reduction
orders at full relative size).  Parameters after a step: see
:func:`_assert_params_close`.  Also: microbatch accumulation equals one
batch, remat gives the reference's gradients, the eval / prefill /
decode steps, and a train step through K4 raises, as in the reference.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as ref_steps
from repro.optim import AdamW as RefAdamW
from repro.optim import constant as ref_constant
from repro.optim import global_norm as ref_global_norm
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro_torch.convert import params_from_jax
from repro_torch.launch import steps
from repro_torch.models.params import flatten, unflatten
from repro_torch.optim import AdamW, AdamWState, constant, global_norm, warmup_cosine
from test_torch_serve import _f32, _pair

LR = 1e-3


def _tokens(cfg, seed, b=4, s=24):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(toks).long()}
    if cfg.family == "vlm":
        vis = rng.standard_normal((b, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
        jb["vision_embeds"], tb["vision_embeds"] = jnp.asarray(vis), torch.as_tensor(vis)
    return jb, tb


def _with_mask(jb, tb, seed):
    m = (np.random.default_rng(seed).random(tb["tokens"].shape) < 0.6).astype(np.int32)
    return dict(jb, loss_mask=jnp.asarray(m)), dict(tb, loss_mask=torch.as_tensor(m))


def _np_leaves(tree):
    """float32 numpy leaves of a port or reference tree, in sorted-key order
    (the order ``jax.tree_util`` flattens a dict in)."""
    return [np.asarray(x.detach().float() if torch.is_tensor(x) else x, np.float32)
            for _, x in flatten(tree)]


def _assert_tree_close(got, want, rtol=1e-4, floor=1e-5):
    for g, w in zip(_np_leaves(got), _np_leaves(want), strict=True):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol, atol=floor * float(np.abs(w).max()))


def _assert_params_close(new, ref_new, old, ref_m, lr):
    """One AdamW step moves each element by lr·(m̂/(√v̂+eps) + wd·p), and at
    step 1 m̂/(√v̂+eps) = g/(|g|+eps) ≈ sign(g): an element whose reference
    gradient is noise-sized (|g| ≤ 1e-6, so |g|/eps is not large) may move
    by anything in [-lr, lr] in either framework.  There the two may differ
    by up to 2·lr; everywhere else they agree at rtol 1e-5."""
    for n, r, o, m in zip(_np_leaves(new), _np_leaves(ref_new), _np_leaves(old),
                          _np_leaves(ref_m), strict=True):
        g = m / 0.1                       # m = (1 - b1)·g after one step from zero
        big = np.abs(g) > 1e-6
        np.testing.assert_allclose(n[big], r[big], rtol=1e-5, atol=1e-7)
        assert np.all(np.abs(n[~big] - r[~big]) <= 2 * lr * (1 + 1e-3))
        assert np.all(np.abs(n - o) <= lr * (1 + 0.1 * np.abs(o)) * (1 + 1e-3))


# -- loss ------------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arch,impl", [("falcon-mamba-7b", "xla"), ("falcon-mamba-7b", "pallas"),
                                       ("mistral-nemo-12b", "xla"), ("internvl2-1b", "xla")])
def test_loss_matches_reference(arch, impl, masked):
    model, tp, ref_model, jp = _pair(arch)
    model = type(model)(model.cfg.with_(ssm_impl=impl))
    ref_model = type(ref_model)(ref_model.cfg.with_(ssm_impl=impl))
    jb, tb = _tokens(model.cfg, 1)
    if masked:
        jb, tb = _with_mask(jb, tb, 2)
    jl, jm = ref_model.loss(jp, jb)
    tl, tm = model.loss(tp, tb)
    assert tl.dtype == torch.float32 and tl.dim() == 0
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), rtol=1e-5)
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0


def test_eval_step_matches_reference():
    model, tp, ref_model, jp = _pair("falcon-mamba-7b")
    jb, tb = _tokens(model.cfg, 3)
    want = ref_steps.make_eval_step(ref_model)(jp, jb)
    got = steps.make_eval_step(model)(tp, tb)
    assert set(got) == set(want) == {"ce", "aux", "loss"}
    assert got["loss"].grad_fn is None
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)


def test_prefill_and_decode_steps_match_reference():
    model, tp, ref_model, jp = _pair("falcon-mamba-7b")
    jb, tb = _tokens(model.cfg, 4, b=2, s=12)
    jl, jc = ref_steps.make_prefill_step(ref_model, 32)(jp, jb)
    tl, tc = steps.make_prefill_step(model, 32)(tp, tb)
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=1e-5)
    tok = np.array([[5], [7]], np.int32)
    jl, jc = ref_steps.make_decode_step(ref_model)(jp, jnp.asarray(tok), jnp.int32(12), jc)
    tl, tc = steps.make_decode_step(model)(tp, torch.as_tensor(tok).long(), 12, tc)
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=1e-5)
    np.testing.assert_allclose(_f32(tc["h"]), _f32(jc["h"]), atol=1e-5)


# -- optimizer ------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 50, 99, 100, 150])
def test_schedules_match_reference(step):
    got = warmup_cosine(3e-4, 10, 100)(torch.tensor(step, dtype=torch.int32))
    want = ref_warmup_cosine(3e-4, 10, 100)(jnp.int32(step))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(warmup_cosine(1e-2, 0, 20, floor=0.0)(step)),
                               float(ref_warmup_cosine(1e-2, 0, 20, floor=0.0)(jnp.int32(step))),
                               rtol=1e-6, atol=1e-12)
    assert float(constant(2e-4)(step)) == float(ref_constant(2e-4)(jnp.int32(step)))


def _random_tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 5)).astype(dtype),
            "b": {"c": rng.standard_normal(7).astype(dtype),
                  "d": rng.standard_normal((2, 2, 4)).astype(dtype)}}


def test_global_norm_matches_reference():
    tree = _random_tree(0)
    got = global_norm(params_from_jax(tree, device="cpu"))
    want = ref_global_norm(jax.tree_util.tree_map(jnp.asarray, tree))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("grad_scale", [0.1, 10.0])   # clip inactive / active
def test_adamw_update_matches_reference(grad_scale):
    """Three updates with the reference's defaults (b1 0.9, b2 0.95, eps
    1e-8, weight decay 0.1 on every leaf, clip 1.0) and a warmup-cosine
    schedule; the inputs are left as they were."""
    opt, ref_opt = AdamW(lr=warmup_cosine(1e-2, 2, 10)), RefAdamW(lr=ref_warmup_cosine(1e-2, 2, 10))
    assert (opt.b1, opt.b2, opt.eps, opt.weight_decay, opt.grad_clip) == (
        ref_opt.b1, ref_opt.b2, ref_opt.eps, ref_opt.weight_decay, ref_opt.grad_clip)
    params = _random_tree(1)
    tp, jp = params_from_jax(params, device="cpu"), jax.tree_util.tree_map(jnp.asarray, params)
    ts, js = opt.init(tp), ref_opt.init(jp)
    for k in range(3):
        grads = jax.tree_util.tree_map(lambda g: g * grad_scale, _random_tree(10 + k))
        tg = params_from_jax(grads, device="cpu")
        old_p, old_m = ([t.clone() for _, t in flatten(tree)] for tree in (tp, ts.m))
        tp2, ts2, tn = opt.update(tg, ts, tp)
        jp, js, jn = ref_opt.update(jax.tree_util.tree_map(jnp.asarray, grads), js, jp)
        for old, tree in ((old_p, tp), (old_m, ts.m)):
            assert all(torch.equal(a, t) for a, (_, t) in zip(old, flatten(tree), strict=True))
        tp, ts = tp2, ts2
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        assert int(ts.count) == int(js.count) == k + 1
        _assert_tree_close(ts.m, js.m)
        _assert_tree_close(ts.v, js.v)
        _assert_tree_close(tp, jp, rtol=1e-5, floor=1e-6)


# -- train step ------------------------------------------------------------------------


def _one_step(arch, accum=1, remat=False, seed=5, **kw):
    model, tp, ref_model, jp = _pair(arch)
    model = type(model)(model.cfg.with_(remat=remat, **kw))
    opt, ref_opt = AdamW(lr=constant(LR)), RefAdamW(lr=ref_constant(LR))
    jb, tb = _tokens(model.cfg, seed)
    out = steps.make_train_step(model, opt, accum=accum)(tp, opt.init(tp), tb)
    return out, (model, tp, ref_model, jp, ref_opt, jb)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "mistral-nemo-12b", "internvl2-1b"])
def test_train_step_matches_reference(arch):
    (tp2, ts, tm), (model, tp, ref_model, jp, ref_opt, jb) = _one_step(arch)
    jp2, js, jm = jax.jit(ref_steps.make_train_step(ref_model, ref_opt))(
        jp, ref_opt.init(jp), jb)
    assert set(tm) == {"loss", "grad_norm"}
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    assert int(ts.count) == int(js.count) == 1
    _assert_tree_close(ts.m, js.m)
    _assert_tree_close(ts.v, js.v)
    _assert_params_close(tp2, jp2, tp, js.m, LR)
    # no autograd state left on the caller's parameters
    assert all(t.grad is None and not t.requires_grad for _, t in flatten(tp))
    assert all(not t.requires_grad for _, t in flatten(tp2))


def test_accumulation_equals_one_batch():
    """accum=2 over the batch's two halves gives one batch's step, as the
    reference's ``tests/test_system.py`` checks for its own."""
    (p1, s1, m1), (_, tp, _, _, _, _) = _one_step("falcon-mamba-7b", accum=1)
    (p2, s2, m2), _ = _one_step("falcon-mamba-7b", accum=2)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]), rtol=1e-5)
    _assert_tree_close(s2.m, s1.m)
    _assert_params_close(p2, p1, tp, s1.m, LR)


def test_remat_gives_the_same_gradients():
    model, tp, _, _ = _pair("falcon-mamba-7b")
    _, tb = _tokens(model.cfg, 6)
    grads = {}
    for remat in (False, True):
        m = type(model)(model.cfg.with_(remat=remat))
        leaves = [t.detach().requires_grad_(True) for _, t in flatten(tp)]
        paths = [p for p, _ in flatten(tp)]
        loss, _ = m.loss(unflatten(paths, leaves), tb)
        grads[remat] = torch.autograd.grad(loss, leaves)
    for a, b in zip(grads[False], grads[True], strict=True):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=1e-9)


def test_train_step_through_k4_raises():
    """The reference cannot differentiate its Pallas scan (``jax.grad``
    fails in ``pallas_call``'s JVP rule), so a train step with
    ``ssm_impl="pallas"`` fails in both packages; the port's fails with
    the reason."""
    with pytest.raises(NotImplementedError, match="no backward"):
        _one_step("falcon-mamba-7b", ssm_impl="pallas")


def test_params_from_jax_defaults_to_the_card():
    from repro_torch.convert import params_from_jax as fn

    assert inspect.signature(fn).parameters["device"].default == "cuda"
    state = AdamW().init(params_from_jax(_random_tree(2), device="cpu"))
    assert isinstance(state, AdamWState) and state.count.dtype == torch.int32
