"""The port's models against the JAX package's, on the CPU.

Parameters: the declaration (shapes, logical axes, counts), seeded
initialisation, conversion from the reference's tree, caches.  Forward:
``Model.prefill`` and ``Model.decode`` logits and caches against the JAX
``Model`` on the same parameters (converted with ``params_from_jax``) for
the dense smoke configs, the VLM, the MoE, hybrid and encoder-decoder
families, with both attention paths: float32 at 1e-5, bfloat16 at 2e-2
(one bfloat16 rounding of the logits is 4e-3 at their size here; the two
frameworks round intermediate bfloat16 products at different places).
``Model.loss`` and its gradient for an MoE and the hybrid config against
``jax.grad``, float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import count_params as ref_count_params
from repro.models.model import Model as RefModel
from repro_torch.configs import get_config
from repro_torch.models import count_params
from repro_torch.models.model import Model
from repro_torch.models.params import flatten, unflatten
from test_torch_serve import NEW_FAMILIES, TOL, _configs, _f32, _pair

DENSE = ["mistral-nemo-12b", "qwen3-32b", "starcoder2-3b", "tiny"]


# -- parameters --------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "qwen3-32b", "starcoder2-3b",
                                  "internvl2-1b", "falcon-mamba-7b"] + NEW_FAMILIES)
def test_declaration_matches_reference(arch):
    cfg, ref_cfg = _configs(arch)
    model, ref_model = Model(cfg), RefModel(ref_cfg)
    ref_abs = jax.tree_util.tree_map(lambda a: tuple(a.shape), ref_model.abstract())
    port_abs = jax.tree_util.tree_map(lambda t: tuple(t.shape), model.abstract())
    assert port_abs == ref_abs
    assert all(t.device.type == "meta" for t in jax.tree_util.tree_leaves(model.abstract()))
    assert model.axes() == ref_model.axes()
    assert count_params(model.defs()) == ref_count_params(ref_model.defs())


def test_init_is_seeded_and_follows_the_declaration():
    cfg = get_config("mistral-nemo-12b", smoke=True).with_(param_dtype="float32")
    model = Model(cfg)
    a = model.init(torch.Generator().manual_seed(3), "cpu")
    b = model.init(torch.Generator().manual_seed(3), "cpu")
    c = model.init(torch.Generator().manual_seed(4), "cpu")
    leaves = lambda t: jax.tree_util.tree_leaves(t)  # noqa: E731
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    assert not torch.equal(a["embed"], c["embed"])
    assert torch.equal(a["ln_f"], torch.ones(cfg.d_model))
    assert abs(float(a["embed"].std()) - 0.02) < 2e-3
    assert a["stack"]["mlp"]["w_gate"].shape == (cfg.n_layers, cfg.d_model, cfg.d_ff)


def test_init_slices_large_leaves(monkeypatch):
    """A leaf bigger than the slice budget is drawn slice by slice and
    comes out whole, finite and in the parameter dtype."""
    from repro_torch.models import params

    monkeypatch.setattr(params, "_SLICE_ELEMS", 100)
    cfg = get_config("mistral-nemo-12b", smoke=True)
    p = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    w = p["stack"]["mlp"]["w_gate"]
    assert w.dtype == torch.bfloat16 and bool(torch.isfinite(w.float()).all())
    assert float(w.float().std()) > 0.015


def test_params_from_jax_keeps_bf16_bits():
    _, tp, _, jp = _pair("mistral-nemo-12b", "bfloat16")
    for t, j in zip(jax.tree_util.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        assert t.dtype == torch.bfloat16
        assert np.array_equal(t.view(torch.int16).numpy(), np.asarray(j).view(np.int16))


def test_init_caches_match_reference():
    _init_caches_match("qwen3-32b", {("k",), ("v",)})


@pytest.mark.parametrize("arch,keys", [
    ("jamba-v0.1-52b", {(f"slot{s}", n) for s in range(8)
                        for n in (("k", "v") if s == 4 else ("conv", "h"))}),
    ("whisper-base", {("k",), ("v",), ("ek",), ("ev",)}),
], ids=["jamba-v0.1-52b", "whisper-base"])
def test_init_caches_match_reference_nested(arch, keys):
    _init_caches_match(arch, keys)


def _init_caches_match(arch, keys):
    cfg, ref_cfg = _configs(arch)
    got = dict(flatten(Model(cfg).init_caches(3, 40, "cpu")))
    want = dict(flatten(RefModel(ref_cfg).init_caches(3, 40)))
    assert set(got) == set(want) == keys
    for name in got:
        assert tuple(got[name].shape) == want[name].shape
        assert str(got[name].dtype).split(".")[-1] == str(want[name].dtype)
        assert not bool(got[name].any())


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "mistral-nemo-12b"] + NEW_FAMILIES)
def test_declaration_matches_reference_at_full_size(arch):
    """The full-size declaration (shapes, logical axes, parameter count)
    equals the reference's, on the meta device and through the reference's
    abstract shapes: nothing is allocated."""
    from repro.configs import get_config as ref_get_config

    model, ref_model = Model(get_config(arch)), RefModel(ref_get_config(arch))
    ref_abs = jax.tree_util.tree_map(lambda a: tuple(a.shape), ref_model.abstract())
    port_abs = jax.tree_util.tree_map(lambda t: tuple(t.shape), model.abstract())
    assert port_abs == ref_abs
    assert model.axes() == ref_model.axes()
    assert count_params(model.defs()) == ref_count_params(ref_model.defs())


# -- model forward -------------------------------------------------------------------


def _batches(cfg, rng, b=2, s=32):
    toks = rng.integers(2, cfg.vocab_size, size=(b, s)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(toks).long()}
    if cfg.family == "vlm":
        vis = rng.standard_normal((b, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
        jb["vision_embeds"], tb["vision_embeds"] = jnp.asarray(vis), torch.as_tensor(vis)
    if cfg.family == "encdec":
        fr = rng.standard_normal((b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        jb["frames"], tb["frames"] = jnp.asarray(fr), torch.as_tensor(fr)
    return jb, tb


def _assert_caches_close(got, want, atol, rows=slice(None)):
    """Every cache leaf's shape, and its batch ``rows`` (axis 1) at ``atol``."""
    got, want = dict(flatten(got)), dict(flatten(want))
    assert set(got) == set(want)
    for path in got:
        assert tuple(got[path].shape) == want[path].shape, path
        np.testing.assert_allclose(_f32(got[path])[:, rows], _f32(want[path])[:, rows],
                                   atol=atol, err_msg=str(path))


#: Two router probabilities closer than this (relative) are a tie within
#: the bfloat16 rounding of the router's input: one bf16 ulp of the hidden
#: state moves a router logit of the smoke configs' size (|l| < 1) by up
#: to about 2**-8, and a probability relatively by as much.
NEAR_TIE = 2.0 ** -7


@pytest.fixture
def routing(monkeypatch):
    """Every MoE call's (probs, expert ids), in call order, from each
    package: the port's through ``moe.recording()``, the reference's
    through a callback beside its gather dispatch (which runs inside
    ``lax.scan``)."""
    from repro.models import moe as ref_moe
    from repro_torch.models import moe

    ref = []
    gather = ref_moe._moe_block_gather

    def ref_gather(p, x, cfg):
        xt = x.reshape(-1, cfg.d_model)
        probs = jax.nn.softmax(
            jnp.einsum("td,de->te", xt, p["router"]).astype(jnp.float32), axis=-1)
        jax.debug.callback(lambda a, b: ref.append((np.asarray(a), np.asarray(b))),
                           probs, jax.lax.top_k(probs, cfg.top_k)[1], ordered=True)
        return gather(p, x, cfg)

    monkeypatch.setattr(ref_moe, "_moe_block_gather", ref_gather)
    with moe.recording() as port:
        yield port, ref


def _kept(gate_idx, cfg):
    """[T, k]: whether each (token, choice) entry of ``gate_idx`` is within
    capacity (the port's dispatch, which ``test_torch_moe`` holds to the
    reference's exactly)."""
    from repro_torch.models import moe

    t = gate_idx.shape[0]
    order, keep, _ = moe.dispatch(torch.as_tensor(gate_idx), cfg.n_experts,
                                  moe.capacity(cfg, t))
    kept = torch.zeros_like(keep)
    kept[order] = keep
    return kept.view(gate_idx.shape).numpy()


def _flip_rows(routing, cfg, batch, flipped):
    """Adds to the set ``flipped`` the batch rows whose routing differs
    between the packages in an MoE call since the last one: an expert id,
    or an entry kept in one package and dropped in the other (the batch
    shares the capacity).  A row's first differing choices must be near
    ties in the reference's probabilities (a bfloat16 rounding flipped
    them); after them the row carries other experts' outputs, and its later
    choices are not held to that.  Clears the records."""
    port, ref = routing
    assert len(port) == len(ref)
    for rec, (probs, want) in zip(port, ref):
        got = rec["gate_idx"].numpy()
        per_row = got.shape[0] // batch
        new = set()
        for t, j in zip(*np.nonzero(got != want)):
            if t // per_row not in flipped:
                a, b = probs[t, want[t, j]], probs[t, got[t, j]]
                assert abs(a - b) <= NEAR_TIE * max(a, b), (t, j, a, b)
            new.add(int(t // per_row))
        new.update(int(t // per_row)
                   for t in np.nonzero((_kept(got, cfg) != _kept(want, cfg)).any(-1))[0])
        flipped |= new
    port.clear()
    ref.clear()
    return flipped


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE + ["internvl2-1b"] + NEW_FAMILIES)
def test_prefill_and_decode_match_reference(arch, dtype, impl, routing):
    """Prefill, then two decode steps, logits and caches at ``TOL``.  MoE
    routing is discontinuous: in bfloat16 a near tie (``NEAR_TIE``) may
    flip between the packages, and moves the logits by their own size;
    float32 must route identically.  A batch row whose routing flipped is
    held to the near-tie rule instead, and its logits and caches are not
    compared from that step on (every later state of the row carries the
    other expert's output); the other row still is."""
    model, tp, ref_model, jp = _pair(arch, dtype, impl)
    cfg = model.cfg
    rng = np.random.default_rng(len(arch))
    jb, tb = _batches(cfg, rng)
    b, s_max, flipped = 2, 64, set()

    def compare(tl, jl, tc, jc):
        _flip_rows(routing, cfg, b, flipped)
        assert dtype == "bfloat16" or not flipped
        rows = [r for r in range(b) if r not in flipped]
        np.testing.assert_allclose(_f32(tl)[rows], _f32(jl)[rows], atol=TOL[dtype])
        _assert_caches_close(tc, jc, TOL[dtype], rows)

    jl, jc = ref_model.prefill(jp, jb, s_max)
    with torch.no_grad():
        tl, tc = model.prefill(tp, tb, s_max)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    compare(tl, jl, tc, jc)
    pos = 32 + (cfg.n_vision_tokens if cfg.family == "vlm" else 0)
    for step in range(2):
        tok = rng.integers(2, cfg.vocab_size, size=(b, 1)).astype(np.int32)
        jl, jc = ref_model.decode(jp, jnp.asarray(tok), jnp.int32(pos + step), jc)
        with torch.no_grad():
            tl, tc = model.decode(tp, torch.as_tensor(tok).long(), pos + step, tc)
        if cfg.family == "encdec":          # the reference keeps [B, 1, V]
            jl = jl[:, 0]
        assert tuple(tl.shape) == jl.shape
        compare(tl, jl, tc, jc)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "jamba-v0.1-52b"])
def test_loss_and_gradient_match_reference(arch):
    """ce, aux and the total, and every parameter's gradient, against
    ``jax.grad`` of the reference's loss, float32; with ``remat`` (one
    layer, or one hybrid period, checkpointed) the same gradients."""
    from test_torch_train import _assert_tree_close

    model, tp, ref_model, jp = _pair(arch)
    jb, tb = _batches(model.cfg, np.random.default_rng(8), b=2, s=24)
    (jl, jm), jg = jax.value_and_grad(lambda p: ref_model.loss(p, jb), has_aux=True)(jp)
    assert float(jm["aux"]) > 0
    paths = [p for p, _ in flatten(tp)]
    grads = {}
    for remat in (False, True):
        m = Model(model.cfg.with_(remat=remat))
        leaves = [t.detach().requires_grad_(True) for _, t in flatten(tp)]
        tl, tm = m.loss(unflatten(paths, leaves), tb)
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
        for key in ("ce", "aux"):
            np.testing.assert_allclose(float(tm[key].detach()), float(jm[key]), rtol=1e-5)
        grads[remat] = torch.autograd.grad(tl, leaves, allow_unused=True,
                                           materialize_grads=True)
        _assert_tree_close(unflatten(paths, grads[remat]), jg)
    for a, b in zip(grads[False], grads[True], strict=True):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=1e-9)


# -- layers ------------------------------------------------------------------------


def test_layer_primitives_match_reference():
    from repro.models import layers as ref_layers
    from repro_torch.models import layers

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    pos = np.arange(5, 14)
    np.testing.assert_allclose(
        layers.rms_norm(torch.as_tensor(x), torch.as_tensor(w), 1e-6).numpy(),
        np.asarray(ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)), atol=1e-6)
    cos, sin = layers.rope_tables(torch.as_tensor(pos), 16, 1e6)
    rcos, rsin = ref_layers.rope_tables(jnp.asarray(pos), 16, 1e6)
    np.testing.assert_allclose(cos.numpy(), np.asarray(rcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(rsin), atol=1e-6)
    np.testing.assert_allclose(
        layers.apply_rope(torch.as_tensor(x), cos, sin).numpy(),
        np.asarray(ref_layers.apply_rope(jnp.asarray(x), rcos, rsin)), atol=1e-6)
    np.testing.assert_allclose(
        layers.sinusoidal_positions(torch.as_tensor(pos), 12).numpy(),
        np.asarray(ref_layers.sinusoidal_positions(jnp.asarray(pos), 12)), atol=1e-6)


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "starcoder2-3b"])
def test_mlp_block_matches_reference(arch):
    from repro.models import layers as ref_layers
    from repro_torch.models import layers

    model, tp, ref_model, jp = _pair(arch)
    mlp_t = {k: v[0] for k, v in tp["stack"]["mlp"].items()}
    mlp_j = {k: v[0] for k, v in jp["stack"]["mlp"].items()}
    x = np.random.default_rng(6).standard_normal((2, 5, model.cfg.d_model)).astype(np.float32)
    got = layers.mlp_block(mlp_t, torch.as_tensor(x), model.cfg)
    want = ref_layers.mlp_block(mlp_j, jnp.asarray(x), ref_model.cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
