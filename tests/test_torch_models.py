"""The port's models against the JAX package's, on the CPU.

Parameters: the declaration (shapes, logical axes, counts), seeded
initialisation, conversion from the reference's tree, caches.  Forward:
``Model.prefill`` and ``Model.decode`` logits and caches against the JAX
``Model`` on the same parameters (converted with ``params_from_jax``) for
the dense smoke configs and the VLM, with both attention paths: float32 at
1e-5, bfloat16 at 2e-2 (one bfloat16 rounding of the logits is 4e-3 at
their size here; the two frameworks round intermediate bfloat16 products
at different places).
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
from test_torch_serve import TOL, _configs, _f32, _pair

DENSE = ["mistral-nemo-12b", "qwen3-32b", "starcoder2-3b", "tiny"]


# -- parameters --------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "qwen3-32b", "starcoder2-3b",
                                  "internvl2-1b", "falcon-mamba-7b"])
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
    cfg, ref_cfg = _configs("qwen3-32b")
    got = Model(cfg).init_caches(3, 40, "cpu")
    want = RefModel(ref_cfg).init_caches(3, 40)
    assert set(got) == set(want) == {"k", "v"}
    for name in got:
        assert tuple(got[name].shape) == want[name].shape
        assert str(got[name].dtype).split(".")[-1] == str(want[name].dtype)
        assert not bool(got[name].any())


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "mistral-nemo-12b"])
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


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "moonshot-v1-16b-a3b", "whisper-base"])
def test_later_families_name_their_roadmap_item(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(get_config(arch, smoke=True)).defs()


# -- model forward -------------------------------------------------------------------


def _batches(cfg, rng, b=2, s=32):
    toks = rng.integers(2, cfg.vocab_size, size=(b, s)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(toks).long()}
    if cfg.family == "vlm":
        vis = rng.standard_normal((b, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
        jb["vision_embeds"], tb["vision_embeds"] = jnp.asarray(vis), torch.as_tensor(vis)
    return jb, tb


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE + ["internvl2-1b"])
def test_prefill_and_decode_match_reference(arch, dtype, impl):
    model, tp, ref_model, jp = _pair(arch, dtype, impl)
    cfg = model.cfg
    rng = np.random.default_rng(len(arch))
    jb, tb = _batches(cfg, rng)
    s_max = 64
    jl, jc = ref_model.prefill(jp, jb, s_max)
    with torch.no_grad():
        tl, tc = model.prefill(tp, tb, s_max)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=TOL[dtype])
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == jc[name].shape
        np.testing.assert_allclose(_f32(tc[name]), _f32(jc[name]), atol=TOL[dtype])
    pos = 32 + (cfg.n_vision_tokens if cfg.family == "vlm" else 0)
    for step in range(2):
        tok = rng.integers(2, cfg.vocab_size, size=(2, 1)).astype(np.int32)
        jl, jc = ref_model.decode(jp, jnp.asarray(tok), jnp.int32(pos + step), jc)
        with torch.no_grad():
            tl, tc = model.decode(tp, torch.as_tensor(tok).long(), pos + step, tc)
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=TOL[dtype])


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
