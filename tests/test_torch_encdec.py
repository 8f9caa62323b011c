"""The port's encoder-decoder (whisper-base) against the JAX package's, on
the CPU: ``encode``, ``decode_full`` (logits through ``Model._head`` and
the collected states, with both attention paths for the decoder's causal
self-attention), ``decode_step`` threading its caches (its input from
``Model._embed``), and the cache declaration, on the
same parameters (converted with ``params_from_jax``), float32 at 1e-5 and
bfloat16 at the serve tests' tolerance.  The reference's decoder under
``attn_impl="pallas"`` runs its Pallas kernel in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as ref_ed
from repro_torch.kernels import flash_attention
from repro_torch.models import encdec as ed
from repro_torch.models.model import Model
from repro_torch.models.params import flatten
from test_torch_models import _assert_caches_close
from test_torch_serve import TOL, _f32, _pair

ARCH = "whisper-base"


def _inputs(cfg, rng, b=2, s=16, frames="float32"):
    toks = rng.integers(2, cfg.vocab_size, size=(b, s)).astype(np.int32)
    fr = rng.standard_normal((b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    tfr = torch.as_tensor(fr).to(getattr(torch, frames))
    jfr = jnp.asarray(fr, frames)
    return (torch.as_tensor(toks).long(), tfr), (jnp.asarray(toks), jfr)


@pytest.mark.parametrize("frames", ["float32", "bfloat16"])   # the engine's are bf16
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_reference(dtype, frames):
    model, tp, ref_model, jp = _pair(ARCH, dtype)
    (_, tfr), (_, jfr) = _inputs(model.cfg, np.random.default_rng(0), frames=frames)
    with torch.no_grad():
        got = ed.encode(tp, tfr, model.cfg)
    want = ref_ed.encode(jp, jfr, ref_model.cfg)
    assert str(got.dtype).split(".")[-1] == str(want.dtype) == dtype
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype])


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_full_and_states_match_reference(dtype, impl):
    model, tp, ref_model, jp = _pair(ARCH, dtype, impl)
    (ttok, tfr), (jtok, jfr) = _inputs(model.cfg, np.random.default_rng(1))
    enc_j = ref_ed.encode(jp, jfr, ref_model.cfg)
    enc_t = torch.from_numpy(np.array(_f32(enc_j))).to(getattr(torch, dtype))   # exact
    want, wst = ref_ed.decode_full(jp, jtok, enc_j, ref_model.cfg, collect_state=True)
    with torch.no_grad():
        x = model._embed(tp, ttok)
        out, gst = ed.decode_full(tp, x, enc_t, model.cfg, collect_state=True)
        bare, none = ed.decode_full(tp, x, enc_t, model.cfg)
        got = model._head(tp, out)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert none is None and torch.equal(bare, out)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype])
    assert {p for p, _ in flatten(gst)} == {("k",), ("v",), ("ek",), ("ev",)}
    _assert_caches_close(gst, wst, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_threads_the_caches_like_the_reference(dtype):
    """Prefill through ``Model`` (k/v padded to s_max, ek/ev left at
    enc_seq), then three ``decode_step``s: logits [B, 1, V] and every cache
    leaf, step by step; the port writes k/v in place."""
    model, tp, ref_model, jp = _pair(ARCH, dtype)
    cfg = model.cfg
    rng = np.random.default_rng(2)
    (ttok, tfr), (jtok, jfr) = _inputs(cfg, rng)
    s_max = 40
    jl, jc = ref_model.prefill(jp, {"tokens": jtok, "frames": jfr}, s_max)
    with torch.no_grad():
        tl, tc = model.prefill(tp, {"tokens": ttok, "frames": tfr}, s_max)
    assert tuple(tc["k"].shape) == (cfg.n_layers, 2, s_max, cfg.n_kv_heads, 16)
    assert tuple(tc["ek"].shape) == (cfg.n_layers, 2, cfg.enc_seq, cfg.n_kv_heads, 16)
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=TOL[dtype])
    _assert_caches_close(tc, jc, TOL[dtype])
    for step in range(3):
        tok = rng.integers(2, cfg.vocab_size, size=(2, 1)).astype(np.int32)
        jl, jc = ref_ed.decode_step(jp, jnp.asarray(tok), jnp.int32(16 + step), jc,
                                    ref_model.cfg)
        k_before = tc["k"]
        with torch.no_grad():
            x = model._embed(tp, torch.as_tensor(tok).long(), start=16 + step)
            out, tc2 = ed.decode_step(tp, x, 16 + step, tc, cfg)
            tl = model._head(tp, out)
        assert tc2 is tc and tc["k"] is k_before
        assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=TOL[dtype])
        _assert_caches_close(tc, jc, TOL[dtype])


def test_cache_declaration_matches_reference():
    from repro.models.model import Model as RefModel
    from test_torch_serve import _configs

    cfg, ref_cfg = _configs(ARCH)
    got = {p: (d.shape, d.axes) for p, d in flatten(Model(cfg).cache_defs(3, 24))}
    want = {p: (d.shape, d.axes) for p, d in flatten(RefModel(ref_cfg).cache_defs(3, 24))}
    assert got == want
    assert got[("ek",)][0] == (cfg.n_layers, 3, cfg.enc_seq, cfg.n_kv_heads,
                               cfg.resolved_head_dim)


def test_decoder_self_attention_takes_the_kernel_path_only_when_causal(monkeypatch):
    """Under ``attn_impl="pallas"`` the decoder's causal self-attention goes
    to the flash-attention wrapper (on CPU tensors, its plain version), one
    call per decoder layer; the bidirectional encoder never does."""
    from repro_torch.kernels import ops

    calls = []
    fa = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda q, k, v, causal=True, **kw: calls.append(q.shape) or
                        fa(q, k, v, causal=causal, **kw))
    model, tp, _, _ = _pair(ARCH, "float32", "pallas")
    (ttok, tfr), _ = _inputs(model.cfg, np.random.default_rng(3))
    launches = flash_attention.stats["launches"]
    with torch.no_grad():
        enc = ed.encode(tp, tfr, model.cfg)
        assert calls == []
        ed.decode_full(tp, model._embed(tp, ttok), enc, model.cfg)
    assert len(calls) == model.cfg.n_layers
    assert flash_attention.stats["launches"] == launches   # CPU: plain version
