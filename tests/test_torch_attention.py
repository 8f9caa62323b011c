"""The port's attention against the JAX package's, on the CPU.

Configs: ``repro_torch.configs.get_config`` equals the reference's for every
arch.  Kernels: the plain versions of K2 (flash attention) and K3 (flash
decode), which the port's wrappers run on CPU tensors, against the
reference's Pallas kernels in interpret mode and against its ``ref``
oracles, on the reference's own ``FLASH_CASES`` and ``DECODE_CASES``
(``tests/test_kernels.py``) with its tolerances: 2e-5 in float32, 2e-2 in
bfloat16.  Inputs are made with numpy from a seed and handed to both.
The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES
from repro.configs import get_config as ref_get_config
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.models import attention as ref_attention
from repro.models.model import Model as RefModel
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import (_build, decode_attention, flash_attention, mamba_scan, ops, ref,
                                 ts_plan_device)
from repro_torch.models import attention

FLASH_CASES = [
    # (B, S, nq, nkv, hd, dtype) — tests/test_kernels.py
    (2, 256, 4, 2, 64, "float32"),
    (1, 128, 8, 8, 128, "float32"),
    (2, 256, 6, 2, 64, "bfloat16"),
    (1, 512, 4, 4, 128, "bfloat16"),
    (1, 128, 14, 2, 64, "float32"),
]
DECODE_CASES = [
    # (B, S, nq, nkv, hd, pos) — tests/test_kernels.py
    (2, 512, 4, 2, 64, 137),
    (1, 1024, 8, 8, 128, 1023),
    (2, 256, 6, 2, 64, 0),
    (1, 512, 16, 16, 64, 300),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, shapes, dtype):
    """numpy normals, rounded to ``dtype`` once, as (jax, torch) pairs."""
    rng = np.random.default_rng(seed)
    out = []
    for shp in shapes:
        x = jnp.asarray(rng.standard_normal(shp).astype(np.float32), dtype)
        out.append((x, torch.from_numpy(np.array(x.astype(jnp.float32))).to(getattr(torch, dtype))))
    return out


def _f32(x):
    return np.asarray(x.float().numpy() if torch.is_tensor(x) else jnp.asarray(x, jnp.float32))


# -- configs ---------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_config_matches_reference(arch, smoke):
    cfg, ref_cfg = get_config(arch, smoke=smoke), ref_get_config(arch, smoke=smoke)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert cfg.param_count() == ref_cfg.param_count()
    if cfg.n_heads:
        assert cfg.resolved_head_dim == ref_cfg.resolved_head_dim


# -- K2: flash attention ------------------------------------------------------------


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_attention_plain_matches_reference(case):
    b, s, nq, nkv, hd, dtype = case
    (jq, tq), (jk, tk), (jv, tv) = _inputs(
        sum(case[:5]), [(b, s, nq, hd), (b, s, nkv, hd), (b, s, nkv, hd)], dtype
    )
    launches = flash_attention.stats["launches"]
    got = ops.flash_attention(tq, tk, tv, causal=True)
    assert flash_attention.stats["launches"] == launches  # CPU: the plain version
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = ref_ops.flash_attention(jq, jk, jv, causal=True, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype])
    oracle = jnp.swapaxes(ref_ref.attention_ref(
        jnp.swapaxes(jq, 1, 2), jnp.swapaxes(jk, 1, 2), jnp.swapaxes(jv, 1, 2), causal=True
    ), 1, 2)
    np.testing.assert_allclose(_f32(got), _f32(oracle), atol=TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_matches_reference_oracle(causal):
    (jq, tq), (jk, tk), (jv, tv) = _inputs(3, [(2, 6, 40, 64), (2, 2, 40, 64), (2, 2, 40, 64)],
                                           "float32")
    got = ref.attention_ref(tq, tk, tv, causal=causal)
    want = ref_ref.attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5)


@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_flash_decode_plain_matches_reference(case):
    b, s, nq, nkv, hd, pos = case
    (jq, tq), (jk, tk), (jv, tv) = _inputs(
        sum(case), [(b, 1, nq, hd), (b, s, nkv, hd), (b, s, nkv, hd)], "float32"
    )
    launches = decode_attention.stats["launches"]
    got = ops.flash_decode(tq, tk, tv, pos)
    assert decode_attention.stats["launches"] == launches
    want = ref_ops.flash_decode(jq, jk, jv, jnp.int32(pos), interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5)
    oracle = jnp.swapaxes(ref_ref.decode_ref(
        jnp.swapaxes(jq, 1, 2), jnp.swapaxes(jk, 1, 2), jnp.swapaxes(jv, 1, 2), jnp.int32(pos)
    ), 1, 2)
    np.testing.assert_allclose(_f32(got), _f32(oracle), atol=2e-5)


@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_flash_decode_plain_bf16_matches_reference_oracle(case):
    b, s, nq, nkv, hd, pos = case
    (jq, tq), (jk, tk), (jv, tv) = _inputs(
        sum(case) + 1, [(b, 1, nq, hd), (b, s, nkv, hd), (b, s, nkv, hd)], "bfloat16"
    )
    got = ops.flash_decode(tq, tk, tv, pos)
    assert got.dtype == torch.bfloat16
    oracle = jnp.swapaxes(ref_ref.decode_ref(
        jnp.swapaxes(jq, 1, 2), jnp.swapaxes(jk, 1, 2), jnp.swapaxes(jv, 1, 2), jnp.int32(pos)
    ), 1, 2)
    np.testing.assert_allclose(_f32(got), _f32(oracle), atol=2e-2)


def test_flash_decode_masks_stale_cache():
    """Entries beyond ``pos`` must not leak — poison them with huge values."""
    b, s, nq, nkv, hd, pos = 1, 256, 4, 4, 64, 63
    (_, q), (_, k), (_, v) = _inputs(5, [(b, 1, nq, hd), (b, s, nkv, hd), (b, s, nkv, hd)],
                                     "float32")
    v[:, pos + 1:] = 1e6
    k[:, pos + 1:] = 3.0
    assert float(ops.flash_decode(q, k, v, pos).abs().max()) < 1e3


CONTRACT = [
    # (q shape, k shape, kwargs): all violate the reference's asserts
    ((1, 128, 6, 64), (1, 128, 4, 64), {}),                 # nq % nkv
    ((1, 192, 4, 64), (1, 192, 2, 64), {}),                 # S % block_q (128)
    ((1, 256, 4, 64), (1, 256, 2, 64), {"block_k": 96}),    # S % block_k
]


@pytest.mark.parametrize("qs,ks,kw", CONTRACT, ids=str)
def test_flash_attention_shape_contract_raises_on_both(qs, ks, kw):
    (jq, tq), (jk, tk) = _inputs(0, [qs, ks], "float32")
    with pytest.raises(AssertionError):
        ref_ops.flash_attention(jq, jk, jk, causal=True, interpret=True, **kw)
    with pytest.raises(ValueError):
        ops.flash_attention(tq, tk, tk, causal=True, **kw)


def test_flash_attention_shape_contract_accepts_short_sequences():
    """S below the block size is one block on both packages."""
    (jq, tq), (jk, tk) = _inputs(1, [(1, 32, 4, 64), (1, 32, 2, 64)], "float32")
    want = ref_ops.flash_attention(jq, jk, jk, causal=True, interpret=True)
    np.testing.assert_allclose(_f32(ops.flash_attention(tq, tk, tk)), _f32(want), atol=2e-5)


def test_flash_decode_shape_contract_raises_on_both():
    (jq, tq), (jk, tk) = _inputs(2, [(1, 1, 4, 64), (1, 768, 2, 64)], "float32")
    with pytest.raises(AssertionError):
        ref_ops.flash_decode(jq, jk, jk, jnp.int32(5), interpret=True)
    with pytest.raises(ValueError):
        ops.flash_decode(tq, tk, tk, 5)


@pytest.mark.parametrize("fn", ["attention", "decode"])
def test_wrappers_refuse_devices_other_than_cpu_and_cuda(fn):
    """A tensor neither on the CPU nor on a card is refused, not sent to
    the plain version."""
    q = torch.empty((1, 4, 1, 64), device="meta")
    k = torch.empty((1, 2, 128, 64), device="meta")
    with pytest.raises(ValueError, match="only CPU"):
        if fn == "attention":
            flash_attention.flash_attention_bhsd(q.expand(1, 4, 128, 64), k, k)
        else:
            decode_attention.flash_decode_bhsd(q, k, k, 3)


def test_mamba_scan_computes_the_reference_function():
    """``ops.mamba_scan`` (K4's wrapper, its plain version on the CPU) is
    the reference's selective scan on the reference's first ``MAMBA_CASES``
    shape; ``tests/test_torch_ssm.py`` covers the rest."""
    b, s, d_in, n = 2, 256, 128, 8
    rng = np.random.default_rng(12)
    x = rng.standard_normal((b, s, d_in)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, d_in)))).astype(np.float32)
    a = -np.exp(0.5 * rng.standard_normal((d_in, n))).astype(np.float32)
    bm, cm = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    args = (x, dt, a, bm, cm)
    got = ops.mamba_scan(*(torch.from_numpy(v) for v in args))
    want = ref_ops.mamba_scan(*(jnp.asarray(v) for v in args), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_kernel_sources_registered_one_library_each():
    for name, fns in (("ts_plan", {"ts_plan_window", "ts_plan_columns", "ts_plan_dense"}),
                      ("flash_attention", {"flash_attention_fwd"}),
                      ("decode_attention", {"flash_decode_fwd"}),
                      ("mamba_scan", {"mamba_scan_fwd"})):
        sigs, _stats = _build._SOURCES[name]
        assert set(sigs) == fns
        assert (_build.CSRC / f"{name}.cu").is_file()
        assert _build._library_path(name).name.startswith(f"lib{name}.")
    assert "--fmad=false" in _build.NVCC_FLAGS  # K1's exactness
    assert _build._SOURCES["ts_plan"][1] is ts_plan_device.stats
    assert mamba_scan.stats["launches"] == 0  # no card here: never launched
    with pytest.raises(KeyError):
        _build.build(["no_such_source"])


def test_library_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _build.library("flash_attention")


# -- model attention --------------------------------------------------------------------


def _layer0(arch, dtype, impl):
    cfg = get_config(arch, smoke=True).with_(param_dtype=dtype, compute_dtype=dtype,
                                              attn_impl=impl)
    ref_cfg = ref_get_config(arch, smoke=True).with_(param_dtype=dtype, compute_dtype=dtype,
                                                      attn_impl=impl)
    jp = RefModel(ref_cfg).init(jax.random.PRNGKey(1))["stack"]["attn"]
    jp = jax.tree_util.tree_map(lambda a: a[0], jp)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return cfg, ref_cfg, jp, tp


def _rope_pair(s, cfg, start=0):
    from repro.models.layers import rope_tables as ref_rope
    from repro_torch.models.layers import rope_tables

    pos = np.arange(start, start + s)
    return (ref_rope(jnp.asarray(pos), cfg.resolved_head_dim, cfg.rope_theta),
            rope_tables(torch.as_tensor(pos), cfg.resolved_head_dim, cfg.rope_theta))


@pytest.mark.parametrize("chunk", [0, 16])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch,dtype", [("mistral-nemo-12b", "float32"),
                                        ("qwen3-32b", "float32"),
                                        ("mistral-nemo-12b", "bfloat16")])
def test_full_attention_matches_reference(arch, dtype, impl, chunk):
    cfg, ref_cfg, jp, tp = _layer0(arch, dtype, impl)
    cfg, ref_cfg = cfg.with_(attn_chunk=chunk), ref_cfg.with_(attn_chunk=chunk)
    ((jx, tx),) = _inputs(7, [(2, 64, cfg.d_model)], dtype)
    jrope, trope = _rope_pair(64, cfg)
    jy, (jk, jv) = ref_attention.full_attention(jp, jx, ref_cfg, jrope)
    ty, (tk, tv) = attention.full_attention(tp, tx, cfg, trope)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for got, want in ((ty, jy), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol)


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "qwen3-32b", "starcoder2-3b"])
def test_decode_attention_matches_reference(arch):
    cfg, ref_cfg, jp, tp = _layer0(arch, "float32", "xla")
    s_max, pos = 48, 21
    (jx, tx), (jkc, tkc), (jvc, tvc) = _inputs(
        9, [(2, 1, cfg.d_model), (2, s_max, cfg.n_kv_heads, cfg.resolved_head_dim),
            (2, s_max, cfg.n_kv_heads, cfg.resolved_head_dim)], "float32")
    jrope, trope = _rope_pair(1, cfg, start=pos)
    jy, jk2, jv2 = ref_attention.decode_attention(jp, jx, ref_cfg, jrope, jkc, jvc, jnp.int32(pos))
    ty, tk2, tv2 = attention.decode_attention(tp, tx, cfg, trope, tkc, tvc, pos)
    assert tk2 is tkc and tv2 is tvc  # written in place
    np.testing.assert_allclose(_f32(ty), _f32(jy), atol=1e-5)
    np.testing.assert_allclose(_f32(tk2), _f32(jk2), atol=1e-5)
    np.testing.assert_allclose(_f32(tv2), _f32(jv2), atol=1e-5)


def test_cross_attention_matches_reference():
    cfg, ref_cfg, jp, tp = _layer0("mistral-nemo-12b", "float32", "xla")
    (jx, tx), (je, te) = _inputs(11, [(2, 8, cfg.d_model), (2, 24, cfg.d_model)], "float32")
    jk, jv = ref_attention.cross_kv(jp, je)
    tk, tv = attention.cross_kv(tp, te)
    np.testing.assert_allclose(_f32(tk), _f32(jk), atol=1e-5)
    want = ref_attention.cross_attention(jp, jx, jk, jv, ref_cfg)
    np.testing.assert_allclose(_f32(attention.cross_attention(tp, tx, tk, tv, cfg)),
                               _f32(want), atol=1e-5)
