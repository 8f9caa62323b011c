"""The port's MoE layer against the JAX package's, on the CPU.

``moe_block`` on the MoE smoke configs (both swiglu) and a gelu variant,
float32 at 1e-5 and bfloat16 at the serve tests' tolerance, with the
auxiliary loss at 1e-5; the routing (expert ids, kept entries, drops)
exactly, including a router whose experts tie exactly and a batch that
overflows the capacity; the combine bit for bit in bfloat16; the a2a
fallback without a mesh; and the drop-rate property of
``tests/test_system.py``.  The reference's routing steps are written out
here in JAX from ``repro/models/moe.py:70-96`` (its function does not
return them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import moe as ref_moe
from repro.models.params import init_params as ref_init_params
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import moe
from test_torch_serve import TOL, _f32

ARCHS = ["moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b"]
VARIANTS = [(a, "swiglu") for a in ARCHS] + [("phi3.5-moe-42b-a6.6b", "gelu")]


def _pair(arch, dtype="float32", mlp_kind=None, seed=0, **kw):
    """(port cfg, port params, reference cfg, reference params) of one MoE
    layer on the same parameters."""
    extra = dict(param_dtype=dtype, compute_dtype=dtype, **kw)
    if mlp_kind:
        extra["mlp_kind"] = mlp_kind
    cfg = get_config(arch, smoke=True).with_(**extra)
    ref_cfg = ref_get_config(arch, smoke=True).with_(**extra)
    jp = ref_init_params(ref_moe.moe_defs(ref_cfg), jax.random.PRNGKey(seed), jnp.dtype(dtype))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return cfg, tp, ref_cfg, jp


def _x(cfg, shape, seed=1, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal(shape + (cfg.d_model,)).astype(np.float32)
    return torch.as_tensor(x).to(getattr(torch, dtype)), jnp.asarray(x, dtype)


def _ref_routing(jp, x, cfg):
    """The reference's routing, ``moe.py:70-96``: (gate_idx [T,k], order,
    keep [T·k] in sorted order)."""
    xt = x.reshape(-1, cfg.d_model)
    logits = jnp.einsum("td,de->te", xt, jp["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, gate_idx = jax.lax.top_k(probs, cfg.top_k)
    cap = ref_moe.capacity(cfg, xt.shape[0])
    flat_e = gate_idx.reshape(-1)
    order = jnp.argsort(flat_e)
    sorted_e = flat_e[order]
    counts = jnp.bincount(flat_e, length=cfg.n_experts)
    starts = jnp.concatenate([jnp.zeros((1,), counts.dtype), jnp.cumsum(counts)[:-1]])
    pos = jnp.arange(flat_e.shape[0], dtype=jnp.int32) - starts[sorted_e].astype(jnp.int32)
    return np.asarray(gate_idx), np.asarray(order), np.asarray(pos < cap)


def _port_routing(tp, x, cfg):
    xt = x.reshape(-1, cfg.d_model)
    _, _, gate_idx = moe.route(tp, xt, cfg)
    order, keep, _ = moe.dispatch(gate_idx, cfg.n_experts, moe.capacity(cfg, xt.shape[0]))
    return gate_idx.numpy(), order.numpy(), keep.numpy()


def _check_block(cfg, tp, ref_cfg, jp, tx, jx, dtype):
    with torch.no_grad():
        y, aux = moe.moe_block(tp, tx, cfg)
    ry, raux = ref_moe.moe_block(jp, jx, ref_cfg)
    assert y.dtype == tx.dtype and tuple(y.shape) == ry.shape
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(_f32(y), _f32(ry), atol=TOL[dtype])
    np.testing.assert_allclose(float(aux), float(raux), atol=1e-5)
    got, want = _port_routing(tp, tx, cfg), _ref_routing(jp, jx, ref_cfg)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,mlp_kind", VARIANTS, ids=lambda v: str(v))
def test_moe_block_matches_reference(arch, mlp_kind, dtype):
    cfg, tp, ref_cfg, jp = _pair(arch, dtype, mlp_kind)
    tx, jx = _x(cfg, (3, 40), dtype=dtype)
    _check_block(cfg, tp, ref_cfg, jp, tx, jx, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_exact_tie_router_picks_the_lower_expert(arch, dtype):
    """Experts in pairs with identical router columns: every token's
    probabilities tie exactly in pairs, and the lower index wins."""
    cfg, tp, ref_cfg, jp = _pair(arch, dtype)
    e = cfg.n_experts
    r = np.array(jp["router"])
    r[:, 1::2] = r[:, 0::2]                    # expert 2i+1 ties with 2i
    jp = dict(jp, router=jnp.asarray(r))
    tp = dict(tp, router=params_from_jax(r, device="cpu"))
    tx, jx = _x(cfg, (2, 24), seed=2, dtype=dtype)
    gate_idx, _, _ = _check_block(cfg, tp, ref_cfg, jp, tx, jx, dtype)
    # k = 2: each token takes a tied pair, lower id first.
    assert np.array_equal(gate_idx[:, 1], gate_idx[:, 0] + 1)
    assert (gate_idx[:, 0] % 2 == 0).all() and gate_idx.max() < e


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_overflow_drops_like_the_reference(arch, dtype):
    """A capacity factor of 0.1: T·k is eight times E·C, so most entries
    drop, and the same ones in both packages."""
    cfg, tp, ref_cfg, jp = _pair(arch, dtype, capacity_factor=0.1)
    tx, jx = _x(cfg, (4, 64), seed=3, dtype=dtype)
    gate_idx, _, keep = _check_block(cfg, tp, ref_cfg, jp, tx, jx, dtype)
    t, k = gate_idx.shape
    slots = cfg.n_experts * moe.capacity(cfg, t)
    assert t * k >= 8 * slots
    assert keep.sum() <= slots and (~keep).sum() >= t * k - slots


def test_combine_is_the_reference_scatter_add_in_bf16():
    """Given the same updates, the combine equals the reference's
    ``.at[tok_idx].add`` (``moe.py:112``) bit for bit in bfloat16: each
    token's k updates in ascending expert id, rounded after each add."""
    rng = np.random.default_rng(5)
    t, k, e, d = 96, 6, 16, 40
    gate_idx = np.stack([rng.choice(e, k, replace=False) for _ in range(t)])
    order = np.argsort(gate_idx.reshape(-1), kind="stable")
    upd = rng.standard_normal((t * k, d)).astype(np.float32)
    want = jnp.zeros((t, d), jnp.bfloat16).at[jnp.asarray(order // k)].add(
        jnp.asarray(upd, jnp.bfloat16))
    got = moe.combine(torch.as_tensor(upd).bfloat16(), torch.as_tensor(order),
                      torch.as_tensor(gate_idx))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(),
                          np.asarray(want).view(np.int16))
    # One rounding at the end instead gives other bits: the order matters.
    once = torch.zeros((t, d)).index_add_(0, torch.as_tensor(order // k),
                                          torch.as_tensor(upd).bfloat16().float())
    assert not torch.equal(once.bfloat16(), got)


def test_a2a_falls_back_without_mesh_context():
    """Without a mesh context ``moe_impl="a2a"`` takes the gather path (the
    expert-parallel dispatch needs a rank mesh: ``test_torch_moe_a2a.py``):
    the same result as ``"gather"`` and as the reference's fallback."""
    cfg, tp, ref_cfg, jp = _pair("phi3.5-moe-42b-a6.6b", moe_impl="a2a")
    tx, jx = _x(cfg, (2, 8))
    with torch.no_grad():
        y, aux = moe.moe_block(tp, tx, cfg)
        yg, auxg = moe.moe_block(tp, tx, cfg.with_(moe_impl="gather"))
    assert y.shape == tx.shape and bool(torch.isfinite(aux))
    assert torch.equal(y, yg) and torch.equal(aux, auxg)
    ry, raux = ref_moe.moe_block(jp, jx, ref_cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=1e-5)
    np.testing.assert_allclose(float(aux), float(raux), atol=1e-5)


def test_moe_drops_are_bounded():
    """Capacity-factor property: with cf=1.25 and near-uniform routing, the
    realized drop rate on random tokens stays small."""
    from repro_torch.models.model import Model

    cfg = get_config("phi3.5-moe-42b-a6.6b", smoke=True)
    params = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    moe_p = {k: v[0] for k, v in params["stack"]["moe"].items()}
    x = torch.randn((4, 64, cfg.d_model), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y, aux = moe.moe_block(moe_p, x.bfloat16(), cfg)
    assert y.shape == x.shape
    assert bool(torch.isfinite(aux))
    nonzero = float((y.float().abs().sum(-1) > 0).float().mean())
    assert nonzero > 0.85


def test_capacity_matches_reference():
    for arch in ARCHS + ["jamba-v0.1-52b"]:
        cfg, ref_cfg = get_config(arch), ref_get_config(arch)
        for t in (1, 4, 8, 512, 2048, 4096):
            assert moe.capacity(cfg, t) == ref_moe.capacity(ref_cfg, t)
    assert moe.capacity(get_config("moonshot-v1-16b-a3b"), 512) == 64


def test_recording_sees_the_reference_routing_and_changes_nothing():
    """``moe.recording()`` hands back each call's probabilities, expert ids
    and kept entries (these equal the reference's), leaves the output as it
    was, nests, and records nothing once it has closed."""
    cfg, tp, ref_cfg, jp = _pair("moonshot-v1-16b-a3b")
    tx, jx = _x(cfg, (2, 40), seed=5)
    with torch.no_grad():
        plain, _ = moe.moe_block(tp, tx, cfg)
        with moe.recording() as outer:
            with moe.recording() as inner:
                y, _ = moe.moe_block(tp, tx, cfg)
            moe.moe_block(tp, tx[:1], cfg)
        moe.moe_block(tp, tx, cfg)
    assert torch.equal(y, plain)
    assert len(inner) == 1 and len(outer) == 1
    assert tuple(outer[0]["gate_idx"].shape) == (40, cfg.top_k)
    gate_idx, _, keep = _ref_routing(jp, jx, ref_cfg)
    assert np.array_equal(inner[0]["gate_idx"].numpy(), gate_idx)
    assert np.array_equal(inner[0]["keep"].numpy(), keep)
    probs = np.asarray(jax.nn.softmax(
        (jx.reshape(-1, cfg.d_model) @ jp["router"]).astype(jnp.float32), axis=-1))
    np.testing.assert_allclose(inner[0]["probs"].numpy(), probs, rtol=1e-6, atol=1e-7)
