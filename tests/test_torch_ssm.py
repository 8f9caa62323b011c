"""The port's SSM (mamba1) against the JAX package's, on the CPU.

Scan: ``ops.mamba_scan`` on CPU tensors (K4's plain version) against the
reference's oracle ``ref.mamba_scan_ref`` and its Pallas kernel in
interpret mode, on the reference's ``MAMBA_CASES``
(``tests/test_kernels.py``) and on shapes whose S and d_in are not powers
of two (the block halving), at the reference's atol 2e-4; the same block
contract; no backward.  Model: ``mamba_block`` (both scan paths, with and
without state), ``mamba_decode`` and a falcon-mamba-7b smoke prefill with
8 decode steps against the JAX ``Model`` on the same parameters
(``params_from_jax``): float32 at 1e-5, bfloat16 at 2e-2, as
``test_torch_models.py`` states.  Inputs are made with numpy from a seed
and handed to both.  K4 itself runs only on the card
(``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels.mamba_scan import mamba_scan_blocked as ref_blocked
from repro.models import ssm as ref_ssm
from repro_torch.kernels import mamba_scan, ops, ref
from repro_torch.models import ssm
from test_torch_serve import TOL, _configs, _f32, _pair

MAMBA_CASES = [
    # (B, S, d_in, N) — tests/test_kernels.py
    (2, 256, 128, 8),
    (1, 512, 256, 16),
    (2, 128, 512, 4),
]
ODD_CASES = [(2, 100, 96, 16), (1, 37, 24, 5), (3, 50, 40, 3)]


def _scan_inputs(case, seed=0):
    """numpy inputs shaped as the reference's test makes them: x normal,
    dt = softplus(normal), a = -exp(0.5 normal), B and C normal."""
    b, s, d_in, n = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d_in)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, d_in)))).astype(np.float32)
    a = -np.exp(0.5 * rng.standard_normal((d_in, n))).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, a, bm, cm


@pytest.mark.parametrize("case", MAMBA_CASES + ODD_CASES, ids=str)
def test_mamba_scan_matches_reference(case):
    arrs = _scan_inputs(case)
    got = ops.mamba_scan(*(torch.from_numpy(x) for x in arrs))
    assert got.dtype == torch.float32 and tuple(got.shape) == case[:3]
    want = ref_ref.mamba_scan_ref(*(jnp.asarray(x) for x in arrs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    kernel = ref_ops.mamba_scan(*(jnp.asarray(x) for x in arrs), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), atol=2e-4)


def test_plain_scan_matches_the_oracle_in_float64():
    """The plain version is the reference's recurrence: in float64 it
    agrees with the reference's float32 oracle to float32 rounding."""
    arrs = _scan_inputs((2, 64, 32, 16), seed=3)
    got = ref.mamba_scan_ref(*(torch.from_numpy(x).double() for x in arrs))
    want = ref_ref.mamba_scan_ref(*(jnp.asarray(x) for x in arrs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("case,block_d,chunk", [
    ((1, 64, 96, 4), 64, 64),     # d_in 96 is not a multiple of 64
    ((1, 100, 32, 4), 32, 64),    # S 100 is not a multiple of 64
    ((1, 64, 32, 4), 32, 64),     # both divide: accepted
])
def test_blocked_scan_keeps_the_reference_contract(case, block_d, chunk):
    arrs = _scan_inputs(case)
    ok = case[2] % min(block_d, case[2]) == 0 and case[1] % min(chunk, case[1]) == 0
    tensors = [torch.from_numpy(x) for x in arrs]
    if ok:
        got = mamba_scan.mamba_scan_blocked(*tensors, block_d=block_d, chunk=chunk)
        want = ref_blocked(*(jnp.asarray(x) for x in arrs), block_d=block_d,
                           chunk=chunk, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
        return
    with pytest.raises(ValueError, match="not multiples"):
        mamba_scan.mamba_scan_blocked(*tensors, block_d=block_d, chunk=chunk)
    with pytest.raises(AssertionError):
        ref_blocked(*(jnp.asarray(x) for x in arrs), block_d=block_d, chunk=chunk,
                    interpret=True)


def test_mamba_scan_has_no_backward():
    """As in the reference, where ``jax.grad`` through the Pallas scan
    fails: the backward raises instead of returning no gradient."""
    x, dt, a, bm, cm = (torch.from_numpy(v) for v in _scan_inputs((1, 16, 8, 4)))
    x.requires_grad_(True)
    y = ops.mamba_scan(x, dt, a, bm, cm)
    assert y.grad_fn is not None
    with pytest.raises(NotImplementedError, match="no backward"):
        y.sum().backward()


class _OtherDevice(torch.Tensor):
    """A tensor on a device that is neither the CPU, ``meta`` nor a card
    (``xpu``, with no data: any op on it raises)."""

    @staticmethod
    def __new__(cls, shape):
        return torch.Tensor._make_wrapper_subclass(cls, shape, dtype=torch.float32,
                                                   device="xpu")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} on a tensor with no data")


def test_mamba_scan_refuses_devices_other_than_cpu_and_cuda():
    """Tensors not all on the CPU (nor all on ``meta``, the cost
    counter's, which get y's shape and run nothing) go to the kernel's
    checks, which take only CUDA tensors: another device, or a mix, is
    refused."""
    tensors = [torch.from_numpy(v) for v in _scan_inputs((1, 16, 8, 4))]
    with pytest.raises(ValueError, match="only all-CPU"):
        mamba_scan.mamba_scan_blocked(*(_OtherDevice(t.shape) for t in tensors))
    with pytest.raises(ValueError, match="only all-CPU"):
        mamba_scan.mamba_scan_blocked(*tensors[:2], tensors[2].to("meta"), *tensors[3:])
    y = mamba_scan.mamba_scan_blocked(*(t.to("meta") for t in tensors))
    assert y.device.type == "meta" and y.shape == tensors[0].shape


# -- the mamba block ------------------------------------------------------------------


def _layer0(dtype, impl="xla"):
    model, tp, ref_model, jp = _pair("falcon-mamba-7b", dtype)
    cfg = model.cfg.with_(ssm_impl=impl)
    ref_cfg = ref_model.cfg.with_(ssm_impl=impl)
    tl = {k: v[0] for k, v in tp["stack"]["mamba"].items()}
    jl = {k: v[0] for k, v in jp["stack"]["mamba"].items()}
    return cfg, ref_cfg, tl, jl


def _pair_inputs(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))


def test_causal_depthwise_conv_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    w = rng.standard_normal((24, 4)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    got = ssm._causal_depthwise_conv(*(torch.from_numpy(v) for v in (x, w, b)))
    want = ref_ssm._causal_depthwise_conv(*(jnp.asarray(v) for v in (x, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("return_state", [False, True])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block_matches_reference(dtype, impl, return_state):
    cfg, ref_cfg, tl, jl = _layer0(dtype, impl)
    jx, tx = _pair_inputs((2, 40, cfg.d_model), dtype, 5)
    want = ref_ssm.mamba_block(jl, jx, ref_cfg, return_state=return_state)
    got = ssm.mamba_block(tl, tx, cfg, return_state=return_state)
    if not return_state:
        got, want = (got, None), (want, None)
    np.testing.assert_allclose(_f32(got[0]), _f32(want[0]), atol=TOL[dtype])
    assert got[0].dtype == getattr(torch, dtype)
    if return_state:
        assert set(got[1]) == set(want[1]) == {"conv", "h"}
        assert got[1]["h"].dtype == torch.float32
        for name in ("conv", "h"):
            assert tuple(got[1][name].shape) == want[1][name].shape
            np.testing.assert_allclose(_f32(got[1][name]), _f32(want[1][name]),
                                       atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_matches_reference(dtype):
    cfg, ref_cfg, tl, jl = _layer0(dtype)
    jx, tx = _pair_inputs((3, 1, cfg.d_model), dtype, 6)
    jc, tc = _pair_inputs((3, cfg.ssm_conv - 1, cfg.d_inner), dtype, 7)
    jh, th = _pair_inputs((3, cfg.d_inner, cfg.ssm_state), "float32", 8)
    want = ref_ssm.mamba_decode(jl, jx, ref_cfg, jc, jh)
    got = ssm.mamba_decode(tl, tx, cfg, tc, th)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_f32(g), _f32(w), atol=TOL[dtype])


# -- falcon-mamba-7b through the model ------------------------------------------------


def test_mamba_caches_match_reference():
    from repro.models.model import Model as RefModel
    from repro_torch.models.model import Model

    cfg, ref_cfg = _configs("falcon-mamba-7b")
    got = Model(cfg).init_caches(3, 40, "cpu")
    want = RefModel(ref_cfg).init_caches(3, 40)
    assert set(got) == set(want) == {"conv", "h"}
    for name in got:
        assert tuple(got[name].shape) == want[name].shape
        assert str(got[name].dtype).split(".")[-1] == str(want[name].dtype)
        assert not bool(got[name].any())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_reference(dtype):
    """Prefill a 24-token prompt, then 8 decode steps: logits and both
    caches agree at every step.  In float32 each side picks its own greedy
    token and the tokens must be identical; in bfloat16 both are fed the
    reference's token, so that one flipped argmax cannot end the check."""
    model, tp, ref_model, jp = _pair("falcon-mamba-7b", dtype)
    cfg = model.cfg
    toks = np.random.default_rng(9).integers(2, cfg.vocab_size, size=(2, 24)).astype(np.int32)
    jl, jc = ref_model.prefill(jp, {"tokens": jnp.asarray(toks)}, 64)
    with torch.no_grad():
        tl, tc = model.prefill(tp, {"tokens": torch.as_tensor(toks).long()}, 64)
    got_tokens, want_tokens = [], []
    for step in range(9):
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=TOL[dtype])
        for name in ("conv", "h"):
            assert tuple(tc[name].shape) == jc[name].shape
            np.testing.assert_allclose(_f32(tc[name]), _f32(jc[name]), atol=TOL[dtype])
        if step == 8:
            break
        jt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        tt = tl.argmax(-1).numpy().astype(np.int32)
        want_tokens.append(jt.tolist())
        got_tokens.append(tt.tolist())
        feed = tt if dtype == "float32" else jt
        jl, jc = ref_model.decode(jp, jnp.asarray(jt[:, None]), jnp.int32(24 + step), jc)
        with torch.no_grad():
            tl, tc = model.decode(tp, torch.as_tensor(feed[:, None]).long(), 24 + step, tc)
    if dtype == "float32":
        assert got_tokens == want_tokens
