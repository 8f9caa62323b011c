"""The arithmetic of the port's selective-scan kernel design (K4) against
the JAX package, on the CPU.

K4 rounds the recurrence differently from the plain time loop: exp(Δ·A) is
``ex2.approx`` of Δ·(A·log₂e), h and y are fused multiply-adds, and y sums
each lane's states in order, then the lanes pairwise (the lane plan is
``mamba_scan.scan_lanes``).  ``ref.mamba_scan_design_ref`` computes exactly
that arithmetic in plain torch.  Here it is held against the reference's
Pallas scan in interpret mode and its oracle on the reference's
``MAMBA_CASES`` at the reference's atol 2e-4, at every lane plan the kernel
uses (N 1..128), and through a 2-layer falcon-mamba ``Model.loss`` against
the plain time loop at float32 1e-5 — the bound ``chip_smoke.py`` phase 7
holds the kernel's eval loss to on the card.  The kernel itself runs only
on the card (``tests/test_torch_cuda.py``).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.models.model import Model as RefModel
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import _build, mamba_scan, ref
from repro_torch.models.model import Model
from test_torch_ssm import MAMBA_CASES, _scan_inputs

ATOL = 2e-4  # tests/test_kernels.py's atol for the scan, float32


def _design(*tensors):
    return ref.mamba_scan_design_ref(*tensors, *mamba_scan.scan_lanes(tensors[2].shape[-1]))


@pytest.mark.parametrize("case", MAMBA_CASES, ids=str)
def test_design_matches_reference_kernel(case):
    arrs = _scan_inputs(case)
    got = _design(*(torch.from_numpy(x) for x in arrs))
    assert got.dtype == torch.float32 and tuple(got.shape) == case[:3]
    kernel = ref_ops.mamba_scan(*(jnp.asarray(x) for x in arrs), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), atol=ATOL)
    want = ref_ref.mamba_scan_ref(*(jnp.asarray(x) for x in arrs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 16, 33, 64, 100, 128])
def test_design_matches_reference_at_every_lane_plan(n):
    """Each N the kernel dispatches on its own (G, K), with a ragged S and
    d_in, against the reference's oracle."""
    arrs = _scan_inputs((2, 70, 24, n), seed=n)
    got = _design(*(torch.from_numpy(x) for x in arrs))
    want = ref_ref.mamba_scan_ref(*(jnp.asarray(x) for x in arrs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16])
def test_design_does_not_depend_on_the_lane_split(lanes):
    """The same 16 states split over 1..16 lanes stay within the tolerance
    of the plain version: the lane sums' order is rounding only."""
    tensors = [torch.from_numpy(x) for x in _scan_inputs((1, 128, 32, 16), seed=5)]
    got = ref.mamba_scan_design_ref(*tensors, lanes, 16 // lanes)
    want = ref.mamba_scan_ref(*tensors)
    assert float((got - want).abs().max()) <= ATOL


def test_lane_plan_is_the_kernels_dispatch():
    """``scan_lanes`` names the (G, K) that ``mamba_scan_fwd`` launches for
    each N, covers N, and keeps y's shuffle steps to log2 G."""
    src = (_build.CSRC / "mamba_scan.cu").read_text()
    body = src[src.index("int mamba_scan_fwd("):]
    rules = [(int(m.group(1)) if m.group(1) else 128, int(m.group(2)), int(m.group(3)))
             for m in re.finditer(r"(?:if \(N <= (\d+)\) )?return launch<(\d+), (\d+)>", body)]
    assert rules[-1][0] == mamba_scan.MAX_STATE
    for n in range(1, mamba_scan.MAX_STATE + 1):
        g, k = next((g, k) for bound, g, k in rules if n <= bound)
        assert mamba_scan.scan_lanes(n) == (g, k)
        assert g * k >= n and 32 % g == 0
    assert mamba_scan.scan_lanes(16) == (2, 8)  # the model's N: one shuffle step
    with pytest.raises(ValueError, match="state dim"):
        mamba_scan.scan_lanes(129)


def test_design_through_model_loss(monkeypatch):
    """A 2-layer falcon-mamba ``Model.loss`` in float32 with N 16, its scan
    computed by the design's arithmetic, against the plain time loop: within
    the float32 bound phase 7 holds the kernel's eval loss to (1e-5)."""
    kw = dict(param_dtype="float32", compute_dtype="float32", remat=False,
              n_layers=2, ssm_state=16)
    cfg = get_config("falcon-mamba-7b", smoke=True).with_(**kw)
    jp = RefModel(ref_get_config("falcon-mamba-7b", smoke=True).with_(**kw)).init(
        jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, 40))).long()}
    with torch.no_grad():
        plain, _ = Model(cfg.with_(ssm_impl="xla")).loss(params, batch)
        monkeypatch.setattr(ref, "mamba_scan_ref", _design)
        design, _ = Model(cfg.with_(ssm_impl="pallas")).loss(params, batch)
    assert np.isfinite(float(design))
    assert abs(float(design) - float(plain)) <= 1e-5
