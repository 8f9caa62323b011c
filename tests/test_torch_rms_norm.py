"""The RMSNorm kernel's wrapper on the CPU: its plain version against the
JAX package's ``rms_norm``, its cost formula against the counted
composition, and the routing in ``models/layers.py::rms_norm`` (the
kernel where no gradient is recorded, the composed ops where one is).
The kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from bf16_steps import bf16_steps

from repro.models import layers as ref_layers
from repro_torch.configs import get_config
from repro_torch.kernels import cost, ops, ref
from repro_torch.models import layers
from repro_torch.models.model import Model

WIDTHS = [128, 896, 5120]
LEADING = {"S_d": (7,), "B_S_d": (2, 5), "B_S_H_hd": (2, 3, 4)}
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float32": (torch.float32, jnp.float32)}
EPS = 1e-5


def _inputs(width, lead, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*lead, width)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(width)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("lead", LEADING, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", WIDTHS)
def test_plain_version_matches_reference(width, dtype, lead):
    tdt, jdt = DTYPES[dtype]
    x, w = _inputs(width, LEADING[lead], width + len(lead))
    xt, wt = torch.as_tensor(x).to(tdt), torch.as_tensor(w).to(tdt)
    want = ref_layers.rms_norm(jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt), EPS)
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).to(tdt)
    for got in (ref.rms_norm_ref(xt, wt, EPS), ops.rms_norm(xt, wt, EPS)):
        assert got.dtype == tdt and got.shape == xt.shape
        if dtype == "bfloat16":   # one rounding of a float32 value: at most a step apart
            steps, equal = bf16_steps(got, want)
            assert steps <= 1 and equal >= 0.999, (steps, equal)
        else:
            torch.testing.assert_close(got, want, rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("w_dtype", DTYPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lead", LEADING, ids=str)
@pytest.mark.parametrize("width", WIDTHS)
def test_norm_cost_equals_the_counted_composition(width, lead, dtype, w_dtype):
    """The wrapper's region counts on the CPU and on ``meta`` what the
    counter counts for the composed ops it replaces, so a dry run's counts
    do not move when the norm goes to the kernel."""
    x, w = _inputs(width, LEADING[lead], 1)
    xt, wt = torch.as_tensor(x).to(DTYPES[dtype][0]), torch.as_tensor(w).to(DTYPES[w_dtype][0])
    with cost.CostCounter() as plain:
        ref.rms_norm_ref(xt, wt, EPS)
    want = plain.result()
    for dev in ("cpu", "meta"):
        xd, wd = xt.to(dev), wt.to(dev)
        with cost.CostCounter() as c:
            out = ops.rms_norm(xd, wd, EPS)
        got = c.result()
        assert out.shape == xt.shape and out.dtype == xt.dtype and out.device.type == dev
        assert ((got["flops"], got["bytes"], got["transcendentals"])
                == (want["flops"], want["bytes"], want["transcendentals"]))
        assert c.by_op == {} and got["regions"]["rms_norm"]["calls"] == 1


@pytest.mark.parametrize("needs_grad", ["x", "weight", "both"])
def test_grad_path_keeps_the_composition(needs_grad):
    """Where autograd records, ``layers.rms_norm`` keeps the composed ops:
    the same values and gradients as the composition written out, no
    kernel region; the wrapper itself refuses to be recorded through."""
    x, w = _inputs(896, (2, 5), 3)
    outs, grads = [], []
    for composed in (False, True):
        xt = torch.as_tensor(x).bfloat16().requires_grad_(needs_grad in ("x", "both"))
        wt = torch.as_tensor(w).bfloat16().requires_grad_(needs_grad in ("weight", "both"))
        with cost.CostCounter() as c:
            if composed:
                xf = xt.float()
                y = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + EPS)
                     * wt.float()).to(xt.dtype)
            else:
                y = layers.rms_norm(xt, wt, EPS)
        assert "rms_norm" not in c.regions
        y.float().square().sum().backward()
        outs.append(y.detach())
        grads.append([t.grad for t in (xt, wt) if t.requires_grad])
        with pytest.raises(RuntimeError, match="no backward"):
            ops.rms_norm(xt, wt, EPS)
        with torch.no_grad():   # nothing recorded: the wrapper takes it
            assert torch.equal(ops.rms_norm(xt, wt, EPS), outs[-1])
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(grads[0], grads[1], strict=True):
        assert torch.equal(a, b)


def test_a_stationary_layout_keeps_the_composition():
    class Lay:   # takes this rank's block of the normed row, as RankLayout.d_block does
        def d_block(self, t):
            return t[..., :64]

    x, w = _inputs(128, (3,), 4)
    xt, wt = torch.as_tensor(x), torch.as_tensor(w)
    with cost.CostCounter() as c, torch.no_grad():
        got = layers.rms_norm(xt, wt[:64], EPS, Lay())
    assert "rms_norm" not in c.regions
    assert torch.equal(got, ref.rms_norm_ref(xt, wt, EPS)[..., :64])


def test_prefill_takes_the_wrapper_and_a_train_step_does_not():
    """A dense prefill normalises through the wrapper 2 L + 1 times (two
    norms a layer, the head's); a train step records gradients and keeps
    the composed ops, so it counts none."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamW

    cfg = get_config("mistral-nemo-12b", smoke=True).with_(n_layers=2)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 16))
    batch = {"tokens": torch.as_tensor(toks)}
    with cost.CostCounter() as c, torch.no_grad():
        model.prefill(params, batch, 32)
    assert c.regions["rms_norm"][0] == 2 * cfg.n_layers + 1
    opt = AdamW()
    state = opt.init(params)
    with cost.CostCounter() as c:
        make_train_step(model, opt)(params, state, batch)
    assert "rms_norm" not in c.regions
