"""The port's distribution modules against the JAX package's, on the CPU.

Gradient compression bit for bit (payloads, scales, residuals) under
hypothesis, zero and padded blocks included, and the error-feedback
residual over 20 steps; the sharding rules — ``spec_for``,
``param_shardings``, ``cache_shardings`` and ``replication_report`` for
every arch's parameter and cache defs at the production mesh shapes (16,
16) and (2, 16, 16), under every rule table, against the reference on an
``AbstractMesh`` of the same shape; the three ``spec_for`` edge cases of
``tests/test_sharding_and_hlo.py``; ``constrain``'s rules; and the mesh
functions.
"""
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import AbstractMesh, NamedSharding as RefNamedSharding

from repro.configs import get_config as ref_get_config
from repro.configs.base import DECODE_32K
from repro.distributed import grad_compress as ref_gc
from repro.distributed import sharding as ref_sharding
from repro.models.model import Model as RefModel
from repro.runtime import elastic_mesh_shape as ref_elastic
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.distributed import actctx, grad_compress, sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.model import Model
from repro_torch.models.params import P, flatten
from repro_torch.runtime import elastic_mesh_shape

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


def _bits_equal(t, a):
    a = np.asarray(a)
    t = t.numpy()
    assert t.dtype == a.dtype and t.shape == a.shape
    assert np.array_equal(t.view(np.uint8), a.view(np.uint8))


def _vector(seed, n, exp, zero_block):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 10.0 ** exp).astype(np.float32)
    if zero_block and n > grad_compress.BLOCK:
        x[: grad_compress.BLOCK] = 0.0
    return x


# -- gradient compression ------------------------------------------------------------


@given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 3 * 1024 + 100),
       exp=st.integers(-6, 6), zero_block=st.booleans(), rows=st.sampled_from([1, 2, 5]))
@settings(max_examples=60, deadline=None)
def test_compress_bitwise_against_reference(seed, n, exp, zero_block, rows):
    x = _vector(seed, n * rows, exp, zero_block).reshape(rows, n)
    r = _vector(seed + 1, n * rows, exp - 3, False).reshape(rows, n)
    assert grad_compress.BLOCK == ref_gc.BLOCK == 1024
    q, s = grad_compress.compress(torch.from_numpy(x))
    rq, rs = ref_gc.compress(jnp.asarray(x))
    _bits_equal(q, rq)
    _bits_equal(s, rs)
    _bits_equal(grad_compress.decompress(q, s, x.shape), ref_gc.decompress(rq, rs, x.shape))
    got = grad_compress.compress_with_feedback(torch.from_numpy(x), torch.from_numpy(r))
    want = ref_gc.compress_with_feedback(jnp.asarray(x), jnp.asarray(r))
    for g, w in zip(got, want, strict=True):
        _bits_equal(g, w)


def test_compress_bf16_input_and_all_zero():
    x = np.random.default_rng(0).standard_normal(3000).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    q, s = grad_compress.compress(xb)
    rq, rs = ref_gc.compress(jnp.asarray(x).astype(jnp.bfloat16))
    _bits_equal(q, rq)
    _bits_equal(s, rs)
    q, s = grad_compress.compress(torch.zeros(1500))
    assert q.shape == (2, 1024) and not q.any() and not s.any()


def test_error_feedback_residual_over_20_steps():
    rng = np.random.default_rng(0)
    res, ref_res = torch.zeros(4096 + 300), jnp.zeros(4096 + 300)
    true_sum = np.zeros(4396)
    sent_sum = np.zeros(4396)
    for _ in range(20):
        g = (rng.standard_normal(4396) * 0.1).astype(np.float32)
        q, s, res = grad_compress.compress_with_feedback(torch.from_numpy(g), res)
        rq, rs, ref_res = ref_gc.compress_with_feedback(jnp.asarray(g), ref_res)
        for a, b in ((q, rq), (s, rs), (res, ref_res)):
            _bits_equal(a, b)
        sent_sum += grad_compress.decompress(q, s, g.shape).numpy()
        true_sum += g
    assert np.abs(true_sum - sent_sum).max() == pytest.approx(float(res.abs().max()), rel=1e-5)


def test_tree_compress_and_decompress_against_reference():
    rng = np.random.default_rng(3)
    tree = {"b": rng.standard_normal((7, 300)).astype(np.float32),
            "a": {"w": rng.standard_normal(2000).astype(np.float32),
                  "z": np.zeros((3, 3), np.float32)}}
    res = {"b": np.full((7, 300), 1e-3, np.float32),
           "a": {"w": np.zeros(2000, np.float32), "z": np.zeros((3, 3), np.float32)}}
    to_t = lambda tr: jax.tree_util.tree_map(torch.from_numpy, tr)  # noqa: E731
    got = grad_compress.tree_compress_with_feedback(to_t(tree), to_t(res))
    want = ref_gc.tree_compress_with_feedback(jax.tree_util.tree_map(jnp.asarray, tree),
                                              jax.tree_util.tree_map(jnp.asarray, res))
    for g, w in zip(got, want, strict=True):
        for (_, a), b in zip(flatten(g), jax.tree_util.tree_leaves(w), strict=True):
            _bits_equal(a, b)
    dec = grad_compress.tree_decompress(got[0], got[1], to_t(tree))
    ref_dec = ref_gc.tree_decompress(want[0], want[1], tree)
    for (_, a), b in zip(flatten(dec), jax.tree_util.tree_leaves(ref_dec), strict=True):
        _bits_equal(a, b)


# -- sharding rules ------------------------------------------------------------------

RULES = ["PARAM_RULES", "PARAM_RULES_SMALL_DP", "ACT_RULES_TRAIN", "ACT_RULES_TRAIN_OPT",
         "ACT_RULES_SMALL_DP", "ACT_RULES_DECODE"]
MESHES = {"16x16": False, "2x16x16": True}


def _meshes(multi_pod):
    port = mesh_mod.make_production_mesh(multi_pod=multi_pod)
    ref = AbstractMesh(port.axis_sizes, port.axis_names)
    return port, ref


def _specs(tree, is_leaf):
    leaves = jax.tree_util.tree_leaves(tree, is_leaf=is_leaf)
    return [tuple(s.spec) for s in leaves]


def test_rule_tables_are_the_references():
    for name in RULES:
        assert getattr(sharding, name) == getattr(ref_sharding, name)


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_and_cache_shardings_match_reference(arch, mesh_name, rules):
    port_mesh, ref_mesh = _meshes(MESHES[mesh_name])
    model, ref_model = Model(get_config(arch)), RefModel(ref_get_config(arch))
    table, ref_table = getattr(sharding, rules), getattr(ref_sharding, rules)
    is_port = lambda x: isinstance(x, sharding.NamedSharding)  # noqa: E731
    is_ref = lambda x: isinstance(x, RefNamedSharding)  # noqa: E731
    got = sharding.param_shardings(model.defs(), port_mesh, table)
    want = ref_sharding.param_shardings(ref_model.defs(), ref_mesh, ref_table)
    assert _specs(got, is_port) == _specs(want, is_ref)
    assert all(s.mesh is port_mesh for s in jax.tree_util.tree_leaves(got, is_leaf=is_port))
    b, s = DECODE_32K.global_batch, DECODE_32K.seq_len
    got = sharding.cache_shardings(model.cache_defs(b, s), port_mesh, table)
    want = ref_sharding.cache_shardings(ref_model.cache_defs(b, s), ref_mesh, ref_table)
    assert _specs(got, is_port) == _specs(want, is_ref)
    if rules.startswith("PARAM"):
        assert (sharding.replication_report(model.defs(), port_mesh, table)
                == ref_sharding.replication_report(ref_model.defs(), ref_mesh, ref_table))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_default_rules_and_report_match_reference(mesh_name):
    port_mesh, ref_mesh = _meshes(MESHES[mesh_name])
    is_port = lambda x: isinstance(x, sharding.NamedSharding)  # noqa: E731
    is_ref = lambda x: isinstance(x, RefNamedSharding)  # noqa: E731
    for arch in ARCH_NAMES:
        model, ref_model = Model(get_config(arch)), RefModel(ref_get_config(arch))
        assert (_specs(sharding.param_shardings(model.defs(), port_mesh), is_port)
                == _specs(ref_sharding.param_shardings(ref_model.defs(), ref_mesh), is_ref))
        assert (sharding.replication_report(model.defs(), port_mesh)
                == ref_sharding.replication_report(ref_model.defs(), ref_mesh))
        cdefs = model.cache_defs(4, 64)
        assert (_specs(sharding.cache_shardings(cdefs, port_mesh), is_port)
                == _specs(ref_sharding.cache_shardings(ref_model.cache_defs(4, 64), ref_mesh),
                          is_ref))


class FakeMesh:
    shape = {"data": 16, "model": 16}


class FakePodMesh:
    shape = {"pod": 2, "data": 16, "model": 16}


def test_spec_divisibility_downgrade():
    spec = sharding.spec_for((14, 64), ("heads", "d_ff"), FakeMesh(), sharding.PARAM_RULES)
    # 14 heads not divisible by 16 → replicated; 64 d_ff divisible → model
    assert spec == (None, "model")


def test_spec_axis_used_once():
    spec = sharding.spec_for((64, 64), ("d_ff", "vocab"), FakeMesh(), sharding.PARAM_RULES)
    # both want "model"; only the first gets it
    assert spec == ("model",)


def test_spec_tuple_axes():
    spec = sharding.spec_for((64, 128), ("batch", None), FakePodMesh(),
                             {"batch": ("pod", "data")})
    assert spec == (("pod", "data"),)
    # a candidate list degrades to the first divisible, unused entry
    small = sharding.spec_for((48, 8), ("batch", None), FakePodMesh(),
                              sharding.ACT_RULES_SMALL_DP)
    ref = ref_sharding.spec_for((48, 8), ("batch", None), FakePodMesh(),
                                ref_sharding.ACT_RULES_SMALL_DP)
    assert small == tuple(ref) == ("data",)


# -- activation constraints ----------------------------------------------------------


def test_constrain_rules():
    x = torch.zeros(32, 64, 128)
    axes = ("batch", "seq", "heads")
    assert actctx.active() is None and actctx.constrain(x, axes) is x
    prod = mesh_mod.make_production_mesh()
    with actctx.activation_sharding(prod, sharding.ACT_RULES_TRAIN):
        assert actctx.active()[0] is prod
        # only_if: the flag is absent from these rules → no constraint
        assert actctx.constrain(x, axes, only_if="megatron_blocks") is x
        # require_axis: heads is not mapped by these rules → no constraint
        assert actctx.constrain(x, axes, require_axis="heads") is x
        # nothing resolves (no rule for any axis) → no constraint
        assert actctx.constrain(x, (None, "d_model", None)) is x
        with actctx.activation_sharding(make_cpu_mesh(), sharding.ACT_RULES_TRAIN_OPT):
            # one device: every constraint is the identity
            assert actctx.constrain(x, axes, only_if="megatron_blocks",
                                    require_axis="heads") is x
        assert actctx.active()[0] is prod
        # a spec that resolves over 256 devices cannot be placed by the port
        want = tuple(ref_sharding.spec_for(tuple(x.shape), axes, FakeMesh(),
                                           ref_sharding.ACT_RULES_TRAIN))
        with pytest.raises(NotImplementedError, match=re.escape(str(want))):
            actctx.constrain(x, axes)
    with actctx.activation_sharding(prod, sharding.ACT_RULES_TRAIN_OPT):
        with pytest.raises(NotImplementedError):
            actctx.constrain(x, axes, only_if="megatron_blocks", require_axis="heads")
    assert actctx.active() is None


def make_cpu_mesh():
    return mesh_mod.make_smoke_mesh(device="cpu")


# -- meshes --------------------------------------------------------------------------


def test_mesh_functions_touch_no_global_state():
    code = ("import torch, repro_torch.launch.mesh as m\n"
            "from repro_torch.launch.mesh import Mesh\n"
            "assert not any(isinstance(v, Mesh) for v in vars(m).values())\n"
            "assert callable(m.make_production_mesh) and callable(m.make_smoke_mesh)\n"
            "print(torch.cuda.is_initialized())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": SRC}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_meshes_agree_with_elastic_mesh_shape():
    single, multi = (mesh_mod.make_production_mesh(multi_pod=m) for m in (False, True))
    assert single.shape == {"data": 16, "model": 16} and single.devices is None
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh_mod.mesh_device_count(single) == 256
    assert mesh_mod.mesh_device_count(multi) == 512
    assert elastic_mesh_shape(256, 16) == ref_elastic(256, 16) == single.axis_sizes
    assert (elastic_mesh_shape(512, 16, prefer_pods=2) == ref_elastic(512, 16, prefer_pods=2)
            == multi.axis_sizes)
    with pytest.raises(ValueError, match="no single device"):
        single.device


def _ref_smoke_mesh_shape(data: int, model: int) -> dict:
    """The reference's ``make_smoke_mesh(data, model).shape``, read in a
    subprocess whose ``XLA_FLAGS`` is cleared: jax in this process may
    already hold the host devices that importing ``repro.launch.dryrun``
    forces (512), where the reference's smoke mesh is no longer (1, 1)."""
    code = ("import json\n"
            "from repro.launch.mesh import make_smoke_mesh\n"
            f"print(json.dumps(dict(make_smoke_mesh(data={data}, model={model}).shape)))\n")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**env, "PYTHONPATH": SRC}, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_smoke_mesh():
    cpu = mesh_mod.make_smoke_mesh(data=4, model=2, device="cpu")
    assert cpu.shape == _ref_smoke_mesh_shape(data=4, model=2) == {"data": 1, "model": 1}
    assert cpu.device == torch.device("cpu") and mesh_mod.mesh_device_count(cpu) == 1
    if torch.cuda.device_count() == 0:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_mod.make_smoke_mesh()
    else:
        assert mesh_mod.make_smoke_mesh().device == torch.device("cuda", 0)


def test_param_defs_round_trip_axes():
    """The port's parameter declarations carry the reference's logical axes
    leaf for leaf, which the rules above read."""
    for arch in ARCH_NAMES:
        got = [(p.shape, p.axes) for _, p in flatten(Model(get_config(arch)).defs())]
        want = [(p.shape, p.axes) for p in jax.tree_util.tree_leaves(
            RefModel(ref_get_config(arch)).defs(), is_leaf=lambda x: hasattr(x, "axes"))]
        assert got == want and all(isinstance(p, P) for _, p in
                                   flatten(Model(get_config(arch)).defs()))
