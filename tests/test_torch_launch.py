"""The port's launch layer against the JAX package's, on the CPU.

``input_specs`` — shapes and dtypes of every ``(arch × shape)`` cell of
``configs.all_cells()``, and their shardings at the production mesh shapes
against the reference's on an ``AbstractMesh``; ``cross_pod_allreduce``
over two gloo ranks, plain and compressed, against the reference's
``shard_map`` all-reduce on 8 fake devices (2 pods), bit for bit; and the
training loop the trainer runs, on ``TINY``: its loss falls over 12 steps
of the increment task, and on the reference's parameters
(``params_from_jax``) it matches the reference's own loop
(``tests/test_system.py::_run_steps``).
"""
import inspect
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import all_cells as ref_all_cells
from repro.configs import get_config as ref_get_config
from repro.configs.base import ALL_SHAPES as REF_SHAPES
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLM as RefSyntheticLM
from repro.launch import inputs as ref_inputs
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.launch.train import TINY as REF_TINY
from repro.models.model import Model as RefModel
from repro.optim import AdamW as RefAdamW
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro_torch.configs import all_cells, get_config
from repro_torch.configs.base import ALL_SHAPES
from repro_torch.convert import params_from_jax
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.distributed.sharding import NamedSharding
from repro_torch.launch import inputs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import TINY
from repro_torch.models.model import Model
from repro_torch.optim import AdamW, warmup_cosine

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
CELLS = [(a, s.name) for a, s in all_cells()]
DTYPES = {torch.int32: jnp.int32, torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


def _leaves(tree, is_leaf=None):
    return jax.tree_util.tree_leaves(tree, is_leaf=is_leaf)


def test_cells_are_the_references():
    assert CELLS == [(a, s.name) for a, s in ref_all_cells()]
    assert [s.__dict__ for s in ALL_SHAPES] == [s.__dict__ for s in REF_SHAPES]


@pytest.mark.parametrize("mesh_kind", [None, "16x16", "2x16x16"])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(arch, shape, mesh_kind):
    spec = {s.name: s for s in ALL_SHAPES}[shape]
    ref_spec = {s.name: s for s in REF_SHAPES}[shape]
    mesh = ref_mesh = None
    if mesh_kind is not None:
        mesh = make_production_mesh(multi_pod=mesh_kind == "2x16x16")
        ref_mesh = AbstractMesh(mesh.axis_sizes, mesh.axis_names)
    got, got_sh = inputs.input_specs(get_config(arch), spec, mesh)
    want, want_sh = ref_inputs.input_specs(ref_get_config(arch), ref_spec, ref_mesh)
    got_l, want_l = _leaves(got), _leaves(want)
    assert len(got_l) == len(want_l) > 0
    for g, w in zip(got_l, want_l):
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape) and DTYPES[g.dtype] == w.dtype
    is_port = lambda x: x is None or isinstance(x, NamedSharding)  # noqa: E731
    got_s = [None if s is None else s.spec for s in _leaves(got_sh, is_port)]
    want_s = [None if s is None else tuple(s.spec)
              for s in _leaves(want_sh, lambda x: x is None or hasattr(x, "spec"))]
    assert got_s == want_s
    if mesh is None:
        assert not [s for s in got_s if s is not None]


# -- the cross-pod all-reduce ------------------------------------------------------

def _x(rank=0):
    """The all-reduce's input: 3 500 float32 values (4 blocks, the last one
    padded), the first block zero; rank r's are r + 1 times rank 0's."""
    x = np.random.default_rng(3).standard_normal((5, 700)).astype(np.float32)
    x.reshape(-1)[:1024] = 0.0
    return x * np.float32(1 + rank)


X_SRC = "import numpy as np\n" + inspect.getsource(_x)  # for the subprocesses

REF_SCRIPT = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    from repro.distributed.dcn import cross_pod_allreduce
    from repro.launch.mesh import _make_mesh

    """
)

REF_MAIN = textwrap.dedent(
    """
    mesh = _make_mesh((2, 2, 2), ("pod", "data", "model"))
    x = jax.numpy.asarray(_x())
    with mesh:
        for compressed in (False, True):
            y = jax.jit(lambda v: cross_pod_allreduce(v, mesh, compressed=compressed))(x)
            print(np.asarray(y, np.float32).tobytes().hex())
    """
)

RANK_SCRIPT = textwrap.dedent(
    """
    import sys
    import torch, torch.distributed as dist
    from repro_torch.distributed import cross_pod_allreduce
    rank, init, distinct = int(sys.argv[1]), sys.argv[2], sys.argv[3] == "1"

    dist.init_process_group("gloo", init_method=init, world_size=2, rank=rank)
    x = torch.from_numpy(_x(rank if distinct else 0))
    for compressed in (False, True):
        y = cross_pod_allreduce(x, compressed=compressed)
        print(y.numpy().tobytes().hex())
    dist.destroy_process_group()
    """
)


def _run_ranks(tmp_path, distinct):
    env = {**os.environ, "PYTHONPATH": SRC, "GLOO_SOCKET_IFNAME": "lo"}
    init = f"file://{tmp_path / ('init_distinct' if distinct else 'init')}"
    procs = [subprocess.Popen([sys.executable, "-c", X_SRC + RANK_SCRIPT, str(r), init,
                               "1" if distinct else "0"],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env) for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    return [out.split() for out, _ in outs]


def _f32(hexes):
    return np.frombuffer(bytes.fromhex(hexes), np.float32)


def test_cross_pod_allreduce_two_ranks_equals_reference_8dev(tmp_path):
    env = {**os.environ, "PYTHONPATH": SRC}
    ref = subprocess.run([sys.executable, "-c", REF_SCRIPT + X_SRC + REF_MAIN],
                         capture_output=True, text=True, env=env, timeout=300)
    assert ref.returncode == 0, ref.stderr[-2000:]
    want_plain, want_packed = ref.stdout.split()
    ranks = _run_ranks(tmp_path, distinct=False)
    for plain, packed in ranks:   # every rank holds the sum
        assert plain == want_plain and packed == want_packed
    x = _x().reshape(-1)
    np.testing.assert_array_equal(_f32(want_plain), x + x)
    err = np.abs(_f32(want_packed) - 2 * x).max()
    assert 0 < err <= 2 * np.abs(x).max() / 127


def test_cross_pod_allreduce_sums_each_ranks_values_in_rank_order(tmp_path):
    from repro_torch.distributed.grad_compress import compress, decompress

    ranks = _run_ranks(tmp_path, distinct=True)
    x0, x1 = (torch.from_numpy(_x(r)) for r in range(2))
    deq = [decompress(*compress(x), tuple(x.shape)) for x in (x0, x1)]
    for plain, packed in ranks:
        assert plain == (x0 + x1).numpy().tobytes().hex()
        assert packed == (deq[0] + deq[1]).numpy().tobytes().hex()


# -- the training loop --------------------------------------------------------------

LOSS_RTOL = 1e-5   # tests/test_torch_train.py's loss and grad-norm tolerance


def test_training_loop_learns_and_matches_reference_loop():
    """12 steps of the increment task (``test_system.py``'s learnable task)
    on ``TINY`` in float32, from the reference's initialisation: the loss
    falls by more than 1.5 nats, every step's loss is the reference's
    ``_run_steps`` loss within 1e-5, and the first step's grad norm too
    (later grad norms carry the two frameworks' reduction orders through
    the updates)."""
    kw = dict(param_dtype="float32", compute_dtype="float32", remat=False)
    cfg, ref_cfg = TINY.with_(**kw), REF_TINY.with_(**kw)
    jp = RefModel(ref_cfg).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    n = 12
    ref_opt, opt = RefAdamW(lr=ref_warmup_cosine(1e-2, 3, n)), AdamW(lr=warmup_cosine(1e-2, 3, n))
    dk = dict(seq_len=64, global_batch=16, vocab_size=cfg.vocab_size, seed=0, task="increment")
    ref_src, src = RefSyntheticLM(RefDataConfig(**dk)), SyntheticLM(DataConfig(**dk))
    ref_step = jax.jit(ref_make_train_step(RefModel(ref_cfg), ref_opt))
    step = make_train_step(Model(cfg), opt)
    js, ts = ref_opt.init(jp), opt.init(tp)
    losses, ref_losses = [], []
    for s in range(n):
        jb = {k: jnp.asarray(v) for k, v in ref_src.batch(s).items()}
        tb = {k: torch.as_tensor(v) for k, v in src.batch(s).items()}
        jp, js, jm = ref_step(jp, js, jb)
        tp, ts, tm = step(tp, ts, tb)
        losses.append(float(tm["loss"]))
        ref_losses.append(float(jm["loss"]))
        if s == 0:
            np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                       rtol=LOSS_RTOL)
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) - 1.5, losses


def test_trainer_presets_are_the_references():
    import dataclasses

    from repro.launch import train as ref_train
    from repro_torch.launch import serve, train

    assert dataclasses.asdict(train.TINY) == dataclasses.asdict(ref_train.TINY)
    assert dataclasses.asdict(train.PRESET_100M) == dataclasses.asdict(ref_train.PRESET_100M)
    assert serve.TINY is train.TINY


def test_trainer_defaults_to_the_card_and_raises_without_one(tmp_path):
    """No fallback: without a card the default ``--device cuda`` raises
    before anything is trained or written."""
    from repro_torch.launch import train

    if torch.cuda.device_count():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1", "--ckpt-dir", str(tmp_path / "ck")])
    assert not (tmp_path / "ck").exists()
