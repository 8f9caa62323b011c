"""The port's data plane against the JAX package's, on the CPU.

``SyntheticLM`` batches bit for bit for every family and both tasks,
``MemmapSource`` reads of the same ``.bin`` shards, ``Prefetcher``'s
``(step, batch)`` stream, and the epoch's shard placement: ``plan_epoch``
and ``prefetch_epoch`` fetch schedules and ledger schedules equal the
reference's as ``float.hex`` images, on the ``torch`` and ``numpy``
backends, on the trainer's instance, ``test_bass_shard_placement_valid``'s
and ``examples/bass_cluster_demo.py``'s.
"""
import numpy as np
import pytest

from repro import data as ref_data
from repro.core.topology import tpu_dcn_fabric as ref_fabric
from repro.kernels import ts_plan as ref_ts_plan
from repro_torch import data
from repro_torch.convert import canon, canon_fetches
from repro_torch.core.topology import tpu_dcn_fabric
from repro_torch.kernels import ts_plan

FAMILIES = {  # family -> the extra DataConfig fields its batches read
    "dense": {}, "moe": {}, "ssm": {}, "hybrid": {},
    "vlm": dict(n_vision_tokens=16, d_model=24),
    "encdec": dict(enc_seq=40, d_model=24),
}


def _configs(**kw):
    return data.DataConfig(**kw), ref_data.DataConfig(**kw)


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("task", ["copy", "increment"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_synthetic_batches_equal_reference(family, task):
    cfg, ref_cfg = _configs(seq_len=64, global_batch=3, vocab_size=200, seed=5,
                            family=family, task=task, **FAMILIES[family])
    src, ref = data.SyntheticLM(cfg), ref_data.SyntheticLM(ref_cfg)
    for step in (0, 1, 7):
        got, want = src.batch(step), ref.batch(step)
        assert set(got) == set(want)
        assert ("vision_embeds" in got) == (family == "vlm")
        assert ("frames" in got) == (family == "encdec")
        for k in want:
            _equal(got[k], want[k])
    _equal(src.sample(3, 11), ref.sample(3, 11))


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_memmap_source_equals_reference(tmp_path, dtype):
    rng = np.random.default_rng(0)
    for i, n in enumerate((1000, 517, 64)):
        rng.integers(0, 50_000, size=n).astype(dtype).tofile(tmp_path / f"tok-{i:05d}.bin")
    src = data.MemmapSource(tmp_path, seq_len=64, dtype=dtype)
    ref = ref_data.MemmapSource(tmp_path, seq_len=64, dtype=dtype)
    assert src.n_sequences() == ref.n_sequences() == 15 + 8 + 1
    for shard, n_seq in enumerate((15, 8, 1)):
        for seq in range(n_seq):
            _equal(src.read(shard, seq), ref.read(shard, seq))
    with pytest.raises(FileNotFoundError):
        data.MemmapSource(tmp_path / "empty", seq_len=64)


def test_prefetcher_yields_the_reference_stream():
    cfg, ref_cfg = _configs(seq_len=32, global_batch=2, vocab_size=100, seed=1)
    pf, ref_pf = data.Prefetcher(data.SyntheticLM(cfg)), ref_data.Prefetcher(
        ref_data.SyntheticLM(ref_cfg))
    it, ref_it = iter(pf), iter(ref_pf)
    try:
        for expect in range(5):
            (step, got), (ref_step, want) = next(it), next(ref_it)
            assert step == ref_step == expect
            _equal(got["tokens"], want["tokens"])
    finally:
        pf.close()
        ref_pf.close()


# -- the epoch's shard placement -----------------------------------------------------


def _trainer(fabric_fn, shards_fn):
    hosts = [f"pod0/host{i}" for i in range(4)]
    return (fabric_fn(n_pods=1, hosts_per_pod=4), hosts, {h: 0.0 for h in hosts},
            shards_fn(16, hosts, size_bytes=64e6, replication=2))


def _substrates(fabric_fn, shards_fn):
    hosts = [f"pod0/host{i}" for i in range(8)]
    return (fabric_fn(1, 8), hosts, {h: 0.0 for h in hosts},
            shards_fn(32, hosts, size_bytes=256e6, replication=3, seed=1))


def _demo(fabric_fn, shards_fn):
    hosts = [f"pod{p}/host{h}" for p in range(2) for h in range(16)]
    backlog = {h: float(np.random.default_rng(0).uniform(0, 0.5)) for h in hosts}
    return (fabric_fn(2, 16), hosts, backlog,
            shards_fn(96, hosts, size_bytes=512e6, replication=3, seed=7))


INSTANCES = {"trainer": _trainer, "substrates": _substrates, "demo": _demo}


@pytest.fixture(params=["torch", "numpy"])
def backend(request):
    prev, ref_prev = ts_plan.get_backend(), ref_ts_plan.get_backend()
    ts_plan.set_backend(request.param)
    ref_ts_plan.set_backend("numpy")
    yield request.param
    ts_plan.set_backend(prev)
    ref_ts_plan.set_backend(ref_prev)


@pytest.mark.parametrize("fn", ["plan_epoch", "prefetch_epoch"])
@pytest.mark.parametrize("instance", list(INSTANCES))
def test_epoch_placement_equals_reference(backend, instance, fn):
    build = INSTANCES[instance]
    fabric, hosts, backlog, shards = build(tpu_dcn_fabric, data.uniform_shards)
    ref_args = build(ref_fabric, ref_data.uniform_shards)
    assert [(s.shard_id, s.size_bytes, s.replicas) for s in shards] == [
        (s.shard_id, s.size_bytes, s.replicas) for s in ref_args[3]]
    waves = ts_plan.calls["wave_scan"]
    fetches, sched = getattr(data, fn)(fabric, hosts, backlog, shards)
    ref_fetches, ref_sched = getattr(ref_data, fn)(*ref_args)
    assert len(fetches) == len(shards)
    assert canon_fetches(fetches) == canon_fetches(ref_fetches)
    assert canon(sched.assignments) == canon(ref_sched.assignments)
    assert sched.makespan.hex() == ref_sched.makespan.hex()
    if instance == "trainer":  # the trainer's batch goes through the planning scan
        assert ts_plan.calls["wave_scan"] - waves == (1 if fn == "plan_epoch" else 3)
