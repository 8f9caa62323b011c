"""The kernels on the card.  K1: each gather form against its plain
PyTorch version on CPU copies of the same inputs, and the scheduling slice
on the ``cuda`` backend against the numpy reference — bit for bit
throughout.  K2, K3: against their plain versions, and a full-width serve.
K4: against its plain version, its input checks, and a full-width eval
step through it against the plain scan.

Every test here needs a Hopper card and skips without one.  On a machine
with one: ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ts_plan, ts_plan_device

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernels are built for capability (9, 0) only")
    prev = ts_plan.get_backend()
    ts_plan.set_backend("cuda")
    yield torch.device("cuda", torch.cuda.current_device())
    ts_plan.set_backend(prev)


def _bits(x):
    x = x.cpu()
    return x.view(torch.int64) if x.dtype == torch.float64 else x


def _same(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        assert torch.equal(_bits(g), _bits(r))


def _mirror(rng, R, Wm):
    M = rng.random((R, Wm))
    u = rng.random((R, Wm))
    M[u < 0.3] = 0.0
    M[u > 0.9] = 1.0
    return M


SHAPES = [(1, 1, 1), (9, 4, 64), (33, 9, 200), (1024, 4, 64), (3, 2, 4096)]


@pytest.mark.parametrize("n,L,W", SHAPES)
def test_window_form_matches_plain(card, n, L, W):
    rng = np.random.default_rng(n + L + W)
    R, Wm, dur = 64, W + 100, 0.1
    M = _mirror(rng, R, Wm)
    pad = rng.integers(0, R, size=(n, L))
    off = rng.integers(0, Wm - W + 1, size=n)
    sz = off + 500
    t0 = sz * dur - rng.uniform(0, dur, size=n)
    first = rng.uniform(1e-3, dur, size=n)
    caps = rng.uniform(1.0, 37.0, size=n)
    sizes = rng.uniform(0.0, 0.05 * W * 37.0, size=n)
    sizes[0] = 0.0
    host = [torch.from_numpy(np.ascontiguousarray(x))
            for x in (M, pad, off, caps, first, sizes, sz, t0)]
    got = ts_plan_device.scan_window(*(h.to(card) for h in host), dur, W)
    _same(got, ts_plan.wave_scan_torch(*host, dur, W))


@pytest.mark.parametrize("n,L,W", SHAPES)
def test_columns_form_matches_plain(card, n, L, W):
    rng = np.random.default_rng(n * L + W)
    R, Wm = 64, W + 100
    host = [torch.from_numpy(np.ascontiguousarray(x)) for x in (
        _mirror(rng, R, Wm), rng.integers(0, R, size=(n, L)),
        rng.integers(0, Wm, size=(n, W)), rng.uniform(1.0, 37.0, size=n),
        rng.uniform(0.0, 0.13, size=(n, W)), rng.uniform(0.0, 0.05 * W * 37.0, size=n),
    )]
    got = ts_plan_device.scan_columns(*(h.to(card) for h in host))
    _same(got, ts_plan.col_scan_torch(*host))


# The failure path's column scans (core/reroute.py): a reroute round's live
# candidates, up to a fat tree's path length, W = 64 escalating ×4.
FAILURE_SHAPES = [(n, L, W) for n in (1, 3, 17, 48) for L in (1, 6)
                  for W in (64, 256, 1024, 4096)]


@pytest.mark.parametrize("n,L,W", FAILURE_SHAPES)
def test_window_form_matches_plain_at_failure_shapes(card, n, L, W):
    test_window_form_matches_plain(card, n, L, W)


@pytest.mark.parametrize("n,L,W", FAILURE_SHAPES)
def test_columns_form_matches_plain_at_failure_shapes(card, n, L, W):
    test_columns_form_matches_plain(card, n, L, W)


@pytest.mark.parametrize("W", [1025, 3 * 1024 + 17, 65536])
def test_scan_carries_the_sum_across_tiles(card, W):
    """Rows longer than one shared tile (1 024 slots): the in-order sum
    carries from tile to tile, and the window form's plan end reads cum
    and bw from an earlier tile where hit falls there."""
    n, L = 5, 3
    test_window_form_matches_plain(card, n, L, W)
    test_columns_form_matches_plain(card, n, L, W)
    rng = np.random.default_rng(W)
    R, Wm, dur = 16, W + 8, 0.1
    M = 0.9 * rng.random((R, Wm))  # every slot adds: hit is the index below
    pad = rng.integers(0, R, size=(n, L))
    off = np.zeros(n, dtype=np.int64)
    sz = off + 500
    caps = np.full(n, 2.0)
    first = np.full(n, dur)
    booked = M[pad[:, :, None], np.arange(W)]
    cum = np.cumsum((1.0 - booked.max(axis=1)) * caps[:, None] * dur, axis=1)
    # sizes whose hit falls in the first tile, the second, the middle, the
    # last slot, and past the end
    idx = [10, min(1100, W - 1), W // 2, W - 2]
    sizes = np.append(cum[np.arange(4), idx], cum[4, -1] * 2)
    host = [torch.from_numpy(np.ascontiguousarray(x))
            for x in (M, pad, off, caps, first, sizes, sz, sz * dur)]
    got = ts_plan_device.scan_window(*(h.to(card) for h in host), dur, W)
    want = ts_plan.wave_scan_torch(*host, dur, W)
    _same(got, want)
    assert got[3].cpu().tolist() == idx + [W]


@pytest.mark.parametrize("cap", [None, 3.7])
@pytest.mark.parametrize("n,L,W", SHAPES)
def test_dense_form_matches_numpy(card, n, L, W, cap):
    rng = np.random.default_rng(7 * n + W)
    booked = rng.random((n, L, W))
    overlay = (rng.random((n, L, W)) < 0.2).astype(np.float64)
    caps = rng.uniform(1.0, 37.0, size=n)
    secs = rng.uniform(0.0, 1.3, size=(n, W))
    sizes = rng.uniform(0.5, 0.3 * W * 37.0, size=n)
    launches = ts_plan_device.stats["launches_dense"]
    got = ts_plan.plan_scan(booked, caps, secs, sizes, cap, overlay)
    assert ts_plan_device.stats["launches_dense"] == launches + 1
    ref = ts_plan.plan_scan_numpy(booked, caps, secs, sizes, cap, overlay)
    for g, r in zip(got, ref):
        assert np.array_equal(np.asarray(g).view(np.int64) if g.dtype == np.float64 else g,
                              np.asarray(r).view(np.int64) if r.dtype == np.float64 else r)


def test_fleet_slice_on_the_card_matches_numpy(card):
    from repro_torch.convert import canon
    from repro_torch.core import ClusterController, Instance, Task, tpu_dcn_fabric

    def instance():
        fab = tpu_dcn_fabric(n_pods=2, hosts_per_pod=32)
        workers = [f"pod{p}/host{h}" for p in range(2) for h in range(32)]
        rng = np.random.default_rng(0)
        idx = rng.integers(0, 64, size=(3000, 3))
        tasks = [Task(i, float(256e6 + (i % 7) * 64e6), 0.05,
                      tuple(workers[j] for j in idx[i])) for i in range(3000)]
        idle = {w: float(rng.uniform(0, 2.0)) for w in workers}
        return Instance(fab, workers, idle, tasks, slot_duration=0.1)

    def run(backend):
        ts_plan.set_backend(backend)
        inst = instance()
        ctrl = ClusterController.from_instance(inst)
        for i in range(0, 3000, 1024):
            ctrl.submit(inst.tasks[i:i + 1024], at=0.0)
            ctrl.run_until(0.0)
        return ctrl

    ts_plan_device.stats.reset()
    waves = ts_plan.calls["wave_scan"]
    on_card = run("cuda")
    assert ts_plan_device.stats["launches_window"] == ts_plan.calls["wave_scan"] - waves > 0
    reference = run("numpy")
    assert canon(on_card.schedule().assignments) == canon(reference.schedule().assignments)
    mirror = on_card.state.ledger.device_mirror()
    assert mirror.device.type == "cuda"
    mirror.sync()
    assert np.array_equal(mirror.host_view(), on_card.state.ledger.reserved)



def test_affine_hierarchy_on_the_card_matches_numpy(card):
    """The pod-affine hierarchical controller on the reference benchmark's
    smoke leg (k 4, 64 jobs × 32 tasks), with the rebalancer on and a short
    retire stride: every pod's wavefront scans its own shard's mirror on
    the card."""
    import random

    from repro_torch.convert import canon
    from repro_torch.core import Task, storage_hosts
    from repro_torch.core.hierarchy import HierarchicalController
    from repro_torch.net import fat_tree_fabric

    def run(backend):
        ts_plan.set_backend(backend)
        fab = fat_tree_fabric(4, link_mbps=25e9)
        hosts = storage_hosts(fab)
        h = HierarchicalController(fab, hosts, affinity=True, slot_duration=0.1,
                                   rebalance_interval=0.5)
        h.ledger.retire_stride = 4
        rng = random.Random(0)
        by_pod = {}
        for host in hosts:
            by_pod.setdefault(host.split("/", 1)[0], []).append(host)
        pods = sorted(by_pod)
        for j in range(64):
            pool = by_pod[pods[j % len(pods)]]
            tasks = [Task(j * 32 + i, float(rng.uniform(64e6, 256e6)), 0.05,
                          tuple(rng.sample(pool, 3))) for i in range(32)]
            h.submit(tasks, at=j * 0.1)
            h.run_until(j * 0.1)
        h.run()
        shards = tuple((n, sh.reserved.tobytes(), sh.base_slot)
                       for n, sh in sorted(h.ledger.shards.items()))
        return h, canon(h.schedule().assignments), shards

    ts_plan_device.stats.reset()
    on_card, got, shards = run("cuda")
    assert ts_plan_device.stats["launches_window"] > 0
    assert on_card._stats["rehomed"] > 0
    _, want, want_shards = run("numpy")
    assert got == want and shards == want_shards
    for pc in on_card.pods.values():
        mir = pc.shard._mirror
        assert mir.device.type == "cuda"
        mir.sync()
        assert np.array_equal(mir.host_view(), pc.shard.reserved)


@pytest.mark.parametrize("cross", [True, False], ids=["across_retire", "same_origin"])
def test_state_restore_with_the_mirror_on_the_card_matches_numpy(card, cross):
    """Wave, snapshot, (retire,) wave, restore, wave: the restore
    invalidates the card's mirror, so the last wave equals numpy's."""
    from repro_torch.convert import canon
    from repro_torch.core import BassPolicy, ClusterState, Task, storage_hosts
    from repro_torch.net import fat_tree_fabric

    def run(backend):
        ts_plan.set_backend(backend)
        fab = fat_tree_fabric(4, link_mbps=100.0)
        hosts = storage_hosts(fab)
        sources, workers = hosts[:8], hosts[8:]
        rng = np.random.default_rng(0)
        idx = rng.integers(0, 8, size=(24, 3))
        tasks = [Task(i, float(32 + (i % 5) * 16), 2.0,
                      tuple(sources[j] for j in idx[i])) for i in range(24)]
        state = ClusterState(fab, workers, slot_duration=0.1, horizon_slots=64)
        pol = BassPolicy(multipath=True)
        out = [canon(pol.place_batch(tasks[:8], state))]
        snap = state.snapshot()
        led = state.ledger
        if cross:
            end = max(float.fromhex(a[6][2]) for a in out[0] if a[6] is not None)
            cut = led.slot_of(end) + 8
            state.advance(cut * led.slot_duration)
            led.retire_to(cut)
        out.append(canon(pol.place_batch(tasks[8:16], state)))
        state.restore(snap)
        out.append(canon(pol.place_batch(tasks[16:], state)))
        return out, led.reserved.tobytes()

    ts_plan_device.stats.reset()
    got = run("cuda")
    assert ts_plan_device.stats["launches_window"] >= 3
    assert got == run("numpy")

def test_multipath_and_switch_kill_on_the_card_match_numpy(card):
    """Pairs-mode waves (``wave_select`` on the card) and a core switch
    killed under in-flight transfers (column scans on the card)."""
    from repro_torch.convert import canon
    from repro_torch.core import BassPolicy, ClusterController, Task, storage_hosts
    from repro_torch.net import fat_tree_fabric

    def run(backend):
        ts_plan.set_backend(backend)
        fab = fat_tree_fabric(4)
        hosts = storage_hosts(fab)
        sources, workers = hosts[:8], hosts[8:]
        rng = np.random.default_rng(11)
        idle = {w: float(rng.uniform(0, 2.0)) for w in workers}
        ctrl = ClusterController(fab, workers, BassPolicy(multipath=True, k_paths=3),
                                 idle=idle, slot_duration=0.1)
        tasks = [Task(i, float(rng.uniform(100, 700)), 0.05,
                      tuple(rng.choice(sources, 3, replace=False))) for i in range(160)]
        ctrl.submit(tasks[:80], at=0.0)
        ctrl.run_until(0.0)
        ctrl.fail_switch("core0_0", at=0.5)
        ctrl.submit(tasks[80:], at=1.0)
        ctrl.run()
        return ctrl

    ts_plan_device.stats.reset()
    selects = ts_plan.calls["wave_select"]
    on_card = run("cuda")
    assert ts_plan.calls["wave_select"] > selects
    assert ts_plan_device.stats["launches_columns"] > 0
    reference = run("numpy")
    assert canon(on_card.schedule().assignments) == canon(reference.schedule().assignments)
    assert len(on_card.reroute_log) == len(reference.reroute_log) > 0
    for a, b in zip(on_card.reroute_log, reference.reroute_log):
        assert (a.flow, a.old_path, a.new_path, float(a.delivered).hex(),
                float(a.remaining).hex()) == (b.flow, b.old_path, b.new_path,
                                              float(b.delivered).hex(),
                                              float(b.remaining).hex())


# -- K2 and K3 ---------------------------------------------------------------------

ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# K2's bf16 path against the plain version of its own arithmetic (P rounded
# to bf16 against the running max of each 64-key tile): |got - want| <=
# rtol |want| + atol, rtol one bf16 ulp at the bottom of a binade.  The
# scores' float32 sums differ in order, which flips a rare rounding of P;
# atol covers those flips (largest reading on the H100: 7.3e-4).
DESIGN_TOL = dict(rtol=2.0 ** -7, atol=2.0 ** -10)

FLASH_CASES_CARD = [
    # (B, S, nq, nkv, hd, dtype, causal): the reference's FLASH_CASES, the
    # model's prefill shape, a sequence shorter than one tile, a ragged last
    # tile, and the non-causal form.
    (2, 256, 4, 2, 64, torch.float32, True),
    (1, 128, 8, 8, 128, torch.float32, True),
    (2, 256, 6, 2, 64, torch.bfloat16, True),
    (1, 512, 4, 4, 128, torch.bfloat16, True),
    (1, 128, 14, 2, 64, torch.float32, True),
    (1, 512, 32, 8, 128, torch.bfloat16, True),
    (1, 32, 4, 2, 64, torch.float32, True),
    (2, 96, 4, 1, 128, torch.bfloat16, True),
    (1, 256, 4, 2, 128, torch.float32, False),
    # The tensor-core path (bf16): hd 64 and 128 at S 40 (one partial
    # tile), 96 (a ragged last tile) and 384 (not a multiple of 256); the
    # non-causal form; g = 7.
    (1, 40, 4, 2, 64, torch.bfloat16, True),
    (1, 40, 4, 2, 128, torch.bfloat16, True),
    (2, 96, 4, 2, 64, torch.bfloat16, True),
    (1, 96, 8, 2, 128, torch.bfloat16, True),
    (1, 384, 4, 2, 64, torch.bfloat16, True),
    (1, 384, 8, 2, 128, torch.bfloat16, True),
    (2, 96, 4, 2, 64, torch.bfloat16, False),
    (1, 256, 4, 2, 128, torch.bfloat16, False),
    (1, 128, 14, 2, 64, torch.bfloat16, True),
    (1, 128, 14, 2, 128, torch.bfloat16, True),
    # The served prefills of the MoE and encoder-decoder families:
    # moonshot-v1-16b-a3b (512 tokens, 16 heads of 128) and whisper-base
    # (128 tokens, 8 heads of 64), in both types.
    (1, 512, 16, 16, 128, torch.bfloat16, True),
    (1, 512, 16, 16, 128, torch.float32, True),
    (1, 128, 8, 8, 64, torch.bfloat16, True),
    (1, 128, 8, 8, 64, torch.float32, True),
]

DECODE_CASES_CARD = [
    # (B, S, nq, nkv, hd, pos): the reference's DECODE_CASES and the
    # model's decode shape; each in float32 and bfloat16.
    (2, 512, 4, 2, 64, 137),
    (1, 1024, 8, 8, 128, 1023),
    (2, 256, 6, 2, 64, 0),
    (1, 512, 16, 16, 64, 300),
    (4, 1024, 32, 8, 128, 600),
    # The split-key design at the model's widths: pos on a chunk boundary
    # (640 live keys make 10 chunks of 64 on 132 SMs), pos = S - 1, pos = 0,
    # and a 4 096-position cache.
    (4, 1024, 32, 8, 128, 639),
    (4, 1024, 32, 8, 128, 1023),
    (4, 1024, 32, 8, 128, 0),
    (4, 4096, 32, 8, 128, 4095),
    (4, 4096, 32, 8, 128, 2047),
]


def _normal(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)


@pytest.mark.parametrize("case", FLASH_CASES_CARD, ids=str)
def test_flash_attention_kernel_matches_plain(card, case):
    from repro_torch.kernels import flash_attention, ops, ref

    b, s, nq, nkv, hd, dtype, causal = case
    rng = np.random.default_rng(s + nq)
    q = _normal(rng, (b, s, nq, hd), dtype, card)
    k = _normal(rng, (b, s, nkv, hd), dtype, card)
    v = _normal(rng, (b, s, nkv, hd), dtype, card)
    launches = flash_attention.stats["launches"]
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.stats["launches"] == launches + 1
    assert got.dtype == dtype and got.shape == q.shape and got.is_contiguous()
    want = ref.attention_ref(*(t.cpu().transpose(1, 2) for t in (q, k, v)), causal=causal)
    err = (got.cpu().float() - want.transpose(1, 2).float()).abs().max()
    assert float(err) <= ATTN_TOL[dtype]
    if dtype == torch.bfloat16:
        want = ref.attention_ref(*(t.cpu().transpose(1, 2) for t in (q, k, v)), causal=causal,
                                 p_dtype=torch.bfloat16, p_block=flash_attention.KEY_TILE_BF16)
        want = want.transpose(1, 2).float()
        over = (got.cpu().float() - want).abs() - DESIGN_TOL["rtol"] * want.abs()
        assert float(over.max()) <= DESIGN_TOL["atol"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DECODE_CASES_CARD, ids=str)
def test_flash_decode_kernel_matches_plain(card, case, dtype):
    from repro_torch.kernels import decode_attention, ops, ref

    b, s, nq, nkv, hd, pos = case
    rng = np.random.default_rng(s + pos)
    q = _normal(rng, (b, 1, nq, hd), dtype, card)
    k = _normal(rng, (b, s, nkv, hd), dtype, card)
    v = _normal(rng, (b, s, nkv, hd), dtype, card)
    launches = decode_attention.stats["launches"]
    got = ops.flash_decode(q, k, v, pos)
    torch.cuda.synchronize()
    assert decode_attention.stats["launches"] == launches + 1
    want = ref.decode_ref(*(t.cpu().transpose(1, 2) for t in (q, k, v)), pos)
    err = (got.cpu().float() - want.transpose(1, 2).float()).abs().max()
    assert float(err) <= ATTN_TOL[dtype]


def test_flash_attention_takes_the_models_strided_views(card):
    """q, k and v as the model holds them, [B, S, H, hd] slices of one fused
    projection, go through ``ops.flash_attention`` as transposed views
    without a copy, and the output comes back in the model's layout."""
    from repro_torch.kernels import flash_attention, ops, ref

    b, s, nq, nkv, hd = 1, 512, 32, 8, 128
    rng = np.random.default_rng(5)
    qkv = _normal(rng, (b, s, nq + 2 * nkv, hd), torch.bfloat16, card)
    q, k, v = qkv.split([nq, nkv, nkv], dim=2)
    assert not q.is_contiguous() and q.stride(1) == (nq + 2 * nkv) * hd
    launches = flash_attention.stats["launches"]
    got = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.stats["launches"] == launches + 1
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    want = ref.attention_ref(*(t.cpu().transpose(1, 2) for t in (q, k, v)), causal=True)
    err = (got.cpu().float() - want.transpose(1, 2).float()).abs().max()
    assert float(err) <= ATTN_TOL[torch.bfloat16]


def test_flash_decode_before_the_first_position_gives_zeros(card):
    """pos < 0: no key counts, l stays 0, and the guarded divide gives
    zeros, as the reference kernel does."""
    from repro_torch.kernels import decode_attention, ops

    rng = np.random.default_rng(3)
    for dtype in (torch.float32, torch.bfloat16):
        q = _normal(rng, (2, 1, 8, 128), dtype, card)
        k = _normal(rng, (2, 256, 2, 128), dtype, card)
        launches = decode_attention.stats["launches"]
        got = ops.flash_decode(q, k, k, -1)
        torch.cuda.synchronize()
        assert decode_attention.stats["launches"] == launches + 1
        assert torch.equal(got.cpu().float(), torch.zeros(got.shape))


def test_attention_kernels_refuse_misaligned_views(card):
    """TMA (K2, bf16) and K3's 16-byte loads need 16-byte aligned bases."""
    from repro_torch.kernels import ops

    flat = torch.zeros(1 + 64 * 4 * 64, device=card, dtype=torch.bfloat16)
    odd = flat[1:].view(1, 64, 4, 64)  # base 2 bytes past an aligned one
    good = torch.zeros((1, 64, 4, 64), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(odd, good[:, :, :2], good[:, :, :2])
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(good, odd[:, :, :2], good[:, :, :2])
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_decode(good[:, :1], odd, good, 10)


def test_attention_kernels_refuse_what_they_do_not_take(card):
    from repro_torch.kernels import ops

    q = torch.zeros((1, 64, 4, 96), device=card)  # head dim 96
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros((1, 64, 4, 64), device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        ops.flash_attention(q, q[:, :, :2], q[:, :, :2])
    with pytest.raises(ValueError, match="host integer"):
        ops.flash_decode(q[:, :1].float(), q.float(), q.float(),
                         torch.tensor(3, device=card))


def test_two_layer_full_width_serve_on_the_card(card):
    """mistral-nemo-12b at full width, 2 layers: the engine's prefills go
    through K2 (one launch per layer and prefill), and in float32 the
    greedy tokens equal the plain attention path's."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention
    from repro_torch.models.model import Model
    from repro_torch.serving import Request, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("mistral-nemo-12b").with_(
        n_layers=2, param_dtype="float32", compute_dtype="float32")
    params = Model(cfg).init(torch.Generator(device=card).manual_seed(0), card)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32) for n in (64, 128)]
    tokens = {}
    for impl in ("pallas", "xla"):
        eng = ServeEngine(Model(cfg.with_(attn_impl=impl)), params, 2, 256, device=card)
        launches = flash_attention.stats["launches"]
        reqs = [Request(rid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)]
        for r in reqs:
            assert eng.admit(r)
        while eng.active:
            eng.tick()
        tokens[impl] = [r.tokens_out for r in reqs]
        want = 2 * cfg.n_layers if impl == "pallas" else 0
        assert flash_attention.stats["launches"] - launches == want
    assert tokens["pallas"] == tokens["xla"]
    assert all(len(t) == 6 for t in tokens["pallas"])


MAMBA_CASES_CARD = [
    # (B, S, d_in, N): the reference's MAMBA_CASES, shapes whose S and d_in
    # are not powers of two (a ragged last chunk of time and of channels),
    # every lane-group width (N 1..128), and the model's shape.
    (2, 256, 128, 8),
    (1, 512, 256, 16),
    (2, 128, 512, 4),
    (2, 100, 96, 16),
    (3, 37, 24, 5),
    (1, 70, 40, 1),
    (1, 64, 32, 32),
    (2, 33, 48, 64),
    (1, 20, 16, 100),
    (2, 1024, 8192, 16),
]


def _scan_inputs(rng, b, s, d_in, n, dev):
    mk = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)  # noqa: E731
    return (mk(rng.standard_normal((b, s, d_in))),
            mk(np.log1p(np.exp(rng.standard_normal((b, s, d_in))))),
            mk(-np.exp(0.5 * rng.standard_normal((d_in, n)))),
            mk(rng.standard_normal((b, s, n))), mk(rng.standard_normal((b, s, n))))


@pytest.mark.parametrize("case", MAMBA_CASES_CARD, ids=str)
def test_mamba_scan_kernel_matches_plain(card, case):
    """K4 against its plain version on the card, at the reference's atol
    2e-4 (float32; the kernel's exp is ex2.approx and its products and sums
    fused, which ``ref.mamba_scan_design_ref`` models on the CPU)."""
    from repro_torch.kernels import mamba_scan, ops, ref

    inputs = _scan_inputs(np.random.default_rng(sum(case)), *case, card)
    launches = mamba_scan.stats["launches"]
    got = ops.mamba_scan(*inputs)
    torch.cuda.synchronize()
    assert mamba_scan.stats["launches"] == launches + 1
    assert got.dtype == torch.float32 and tuple(got.shape) == case[:3]
    want = ref.mamba_scan_ref(*inputs)
    assert float((got - want).abs().max()) <= 2e-4


MAMBA_DESIGN_CASES_CARD = [
    # (B, S, d_in, N): every lane plan of the design (mamba_scan.scan_lanes),
    # d_in not a multiple of the block's channels (128 / G) nor of 4 (the
    # 4-byte staging path), S not a multiple of the chunk (64 or 32 steps),
    # and the model's N at a ragged d_in and S.
    (2, 100, 200, 1),
    (1, 77, 130, 3),
    (2, 1000, 520, 16),
    (1, 70, 36, 33),
    (2, 65, 20, 64),
    (1, 45, 12, 128),
    (1, 33, 7, 16),
    (3, 129, 66, 5),
]


@pytest.mark.parametrize("case", MAMBA_DESIGN_CASES_CARD, ids=str)
def test_mamba_scan_kernel_matches_plain_at_every_lane_plan(card, case):
    test_mamba_scan_kernel_matches_plain(card, case)


def test_mamba_scan_kernel_takes_unaligned_views(card):
    """x and dt as views 4 bytes past an aligned base, and B, C with N not
    a multiple of 4: the kernel stages them 4 bytes at a time."""
    from repro_torch.kernels import ops, ref

    b, s, d_in, n = 2, 96, 64, 6
    inputs = list(_scan_inputs(np.random.default_rng(9), b, s, d_in, n, card))
    for i in (0, 1):
        flat = torch.empty(1 + inputs[i].numel(), device=card)
        view = flat[1:].view(b, s, d_in)
        view.copy_(inputs[i])
        inputs[i] = view
    assert inputs[0].data_ptr() % 16 == 4 and inputs[0].is_contiguous()
    got = ops.mamba_scan(*inputs)
    want = ref.mamba_scan_ref(*inputs)
    assert float((got - want).abs().max()) <= 2e-4


def test_mamba_scan_kernel_refuses_what_it_does_not_take(card):
    from repro_torch.kernels import mamba_scan

    inputs = _scan_inputs(np.random.default_rng(0), 1, 16, 8, 4, card)
    for dtype in (torch.float64, torch.bfloat16):
        with pytest.raises(TypeError, match="float32"):
            mamba_scan.mamba_scan_blocked(*(t.to(dtype) for t in inputs))
    with pytest.raises(ValueError, match="only all-CPU"):
        mamba_scan.mamba_scan_blocked(inputs[0].cpu(), *inputs[1:])
    with pytest.raises(ValueError, match="only all-CPU"):
        mamba_scan.mamba_scan_blocked(*inputs[:2], inputs[2].cpu(), *inputs[3:])
    with pytest.raises(ValueError, match="contiguous"):
        mamba_scan.mamba_scan_blocked(inputs[0].transpose(1, 2).contiguous().transpose(1, 2),
                                      *inputs[1:])
    with pytest.raises(ValueError, match="state dim"):
        big = _scan_inputs(np.random.default_rng(0), 1, 16, 8, 129, card)
        mamba_scan.mamba_scan_blocked(*big)


def test_two_layer_full_width_eval_through_k4(card):
    """falcon-mamba-7b at full width, 2 layers, float32: the eval step's
    loss through K4 (one launch per layer) equals the plain scan's to
    float32 rounding, and a train step through K4 raises, as in the
    reference."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import mamba_scan
    from repro_torch.launch.steps import make_eval_step, make_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("falcon-mamba-7b").with_(
        n_layers=2, param_dtype="float32", compute_dtype="float32")
    params = Model(cfg).init(torch.Generator(device=card).manual_seed(0), card)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 256))
    batch = {"tokens": torch.as_tensor(toks, device=card)}
    losses = {}
    for impl in ("pallas", "xla"):
        launches = mamba_scan.stats["launches"]
        losses[impl] = float(make_eval_step(Model(cfg.with_(ssm_impl=impl)))(params, batch)["loss"])
        assert mamba_scan.stats["launches"] - launches == (2 if impl == "pallas" else 0)
    assert np.isfinite(losses["pallas"])
    assert abs(losses["pallas"] - losses["xla"]) <= 1e-4
    model = Model(cfg.with_(ssm_impl="pallas"))
    opt = AdamW()
    with pytest.raises(NotImplementedError, match="no backward"):
        make_train_step(model, opt)(params, opt.init(params), batch)


def test_two_layer_full_width_eval_through_k4_at_the_models_length(card):
    """The same at the model's 2 × 1 024 tokens, where K4 runs 16 chunks of
    64 steps: the loss through K4 equals the plain scan's within the
    float32 bound of the test above."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import mamba_scan
    from repro_torch.launch.steps import make_eval_step
    from repro_torch.models.model import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("falcon-mamba-7b").with_(
        n_layers=2, param_dtype="float32", compute_dtype="float32")
    params = Model(cfg).init(torch.Generator(device=card).manual_seed(1), card)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(2, 1024))
    batch = {"tokens": torch.as_tensor(toks, device=card)}
    launches = mamba_scan.stats["launches"]
    loss_k = float(make_eval_step(Model(cfg.with_(ssm_impl="pallas")))(params, batch)["loss"])
    assert mamba_scan.stats["launches"] - launches == 2
    loss_x = float(make_eval_step(Model(cfg.with_(ssm_impl="xla")))(params, batch)["loss"])
    assert np.isfinite(loss_k) and abs(loss_k - loss_x) <= 1e-4


#: A full-width MoE layer in float32 on the card against its CPU copy: the
#: router and the expert products are sums of 2 048 and 1 408 float32
#: terms in another order (cuBLAS without TF32 against the CPU's BLAS), a
#: few float32 ulps of outputs under 1 in size.
MOE_LAYER_TOL = 1e-4


def _moonshot_moe_layer(dev, dtype, seed=0):
    """One moonshot-v1-16b-a3b MoE layer at full width (64 experts, top 6,
    d 2 048, d_ff 1 408) and the prefill's 512 normed tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import moe_defs
    from repro_torch.models.params import init_params

    cfg = get_config("moonshot-v1-16b-a3b").with_(param_dtype=dtype, compute_dtype=dtype)
    p = init_params(moe_defs(cfg), torch.Generator(device=dev).manual_seed(seed), dtype, dev)
    x = torch.randn((1, 512, cfg.d_model), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev).to(getattr(torch, dtype))
    return cfg, p, x


def test_full_width_moe_layer_on_the_card_matches_its_cpu_copy(card):
    """Identical routing (expert ids and kept entries), outputs and aux
    within ``MOE_LAYER_TOL``, in float32."""
    from repro_torch.models import moe

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, p, x = _moonshot_moe_layer(card, "float32")
    pc, xc = {k: v.cpu() for k, v in p.items()}, x.cpu()
    with torch.no_grad():
        y, aux = moe.moe_block(p, x, cfg)
        yc, auxc = moe.moe_block(pc, xc, cfg)
        routes = [moe.route(q, z.reshape(-1, cfg.d_model), cfg)[2] for q, z in ((p, x), (pc, xc))]
    assert torch.equal(routes[0].cpu(), routes[1])
    cap = moe.capacity(cfg, 512)
    keeps = [moe.dispatch(r, cfg.n_experts, cap)[1].cpu() for r in routes]
    assert cap == 64 and torch.equal(keeps[0], keeps[1])
    assert float((y.cpu() - yc).abs().max()) <= MOE_LAYER_TOL
    assert abs(float(aux) - float(auxc)) <= MOE_LAYER_TOL


def test_moe_combine_on_the_card_is_bit_identical_across_runs(card):
    """bf16 at full width: two runs give the same bits (the combine is a
    loop over the k choices, with no atomics)."""
    from repro_torch.models import moe

    cfg, p, x = _moonshot_moe_layer(card, "bfloat16")
    with torch.no_grad():
        a, aux_a = moe.moe_block(p, x, cfg)
        b, aux_b = moe.moe_block(p, x, cfg)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    assert bool(torch.isfinite(a.float()).all())


def test_hybrid_admit_writes_only_its_slot_on_the_card(card):
    """jamba's smoke config on the card: admitting into slot 2 writes that
    slot's ``conv``, ``h``, ``k`` and ``v`` of every period and no other
    slot."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.models.params import flatten
    from repro_torch.serving import Request, ServeEngine

    model = Model(get_config("jamba-v0.1-52b", smoke=True).with_(remat=False))
    params = model.init(torch.Generator(device=card).manual_seed(0), card)
    eng = ServeEngine(model, params, 4, 64, device=card)
    rng = np.random.default_rng(0)
    for rid in range(2):
        assert eng.admit(Request(rid=rid, prompt=rng.integers(2, 256, size=8).astype(np.int32),
                                 max_new=4))
    before = {path: t.clone() for path, t in flatten(eng._caches)}
    assert eng.admit(Request(rid=2, prompt=rng.integers(2, 256, size=12).astype(np.int32),
                             max_new=4))
    kinds = set()
    for path, leaf in flatten(eng._caches):
        assert torch.equal(leaf[:, [0, 1, 3]], before[path][:, [0, 1, 3]]), path
        assert not torch.equal(leaf[:, 2], before[path][:, 2]), path
        kinds.add(path[-1])
    assert kinds == {"conv", "h", "k", "v"}


def test_whisper_decoder_prefill_through_k2_at_head_dim_64(card):
    """whisper-base at full width, float32: ``decode_full`` under
    ``attn_impl="pallas"`` launches K2 once per decoder layer (head dim 64)
    and its logits equal the plain path's to float32 rounding; the encoder
    launches nothing."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention
    from repro_torch.models import encdec as ed
    from repro_torch.models.model import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("whisper-base").with_(param_dtype="float32", compute_dtype="float32",
                                           attn_impl="pallas", remat=False)
    assert cfg.resolved_head_dim == 64
    params = Model(cfg).init(torch.Generator(device=card).manual_seed(0), card)
    toks = torch.as_tensor(np.random.default_rng(0).integers(2, cfg.vocab_size, size=(2, 128)),
                           device=card)
    frames = torch.randn((2, cfg.enc_seq, cfg.d_model), device=card,
                         generator=torch.Generator(device=card).manual_seed(1))
    with torch.no_grad():
        launches = flash_attention.stats["launches"]
        enc = ed.encode(params, frames, cfg)
        assert flash_attention.stats["launches"] == launches
        got, _ = ed.decode_full(params, toks, enc, cfg)
        assert flash_attention.stats["launches"] - launches == cfg.n_layers
        want, _ = ed.decode_full(params, toks, enc, cfg.with_(attn_impl="xla"))
    assert float((got - want).abs().max()) <= 1e-4


# -- the trainer's modules on the card -------------------------------------------------


def _raw(x):
    """``x`` on the CPU with its floats as same-width integers (bits)."""
    x = x.detach().cpu()
    if x.is_floating_point():
        x = x.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()])
    return x


def test_checkpoint_roundtrip_on_the_card(card, tmp_path):
    """bf16, float32 and int32 leaves on the card, params and AdamW state:
    the async save snapshots before it returns (the leaves change after),
    and restore puts every leaf back on the card, bit for bit."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.models.params import flatten
    from repro_torch.optim import AdamW

    params = Model(get_config("internvl2-1b", smoke=True)).init(
        torch.Generator(device=card).manual_seed(0), card)
    state = AdamW().init(params)
    state.m["embed"].add_(0.25)
    leaves = lambda p, s: ([t for _, t in flatten(p)] + [t for _, t in flatten(s.m)]  # noqa: E731
                           + [t for _, t in flatten(s.v)] + [s.count])
    want = [t.clone() for t in leaves(params, state)]
    ck = Checkpointer(tmp_path)
    ck.save(4, (params, state))
    for t in leaves(params, state):
        t.add_(1)
    ck.wait()
    step, (rp, rs) = ck.restore((params, state))
    assert step == 4
    for got, w in zip(leaves(rp, rs), want, strict=True):
        assert got.device.type == "cuda" and got.dtype == w.dtype
        assert torch.equal(_raw(got), _raw(w))


@pytest.mark.parametrize("n", [1, 1024, 3000, 1 << 20])
def test_grad_compression_on_the_card_matches_the_cpu(card, n):
    """Payloads, scales and residuals on the card equal the CPU's bit for
    bit: the scale divides by 127 as a true division there too."""
    from repro_torch.distributed.grad_compress import compress_with_feedback

    gen = torch.Generator(device=card).manual_seed(n)
    x = torch.randn((n,), generator=gen, device=card) * 1e-3
    if n > 1024:
        x[:1024] = 0.0
    r = torch.randn((n,), generator=gen, device=card) * 1e-6
    got = compress_with_feedback(x.bfloat16(), r)
    want = compress_with_feedback(x.bfloat16().cpu(), r.cpu())
    for g, w in zip(got, want, strict=True):
        assert g.device.type == "cuda"
        assert torch.equal(_raw(g), _raw(w))


def test_counted_k2_prefill_on_the_card_equals_its_meta_count(card):
    """A prefill through K2 counts on the card what it counts on ``meta``:
    the kernel region's formula stands for the kernel the dispatch mode
    cannot see, so FLOPs and bytes are functions of the shapes alone."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import cost, flash_attention
    from repro_torch.models.model import Model

    cfg = get_config("mistral-nemo-12b", smoke=True).with_(
        d_model=256, n_heads=4, n_kv_heads=2, head_dim=128, attn_impl="pallas")
    model = Model(cfg)
    params = model.init(torch.Generator(device=card).manual_seed(0), card)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 256))
    counts = {}
    for dev, p in ((card, params), (torch.device("meta"), model.abstract())):
        batch = {"tokens": torch.as_tensor(toks, device=dev)}
        before = flash_attention.stats["launches"]
        with cost.CostCounter(p, batch) as c, torch.no_grad():
            model.prefill(p, batch, 512)
        counts[dev.type] = (c.flops, c.bytes, c.regions, c.uncounted)
        if dev.type == "cuda":
            assert flash_attention.stats["launches"] - before == cfg.n_layers
    assert counts["cuda"] == counts["meta"]
    assert counts["cuda"][2]["flash_attention"][0] == cfg.n_layers
