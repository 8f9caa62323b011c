"""The port's serving path against the JAX package's, on the CPU.

Engine: greedy tokens identical to the reference engine's on the same
parameters (converted with ``params_from_jax``), with both attention
paths.  Router: decisions, counters and ledger identical to the reference
router's on the streams of ``tests/test_serving.py``, with the planning
scan on ``numpy``.  Launcher: ``launch/serve.py`` runs on the CPU.  The
models' own parity tests are ``tests/test_torch_models.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch.train import TINY as REF_TINY
from repro.models.model import Model as RefModel
from repro.serving import BassRouter as RefRouter
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefEngine
from repro.serving.kvcache import gather_pages as ref_gather_pages
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import flash_attention, ts_plan
from repro_torch.launch import serve as serve_launch
from repro_torch.launch.serve import TINY
from repro_torch.models.model import Model
from repro_torch.serving import BassRouter, Request, ServeEngine
from repro_torch.serving.kvcache import gather_pages

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
#: The MoE, hybrid and encoder-decoder families.
NEW_FAMILIES = ["moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b",
                "whisper-base"]


@pytest.fixture(autouse=True)
def numpy_backend():
    prev = ts_plan.get_backend()
    ts_plan.set_backend("numpy")
    yield
    ts_plan.set_backend(prev)


def _configs(arch, **kw):
    if arch == "tiny":
        return TINY.with_(**kw), REF_TINY.with_(**kw)
    return get_config(arch, smoke=True).with_(**kw), ref_get_config(arch, smoke=True).with_(**kw)


def _pair(arch, dtype="float32", impl="xla", seed=0):
    """(port model, its params, reference model, its params) on the same
    parameters."""
    cfg, ref_cfg = _configs(arch, param_dtype=dtype, compute_dtype=dtype,
                            attn_impl=impl, remat=False)
    ref_model = RefModel(ref_cfg)
    jp = ref_model.init(jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return Model(cfg), tp, ref_model, jp


def _f32(x):
    return np.asarray(x.float().numpy() if torch.is_tensor(x) else jnp.asarray(x, jnp.float32))


def test_tiny_is_the_reference_preset():
    assert dataclasses.asdict(TINY) == dataclasses.asdict(REF_TINY)


# -- engine ----------------------------------------------------------------------------


def _serve(engine_cls, model, params, reqs, **kw):
    eng = engine_cls(model, params, slots=2, s_max=64, **kw)
    pending, done = list(reqs), []
    while pending or eng.active:
        while pending and eng.has_capacity():
            assert eng.admit(pending.pop(0))
        done += eng.tick()
    return {r.rid: list(r.tokens_out) for r in done}


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_engine_greedy_tokens_match_reference(impl):
    _engine_matches_reference("mistral-nemo-12b", impl)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_engine_greedy_tokens_match_reference_for_each_family(arch, impl):
    _engine_matches_reference(arch, impl)


def _engine_matches_reference(arch, impl):
    model, tp, ref_model, jp = _pair(arch, "float32", impl, seed=1)
    lens, news = (8, 13, 5), (6, 4, 7)

    def reqs(cls):
        r = np.random.default_rng(7)
        return [cls(rid=i, prompt=r.integers(2, 256, size=n).astype(np.int32), max_new=m)
                for i, (n, m) in enumerate(zip(lens, news))]

    launches = flash_attention.stats["launches"]
    got = _serve(ServeEngine, model, tp, reqs(Request), device="cpu")
    want = _serve(RefEngine, ref_model, jp, reqs(RefRequest))
    assert got == want
    assert all(len(got[i]) == m for i, m in enumerate(news))
    assert flash_attention.stats["launches"] == launches  # CPU: plain version


def test_engine_respects_capacity():
    cfg = TINY.with_(param_dtype="float32", compute_dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    eng = ServeEngine(model, params, slots=1, s_max=64, device="cpu")
    rng = np.random.default_rng(1)
    r1 = Request(rid=0, prompt=rng.integers(2, 500, size=8).astype(np.int32), max_new=3)
    r2 = Request(rid=1, prompt=rng.integers(2, 500, size=8).astype(np.int32), max_new=3)
    assert eng.admit(r1)
    assert not eng.admit(r2)
    while not r1.done:
        eng.tick()
    assert eng.admit(r2)
    assert len(r1.tokens_out) == 3


def test_launcher_serves_on_the_cpu(capsys):
    serve_launch.main(["--device", "cpu", "--requests", "3", "--max-new", "3",
                       "--prompt-len", "8", "--s-max", "32"])
    out = capsys.readouterr().out
    assert out.count("finished on") == 3
    assert "served 3 requests / 9 tokens" in out


def _to_jax(tree):
    """The reference's parameter tree from the port's, bit for bit (the
    inverse of ``params_from_jax``)."""
    import ml_dtypes

    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if tree.dtype == torch.bfloat16:
        return jnp.asarray(tree.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
    return jnp.asarray(tree.numpy())


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_launcher_serves_each_family_like_the_reference_engine(arch, capsys):
    """``launch/serve.py --device cpu --arch`` (smoke size, bfloat16) serves
    every request, and the reference's engines and router, driven the same
    way on the launcher's parameters, give the same greedy tokens."""
    got = serve_launch.main(["--device", "cpu", "--arch", arch, "--requests", "4",
                             "--max-new", "4", "--prompt-len", "8", "--s-max", "32",
                             "--slots", "2"])
    out = capsys.readouterr().out
    assert out.count("finished on") == 4 and "served 4 requests / 16 tokens" in out
    ref_model = RefModel(ref_get_config(arch, smoke=True).with_(remat=False))
    jp = _to_jax(got["params"])
    names = [f"pod0/host{i}" for i in range(2)]
    engines = {n: RefEngine(ref_model, jp, 2, 32, name=n) for n in names}
    reqs = [RefRequest(rid=r.rid, prompt=r.prompt, max_new=r.max_new,
                       prefix_hash=r.prefix_hash) for r in got["requests"]]
    serve_launch.drive(engines, RefRouter(names), reqs, log=None)
    assert {r.rid: r.tokens_out for r in got["requests"]} == {r.rid: r.tokens_out for r in reqs}


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "whisper-base"])
def test_admit_writes_only_its_slot_of_nested_caches(arch):
    """Admitting into slot 2 writes that slot of every cache leaf (the
    hybrid's ``slot{s}`` ``conv``, ``h``, ``k``, ``v``; the encoder-decoder's
    ``k``, ``v``, ``ek``, ``ev``) with the request's own prefill caches,
    and changes no other slot."""
    from repro_torch.models.params import flatten

    model, tp, _, _ = _pair(arch)
    eng = ServeEngine(model, tp, slots=4, s_max=32, device="cpu")
    rng = np.random.default_rng(9)
    for rid in range(2):
        assert eng.admit(Request(rid=rid, prompt=rng.integers(2, 256, size=6).astype(np.int32),
                                 max_new=4))
    before = {p: t.clone() for p, t in flatten(eng._caches)}
    prompt = rng.integers(2, 256, size=10).astype(np.int32)
    assert eng.admit(Request(rid=2, prompt=prompt, max_new=4)) and 2 in eng.active
    batch = {"tokens": torch.as_tensor(prompt[None]).long()}
    if model.cfg.family == "encdec":
        batch["frames"] = torch.zeros((1, model.cfg.enc_seq, model.cfg.d_model),
                                      dtype=torch.bfloat16)
    with torch.no_grad():
        _, single = model.prefill(tp, batch, 32)
    single = dict(flatten(single))
    kinds = set()
    for path, leaf in flatten(eng._caches):
        others = [i for i in range(4) if i != 2]
        assert torch.equal(leaf[:, others], before[path][:, others]), path
        assert torch.equal(leaf[:, 2:3], single[path].to(leaf.dtype)), path
        assert not torch.equal(leaf[:, 2], before[path][:, 2]), path
        kinds.add(path[-1])
    assert kinds == ({"conv", "h", "k", "v"} if arch == "jamba-v0.1-52b"
                     else {"k", "v", "ek", "ev"})


def test_drive_reports_prefills_and_ticks():
    cfg = TINY
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    engines = {n: ServeEngine(model, params, 1, 32, name=n, device="cpu") for n in ("a", "b")}
    reqs = serve_launch.make_requests(cfg, 3, 6, 2, seed=0)
    out = serve_launch.drive(engines, BassRouter(list(engines)), reqs, log=None)
    assert len(out["prefill_s"]) == 3  # one request waited for a free slot
    assert len(out["tick_s"]) >= 2 and out["seconds"] > 0
    assert all(len(r.tokens_out) == 2 for r in reqs)


# -- router ------------------------------------------------------------------------------


def _decision(d):
    return (d.rid, d.replica, d.migrated_from, float(d.ready_at).hex(), tuple(d.slots),
            d.degraded, d.rejected)


def _counters(router):
    return {k: v for k, v in router.controller.obs.snapshot()["counters"].items()
            if k.startswith(("router.", "tenant."))}


def _tenants(mod):
    return [mod.TenantSpec("free", weight=1.0, rate=2.0, burst=2.0),
            mod.TenantSpec("pro", weight=4.0)]


def _stream_sticky(router_cls, req_cls, _qos):
    r = router_cls(["r0", "r1"], decode_s_per_token=0.001, bytes_per_ctx_token=2e6)
    p = np.arange(4096, dtype=np.int32)
    return r, [r.route(req_cls(rid=i, prompt=p, max_new=8, prefix_hash=7)) for i in range(2)]


def _stream_backlog(router_cls, req_cls, _qos):
    r = router_cls(["r0", "r1"], decode_s_per_token=0.5)
    p = np.arange(512, dtype=np.int32)
    out = [r.route(req_cls(rid=0, prompt=p, max_new=4, prefix_hash=3))]
    r.update_backlog({out[0].replica: 1000.0})
    r.update_backlog({[x for x in r.replicas if x != out[0].replica][0]: 0.0})
    out.append(r.route(req_cls(rid=1, prompt=p, max_new=4, prefix_hash=3)))
    return r, out


def _stream_minnow(router_cls, req_cls, _qos):
    r = router_cls(["r0", "r1", "r2"])
    r.update_backlog({"r0": 50.0, "r1": 0.5, "r2": 90.0})
    return r, [r.route(req_cls(rid=0, prompt=np.arange(8, dtype=np.int32), max_new=2,
                               prefix_hash=999))]


def _tenant_router(router_cls, qos):
    return router_cls(["r0", "r1"], decode_s_per_token=0.001, bytes_per_ctx_token=2e6,
                      tenants=_tenants(qos), fairness_slack_s=0.05)


def _req(req_cls, rid, prefix_hash=0, tokens=8, max_new=100):
    return req_cls(rid=rid, prompt=np.zeros(tokens, dtype=np.int32), max_new=max_new,
                   prefix_hash=prefix_hash)


def _stream_tenants(router_cls, req_cls, qos):
    r = _tenant_router(router_cls, qos)
    out = [r.route(_req(req_cls, i), now=0.0, tenant="free") for i in range(4)]
    r.tenants.charge("free", 1.0)
    out.append(r.route(_req(req_cls, 4, prefix_hash=7), now=0.0, tenant="free"))
    out.append(r.route(_req(req_cls, 5, prefix_hash=7), now=0.0, tenant="pro"))
    r.tenants.charge("pro", 50.0)
    out.append(r.route(_req(req_cls, 6), now=1.0, tenant="free"))
    return r, out


def _stream_churn(router_cls, req_cls, qos):
    r = _tenant_router(router_cls, qos)
    r.fail_link("nic0")
    out = [r.route(_req(req_cls, i), now=float(i), tenant="pro") for i in range(2)]
    r.fail_link("nic1")
    out.append(r.route(_req(req_cls, 2), now=2.0, tenant="pro"))
    r.recover_link("nic0")
    r.recover_link("nic1")
    out.append(r.route(_req(req_cls, 3), now=3.0, tenant="pro"))
    return r, out


def _stream_fleet(router_cls, req_cls, topo):
    fab = topo.tpu_dcn_fabric(n_pods=2, hosts_per_pod=2)
    r = router_cls(topo.storage_hosts(fab), fabric=fab, decode_s_per_token=0.001,
                   bytes_per_ctx_token=2e6)
    rng = np.random.default_rng(5)
    out = []
    for i in range(40):
        req = _req(req_cls, i, prefix_hash=int(rng.integers(0, 4)),
                   tokens=int(rng.integers(4, 64)), max_new=int(rng.integers(10, 400)))
        r.update_backlog({rep: float(rng.uniform(0.0, 0.2)) for rep in r.replicas})
        out.append(r.route(req, now=i * 0.01))
    return r, out


@pytest.mark.parametrize("stream", [_stream_sticky, _stream_backlog, _stream_minnow,
                                    _stream_tenants, _stream_churn, _stream_fleet],
                         ids=lambda f: f.__name__[len("_stream_"):])
def test_router_decisions_match_reference(stream):
    import repro.core.qos as ref_qos
    import repro.core.topology as ref_topo
    import repro_torch.core.qos as qos
    import repro_torch.core.topology as topo

    fleet = stream is _stream_fleet
    r, got = stream(BassRouter, Request, topo if fleet else qos)
    ref_r, want = stream(RefRouter, RefRequest, ref_topo if fleet else ref_qos)
    assert [_decision(d) for d in got] == [_decision(d) for d in want]
    assert _counters(r) == _counters(ref_r)
    assert np.array_equal(r.ledger.reserved, ref_r.ledger.reserved)
    assert r.backlog == ref_r.backlog and r.prefix_home == ref_r.prefix_home


def test_router_rejects_tenant_without_config():
    r = BassRouter(["r0", "r1"])
    with pytest.raises(ValueError):
        r.route(_req(Request, 0), tenant="free")


# -- paged KV cache -------------------------------------------------------------------------


def test_gather_pages_matches_reference():
    rng = np.random.default_rng(2)
    pool = rng.standard_normal((6, 4, 2, 8)).astype(np.float32)
    table = np.array([3, 0, -1, 5], dtype=np.int32)
    want = np.asarray(ref_gather_pages(jnp.asarray(pool), jnp.asarray(table)))
    got = gather_pages(torch.as_tensor(pool), table)
    assert np.array_equal(got.numpy(), want)
