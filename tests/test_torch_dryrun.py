"""The port's cost accounting against the JAX package's, on the CPU.

``launch/dryrun.py::policy_rules`` bit for bit the reference's for every
cell, mesh and policy (and the reference's ``tests/test_policy.py`` cases
on the port); ``launch/hlo_analysis.py``'s copied formulas exactly the
reference's for every cell, and ``roofline_terms`` at a test-only chip
record with the reference's TPU v5e numbers equal to the reference's;
``kernels/cost.py``'s count of a step on ``meta`` against the reference's
``accounting_lowering(...).cost_analysis()`` plus its mamba addendum at
smoke width, one arch per family × {train, prefill, decode}: FLOPs within
±5 %, bytes no more than twice XLA's and no less than a quarter of them
(XLA's unoptimized module writes and reads every reshape, per-layer
slice, broadcast and the intermediates of softmax, GELU and the norms,
which torch's views and fused kernels do not move; the ratios are in
``PERF.md`` §6); ``argument_gib`` (and the outputs and aliases) against
XLA's ``memory_analysis()`` on an 8-device mesh; the mamba stand-in on
``meta`` keeping the train step's graph (the same count as on the CPU); each kernel
region the same on the CPU and ``meta`` and equal to the counter's count
of the plain version; and the CLI.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro.launch.dryrun as ref_dryrun
import repro_torch.launch.dryrun as dryrun
from repro.configs import get_config as ref_get_config
from repro.configs.base import ALL_SHAPES as REF_SHAPES
from repro.configs.base import ShapeSpec as RefShapeSpec
from repro.launch import hlo_analysis as ref_hlo
from repro_torch.configs import DECODE_32K, PREFILL_32K, TRAIN_4K, all_cells, get_config
from repro_torch.configs.base import ALL_SHAPES, ShapeSpec
from repro_torch.kernels import cost, ops, ref
from repro_torch.launch import hlo_analysis as hlo
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import Model
from repro_torch.optim import AdamW

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
CELLS = [(a, s.name) for a, s in all_cells()]
SHAPE = {s.name: s for s in ALL_SHAPES}
REF_SHAPE = {s.name: s for s in REF_SHAPES}
FLOPS_RTOL = 0.05                 # the counter's FLOPs against XLA's
BYTES_BELOW, BYTES_ABOVE = 4, 2   # XLA's bytes / 4 ≤ the counter's ≤ 2 × XLA's


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


SINGLE = FakeMesh({"data": 16, "model": 16})
MULTI = FakeMesh({"pod": 2, "data": 16, "model": 16})


def _smoke(monkeypatch):
    """Both packages' dry runs at each arch's smoke width."""
    monkeypatch.setattr(ref_dryrun, "get_config", lambda a, smoke=False: ref_get_config(a, True))
    monkeypatch.setattr(dryrun, "get_config", lambda a, smoke=False: get_config(a, True))


# -- policy_rules ---------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["baseline", "opt"])
@pytest.mark.parametrize("mesh", [SINGLE, MULTI], ids=["single", "multi"])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_policy_rules_match_reference(arch, shape, mesh, policy):
    cfg, pr, act = dryrun.policy_rules(arch, SHAPE[shape], mesh, policy)
    rcfg, rpr, ract = ref_dryrun.policy_rules(arch, REF_SHAPE[shape], mesh, policy)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert pr == rpr and act == ract
    assert dryrun.SMALL_MODEL_PARAMS == ref_dryrun.SMALL_MODEL_PARAMS


def test_baseline_rules_have_no_opt_axes():
    cfg, pr, act = dryrun.policy_rules("qwen3-32b", TRAIN_4K, SINGLE, "baseline")
    assert "heads" not in act and "d_ff" not in act
    assert "megatron_blocks" not in act
    assert cfg.moe_impl == "gather"


def test_opt_train_gets_megatron_rules():
    cfg, pr, act = dryrun.policy_rules("qwen3-32b", TRAIN_4K, SINGLE, "opt")
    assert act.get("heads") == "model"
    assert act.get("d_ff") == "model"
    assert act.get("megatron_blocks") is True


def test_opt_prefill_keeps_baseline_sharding():
    cfg, pr, act = dryrun.policy_rules("qwen3-32b", PREFILL_32K, SINGLE, "opt")
    assert "heads" not in act and "megatron_blocks" not in act


def test_opt_moe_gets_a2a_everywhere():
    for shape in (TRAIN_4K, PREFILL_32K):
        cfg, _, _ = dryrun.policy_rules("moonshot-v1-16b-a3b", shape, SINGLE, "opt")
        assert cfg.moe_impl == "a2a"


def test_opt_small_model_pure_dp():
    assert get_config("whisper-base").param_count() < dryrun.SMALL_MODEL_PARAMS
    cfg, pr, act = dryrun.policy_rules("whisper-base", TRAIN_4K, SINGLE, "opt")
    assert isinstance(act["batch"], list)
    assert pr == {}


def test_internvl2_above_small_threshold():
    assert get_config("internvl2-1b").param_count() > dryrun.SMALL_MODEL_PARAMS
    _, pr, act = dryrun.policy_rules("internvl2-1b", TRAIN_4K, SINGLE, "opt")
    assert pr is None and not isinstance(act["batch"], list)


def test_multipod_batch_axes():
    _, _, act = dryrun.policy_rules("qwen3-32b", TRAIN_4K, MULTI, "baseline")
    assert act["batch"] == ("pod", "data")
    _, _, act = dryrun.policy_rules("qwen3-32b", DECODE_32K, MULTI, "baseline")
    assert act["batch"] == ("pod", "data")


# -- hlo_analysis's copied formulas --------------------------------------------------------

KINDS = ["all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute"]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_copied_formulas_equal_reference(arch, shape):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    s, rs = SHAPE[shape], REF_SHAPE[shape]
    assert hlo.model_flops_estimate(cfg, s) == ref_hlo.model_flops_estimate(rcfg, rs)
    assert hlo.ssm_scan_addendum(cfg, s) == ref_hlo.ssm_scan_addendum(rcfg, rs)
    assert hlo.ssm_scan_addendum(cfg, s, 8) == ref_hlo.ssm_scan_addendum(rcfg, rs, 8)
    rb = int(cfg.param_count())
    for kind in KINDS:
        for g in (1, 2, 16, 256, 512):
            assert hlo._wire_bytes(kind, rb, g) == ref_hlo._wire_bytes(kind, rb, g)


#: A chip record for the tests only: the reference's TPU v5e constants.
V5E = hlo.Chip(name="TPU v5e (reference constants, tests only)",
               peak_bf16_flop_s=ref_hlo.PEAK_FLOPS, hbm_bytes_s=ref_hlo.HBM_BW,
               link_bytes_s=ref_hlo.ICI_BW, dcn_bytes_s=ref_hlo.DCN_BW,
               peak_f32_flop_s=0.0, peak_f64_flop_s=0.0)


def _reports(seed):
    rng = np.random.default_rng(seed)
    ops_ = [(str(rng.choice(KINDS)), int(rng.integers(1, 1 << 30)), int(rng.choice([2, 16, 512])),
             int(rng.integers(1, 9)), bool(rng.integers(0, 2))) for _ in range(12)]
    out = []
    for mod in (hlo, ref_hlo):
        rep = mod.CollectiveReport()
        for kind, rb, g, trips, dcn in ops_:
            rep.ops.append(mod.Collective(kind, rb, g, trips, mod._wire_bytes(kind, rb, g),
                                          "scan_layers/while/body", dcn))
        out.append(rep)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_roofline_terms_equal_reference_at_v5e(seed):
    rng = np.random.default_rng(100 + seed)
    flops, nbytes, mf = (float(x) for x in rng.uniform(1e12, 1e18, 3))
    chips = int(rng.choice([1, 256, 512]))
    port_rep, ref_rep = _reports(seed)
    assert port_rep.by_kind() == ref_rep.by_kind() and port_rep.count() == ref_rep.count()
    got = hlo.roofline_terms(flops, nbytes, port_rep, chips, mf, chip=V5E).to_dict()
    want = ref_hlo.roofline_terms(flops, nbytes, ref_rep, chips, mf).to_dict()
    assert got == want


def test_h100_record_is_keyed_by_its_smi_name():
    assert hlo.chip_named("NVIDIA H100 80GB HBM3") is hlo.H100_SXM
    assert hlo.H100_SXM.peak_bf16_flop_s == 989e12 and hlo.H100_SXM.hbm_bytes_s == 3.35e12
    with pytest.raises(KeyError):
        hlo.chip_named("NVIDIA A100-SXM4-80GB")


# -- the counter against XLA's cost analysis ------------------------------------------------

FAMILIES = ["mistral-nemo-12b", "internvl2-1b", "moonshot-v1-16b-a3b", "jamba-v0.1-52b",
            "falcon-mamba-7b", "whisper-base"]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_counter_matches_xla_cost_analysis(monkeypatch, arch, kind):
    _smoke(monkeypatch)
    lowered, rcfg = ref_dryrun.accounting_lowering(arch, RefShapeSpec("smoke", kind, 64, 4))
    ca = lowered.cost_analysis()
    add_f, add_b = ref_hlo.ssm_scan_addendum(rcfg, RefShapeSpec("smoke", kind, 64, 4))
    want_f, want_b = ca["flops"] + add_f, ca["bytes accessed"] + add_b
    got = dryrun.accounting(arch, ShapeSpec("smoke", kind, 64, 4))
    assert abs(got["flops"] / want_f - 1) <= FLOPS_RTOL, (got["flops"], want_f)
    assert want_b / BYTES_BELOW <= got["bytes"] <= BYTES_ABOVE * want_b, (got["bytes"], want_b)
    assert not got["uncounted"], got["uncounted"]


# -- memory per device against XLA's memory analysis -----------------------------------------

XLA_MEMORY = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, jax
    import repro.launch.dryrun as rd
    from repro.configs import get_config
    from repro.configs.base import ShapeSpec
    from repro.distributed.actctx import activation_sharding
    from repro.launch.mesh import _make_mesh

    rd.get_config = lambda a, smoke=False: get_config(a, True)
    mesh = _make_mesh((2, 2, 2), ("pod", "data", "model"))
    out = {}
    for arch in ("mistral-nemo-12b", "internvl2-1b"):
        shape = ShapeSpec("smoke", "train", 32, 64)
        fn, args, _trips, _cfg = rd.build_cell(arch, shape, mesh)
        _, _, act = rd.policy_rules(arch, shape, mesh, "baseline")
        with mesh, activation_sharding(mesh, act):
            mem = fn.lower(*args).compile().memory_analysis()
        out[arch] = [mem.argument_size_in_bytes, mem.output_size_in_bytes,
                     mem.alias_size_in_bytes]
    print(json.dumps(out))
    """
)


def test_argument_bytes_equal_xla_memory_analysis(monkeypatch):
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", XLA_MEMORY], capture_output=True, text=True,
                         env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    _smoke(monkeypatch)
    mesh = Mesh(("pod", "data", "model"), (2, 2, 2))
    for arch, (args_b, out_b, alias_b) in want.items():
        cell = dryrun.build_cell(arch, ShapeSpec("smoke", "train", 32, 64), mesh)
        mem = dryrun.memory_per_device(cell, mesh)
        assert mem["argument"] == args_b
        # XLA's output buffer is a tuple: 8 bytes of its index table per output
        assert mem["output"] + 8 * len(list(dryrun._leaves(cell["outs"]))) == out_b
        assert mem["alias"] == alias_b


# -- the mamba stand-in and the kernel regions ----------------------------------------------

def _train_count(cfg, device):
    model = Model(cfg)
    params = model.abstract() if device == "meta" else model.init(
        torch.Generator().manual_seed(0), "cpu")
    opt = AdamW()
    state = opt.init(params)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 32))
    batch = {"tokens": torch.as_tensor(toks, device=device)}
    with cost.CostCounter(params, state, batch) as c:
        make_train_step(model, opt)(params, state, batch)
    return c.result()


@pytest.mark.parametrize("remat", [True, False])
def test_ssm_stand_in_keeps_the_graph(remat):
    """On a 2-layer falcon-mamba, the train step counts the same on
    ``meta`` (the stand-in, no time loop) as on the CPU (the loop): outside
    the scan regions op by op, and the regions' formulas alike; the
    backward's region is there, so the graph reached below the scan."""
    cfg = get_config("falcon-mamba-7b", smoke=True).with_(n_layers=2, remat=remat)
    meta, cpu = _train_count(cfg, "meta"), _train_count(cfg, "cpu")
    outside = lambda r: (r["flops"] - sum(v["flops"] for v in r["regions"].values()),  # noqa: E731
                         r["bytes"] - sum(v["bytes"] for v in r["regions"].values()))
    assert outside(meta) == outside(cpu)
    assert meta["regions"] == cpu["regions"]
    assert meta["regions"]["ssm_scan_backward"]["calls"] == cfg.n_layers
    assert meta["regions"]["ssm_scan"]["calls"] == cfg.n_layers * (2 if remat else 1)
    assert (meta["flops"], meta["bytes"]) == (cpu["flops"], cpu["bytes"])
    assert not meta["uncounted"]


def test_ssm_stand_in_without_graph_would_cut_the_count(monkeypatch):
    """The trap the stand-in avoids: a stand-in with no ``grad_fn`` loses
    the backward of every layer below it."""
    from repro_torch.models import ssm

    cfg = get_config("falcon-mamba-7b", smoke=True).with_(n_layers=2, remat=False)
    want = _train_count(cfg, "meta")["flops"]
    monkeypatch.setattr(ssm._MetaScan, "apply", staticmethod(
        lambda x, dt, a, b, c, h: (torch.empty_like(x).detach(), torch.empty_like(h).detach())))
    assert _train_count(cfg, "meta")["flops"] < want


ATTN = [(1, 4, 2, 64, 16, True, torch.bfloat16), (2, 8, 8, 128, 32, True, torch.float32),
        (2, 4, 1, 32, 64, False, torch.bfloat16), (1, 6, 3, 128, 128, False, torch.float32)]


def _bshd(rng, b, s, h, hd, dtype, device):
    return torch.as_tensor(rng.standard_normal((b, s, h, hd)), dtype=torch.float32).to(
        device=device, dtype=dtype)


@pytest.mark.parametrize("b,nq,nkv,s,hd,causal,dtype", ATTN)
def test_flash_attention_region_equals_plain_count(b, nq, nkv, s, hd, causal, dtype):
    rng = np.random.default_rng(s + hd)
    counts = {}
    for device in ("cpu", "meta"):
        q, k, v = (_bshd(rng, b, s, n, hd, dtype, device) for n in (nq, nkv, nkv))
        with cost.CostCounter() as c:
            out = ops.flash_attention(q, k, v, causal=causal)
        assert out.shape == q.shape and out.device.type == device
        counts[device] = (c.flops, c.bytes, c.regions, c.by_op)
    assert counts["cpu"] == counts["meta"]
    assert counts["cpu"][3] == {}    # nothing counted beside the region
    q, k, v = (_bshd(rng, b, s, n, hd, dtype, "cpu").transpose(1, 2).contiguous()
               for n in (nq, nkv, nkv))
    with cost.CostCounter() as c:
        ref.attention_ref(q, k, v, causal=causal)
    assert (c.flops, c.bytes) == counts["cpu"][:2]


@pytest.mark.parametrize("b,nq,nkv,s,hd,pos,dtype", [(2, 4, 2, 64, 16, 37, torch.bfloat16),
                                                     (3, 6, 3, 128, 64, 127, torch.float32)])
def test_flash_decode_region_equals_plain_count(b, nq, nkv, s, hd, pos, dtype):
    rng = np.random.default_rng(pos)
    counts = {}
    for device in ("cpu", "meta"):
        q = _bshd(rng, b, 1, nq, hd, dtype, device)
        k, v = (_bshd(rng, b, s, nkv, hd, dtype, device) for _ in range(2))
        with cost.CostCounter() as c:
            out = ops.flash_decode(q, k, v, pos)
        assert out.shape == q.shape
        counts[device] = (c.flops, c.bytes, c.regions, c.by_op)
    assert counts["cpu"] == counts["meta"] and counts["cpu"][3] == {}
    q = _bshd(rng, b, 1, nq, hd, dtype, "cpu").transpose(1, 2).contiguous()
    k, v = (_bshd(rng, b, s, nkv, hd, dtype, "cpu").transpose(1, 2).contiguous()
            for _ in range(2))
    with cost.CostCounter() as c:
        ref.decode_ref(q, k, v, pos)
    assert (c.flops, c.bytes) == counts["cpu"][:2]


def test_mamba_scan_region_is_the_addendums_share():
    b, s, d_in, n = 2, 64, 32, 4
    rng = np.random.default_rng(7)
    counts = {}
    for device in ("cpu", "meta"):
        mk = lambda *shape: torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,  # noqa: E731
                                            device=device)
        inputs = (mk(b, s, d_in), mk(b, s, d_in).abs(), -mk(d_in, n).abs(), mk(b, s, n),
                  mk(b, s, n))
        with cost.CostCounter() as c:
            y = ops.mamba_scan(*inputs)
        assert y.shape == (b, s, d_in)
        counts[device] = (c.flops, c.bytes, c.regions, c.by_op)
    assert counts["cpu"] == counts["meta"] and counts["cpu"][3] == {}
    # ssm_scan_addendum's forward share of one layer at these shapes
    cfg = get_config("falcon-mamba-7b", smoke=True).with_(n_layers=1, d_model=d_in // 2,
                                                          ssm_state=n)
    want = hlo.ssm_scan_addendum(cfg, ShapeSpec("p", "prefill", s, b))
    assert counts["cpu"][:2] == want


def test_region_is_a_shared_null_context_without_a_counter():
    assert not cost.active()
    assert cost.region("x", 1, 2) is cost.region("y", 3, 4)
    assert cost.formula_region("x", lambda: 1 / 0) is cost.region("y", 3, 4)
    with cost.region("x", 1, 2):
        pass
    with cost.CostCounter() as c:
        with cost.formula_region("k", lambda n: (2 * n, 3 * n), 5):
            with cost.region("inner", 7, 7):   # inside a region: adds nothing
                torch.ones(3) * 2            # and no op is counted
    assert (c.flops, c.bytes, c.by_op) == (10, 15, {})
    assert c.result()["regions"] == {"k": dict(calls=1, flops=10, bytes=15)}


def test_live_peak_counts_arguments_and_frees():
    x = torch.empty(1 << 18, device="meta")            # 1 MiB
    with cost.CostCounter(x) as c:
        y = x * 2                                      # x, y live
        del y
        z = (x + 1) * 3                                # x, x + 1, z live at once
    assert c.argument_bytes == 1 << 20
    assert c.live_peak_bytes == 3 << 20
    assert c.flops == 3 * (1 << 18) and c.bytes == 6 << 20
    del z


# -- the CLI ----------------------------------------------------------------------------

def test_cli_writes_an_ok_record_without_jax(tmp_path):
    env = {**os.environ, "PYTHONPATH": SRC}
    code = ("import sys, runpy; sys.argv = ['dryrun', '--arch', 'whisper-base', '--shape', "
            f"'decode_32k', '--mesh', 'single', '--out', {str(tmp_path)!r}]; "
            "runpy.run_module('repro_torch.launch.dryrun', run_name='__main__'); "
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "1 ok, 0 failed" in res.stdout
    rec = json.loads((tmp_path / "whisper-base__decode_32k__pod256.json").read_text())
    assert rec["ok"] and rec["chip"] == "NVIDIA H100 80GB HBM3"
    coll = rec["collectives"]
    assert set(coll) == {"count", "by_kind_wire_bytes", "wire_bytes_ici", "wire_bytes_dcn"}
    assert coll["count"] > 0 and coll["wire_bytes_ici"] > 0 and coll["wire_bytes_dcn"] == 0
    assert rec["roofline"]["chips"] == 256
    assert rec["roofline"]["wire_bytes_ici"] == coll["wire_bytes_ici"]
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["accounting"]["flops_global"] > rec["accounting"]["model_flops"] > 0
    mem = rec["memory"]
    assert mem["peak_gib"] > mem["temp_gib"] > 0 and "temp_gib_one_device" not in mem
