"""The benchmark on the CPU at small sizes: BENCHMARK.json against the
contract, the frozen FLOP and byte counts against hand-worked values, the
wave generator, both drivers and the last line, the reference against the
program, the control and the planted faults against the check, and the
check that a run loads no JAX.  Nothing here needs the card: the drivers
run on the CPU with the kernels' plain versions."""
import copy
import importlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.harness import bench, flops, weights
from portbench.reference import data, dense

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SERVE, TRAIN = "nemo12b.longdoc", "internvl2-1b.train"


@pytest.fixture(scope="module")
def spec():
    return bench.load_json(ROOT / "BENCHMARK.json")


@pytest.fixture(autouse=True)
def one_thread():
    """Smoke-sized steps are too small to split, and a shared host's
    workers would contend for every core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def smoke(spec, name, **traffic):
    """The cell ``name`` cut to a CPU's size: its configuration at smoke
    widths (2 layers, width 64, vocabulary 256; a VLM prefix of 8), the
    traffic's other settings as given."""
    _, conf, tr, limits = bench.cell(name, spec)
    conf = copy.deepcopy(conf)
    conf["config"].update(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                          num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                          vocab_size=256)
    conf["port"].update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                        d_ff=128, vocab_size=256)
    if "num_image_token" in conf.get("assumed", {}):
        conf["assumed"] = dict(conf["assumed"], num_image_token=8, head_dim=16)
        conf["port"]["n_vision_tokens"] = 8
    tr = dict(tr, **traffic)
    return conf, tr, limits


SERVE_SMOKE = dict(slots=4, prompt_lengths=[16, 32, 16], check_requests=64)
TRAIN_SMOKE = dict(rows=4, seq=32)
#: Limits at the smoke size, set as the cells' are: above the program's
#: readings here (max_logit_gap at most 3e-3; grad_norm_leaf 4e-4,
#: grad_diff_leaf 6e-3, change_leaf 9e-4, loss 3.5e-5), below the control's
#: (max_logit_gap at least 0.015; grad_diff_leaf 0.06) and a state left
#: unchanged (loss at least 3.8e-4).
SMOKE_LIMITS = {SERVE: {"max_logit_gap": 5e-3, "failed_requests": 0, "weights_changed": 0},
                TRAIN: {"grad_norm_leaf": 2e-3, "grad_diff_leaf": 0.02, "change_leaf": 3e-3,
                        "loss": 1.5e-4, "window_loss_not_finite": 0}}


def make_run(conf, tr, limits, name, seed=2**33 + 5, seconds=2.0):
    return bench.Run(workload=name, conf=conf, traffic=tr, limits=limits, seed=seed,
                     seconds=seconds, trace=False, device="cpu", t_process0=time.perf_counter())


def execute(spec, name, seed=2**33 + 5, **traffic):
    conf, tr, _ = smoke(spec, name, **traffic)
    run = make_run(conf, tr, {"checks": SMOKE_LIMITS[name]}, name, seed)
    return run, bench.execute(run, tr["driver"], spec)


# -- BENCHMARK.json ------------------------------------------------------------------

def test_benchmark_json_keeps_the_contract(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["portbench"] and spec["command"][1] == "portbench/run.py"
    assert 1 <= spec["run_seconds"] <= 51
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    names = [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]]
    names += [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in spec["configs"]:
        conf = bench.load_json(ROOT / c["file"])
        assert c["file"].startswith("portbench/") and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
    for w in spec["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        entry, conf, tr, limits = bench.cell(w["name"], spec)
        assert (HERE / "drivers" / f"{tr['driver']}.py").is_file()
        reported = {m["name"] for m in bench.metric_names(spec, w["name"], False)}
        layers = bench.metric_names(spec, w["name"], True)
        assert "setup_s" in reported and len(reported) >= 2 and layers
        assert all(m["moves"] in reported for m in layers)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]


# -- the yardstick's arithmetic ------------------------------------------------------

def test_flops_against_hand_worked_counts():
    nemo = dense.Dims.of(bench.load_json(HERE / "configs" / "mistral-nemo-12b.json"))
    # q, k, v: 5120 x (32 + 8 + 8) x 128; o: 32 x 128 x 5120; MLP 3 x 5120 x 14336
    assert flops.layer_params(nemo) == 31_457_280 + 20_971_520 + 220_200_960
    # 2 048 positions: 2 x 2048 x 40 x 272 629 760, attention 40 x 4 x 32 x 128 x
    # (2048 x 2049 / 2), the head at one position 2 x 5120 x 131072
    assert flops.prefill_flops(nemo, 2048) == (44_667_659_878_400 + 1_375_060_623_360
                                                + 1_342_177_280)
    # K2 at 8 192: 4 x 32 x 128 x 33 558 528 FLOPs against 2 x 8192 x 128 x 80 bytes
    assert flops.attention_bound_s(nemo, 8192) == pytest.approx(549_822_922_752 / 989e12)
    assert flops.attention_bound_s(nemo, 16) == pytest.approx(327_680 / 3.35e12)
    vlm = dense.Dims.of(bench.load_json(HERE / "configs" / "internvl2-1b.json"))
    assert vlm.n_prefix == 256 and vlm.head_dim == 64 and vlm.tied
    # layer 896 x 18 x 64 + 14 x 64 x 896 + 3 x 896 x 4864 = 14 909 440; 8 rows of
    # 1024: 6 x 8192 x 24 x layer, the head 6 x 8 x 767 x 896 x 151655, attention
    # 3 x 24 x 4 x 8 x 14 x 64 x 524 800
    assert flops.layer_params(vlm) == 14_909_440
    assert flops.train_step_flops(vlm, 8, 1024) == (17_587_891_077_120 + 5_002_664_110_080
                                                     + 1_083_388_723_200)


def test_weights_are_the_seeds_and_the_programs_layout():
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    dims = dense.Dims.of({"config": dict(hidden_size=64, intermediate_size=128,
                                         num_hidden_layers=2, num_attention_heads=4,
                                         num_key_value_heads=2, head_dim=16, vocab_size=256,
                                         rope_theta=1e6, rms_norm_eps=1e-5)})
    spec = dense.param_spec(dims)
    a, flat_a = weights.make(spec, 2**40 + 3, torch.device("cpu"))
    b, flat_b = weights.make(spec, 2**40 + 3, torch.device("cpu"))
    c, flat_c = weights.make(spec, 2**40 + 4, torch.device("cpu"))
    assert torch.equal(flat_a, flat_b) and not torch.equal(flat_a, flat_c)
    assert weights.fingerprint(flat_a) == weights.fingerprint(flat_b)
    assert float(flat_a.float().std()) == pytest.approx(0.02, rel=0.05)
    cfg = get_config("mistral-nemo-12b", smoke=True).with_(d_ff=128)
    weights.check_layout(a, Model(cfg).abstract())
    with pytest.raises(ValueError):
        weights.check_layout(a, Model(cfg.with_(d_ff=96)).abstract())


# -- traffic and drivers -------------------------------------------------------------

def test_waves_refill_every_slot_with_one_length_and_the_seed_draws_only_tokens(spec):
    run, out = execute(spec, SERVE, **SERVE_SMOKE)
    slots, lengths = SERVE_SMOKE["slots"], SERVE_SMOKE["prompt_lengths"]
    waves = {}
    for r in run.requests:
        waves.setdefault(r["wave"], []).append(r)
    assert sorted(waves) == list(range(len(waves)))
    for w, recs in waves.items():     # the wave in flight at the window's end too
        assert {len(r["req"].prompt) for r in recs} == {lengths[w % len(lengths)]}
        assert len({r["due"] for r in recs}) == 1
        assert sorted(r["rid"] for r in recs) == list(range(w * slots, (w + 1) * slots))
    from portbench.drivers.serve_waves import prompt, sample

    picked = sample(run, slots)
    assert {r["slot"] for r in picked} == set(range(slots)) and len(picked) == slots
    assert max(r["n"] for r in picked) == max(lengths)
    assert len(sample(run, slots + 3)) == slots + 3
    assert np.array_equal(prompt(5, 3, 16, 256), prompt(5, 3, 16, 256))
    assert not np.array_equal(prompt(5, 3, 16, 256), prompt(6, 3, 16, 256))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] == len(run.requests)


@pytest.mark.parametrize("name", [SERVE, TRAIN])
def test_a_run_prints_the_contracts_last_line(spec, name, capsys):
    traffic = SERVE_SMOKE if name == SERVE else TRAIN_SMOKE
    run, out = execute(spec, name, **traffic)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] is True and out["attempted"] > 0
    wanted = {m["name"] for m in bench.metric_names(spec, name, False)}
    assert set(out["metrics"]) == wanted
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert set(out["checks"]) == set(SMOKE_LIMITS[name])
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    json.dumps(out)


def test_per_layer_readers_read_a_run_or_nothing(spec):
    run, _ = execute(spec, SERVE, **SERVE_SMOKE)
    got = {m["name"]: bench.read_metric(m["name"], run)
           for m in bench.metric_names(spec, SERVE, True)}
    # host spans read on any device; the device's share, trace and memory only on the card
    assert got["router.route_ms"] > 0 and got["engine.admit_ms"] > 0
    assert got["engine.tick_ms"] is None or got["engine.tick_ms"] > 0
    assert all(got[k] is None for k in ("prefill.mfu", "k2.roofline", "device.idle.serve",
                                        "device.mem_gib.serve"))


def test_data_copy_is_the_programs_stream():
    from repro_torch.data import DataConfig, SyntheticLM

    src = SyntheticLM(DataConfig(seq_len=64, global_batch=3, vocab_size=500, seed=2**34 + 1,
                                 n_vision_tokens=16, d_model=8, family="vlm"))
    for step in (0, 5):
        got, want = data.batch(2**34 + 1, step, 3, 64, 500, 16, 8), src.batch(step)
        assert np.array_equal(got["tokens"], want["tokens"])
        assert np.array_equal(got["prefix"], want["vision_embeds"])


# -- the reference, the control and the faults -----------------------------------------

def test_reference_serves_the_programs_logits_in_float32():
    """The program in float32 (prefill, then ticks through its cache)
    against the reference's whole-sequence logits."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    dims = dense.Dims.of({"config": dict(hidden_size=64, intermediate_size=128,
                                         num_hidden_layers=2, num_attention_heads=4,
                                         num_key_value_heads=2, head_dim=16, vocab_size=256,
                                         rope_theta=1e6, rms_norm_eps=1e-5)})
    cfg = get_config("mistral-nemo-12b", smoke=True).with_(
        d_ff=128, norm_eps=1e-5, param_dtype="float32", compute_dtype="float32")
    params, _ = weights.make(dense.param_spec(dims), 11, torch.device("cpu"), torch.float32)
    model = Model(cfg)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(2, 256, size=20))
    logits, caches = model.prefill(params, {"tokens": tokens[None, :16]}, 32)
    got = [logits[0]]
    for pos in range(16, 20):
        lg, caches = model.decode(params, tokens[None, pos:pos + 1], pos, caches)
        got.append(lg[0])
    want = dense.serve_logits(params, dims, [tokens], 5)[0]
    assert torch.allclose(torch.stack(got), want, atol=1e-4)
    low = dense.serve_logits(params, dims, [tokens], 5, mm=dense.mm_fp8)[0]
    assert float((low - want).abs().max()) > 100 * float((torch.stack(got) - want).abs().max())


def test_reference_trains_as_the_program_does_in_float32():
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import Model
    from portbench.drivers import train_steps

    conf = {"config": dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                           vocab_size=256, rope_theta=1e6, rms_norm_eps=1e-6,
                           tie_word_embeddings=True),
            "assumed": {"num_image_token": 8}}
    dims = dense.Dims.of(conf)
    opt = dict(lr=3e-3, warmup=5, total=100, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
               grad_clip=1.0)
    cfg = get_config("internvl2-1b", smoke=True).with_(
        d_ff=128, param_dtype="float32", compute_dtype="float32")
    params, _ = weights.make(dense.param_spec(dims), 3, torch.device("cpu"), torch.float32)
    start = copy.deepcopy(params)
    step = make_train_step(Model(cfg), train_steps.optimizer(opt), accum=2, donate=True)
    state = train_steps.optimizer(opt).init(params)
    batches = [{k: torch.as_tensor(v) for k, v in data.batch(3, s, 4, 24, 256, 8, 64).items()}
               for s in range(3)]
    losses = []
    for b in batches:
        params, state, m = step(params, state, {"tokens": b["tokens"],
                                                "vision_embeds": b["prefix"]})
        losses.append(float(m["loss"]))
    ref = dense.train_reference(start, dims, batches, opt, 2, param_dtype=torch.float32)
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    for p, t in ref["params"].items():
        assert torch.allclose(dense.leaf(params, p), t, atol=1e-5), p


def test_control_reads_above_the_program(spec):
    """At the smoke size, as at the cells' (``control.py`` on the card):
    the float8 control reads at least three times what the program does
    on every number it fails."""
    from portbench import control

    for name, traffic in ((SERVE, SERVE_SMOKE), (TRAIN, TRAIN_SMOKE)):
        conf, tr, limits = smoke(spec, name, **traffic)
        driver = importlib.import_module(f"portbench.drivers.{tr['driver']}")
        for seed in (1, 2):
            run = make_run(conf, tr, limits, name, seed, seconds=0.3)
            run.dims = dense.Dims.of(conf)
            driver.run(run)
            fn = control.serve_readings if name == SERVE else control.train_readings
            got = fn(run, driver, dense)
            assert bench.judge(got["program"], {k: v for k, v in SMOKE_LIMITS[name].items()
                                                if k in got["program"]})
            assert not bench.judge(got["control"], {k: v for k, v in SMOKE_LIMITS[name].items()
                                                    if k in got["control"]})


def _planted(monkeypatch, spec, name, fault):
    """A run of ``name`` with ``fault`` planted in the program."""
    fault(monkeypatch)
    traffic = SERVE_SMOKE if name == SERVE else TRAIN_SMOKE
    return execute(spec, name, **traffic)[1]


def _alter_token(monkeypatch):
    from repro_torch.serving import engine

    tick = engine.ServeEngine.tick

    def wrong(self):
        done = tick(self)
        for req in list(self.active.values()) + done:
            req.tokens_out[-1] = (req.tokens_out[-1] + 1) % self.cfg.vocab_size
        return done

    monkeypatch.setattr(engine.ServeEngine, "tick", wrong)


def _unchanged_state(monkeypatch):
    from repro_torch.launch import steps

    make = steps.make_train_step

    def frozen(*a, **k):
        real = make(*a, **k)

        def step(params, state, batch):
            metrics = real(copy.deepcopy(params), copy.deepcopy(state), batch)[2]
            return params, state, metrics
        return step

    monkeypatch.setattr(steps, "make_train_step", frozen)


def _half_batch(monkeypatch):
    from repro_torch.models.model import Model

    loss = Model.loss

    def half(self, params, batch):
        return loss(self, params, {k: v[: v.shape[0] // 2] for k, v in batch.items()})

    monkeypatch.setattr(Model, "loss", half)


@pytest.mark.parametrize("name,fault", [(SERVE, _alter_token), (TRAIN, _unchanged_state),
                                        (TRAIN, _half_batch)],
                         ids=["token_altered", "state_unchanged", "half_batch"])
def test_a_planted_fault_makes_the_run_incorrect(monkeypatch, spec, name, fault):
    out = _planted(monkeypatch, spec, name, fault)
    assert out["correct"] is False, out["checks"]


# -- processes -------------------------------------------------------------------------

def test_a_run_loads_no_jax_and_refuses_without_a_card(tmp_path):
    """The drivers' and the program's modules load neither JAX nor the JAX
    package (compared by whole top-level name), and ``run.py`` without a
    card exits non-zero and prints no result."""
    code = ("import sys; sys.path[:0] = ['src', '.']\n"
            "import portbench.drivers.serve_waves, portbench.drivers.train_steps\n"
            "import repro_torch.serving, repro_torch.launch.steps, repro_torch.data, "
            "repro_torch.optim, repro_torch.kernels.flash_attention\n"
            "from portbench.harness import bench\n"
            "assert bench.forbidden_modules() == [], bench.forbidden_modules()\n"
            "sys.modules['repro.core'] = sys.modules['repro_torch']\n"
            "assert bench.forbidden_modules() == ['repro']\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a card is here: run.py would run")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", SERVE, "--seed",
                          "3", "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0 and res.stdout == ""
