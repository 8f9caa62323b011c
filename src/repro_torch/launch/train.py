"""Training launcher — the end-to-end entry point wiring every subsystem:

data pipeline (+ BASS shard placement) → eager train step → AdamW → async
checkpointing (Q3) → heartbeat supervision.

The model runs on ``--device`` (default ``cuda``; without a card the
launcher raises).  ``--device cpu`` runs it on the CPU, and the shard
placement's planning scans then run on the ``numpy`` backend; on the card
they run on the ``cuda`` backend, whose kernel (K1) the placement's
batched ``wave_scan`` launches.  ``--preset tiny`` is what the e2e
example exercises; ``--arch <assigned>`` selects any of the ten
architecture configs (pass ``--smoke`` for each arch's reduced variant).
``--resume`` restores the newest checkpoint of ``--ckpt-dir`` and goes on
from its step, with the same result as a run that was never stopped.

Example::

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --preset tiny --steps 20 --ckpt-dir /tmp/ck
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-32b --smoke --steps 20
"""
from __future__ import annotations

import argparse
import time
from typing import List, Tuple

import torch

from ..checkpoint import Checkpointer
from ..configs import ARCH_NAMES, get_config
from ..configs.base import ModelConfig
from ..core.tasks import Schedule
from ..core.topology import tpu_dcn_fabric
from ..data import DataConfig, FetchAssignment, SyntheticLM, plan_epoch, uniform_shards
from ..kernels import ts_plan
from ..models.model import Model
from ..optim import AdamW, warmup_cosine
from ..runtime import HeartbeatMonitor, ProgressTracker
from .mesh import make_smoke_mesh
from .steps import make_train_step

TINY = ModelConfig(
    name="tiny",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=384,
    vocab_size=512,
)

PRESET_100M = ModelConfig(
    name="lm-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    head_dim=64,
    d_ff=2048,
    vocab_size=32_768,
)


def build_cfg(args) -> ModelConfig:
    if args.arch:
        return get_config(args.arch, smoke=args.smoke)
    return {"tiny": TINY, "100m": PRESET_100M}[args.preset]


def epoch_placement() -> Tuple[List[str], List[FetchAssignment], Schedule]:
    """The trainer's BASS shard placement: 16 shards of 64 MB, two replicas
    each, on one pod of 4 idle hosts → (hosts, fetches, schedule).  Its 16
    tasks go to the planner as one batch, so on the ``cuda`` backend it
    launches the planning-scan kernel."""
    fabric = tpu_dcn_fabric(n_pods=1, hosts_per_pod=4)
    hosts = [f"pod0/host{i}" for i in range(4)]
    shards = uniform_shards(16, hosts, size_bytes=64e6, replication=2)
    assigns, plan = plan_epoch(fabric, hosts, {h: 0.0 for h in hosts}, shards)
    return hosts, assigns, plan


def main(argv=None) -> dict:
    """Parse ``argv``, train, print what the reference's launcher prints →
    the logged ``(step, value)`` losses and grad norms, tokens/s, host
    seconds per step, the step resumed from, the placement's fetches and
    ``ts_plan.device_stats()`` after it, the seconds each ``save`` held
    the loop and each write took, and the final params, optimizer state,
    step function, last batch and config."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="", choices=[""] + ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--preset", default="tiny", choices=["tiny", "100m"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = make_smoke_mesh(device=args.device).device
    if device.type == "cpu":
        ts_plan.set_backend("numpy")

    cfg = build_cfg(args)
    model = Model(cfg)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"family={cfg.family}", flush=True)

    # --- data + BASS shard placement (control plane) -------------------------
    dcfg = DataConfig(
        seq_len=args.seq,
        global_batch=args.batch,
        vocab_size=cfg.vocab_size,
        seed=args.seed,
        n_vision_tokens=cfg.n_vision_tokens,
        d_model=cfg.d_model,
        family=cfg.family,
        enc_seq=cfg.enc_seq,
    )
    source = SyntheticLM(dcfg)
    hosts, assigns, plan = epoch_placement()
    placement_stats = ts_plan.device_stats()
    local = sum(1 for a in assigns if a.source is None)
    print(f"BASS shard placement: {len(assigns)} shards, {local} local, "
          f"epoch ingest makespan {plan.makespan:.2f}s", flush=True)

    # --- model/optimizer state ------------------------------------------------
    params = model.init(torch.Generator(device=device).manual_seed(args.seed), device)
    opt = AdamW(lr=warmup_cosine(args.lr, max(args.steps // 20, 5), args.steps))
    opt_state = opt.init(params)
    step0 = 0

    ckpt = None
    if args.ckpt_dir:
        ckpt = Checkpointer(args.ckpt_dir)
        if args.resume and ckpt.latest_step() is not None:
            step0, (params, opt_state) = ckpt.restore((params, opt_state))
            print(f"resumed from step {step0}", flush=True)

    # params and opt_state are updated in place, as the reference's jitted
    # step donates them: a step holds one copy of each.
    train_step = make_train_step(model, opt, accum=args.accum, donate=True)

    # --- supervision ------------------------------------------------------------
    monitor = HeartbeatMonitor(hosts, grace_s=60.0)
    tracker = ProgressTracker()

    losses, norms, step_s, save_s = [], [], [], []
    t0 = time.time()
    tokens_done = 0
    batch = None
    for step in range(step0, args.steps):
        t_step = time.perf_counter()
        batch = {k: torch.as_tensor(v, device=device) for k, v in source.batch(step).items()}
        if "vision_embeds" in batch:
            batch["vision_embeds"] = batch["vision_embeds"].to(torch.bfloat16)
        if "frames" in batch:
            batch["frames"] = batch["frames"].to(torch.bfloat16)
        params, opt_state, metrics = train_step(params, opt_state, batch)
        for h in hosts:
            monitor.beat(h)
        tokens_done += args.batch * args.seq
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            gn = float(metrics["grad_norm"])
            losses.append((step, loss))
            norms.append((step, gn))
            tps = tokens_done / max(time.time() - t0, 1e-6)
            print(
                f"step {step:5d} loss {loss:8.4f} gnorm {gn:7.3f} "
                f"tok/s {tps:9.0f}",
                flush=True,
            )
        step_s.append(time.perf_counter() - t_step)
        if ckpt is not None and (step + 1) % args.ckpt_every == 0:
            t_save = time.perf_counter()
            ckpt.save(step + 1, (params, opt_state))
            save_s.append(time.perf_counter() - t_save)
    if device.type == "cuda":     # the steps' work done, not only enqueued
        torch.cuda.synchronize(device)
    tokens_s = tokens_done / max(time.time() - t0, 1e-6)
    if ckpt is not None:
        t_save = time.perf_counter()
        ckpt.save(args.steps, (params, opt_state), blocking=True)
        save_s.append(time.perf_counter() - t_save)
    print("done.", flush=True)
    return dict(losses=losses, grad_norms=norms, tokens_s=tokens_s, step_s=step_s,
                resumed_from=step0, assignments=assigns, device_stats=placement_stats,
                save_s=save_s, write_s=list(ckpt.write_s) if ckpt is not None else [],
                params=params, opt_state=opt_state, train_step=train_step, batch=batch,
                cfg=cfg)


if __name__ == "__main__":
    main()
