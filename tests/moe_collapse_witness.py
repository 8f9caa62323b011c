"""Witness for the MoE routing collapse at full width with random weights.

Runs moonshot-v1-16b-a3b at its full width (d_model 2 048, 64 experts,
top-6, capacity factor 1.25), cut to ``--layers`` layers, in bfloat16 on
the CPU, on one 512-token prompt (the card's serve prompt length, one
prefill as the engine runs it: capacity 64), through three parameter sets:

- ``reference``: the JAX package on its own initialisation;
- ``port_on_reference_weights``: the PyTorch package on the same weights
  (``params_from_jax``);
- ``port_init``: the PyTorch package on its own seeded initialisation, the
  one the card's smoke run serves.

For each it prints, by layer, the share of (token, choice) entries dropped
beyond capacity, and the share of entries routed to the 6 most loaded
experts (6/64 = 0.094 when the load is even).  Between the first two it
prints the share of expert ids that differ.  Needs both packages, like the
tests; about 12 GB of memory at 4 layers.

    PYTHONPATH=src python tests/moe_collapse_witness.py [--layers 4] [--out FILE]
"""
import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.models import moe as ref_moe
from repro.models.model import Model as RefModel
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import make_requests
from repro_torch.models import moe
from repro_torch.models.model import Model

ARCH, PROMPT_LEN, SEED = "moonshot-v1-16b-a3b", 512, 0


def _stats(gate_idx, n_experts, cap):
    """(dropped share, share routed to the 6 most loaded experts) of one
    call's [T, k] expert ids."""
    counts = np.bincount(np.asarray(gate_idx).reshape(-1), minlength=n_experts)
    dropped = np.maximum(counts - cap, 0).sum() / counts.sum()
    return float(dropped), float(np.sort(counts)[-6:].sum() / counts.sum())


def _summary(calls, cfg):
    cap = moe.capacity(cfg, PROMPT_LEN)
    per_layer = [_stats(g, cfg.n_experts, cap) for g in calls]
    return dict(drop_by_layer=[d for d, _ in per_layer],
                top6_load_by_layer=[t for _, t in per_layer])


def _reference(cfg_kw, prompt):
    ref_model = RefModel(ref_get_config(ARCH).with_(**cfg_kw))
    calls = []
    gather = ref_moe._moe_block_gather

    def recording_gather(p, x, cfg):
        xt = x.reshape(-1, cfg.d_model)
        probs = jax.nn.softmax(
            jnp.einsum("td,de->te", xt, p["router"]).astype(jnp.float32), axis=-1)
        jax.debug.callback(lambda i: calls.append(np.asarray(i)),
                           jax.lax.top_k(probs, cfg.top_k)[1], ordered=True)
        return gather(p, x, cfg)

    ref_moe._moe_block_gather = recording_gather
    try:
        jp = ref_model.init(jax.random.PRNGKey(SEED))
        logits, _ = ref_model.prefill(jp, {"tokens": jnp.asarray(prompt[None])}, PROMPT_LEN)
        jax.block_until_ready(logits)
    finally:
        ref_moe._moe_block_gather = gather
    return jp, calls, np.asarray(logits, np.float32)


def _port(cfg, params, prompt):
    with torch.no_grad(), moe.recording() as rec:
        logits, _ = Model(cfg).prefill(
            params, {"tokens": torch.as_tensor(prompt[None]).long()}, PROMPT_LEN)
    return [r["gate_idx"].numpy() for r in rec], logits.float().numpy()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    cfg_kw = dict(n_layers=args.layers, attn_impl="xla", remat=False)
    cfg = get_config(ARCH).with_(**cfg_kw)
    prompt = make_requests(cfg, 1, PROMPT_LEN, 1, SEED)[0].prompt
    t0 = time.perf_counter()
    out = dict(arch=ARCH, layers=args.layers, d_model=cfg.d_model, n_experts=cfg.n_experts,
               top_k=cfg.top_k, capacity=moe.capacity(cfg, PROMPT_LEN), tokens=PROMPT_LEN,
               dtype=cfg.compute_dtype)

    jp, ref_calls, ref_logits = _reference(cfg_kw, prompt)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    del jp
    port_calls, port_logits = _port(cfg, tp, prompt)
    del tp
    assert len(ref_calls) == len(port_calls) == args.layers
    out["reference"] = _summary(ref_calls, cfg)
    out["port_on_reference_weights"] = _summary(port_calls, cfg)
    out["expert_ids_differing_by_layer"] = [
        float((a != b).mean()) for a, b in zip(ref_calls, port_calls)]
    out["logits_max_abs_diff"] = float(np.abs(ref_logits - port_logits).max())

    own = Model(cfg).init(torch.Generator().manual_seed(SEED), "cpu")
    out["port_init"] = _summary(_port(cfg, own, prompt)[0], cfg)
    out["seconds"] = time.perf_counter() - t0
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
