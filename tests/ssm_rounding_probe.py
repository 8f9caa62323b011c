"""Probe of the sharded SSM's bf16 arithmetic (not a test; needs a card).

``chip_smoke.py`` phase 15 (b) holds the ranks' bf16 eval of falcon-mamba-7b
through K4 against one rank's time loop.  This script shows where the two
part, on one card and in one process: the eval loss of phase 15's 2 × 1 024
tokens at full width and depth, from the phase's seeded parameters, for
each of these arithmetics of the stack:

- ``loop``, ``k4``: the one-rank model (``Model.loss``) through the time
  loop, and through K4;
- ``f32``: float32 throughout, each layer's weights upcast as it runs (the
  time loop);
- ``ranks``: the (1, 4) rank mesh's arithmetic, emulated: each mamba layer
  cut into 4 blocks of ``d_inner`` as the ranks hold them, ``w_in_x`` and
  ``w_in_z`` as 4 column blocks, the conv, ``dt_proj`` and K4 on each block,
  ``w_dt``/``w_b``/``w_c``'s and ``w_out``'s float32 partial products summed
  over the blocks and rounded once (``models/ssm.py``'s ``mamba/dtbc`` and
  ``mamba/out``), the tied head as 4 blocks of the vocabulary;
- ``ranks_dtbc``, ``ranks_out``, ``ranks_in``, ``ranks_head``: ``ranks`` with
  one of those products computed as one rank computes it (one bf16 product
  over every channel, or every column), so that each one's share of the
  ranks' distance shows.

Each loss is printed beside its distance from ``loop`` and from ``f32``,
for ``--batches`` batches of tokens (the first is phase 15's).

    PYTHONPATH=src python tests/ssm_rounding_probe.py [--layers N] [--out FILE]

(``--device cpu --smoke`` is a dry run at smoke width, K4's plain version
in place of the kernel.)
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.layers import rms_norm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.ssm import _causal_depthwise_conv  # noqa: E402

SEED = 0                  # chip_smoke.py's
BLOCKS = 4                # the (1, 4) rank mesh's model axis
VARIANTS = ("ranks", "ranks_dtbc", "ranks_out", "ranks_in", "ranks_head")


def _layer(p, x, cfg, whole):
    """One mamba layer's output (before the residual add) by the ranks'
    arithmetic, except the products named in ``whole``."""
    d_in, n = cfg.d_inner, cfg.ssm_state
    blk = d_in // BLOCKS
    cols = [slice(i * blk, (i + 1) * blk) for i in range(BLOCKS)]
    if "in" in whole:
        xp_all, z_all = x @ p["w_in_x"], x @ p["w_in_z"]
        xps = [xp_all[..., c] for c in cols]
        zs = [z_all[..., c] for c in cols]
    else:
        xps = [x @ p["w_in_x"][:, c] for c in cols]
        zs = [x @ p["w_in_z"][:, c] for c in cols]
    xcs = [F.silu(_causal_depthwise_conv(xp, p["conv_w"][c], p["conv_b"][c]).float())
           .to(x.dtype) for xp, c in zip(xps, cols)]
    w = torch.cat([p["w_dt"], p["w_b"], p["w_c"]], -1)
    if "dtbc" in whole:
        dtbc = torch.cat(xcs, -1) @ w
    else:
        dtbc = sum(xc.float() @ w[c].float() for xc, c in zip(xcs, cols)).to(x.dtype)
    low, b_mat, c_mat = dtbc.split([w.shape[-1] - 2 * n, n, n], -1)
    ys = []
    for xc, z, c in zip(xcs, zs, cols):
        dt = F.softplus((low @ p["dt_proj"][:, c]).float() + p["dt_bias"][c].float())
        a = -torch.exp(p["a_log"][c].float())
        y = ops.mamba_scan(xc.float(), dt, a, b_mat.float(), c_mat.float())
        y = y + p["d_skip"][c].float() * xc.float()
        ys.append((y * F.silu(z.float())).to(x.dtype))
    if "out" in whole:
        return torch.cat(ys, -1) @ p["w_out"]
    return sum(y.float() @ p["w_out"][c].float() for y, c in zip(ys, cols)).to(x.dtype)


def ranks_loss(cfg, params, tokens, whole=()):
    """The eval loss by the emulated ranks' arithmetic (module docstring)."""
    x = params["embed"][tokens].to(torch.bfloat16)
    for li in range(cfg.n_layers):
        lp = tf._index_tree(params["stack"], li)
        x = x + _layer(lp["mamba"], rms_norm(x, lp["ln1"], cfg.norm_eps), cfg, whole)
    h = rms_norm(x, params["ln_f"], cfg.norm_eps)
    emb = params["embed"]
    if "head" in whole:
        logits = (h @ emb.T).float()
    else:
        v = emb.shape[0] // BLOCKS
        logits = torch.cat([(h @ emb[i * v:(i + 1) * v].T).float() for i in range(BLOCKS)], -1)
    pred, tgt = logits[:, :-1], tokens[:, 1:]
    nll = torch.logsumexp(pred, -1) - torch.gather(pred, -1, tgt[..., None])[..., 0]
    return float(nll.mean())


def f32_loss(cfg, params, tokens):
    """The eval loss in float32 throughout, each layer upcast as it runs."""
    cfg32 = cfg.with_(param_dtype="float32", compute_dtype="float32", ssm_impl="xla")
    model = Model(cfg32)
    def up(t):
        return {k: up(v) for k, v in t.items()} if isinstance(t, dict) else t.float()

    x = params["embed"][tokens].float()
    for li in range(cfg.n_layers):
        x, _, _ = tf._apply_layer_full(up(tf._index_tree(params["stack"], li)), x, cfg32, None,
                                       "mamba", "none", False)
    logits = model._head(up({"ln_f": params["ln_f"], "embed": params["embed"]}), x)
    pred, tgt = logits[:, :-1], tokens[:, 1:]
    return float((torch.logsumexp(pred, -1)
                  - torch.gather(pred, -1, tgt[..., None])[..., 0]).mean())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=0, help="depth (default: the config's)")
    ap.add_argument("--out", default=None, help="also write the result as JSON here")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true", help="the config's smoke width")
    ap.add_argument("--batches", type=int, default=3,
                    help="token batches of 2 × 1 024, the first phase 15's")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("ssm_rounding_probe: no card (--device cpu --smoke for a dry run)")
    cfg = get_config("falcon-mamba-7b", smoke=args.smoke)
    if args.layers:
        cfg = cfg.with_(n_layers=args.layers)
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(SEED), dev)
    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    out, t0 = dict(layers=cfg.n_layers, blocks=BLOCKS, device=name, batches=[]), \
        time.perf_counter()
    rng = np.random.default_rng(SEED + 15)   # its first draw: phase 15's eval tokens
    for _ in range(args.batches):
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 1024)), device=dev)
        res = {}
        with torch.no_grad():
            res["loop"] = float(Model(cfg).loss(params, {"tokens": tokens})[0])
            res["k4"] = float(Model(cfg.with_(ssm_impl="pallas")).loss(
                params, {"tokens": tokens})[0])
            res["f32"] = f32_loss(cfg, params, tokens)
            for v in VARIANTS:
                res[v] = ranks_loss(cfg, params, tokens,
                                    () if v == "ranks" else (v.split("_")[1],))
            res["ranks_all_whole"] = ranks_loss(cfg, params, tokens,
                                                ("in", "dtbc", "out", "head"))
        res["from_loop"] = {k: res[k] - res["loop"] for k in ("k4", "f32", "ranks_all_whole")
                            + VARIANTS}
        res["from_f32"] = {k: res[k] - res["f32"] for k in ("loop", "k4") + VARIANTS}
        out["batches"].append(res)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out, indent=1))
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
