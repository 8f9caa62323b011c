"""Probe of the sharded hybrid's float32 arithmetic (not a test; needs a card).

``chip_smoke.py`` phase 17 (a) holds the (1, 4) ranks' float32 prefill of
jamba-v0.1-52b (one period, 8 layers) against one rank's.  The ranks sum
several products over blocks of a contracted dimension: each mamba slot's
``w_dt``/``w_b``/``w_c`` (``mamba/dtbc``) and ``w_out`` (``mamba/out``)
over ``d_inner``, each MLP slot's down projection over ``d_ff``
(``mlp/out``), the attention slot's output projection over its heads
(``attn/out``).  This script shows how far such a reordering alone moves
one rank's own logits: on one card, in one process, the prefill of phase
17's 2 × 512 tokens from the phase's seeded parameters, with one kind of
those products (and then all of them) computed as 4 blocks summed in order,
each block's product in float32, against the same model computing each
product whole.

    PYTHONPATH=src python tests/hybrid_rounding_probe.py [--out FILE]

(``--device cpu --smoke`` is a dry run at smoke width.)  It prints one JSON
object: the largest |logit|, and for each kind the largest and the median
distance of the prefill's last-position logits from the whole products'.
"""
import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import make_requests  # noqa: E402
from repro_torch.models import attention, ssm, transformer  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

SEED = 0          # chip_smoke.py's
BLOCKS = 4        # the (1, 4) rank mesh's model axis


def _blocks(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over ``x``'s last dimension as BLOCKS products summed in
    order."""
    k = x.shape[-1] // BLOCKS
    out = x[..., :k] @ w[:k]
    for i in range(1, BLOCKS):
        out = out + x[..., i * k:(i + 1) * k] @ w[i * k:(i + 1) * k]
    return out


def _ssm_inputs(p, x, cfg, lay=None):
    xc = F.silu(x.float()).to(x.dtype)
    w = torch.cat([p["w_dt"], p["w_b"], p["w_c"]], -1)
    low, b_mat, c_mat = _blocks(xc, w).split([w.shape[-1] - 2 * cfg.ssm_state,
                                              cfg.ssm_state, cfg.ssm_state], -1)
    dt = F.softplus((low @ p["dt_proj"]).float() + p["dt_bias"].float())
    return xc, dt, b_mat.float(), c_mat.float()


def _ssm_out(y, w_out, lay, split):
    return _blocks(y, w_out)


def _mlp(p, x, cfg, lay=None):
    h = F.silu((x @ p["w_gate"]).float()).to(x.dtype) * (x @ p["w_up"])
    return _blocks(h, p["w_down"])


def _attn_out(out, w):
    n, h, d = w.shape
    return _blocks(out.reshape(*out.shape[:-2], n * h), w.reshape(n * h, d))


#: kind → (module, attribute, the blocked stand-in)
KINDS = {"mamba/dtbc": (ssm, "_ssm_inputs", _ssm_inputs),
         "mamba/out": (ssm, "_out_proj", _ssm_out),
         "mlp/out": (transformer, "mlp_block", _mlp),
         "attn/out": (attention, "_out_proj", _attn_out)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the result as JSON here")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true", help="the config's smoke width")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cfg = get_config("jamba-v0.1-52b", smoke=args.smoke).with_(
        n_layers=8, param_dtype="float32", compute_dtype="float32", remat=False,
        attn_impl="pallas", ssm_impl="pallas")
    if cfg.mlp_kind != "swiglu":
        raise SystemExit("the MLP stand-in is swiglu's")
    prompts = np.stack([r.prompt for r in make_requests(cfg, 2, 512, 1, SEED)])
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    tok = torch.as_tensor(prompts, device=dev).long()

    def logits():
        with torch.no_grad():
            return model.prefill(params, {"tokens": tok}, 1024)[0].float()

    whole = logits()
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "max_abs_logit": float(whole.abs().max()),
           "repeat": float((logits() - whole).abs().max())}
    for kinds in [[k] for k in KINDS] + [list(KINDS)]:
        saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in (KINDS[k] for k in kinds)]
        for k in kinds:
            mod, attr, fn = KINDS[k]
            setattr(mod, attr, fn)
        try:
            d = (logits() - whole).abs()
        finally:
            for mod, attr, fn in saved:
                setattr(mod, attr, fn)
        out[kinds[0] if len(kinds) == 1 else "all"] = dict(max=float(d.max()),
                                                            median=float(d.median()))
    print(json.dumps(out))
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
