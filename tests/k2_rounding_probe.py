"""Probe of K2's bf16 rounding of P (not a test; needs a card).

K2's tensor-core path rounds each key tile's probabilities P to bf16
before P.V.  ``tests/test_torch_cuda.py`` holds it against the design
oracle ``ref.attention_ref(..., p_dtype=torch.bfloat16, p_block=64)``.
This script shows, for the card cases of that test, where the kernel and
such an oracle part, and why.

1. For every bf16 case of ``FLASH_CASES_CARD`` (the test's inputs, from
   its seed), the test's measure ``max(|got - want| - rtol |want|)``
   against three oracles that round P by the same rule and differ only in
   the arithmetic before the rounding: ``float32`` (float32 scores over
   sqrt(hd), ``exp``), ``exact`` (the same in float64, P rounded from
   float64: ``ref.attention_ref``'s design form, which the script checks
   it equals) and ``kernel`` (float32 raw scores, the running max kept in
   the scaled log2 domain, the exponent ``fma(x, scale log2 e, -m)``
   rounded once to float32, ``exp2``).
2. At the element where the ``float32`` oracle and the kernel part most,
   for a query row inside the first key tile, the kernel's own bf16 P of
   each live key, read back by a second launch on the same q and k with a
   crafted v: v[j] = e_j, less c_d on the max key's row, so that output
   column d is (P_d as the kernel rounded it - c_d) / l, c_d that
   oracle's rounding: 0 where they agree, one bf16 step over l where they
   do not.  Beside it, each oracle's P before its rounding and the
   distance of the exact P from the bf16 rounding boundary.

    PYTHONPATH=src python tests/k2_rounding_probe.py [--out FILE] [--device cpu]
"""
import argparse
import json
import math
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_cuda import DESIGN_TOL, FLASH_CASES_CARD, _normal  # noqa: E402

from repro_torch.kernels import flash_attention, ops, ref  # noqa: E402

BF = torch.bfloat16
TILE = flash_attention.KEY_TILE_BF16


def oracle(q, k, v, causal, mode):
    """[B, S, nq, hd] output of the design rule under ``mode`` (float32 of
    bf16), and P before its rounding (float64), [B, nkv, g, Sq, Sk]."""
    b, sq, nq, hd = q.shape
    nkv, sk = k.shape[2], k.shape[1]
    dt = torch.float64 if mode == "exact" else torch.float32
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    qg = qt.reshape(b, nkv, nq // nkv, sq, hd).to(dt)
    s = torch.einsum("bkgqh,bksh->bkgqs", qg, kt.to(dt))
    if mode == "kernel":   # raw float32 scores times f32(scale log2 e), exact in float64
        sl2 = np.float32(np.float32(flash_attention.scale_f32(hd)) * np.float32(ref.LOG2E))
        s = s.double() * float(sl2)
    else:
        s = s / (hd ** 0.5)
    ki = torch.arange(sk)[None, :]
    if causal:
        s = torch.where(ki <= torch.arange(sq)[:, None], s, ref.NEG_INF)
    nb = -(-sk // TILE)
    blocks = torch.nn.functional.pad(s, (0, nb * TILE - sk), value=ref.NEG_INF)
    tmax = blocks.unflatten(-1, (nb, TILE)).amax(dim=-1)
    if mode == "kernel":   # m = f32(max x * scale log2 e)
        tmax = tmax.float().double()
    run = tmax.cummax(dim=-1).values
    mj = run.repeat_interleave(TILE, dim=-1)[..., :sk]
    m = run[..., -1:]
    if mode == "kernel":   # the fma's one rounding to float32, then exp2
        e, w = torch.exp2((s - mj).float()), torch.exp2((mj - m).float())
    else:
        e, w = torch.exp(s - mj), torch.exp(mj - m)
    dt = e.dtype
    pv = torch.einsum("bkgqs,bksh->bkgqh", e.to(BF).to(dt) * w, vt.to(dt))
    out = (pv / (e * w).sum(-1, keepdim=True)).reshape(b, nq, sq, hd).to(BF)
    return out.transpose(1, 2).float(), e.double()


def over(got, want):
    return (got - want).abs() - DESIGN_TOL["rtol"] * want.abs()


def kernel_p(q, k, row_b, kv_h, row, jmax, c, dev):
    """The kernel's bf16 P at (batch ``row_b``, query ``row``) of every
    q head of kv head ``kv_h``, relative to the oracle's rounding ``c``
    (keys 0..row): the second launch's column d times l, in bf16 steps."""
    b, sk, nkv, hd = k.shape
    vp = torch.zeros((b, sk, nkv, hd), dtype=torch.float32)
    for j in range(row + 1):
        vp[row_b, j, kv_h, j] = 1.0
    vp[row_b, jmax, kv_h, :row + 1] -= c
    vp[row_b, jmax, kv_h, jmax] = 1.0            # column jmax: 1 / l
    out = ops.flash_attention(q.to(dev), k.to(dev), vp.to(dev, BF), causal=True)
    return out.cpu().float()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="cpu: a dry run on the plain version")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    report = {"device": name, "atol": DESIGN_TOL["atol"], "cases": []}
    worst = None
    for case in FLASH_CASES_CARD:
        b, s, nq, nkv, hd, dtype, causal = case
        if dtype != BF:
            continue
        rng = np.random.default_rng(s + nq)
        q, k, v = (_normal(rng, (b, s, n, hd), dtype, dev) for n in (nq, nkv, nkv))
        got = ops.flash_attention(q, k, v, causal=causal).cpu().float()
        q, k, v = q.cpu(), k.cpu(), v.cpu()
        row = {"case": str(case)}
        for mode in ("float32", "exact", "kernel"):
            want, _ = oracle(q, k, v, causal, mode)
            o = over(got, want)
            row[mode] = float(o.max())
            row[mode + "_elements_over_atol"] = int((o > DESIGN_TOL["atol"]).sum())
            if mode == "float32":
                at = np.unravel_index(int(o.argmax()), o.shape)
                row["float32_worst_at"] = [int(i) for i in at]
            if mode == "exact":
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                test_oracle = ref.attention_ref(qt, kt, vt, causal=causal, p_dtype=BF,
                                                p_block=TILE).transpose(1, 2).float()
                row["exact_is_ref_attention_ref"] = bool(torch.equal(want, test_oracle))
        report["cases"].append(row)
        print(json.dumps(row), flush=True)
        if worst is None or row["float32"] > worst[0]:
            worst = (row["float32"], case, (q, k, v, got), row["float32_worst_at"])

    _, case, (q, k, v, got), (bi, qi, hi, di) = worst
    b, s, nq, nkv, hd, dtype, causal = case
    g = nq // nkv
    kv_h, gi = hi // g, hi % g
    detail = {"case": str(case), "batch": bi, "row": qi, "head": hi, "column": di}
    if qi < TILE and causal:
        per = {}
        for mode in ("float32", "exact", "kernel"):
            want, e = oracle(q, k, v, causal, mode)
            per[mode] = (want, e[bi, kv_h, gi, qi, :qi + 1])
        p_exact = per["exact"][1]
        jmax = int(p_exact.argmax())
        c = per["float32"][1].to(BF).float()
        out = kernel_p(q, k, bi, kv_h, qi, jmax, c, dev)[bi, qi, hi]
        l_k = 1.0 / float(out[jmax])
        keys = []
        for j in range(qi + 1):
            pe = float(p_exact[j])
            lo = float(torch.tensor(pe).to(BF).float())
            step = 2.0 ** (math.floor(math.log2(lo)) - 7) if lo > 0 else 0.0
            below = step / 2 if lo == 2.0 ** math.floor(math.log2(lo)) else step
            bound = lo + step / 2 if pe >= lo else lo - below / 2
            k_steps = float(out[j]) * l_k / step if (j != jmax and step) else 0.0
            keys.append(dict(
                key=j, p_exact=pe, p_float32=float(per["float32"][1][j]),
                p_kernel_emulated=float(per["kernel"][1][j]),
                bf16_exact=lo,
                bf16_float32=float(per["float32"][1][j].to(BF)),
                bf16_kernel_emulated=float(per["kernel"][1][j].to(BF)),
                bf16_kernel=float(c[j]) + round(k_steps) * step,
                kernel_steps_from_float32=k_steps,
                exact_from_boundary_f32_ulps=(pe - bound) / (2.0 ** (math.floor(
                    math.log2(abs(bound))) - 23))))
        detail.update(l_kernel=l_k, jmax=jmax, got=float(got[bi, qi, hi, di]),
                      v=float(v[bi, :qi + 1, kv_h, di].abs().max()),
                      want={m: float(per[m][0][bi, qi, hi, di]) for m in per}, keys=keys)
    report["worst"] = detail
    print(json.dumps(detail, indent=1), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
