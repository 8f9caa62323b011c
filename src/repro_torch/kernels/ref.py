"""Plain PyTorch versions of the kernels (the counterparts of
``repro/kernels/ref.py``'s oracles): K2 is held against
:func:`attention_ref`, K3 against :func:`decode_ref`, K4 against
:func:`mamba_scan_ref`, the RMSNorm kernel against :func:`rms_norm_ref`
(the composition ``models/layers.py::rms_norm`` keeps, op for op).

The attention oracles compute in float32 and cast back to ``q.dtype``, and
mask with ``NEG_INF = -1e30`` as the reference does (not ``-inf``).  The
mamba oracle is a Python loop over time on a ``[B, d_in, N]`` float32
state.  All run on any device.  The kernel wrappers use them for tensors
on the CPU only; on the card's paths nothing calls them.

Three more spell out the arithmetic of the kernels' designs, for the
checks of the kernels and their tests only: ``attention_ref(...,
p_dtype=torch.bfloat16, p_block=64)`` rounds the probabilities before P.V
as K2's tensor-core path does, each key tile's against the running row
max (computing in float64, so that each P is rounded from its exact
value), :func:`decode_split_ref` computes K3's per-chunk partials and their
merge, and :func:`mamba_scan_design_ref` rounds K4's recurrence as the
kernel does.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

NEG_INF = -1e30
LOG2E = 1.4426950408889634


def rms_norm_ref(x: torch.Tensor, weight: torch.Tensor, eps: float,
                 block=None) -> torch.Tensor:
    """RMSNorm over the last dimension in float32, rounded once to x's dtype;
    with ``block`` (a callable on the normed row, e.g. ``RankLayout.d_block``),
    ``weight`` scales ``block``'s part of the row."""
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    if block is not None:
        out = block(out)
    return (out * weight.float()).to(dtype)


def attention_ref(
    q: torch.Tensor,            # [B, nq, Sq, hd]
    k: torch.Tensor,            # [B, nkv, Sk, hd]
    v: torch.Tensor,            # [B, nkv, Sk, hd]
    causal: bool = True,
    pos: Optional[Union[int, torch.Tensor]] = None,
    p_dtype: Optional[torch.dtype] = None,
    p_block: Optional[int] = None,
) -> torch.Tensor:
    """With ``p_dtype``, the unnormalised probabilities exp(s - m) enter
    P.V rounded to it, and are summed for the divide unrounded.  m is the
    row max; with ``p_block``, the running row max over the blocks of
    ``p_block`` keys up to each key's own, as a flash kernel that walks the
    keys in blocks rounds them, each block's products then rescaled by
    e^(m - row max).  This form computes in float64: a P that float32
    arithmetic puts a few ulps to the wrong side of a rounding boundary
    (or on it, where it ties to even) would round one step off the exact
    value's rounding, which at a row of few keys moves the output by more
    than the kernel checks allow."""
    b, nq, sq, hd = q.shape
    nkv, sk = k.shape[1], k.shape[2]
    g = nq // nkv
    dt = torch.float32 if p_dtype is None else torch.float64
    qg = q.reshape(b, nkv, g, sq, hd).to(dt)
    s = torch.einsum("bkgqh,bksh->bkgqs", qg, k.to(dt)) / (hd ** 0.5)
    ki = torch.arange(sk, device=q.device)[None, :]
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None]
        s = torch.where(ki <= qi, s, NEG_INF)
    if pos is not None:
        s = torch.where(ki <= pos, s, NEG_INF)
    if p_dtype is None:
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgqs,bksh->bkgqh", p, v.float())
    else:
        m = s.amax(dim=-1, keepdim=True)
        mj = m
        if p_block is not None:
            nb = -(-sk // p_block)
            blocks = torch.nn.functional.pad(s, (0, nb * p_block - sk), value=NEG_INF)
            run = blocks.unflatten(-1, (nb, p_block)).amax(dim=-1).cummax(dim=-1).values
            mj = run.repeat_interleave(p_block, dim=-1)[..., :sk]
        e, w = torch.exp(s - mj), torch.exp(mj - m)
        out = torch.einsum("bkgqs,bksh->bkgqh", e.to(p_dtype).to(dt) * w, v.to(dt))
        out = out / (e * w).sum(dim=-1, keepdim=True)
    return out.reshape(b, nq, sq, hd).to(q.dtype)


def decode_ref(q, k, v, pos):
    """q [B,nq,1,hd] vs cache [B,nkv,S,hd], valid positions ≤ pos."""
    return attention_ref(q, k, v, causal=False, pos=pos)


def decode_split_ref(q, k, v, pos: int, splits: int, chunk: int) -> torch.Tensor:
    """K3's split-key arithmetic: q [B,nq,1,hd] vs cache [B,nkv,S,hd].  The
    live keys [0, min(pos + 1, S)) are cut into ``splits`` chunks of
    ``chunk`` keys, as ``decode_attention.split_plan`` gives them to the
    kernel.  Each chunk gives (m, l, acc) over its live keys (m = -1e30,
    l = 0, acc = 0 where it holds none); the merge rescales each by
    e^(m - M), M the largest m, and divides the summed acc by the summed l
    where it is > 0."""
    b, nq, _, hd = q.shape
    nkv, sk = k.shape[1], k.shape[2]
    g = nq // nkv
    kend = min(pos + 1, sk)
    qg = q.reshape(b, nkv, g, hd).float() * float(1.0 / hd ** 0.5)
    ms, ls, accs = [], [], []
    for s in range(splits):
        lo, hi = s * chunk, min((s + 1) * chunk, kend)
        if hi <= lo:
            ms.append(torch.full((b, nkv, g, 1), NEG_INF, device=q.device))
            ls.append(torch.zeros((b, nkv, g, 1), device=q.device))
            accs.append(torch.zeros((b, nkv, g, hd), device=q.device))
            continue
        sc = torch.einsum("bkgh,bksh->bkgs", qg, k[:, :, lo:hi].float())
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.exp(sc - m)
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bkgs,bksh->bkgh", p, v[:, :, lo:hi].float()))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    w = torch.exp(m - m.amax(dim=0))
    lsum, out = (w * l).sum(dim=0), (w * acc).sum(dim=0)
    out = out / torch.where(lsum > 0, lsum, torch.ones_like(lsum))
    return out.reshape(b, nq, 1, hd).to(q.dtype)


def mamba_scan_ref(
    x: torch.Tensor,            # [B, S, d_in] f32
    dt: torch.Tensor,           # [B, S, d_in] f32
    a: torch.Tensor,            # [d_in, N] f32
    b_mat: torch.Tensor,        # [B, S, N] f32
    c_mat: torch.Tensor,        # [B, S, N] f32
) -> torch.Tensor:
    bsz, s, d_in = x.shape
    h = torch.zeros((bsz, d_in, a.shape[-1]), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        da = torch.exp(dt[:, t, :, None] * a)
        h = da * h + (dt[:, t] * x[:, t])[..., None] * b_mat[:, t, None, :]
        ys.append(torch.einsum("bin,bn->bi", h, c_mat[:, t]))
    return torch.stack(ys, 1)


def _fma32(a, b, c):
    """float32 fused multiply-add: the product exact in float64, the sum
    rounded once to float64 and then to float32."""
    return (a.double() * b.double() + c.double()).float()


def mamba_scan_design_ref(
    x: torch.Tensor,            # [B, S, d_in] f32
    dt: torch.Tensor,           # [B, S, d_in] f32
    a: torch.Tensor,            # [d_in, N] f32
    b_mat: torch.Tensor,        # [B, S, N] f32
    c_mat: torch.Tensor,        # [B, S, N] f32
    lanes: int,
    per_lane: int,
) -> torch.Tensor:
    """K4's arithmetic, for a channel's states held by ``lanes`` lanes of
    ``per_lane`` consecutive states (``mamba_scan.scan_lanes``): exp(Δ·A)
    as 2^(Δ·(A·log₂e)) with A·log₂e and Δ·(A·log₂e) rounded to float32 and
    results below 2^-126 flushed to 0 (``ex2.approx.ftz``); h = fma(e, h,
    B·(Δx)); y as each lane's fma sum over its states in order, then the
    lanes' sums added pairwise by the kernel's shuffle butterfly."""
    bsz, s, d_in = x.shape
    n = a.shape[-1]
    npad = lanes * per_lane
    pad = lambda t: torch.nn.functional.pad(t, (0, npad - n))  # noqa: E731
    a2 = pad(a * torch.tensor(LOG2E, dtype=torch.float32))
    bp, cp = pad(b_mat), pad(c_mat)
    h = torch.zeros((bsz, d_in, npad), dtype=torch.float32, device=x.device)
    lane = torch.arange(lanes, device=x.device)
    tiny = torch.tensor(2.0 ** -126, dtype=torch.float32)
    ys = []
    for t in range(s):
        d = dt[:, t, :, None]
        e = torch.exp2(d * a2)
        e = torch.where(e < tiny, torch.zeros_like(e), e)
        u = bp[:, t, None, :] * (dt[:, t] * x[:, t])[..., None]
        h = _fma32(e, h, u)
        hl = h.view(bsz, d_in, lanes, per_lane)
        cl = cp[:, t].view(bsz, 1, lanes, per_lane).expand_as(hl)
        acc = torch.zeros((bsz, d_in, lanes), dtype=torch.float32, device=x.device)
        for k in range(per_lane):
            acc = _fma32(cl[..., k], hl[..., k], acc)
        w = lanes // 2
        while w >= 1:
            acc = acc + acc[..., lane ^ w]
            w //= 2
        ys.append(acc[..., 0])
    return torch.stack(ys, 1)
