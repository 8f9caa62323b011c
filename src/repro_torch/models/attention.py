"""GQA attention: full (train/prefill), decode-with-cache, and cross-attn.

The plain path is PyTorch tensor code (the reference's XLA path).
``cfg.attn_impl == "pallas"`` routes the full-sequence causal path through
the hand-written flash-attention kernel (K2) instead, as the reference
routes it through its Pallas kernel; the two are held against each other
in ``tests/test_torch_attention.py``.  Decode stays on the plain path, as
in the reference.  The reference's mesh-sharding constraints are no-ops
without a mesh and are dropped (see ``layers``).  On a rank mesh the
dense model hands :func:`full_attention` its ``RankLayout``: the block of
the residual stream is gathered along the sequence, q, k and v are
projected on this rank's heads (column-parallel), the attention runs on
those heads over the whole sequence (K2 under ``attn_impl="pallas"``),
and the row-parallel output projection's partial sums are reduce-scattered
back.  Kv heads that do not split over ``model`` stay whole on every rank,
which takes the ones its q heads read (:func:`rank_kv_heads`).  Under the
decode rules the dense model hands :func:`decode_attention` its decode
layout, whose caches hold a block of positions for every kv head: the
softmax runs across the ranks (:func:`_decode_attention_sharded`).  The
encoder-decoder's cross-attention runs on the rank's heads the same way
(:func:`cross_kv`, :func:`cross_attention`): k and v of the rank's kv
heads of the whole encoder output, q of the gathered decoder stream.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from .layers import apply_rope, rms_norm
from .params import P

NEG_INF = -1e30


def attn_defs(cfg: ModelConfig, cross: bool = False) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    defs = {
        "w_q": P((d, nq, hd), ("d_model", "heads", "head_dim")),
        "w_k": P((d, nkv, hd), ("d_model", "kv_heads", "head_dim")),
        "w_v": P((d, nkv, hd), ("d_model", "kv_heads", "head_dim")),
        "w_o": P((nq, hd, d), ("heads", "head_dim", "d_model")),
    }
    if cfg.qk_norm and not cross:
        defs["q_norm"] = P((hd,), ("head_dim",), "ones")
        defs["k_norm"] = P((hd,), ("head_dim",), "ones")
    return defs


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dnh->bsnh")`` as one matrix product."""
    d, n, h = w.shape
    return (x @ w.reshape(d, n * h)).view(*x.shape[:-1], n, h)


def _out_proj(out: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsnh,nhd->bsd")`` as one matrix product."""
    n, h, d = w.shape
    return out.reshape(*out.shape[:-2], n * h) @ w.reshape(n * h, d)


def _qk_normalize(p: dict, q: torch.Tensor, k: torch.Tensor, cfg: ModelConfig):
    if cfg.qk_norm and "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k


def _qkv(p: dict, x: torch.Tensor, cfg: ModelConfig, rope, w_k: torch.Tensor,
         w_v: torch.Tensor, lay=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k and v of ``x`` (k and v by ``w_k``, ``w_v``), q and k
    normalised and rotated.  ``lay`` (a ``stationary`` decode layout):
    ``x`` and the weights are this rank's blocks of ``d_model``, whose
    float32 partial products are summed over ``data`` in one all-reduce
    (``attn/in``) and rounded once."""
    if lay is None:
        q, k, v = _proj(x, p["w_q"]), _proj(x, w_k), _proj(x, w_v)
    else:
        ws = (p["w_q"], w_k, w_v)
        qkv = lay.contract(x, torch.cat([w.flatten(1) for w in ws], -1), "attn/in")
        q, k, v = (t.unflatten(-1, w.shape[1:])
                   for t, w in zip(qkv.split([w[0].numel() for w in ws], -1), ws))
    q, k = _qk_normalize(p, q, k, cfg)
    if rope is not None:
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _gqa_scores_out(
    q: torch.Tensor,          # [B, Sq, nq, hd]
    k: torch.Tensor,          # [B, Sk, nkv, hd]
    v: torch.Tensor,          # [B, Sk, nkv, hd]
    mask: Optional[torch.Tensor],  # broadcastable to [B, 1, 1, Sq, Sk] or None
) -> torch.Tensor:
    scores = _gqa_scores(q, k)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(q.shape)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Scaled float32 scores ``[B, nkv, g, Sq, Sk]`` of q ``[B, Sq, nq,
    hd]`` against k ``[B, Sk, nkv, hd]`` (each q head against the kv head
    it reads), the product in q's dtype."""
    b, sq, nq, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(b, sq, nkv, nq // max(nkv, 1), hd)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))  # float32, as the reference
    return torch.einsum("bqkgh,bskh->bkgqs", qg, k).float() * scale


def _chunked_attention(
    q: torch.Tensor,          # [B, Sq, nq, hd]
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool,
    chunk: int,
) -> torch.Tensor:
    """Plain-path attention over blocks of ``chunk`` query rows (the last
    one shorter), so the materialized score block is [B, nkv, g, chunk,
    Sk] instead of O(Sq·Sk).  The reference scans chunks of ``chunk``
    halved until it divides Sq; each row's attention is its own, so the
    port takes the rows ``chunk`` at a time (whisper's 1 500 encoder
    positions were a Python loop of 375 chunks of 4)."""
    sq, sk = q.shape[1], k.shape[1]
    if chunk <= 0 or chunk >= sq:
        mask = causal_mask(sq, sk, device=q.device) if causal else None
        return _gqa_scores_out(q, k, v, mask)
    outs = []
    kpos = torch.arange(sk, device=q.device)[None, :]
    for r0 in range(0, sq, chunk):
        qi = q[:, r0:r0 + chunk]
        mask = None
        if causal:
            qpos = r0 + torch.arange(qi.shape[1], device=q.device)[:, None]
            mask = (kpos <= qpos)[None, None, None]
        outs.append(_gqa_scores_out(qi, k, v, mask))
    return torch.cat(outs, dim=1)


def causal_mask(sq: int, sk: int, offset: int = 0, device=None) -> torch.Tensor:
    """[1,1,1,Sq,Sk] True where attendable; query i sees keys ≤ i+offset."""
    qi = torch.arange(sq, device=device)[:, None]
    ki = torch.arange(sk, device=device)[None, :]
    return (ki <= qi + offset)[None, None, None]


def local_kv_heads(n_heads: int, n_kv_heads: int, q0: int, nq_loc: int) -> List[int]:
    """The global kv heads that q heads ``q0 .. q0 + nq_loc - 1`` read
    (GQA: q head ``j`` reads kv head ``j // (n_heads // n_kv_heads)``),
    one per local group: consecutive local q heads that share a kv head
    form a group when every group has the same size, else each q head is
    its own group (its kv head listed once for it)."""
    reads = [(q0 + j) // (n_heads // n_kv_heads) for j in range(nq_loc)]
    uniq = sorted(set(reads))
    g = nq_loc // len(uniq)
    if all(reads[j] == uniq[j // g] for j in range(nq_loc)) and g * len(uniq) == nq_loc:
        return uniq
    return reads


def rank_kv_heads(cfg: ModelConfig, w_q: torch.Tensor, w_k: torch.Tensor, mi: int) -> List[int]:
    """The global kv heads whose k and v a rank computes, from its blocks
    of ``w_q`` and ``w_k`` (heads on the second to last dimension) at
    coordinate ``mi`` along ``model``: where the q heads split and the kv
    heads stay whole, those its q heads read (:func:`local_kv_heads`);
    else the kv heads of its block."""
    nq_loc, nkv_loc = w_q.shape[-2], w_k.shape[-2]
    if nq_loc != cfg.n_heads and nkv_loc == cfg.n_kv_heads:
        return local_kv_heads(cfg.n_heads, cfg.n_kv_heads, mi * nq_loc, nq_loc)
    k0 = mi * nkv_loc if nkv_loc != cfg.n_kv_heads else 0
    return list(range(k0, k0 + nkv_loc))


def _rank_kv(p: dict, cfg: ModelConfig, lay) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """(``w_k``, ``w_v``, whether the q heads split): this rank's blocks of
    the k and v weights of the kv heads it computes, those its q heads read
    where the q heads split and the kv heads stay whole
    (:func:`rank_kv_heads`)."""
    w_k, w_v = p["w_k"], p["w_v"]
    heads_split = p["w_q"].shape[1] != cfg.n_heads
    if heads_split and w_k.shape[1] == cfg.n_kv_heads:    # kv heads whole
        kv = rank_kv_heads(cfg, p["w_q"], w_k, lay.mi)
        w_k, w_v = w_k[:, kv], w_v[:, kv]
    return w_k, w_v, heads_split


def full_attention(
    p: dict,
    x: torch.Tensor,                    # [B, S, d]
    cfg: ModelConfig,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]],
    causal: bool = True,
    lay=None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Self-attention over the whole sequence → (out, (k, v) for caching).

    With ``lay`` (a rank mesh's ``RankLayout``), ``x`` is this rank's
    block of the residual stream and ``p`` its blocks of the weights, with
    ``d_model`` whole; the output is this rank's block, and k, v are this
    rank's rows over the whole sequence, on its kv heads
    (:func:`rank_kv_heads`)."""
    w_k, w_v, heads_split = p["w_k"], p["w_v"], False
    if lay is not None:
        x = lay.gather_seq(x, "attn/in")
        w_k, w_v, heads_split = _rank_kv(p, cfg, lay)
    q, k, v = _qkv(p, x, cfg, rope, w_k, w_v)
    if cfg.attn_impl == "pallas" and causal:
        from ..kernels import ops as kops

        out = kops.flash_attention(q, k, v, causal=True)
    else:
        out = _chunked_attention(q, k, v, causal, cfg.attn_chunk)
    y = _out_proj(out, p["w_o"])
    if lay is not None:
        y = lay.scatter_seq(y, heads_split, "attn/out")
    return y, (k, v)


def decode_attention(
    p: dict,
    x: torch.Tensor,                    # [B, 1, d]
    cfg: ModelConfig,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]],
    k_cache: torch.Tensor,              # [B, S_max, nkv, hd]
    v_cache: torch.Tensor,
    pos: int,                           # next position to write
    lay=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode: write k/v at ``pos``, attend over positions ≤ pos.

    The caches are written in place (the reference returns updated copies
    and its engine donates the old ones); the same tensors are returned.
    As with ``dynamic_update_slice``, a ``pos`` outside the cache writes at
    the nearest end.  With ``lay`` (a rank mesh's decode ``RankLayout``),
    :func:`_decode_attention_sharded`."""
    if lay is not None:
        return _decode_attention_sharded(p, x, cfg, rope, k_cache, v_cache, int(pos), lay)
    q, k, v = _qkv(p, x, cfg, rope, p["w_k"], p["w_v"])   # rope: position `pos`'s tables
    s_max = k_cache.shape[1]
    at = min(max(int(pos), 0), s_max - 1)
    k_cache[:, at] = k[:, 0]
    v_cache[:, at] = v[:, 0]
    ki = torch.arange(s_max, device=x.device)
    mask = (ki <= pos).reshape(1, 1, 1, 1, s_max)
    out = _gqa_scores_out(q, k_cache, v_cache, mask)
    return _out_proj(out, p["w_o"]), k_cache, v_cache


def _decode_attention_sharded(p, x, cfg: ModelConfig, rope, k_cache, v_cache, pos: int, lay):
    """The decode step on a rank mesh, as GSPMD partitions the reference's
    ``decode_attention`` under ``ACT_RULES_DECODE``.  ``x`` ``[b_loc, 1,
    d]`` is this rank's rows, ``p`` its blocks of the weights with
    ``d_model`` whole, and the caches ``[b_loc, kv_loc, nkv, hd]`` its
    block of positions (``lay.kv0`` on) for every kv head.

    q, k and v are projected on this rank's heads (column-parallel);
    where the kv heads do not split over ``model`` every rank projects all
    of them, as the cache needs them.  One all-gather over ``model``
    (``attn/qkv``) makes the new token's q, and k and v where their heads
    split, whole.  The rank whose block holds ``clamp(pos, 0, s_max - 1)``
    writes k and v there.  Every rank scores all q heads against its
    positions, masked to ``≤ pos``; a two-pass softmax across the ranks —
    the row maxima's ``pmax`` (``attn/max``), the sums of ``exp(s - M)``'s
    ``psum`` (``attn/sum``) — gives ``p = exp(s - M) / L``, rounded to the
    compute dtype where one rank's softmax rounds it; ``p @ v`` over the
    block in float32, reduce-scattered onto this rank's heads
    (``attn/pv``; summed where the heads do not split), rounded once.  A
    block wholly after ``pos`` adds exactly 0.  (A flash-decode merge of
    each rank's normalised partials would round the probabilities
    elsewhere.)  Where the positions do not split, every rank holds the
    whole cache and attends as one rank does.  The row-parallel output
    projection on this rank's heads is summed over ``model``
    (``attn/out``).  A ``stationary`` layout (a tick whose batch does not
    split over ``data``) hands it ``x``'s block of ``d_model`` and the
    weights' blocks: q, k and v are float32 partial products summed over
    ``data`` (``attn/in``), and the output's block of ``d_model`` is
    gathered over ``data`` (``attn/data``)."""
    from ..distributed.collectives import all_gather, pmax, psum, reduce_scatter

    heads_split = p["w_q"].shape[1] != cfg.n_heads
    kv_split = p["w_k"].shape[1] != cfg.n_kv_heads
    q, k, v = _qkv(p, x, cfg, rope, p["w_k"], p["w_v"], lay if lay.stationary else None)
    nq_loc = q.shape[2]
    if heads_split:
        parts = [q, k, v] if kv_split else [q]
        widths = [t.shape[2] for t in parts]
        whole = all_gather(torch.cat(parts, 2), lay.mesh, "model", 2, "attn/qkv")
        whole = whole.unflatten(2, (lay.n_model, sum(widths))).split(widths, 3)
        parts = [t.flatten(2, 3) for t in whole]
        q = parts[0]
        if kv_split:
            k, v = parts[1:]
    at = min(max(pos, 0), lay.s_max - 1) - lay.kv0
    if 0 <= at < lay.kv_loc:
        k_cache[:, at] = k[:, 0]
        v_cache[:, at] = v[:, 0]
    ki = lay.kv0 + torch.arange(lay.kv_loc, device=x.device)
    mask = (ki <= pos).reshape(1, 1, 1, 1, lay.kv_loc)
    if not lay.kv_sharded:
        out = _gqa_scores_out(q, k_cache, v_cache, mask)
        if heads_split:
            out = out[:, :, lay.mi * nq_loc:(lay.mi + 1) * nq_loc]
    else:
        s = torch.where(mask, _gqa_scores(q, k_cache), NEG_INF)
        m = pmax(s.amax(-1, keepdim=True), lay.mesh, "model", "attn/max")
        e = torch.exp(s - m)
        total = psum(e.sum(-1, keepdim=True), lay.mesh, "model", "attn/sum")
        probs = (e / total).to(q.dtype)
        part = torch.einsum("bkgqs,bskh->bqkgh", probs.float(), v_cache.float())
        part = part.reshape(q.shape[:2] + (cfg.n_heads, q.shape[3]))
        out = (reduce_scatter(part, lay.mesh, "model", 2, "attn/pv") if heads_split
               else psum(part, lay.mesh, "model", "attn/pv")).to(q.dtype)
    y = lay.scatter_seq(_out_proj(out, p["w_o"]), heads_split, "attn/out")
    return (lay.whole_d(y, "attn/data") if lay.stationary else y), k_cache, v_cache


def cross_attention(
    p: dict,
    x: torch.Tensor,                    # [B, Sq, d]
    k: torch.Tensor,                    # [B, Sk, nkv, hd] (precomputed enc K)
    v: torch.Tensor,
    cfg: ModelConfig,
    lay=None,
) -> torch.Tensor:
    """The queries of ``x`` against the encoder's ``k`` and ``v``, unmasked.
    With ``lay`` (the decoder's ``RankLayout``), ``x`` is this rank's block
    of the decoder stream, ``p`` its blocks of the weights with ``d_model``
    whole, ``k`` and ``v`` its kv heads (:func:`cross_kv`): the block is
    gathered along the sequence (``xattn/in``), q projected on the rank's
    heads, and the row-parallel output's partial sums reduce-scattered back
    (``xattn/out``; summed where the sequence is whole); where the heads do
    not split, every rank computes every head and keeps its positions."""
    if lay is not None:
        x = lay.gather_seq(x, "xattn/in")
    out = _gqa_scores_out(_proj(x, p["w_q"]), k, v, None)
    y = _out_proj(out, p["w_o"])
    if lay is not None:
        y = lay.scatter_seq(y, p["w_q"].shape[1] != cfg.n_heads, "xattn/out")
    return y


def cross_kv(p: dict, enc: torch.Tensor, cfg: Optional[ModelConfig] = None,
             lay=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder output's k and v; with ``lay``, ``enc`` is this rank's
    rows of the whole output and k, v its kv heads
    (:func:`rank_kv_heads`)."""
    w_k, w_v = (p["w_k"], p["w_v"]) if lay is None else _rank_kv(p, cfg, lay)[:2]
    return _proj(enc, w_k), _proj(enc, w_v)
