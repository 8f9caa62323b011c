"""Whisper-style encoder-decoder.

Encoder: bidirectional self-attention over precomputed frame embeddings
(the conv/log-mel frontend is a stub, as in the reference: the batch's
``frames`` are ``[B, enc_seq, d_model]``).  Decoder: causal
self-attention + cross-attention + MLP.  Positions are sinusoidal, added
at the embedding (``Model._embed``, which hands the decoder its input).

The encoder's attention is not causal, so it takes the plain path on
either ``attn_impl``; under ``attn_impl="pallas"`` the decoder's causal
self-attention goes through the flash-attention kernel (K2), as in the
reference.  Parameters keep the reference's layout (``encoder`` and
``decoder`` stacked ``[L, ...]``), and the stacks run as Python loops over
layers, checkpointing each layer of a training pass under ``cfg.remat``.
Decode caches are the self-attention ``{"k", "v"}`` of ``[L, B, S_max,
nkv, hd]`` and the encoder's projected ``{"ek", "ev"}`` of ``[L, B,
enc_seq, nkv, hd]``; a decode step writes ``k``/``v`` in place.  The
stacks return their last layer's output; ``Model._head`` makes the logits.

On a rank mesh each stack runs as the dense family's does
(``models/transformer.py``), on a layout of its own sequence: the encoder
on ``rank_layout(b, enc_seq, d)``, the decoder on its tokens'.  Each
layer's weights are gathered over ``data`` just before it runs
(``transformer.gather_layer``, inside the checkpointed layer), its
attention runs on the rank's heads, its MLP on its ``d_ff`` columns.  The
encoder's output is gathered over ``model`` once a forward pass
(``enc/out``); each decoder layer projects the rank's kv heads of it and
runs the cross-attention on the rank's q heads
(``attention.cross_attention``).
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from .attention import (attn_defs, cross_attention, cross_kv, decode_attention, full_attention,
                        rank_kv_heads)
from .layers import mlp_block, mlp_defs, rms_norm, sinusoidal_positions
from .params import P, Tree, dtype_of
from .transformer import (_attn_cache_defs, _index_tree, _one_layer_defs, _remat_contexts, _stack,
                          _stack_trees, gather_layer)


def dec_layer_defs(cfg: ModelConfig) -> Tree:
    d = cfg.d_model
    return {
        "ln1": P((d,), ("d_model",), "ones"),
        "attn": attn_defs(cfg),
        "ln_x": P((d,), ("d_model",), "ones"),
        "xattn": attn_defs(cfg, cross=True),
        "ln2": P((d,), ("d_model",), "ones"),
        "mlp": mlp_defs(cfg),
    }


def encdec_defs(cfg: ModelConfig) -> Tree:
    d, v = cfg.d_model, cfg.vocab_size
    return {
        "embed": P((v, d), ("vocab", "d_model")),
        "enc_in": P((d, d), ("d_model", None)),  # frame-embedding adapter stub
        "encoder": _stack(_one_layer_defs(cfg, "attn", "mlp"), cfg.n_enc_layers),
        "ln_enc": P((d,), ("d_model",), "ones"),
        "decoder": _stack(dec_layer_defs(cfg), cfg.n_layers),
        "ln_f": P((d,), ("d_model",), "ones"),
        "lm_head": P((d, v), ("d_model", "vocab")),
    }


def _run(body, stack: Tree, n: int, x: torch.Tensor, cfg: ModelConfig, defs: Tree, lay,
         remat: bool):
    """``body(lp, x) → (x, state)`` over ``n`` stacked layers → (x,
    [state per layer]).  ``lay``: each layer's weights (declared by
    ``defs``) gathered just before it; with ``remat`` and grad enabled each
    layer, its gather included, is checkpointed, and its recomputation's
    collectives count as the backward pass's."""
    def unit(lp, xc):
        if lay is not None:
            lp = gather_layer(cfg, lp, defs, lay, "mlp")
        return body(lp, xc)

    remat = remat and torch.is_grad_enabled()
    states = []
    for li in range(n):
        lp = _index_tree(stack, li)
        x, st = (checkpoint(unit, lp, x, use_reentrant=False, context_fn=_remat_contexts)
                 if remat else unit(lp, x))
        states.append(st)
    return x, states


def encode(params: Tree, frames: torch.Tensor, cfg: ModelConfig, lay=None) -> torch.Tensor:
    """frames [B, enc_seq, d] → encoder output [B, enc_seq, d].

    With ``lay`` (the encoder's ``RankLayout``), ``frames`` is the whole
    batch and the encoder runs on this rank's rows and block of positions:
    ``enc_in`` and ``ln_enc`` gathered over ``data`` (``enc/in``), the
    sinusoidal positions of the block, each layer on the rank's heads and
    columns; → this rank's rows of the whole output, its blocks gathered
    over ``model`` (``enc/out``)."""
    w, ln, s0 = params["enc_in"], params["ln_enc"], 0
    if lay is not None:
        frames = lay.rows(frames)[:, lay.s0:lay.s0 + lay.s_loc]
        defs = encdec_defs(cfg)
        whole = lay.gather_params({"enc_in": w, "ln_enc": ln},
                                  {k: defs[k] for k in ("enc_in", "ln_enc")}, "enc/in")
        w, ln, s0 = whole["enc_in"], whole["ln_enc"], lay.s0
    pos = sinusoidal_positions(torch.arange(s0, s0 + frames.shape[1], device=frames.device),
                               cfg.d_model)
    dt = torch.promote_types(frames.dtype, w.dtype)   # the reference's einsum promotes
    x = frames.to(dt) @ w.to(dt)
    x = (x + pos[None].to(x.dtype)).to(dtype_of(cfg.compute_dtype))

    def body(lp, xc):
        h = rms_norm(xc, lp["ln1"], cfg.norm_eps)
        y, _ = full_attention(lp["attn"], h, cfg, rope=None, causal=False, lay=lay)
        xc = xc + y
        h = rms_norm(xc, lp["ln2"], cfg.norm_eps)
        return xc + mlp_block(lp["mlp"], h, cfg, lay), None

    x, _ = _run(body, params["encoder"], cfg.n_enc_layers, x, cfg,
                _one_layer_defs(cfg, "attn", "mlp"), lay, cfg.remat)
    x = rms_norm(x, ln, cfg.norm_eps)
    return x if lay is None else lay.gather_seq(x, "enc/out")


def decode_full(
    params: Tree,
    x: torch.Tensor,            # [B, S, d]: the decoder's input
    enc_out: torch.Tensor,      # [B, enc_seq, d]
    cfg: ModelConfig,
    collect_state: bool = False,
    lay=None,
):
    """Teacher-forced decoder pass over its input (the embedding and its
    positions, ``Model._embed``) → (the last layer's output, states |
    None): per layer ``{"k", "v"}`` over the S positions and the encoder's
    ``{"ek", "ev"}``, stacked ``[L, ...]``.  With ``lay`` (the decoder's
    ``RankLayout``), ``x`` is this rank's block of the stream and
    ``enc_out`` its rows of the whole encoder output; the self-attention
    and the cross-attention run on the rank's heads, the states are its
    rows on its kv heads (``attention.rank_kv_heads``)."""
    def body(lp, xc):
        h = rms_norm(xc, lp["ln1"], cfg.norm_eps)
        y, (k, v) = full_attention(lp["attn"], h, cfg, rope=None, causal=True, lay=lay)
        xc = xc + y
        h = rms_norm(xc, lp["ln_x"], cfg.norm_eps)
        ek, ev = cross_kv(lp["xattn"], enc_out, cfg, lay)
        xc = xc + cross_attention(lp["xattn"], h, ek, ev, cfg, lay)
        h = rms_norm(xc, lp["ln2"], cfg.norm_eps)
        xc = xc + mlp_block(lp["mlp"], h, cfg, lay)
        return xc, ({"k": k, "v": v, "ek": ek, "ev": ev} if collect_state else None)

    x, states = _run(body, params["decoder"], cfg.n_layers, x, cfg, dec_layer_defs(cfg), lay,
                     cfg.remat and not collect_state)
    return x, (_stack_trees(states) if collect_state else None)


def decode_step(
    params: Tree,
    x: torch.Tensor,            # [B, 1, d]: the decoder's input
    pos_id: int,                # position being written
    caches: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    lay=None,
):
    """Single-token decode with the self-attention and cross-attention
    caches → (the last layer's output, caches); ``k``/``v`` are written in
    place and the same dict is returned.  With ``lay`` (a decode layout,
    ``Model.cache_layout``), ``x`` is this rank's rows and the caches its
    blocks: each layer's weights gathered over ``data``, the
    self-attention across the ranks' blocks of positions
    (``attention.decode_attention``), the cross-attention on the rank's q
    heads against those heads of the whole ``ek``/``ev``."""
    defs = dec_layer_defs(cfg)
    for li in range(cfg.n_layers):
        lp, cc = _index_tree(params["decoder"], li), _index_tree(caches, li)
        ek, ev = cc["ek"], cc["ev"]
        if lay is not None:
            lp = gather_layer(cfg, lp, defs, lay, "mlp")
            kv = rank_kv_heads(cfg, lp["xattn"]["w_q"], lp["xattn"]["w_k"], lay.mi)
            ek, ev = ek[:, :, kv], ev[:, :, kv]
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, _, _ = decode_attention(lp["attn"], h, cfg, None, cc["k"], cc["v"], int(pos_id), lay)
        x = x + y
        h = rms_norm(x, lp["ln_x"], cfg.norm_eps)
        x = x + cross_attention(lp["xattn"], h, ek, ev, cfg, lay)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + mlp_block(lp["mlp"], h, cfg, lay)
        del lp
    return x, caches


def encdec_cache_defs(cfg: ModelConfig, batch: int, s_max: int) -> Tree:
    hd = cfg.resolved_head_dim
    one = dict(_attn_cache_defs(cfg, batch, s_max))
    one["ek"] = P((batch, cfg.enc_seq, cfg.n_kv_heads, hd),
                  ("batch", None, "kv_heads", "head_dim"), "zeros")
    one["ev"] = P((batch, cfg.enc_seq, cfg.n_kv_heads, hd),
                  ("batch", None, "kv_heads", "head_dim"), "zeros")
    return _stack(one, cfg.n_layers)
