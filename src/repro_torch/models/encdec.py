"""Whisper-style encoder-decoder.

Encoder: bidirectional self-attention over precomputed frame embeddings
(the conv/log-mel frontend is a stub, as in the reference: the batch's
``frames`` are ``[B, enc_seq, d_model]``).  Decoder: causal
self-attention + cross-attention + MLP.  Positions are sinusoidal, added
at the embedding.

The encoder's attention is not causal, so it takes the plain path on
either ``attn_impl``; under ``attn_impl="pallas"`` the decoder's causal
self-attention goes through the flash-attention kernel (K2), as in the
reference.  Parameters keep the reference's layout (``encoder`` and
``decoder`` stacked ``[L, ...]``), and the stacks run as Python loops over
layers, checkpointing each layer of a training pass under ``cfg.remat``.
Decode caches are the self-attention ``{"k", "v"}`` of ``[L, B, S_max,
nkv, hd]`` and the encoder's projected ``{"ek", "ev"}`` of ``[L, B,
enc_seq, nkv, hd]``; a decode step writes ``k``/``v`` in place.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from .attention import attn_defs, cross_attention, cross_kv, decode_attention, full_attention
from .layers import mlp_block, mlp_defs, rms_norm, sinusoidal_positions
from .params import P, Tree, dtype_of
from .transformer import _attn_cache_defs, _index_tree, _stack, _stack_trees


def encdec_defs(cfg: ModelConfig) -> Tree:
    d, v = cfg.d_model, cfg.vocab_size
    enc_layer = {
        "ln1": P((d,), ("d_model",), "ones"),
        "attn": attn_defs(cfg),
        "ln2": P((d,), ("d_model",), "ones"),
        "mlp": mlp_defs(cfg),
    }
    dec_layer = {
        "ln1": P((d,), ("d_model",), "ones"),
        "attn": attn_defs(cfg),
        "ln_x": P((d,), ("d_model",), "ones"),
        "xattn": attn_defs(cfg, cross=True),
        "ln2": P((d,), ("d_model",), "ones"),
        "mlp": mlp_defs(cfg),
    }
    return {
        "embed": P((v, d), ("vocab", "d_model")),
        "enc_in": P((d, d), ("d_model", None)),  # frame-embedding adapter stub
        "encoder": _stack(enc_layer, cfg.n_enc_layers),
        "ln_enc": P((d,), ("d_model",), "ones"),
        "decoder": _stack(dec_layer, cfg.n_layers),
        "ln_f": P((d,), ("d_model",), "ones"),
        "lm_head": P((d, v), ("d_model", "vocab")),
    }


def _run(body, params_stack: Tree, n: int, x: torch.Tensor, remat: bool):
    """``body(lp, x) → (x, state)`` over ``n`` stacked layers → (x,
    [state per layer]); with ``remat`` and grad enabled each layer is
    checkpointed."""
    remat = remat and torch.is_grad_enabled()
    states = []
    for li in range(n):
        lp = _index_tree(params_stack, li)
        x, st = checkpoint(body, lp, x, use_reentrant=False) if remat else body(lp, x)
        states.append(st)
    return x, states


def encode(params: Tree, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames [B, enc_seq, d] → encoder output [B, enc_seq, d]."""
    pos = sinusoidal_positions(torch.arange(frames.shape[1], device=frames.device),
                               cfg.d_model)
    w = params["enc_in"]
    dt = torch.promote_types(frames.dtype, w.dtype)   # the reference's einsum promotes
    x = frames.to(dt) @ w.to(dt)
    x = (x + pos[None].to(x.dtype)).to(dtype_of(cfg.compute_dtype))

    def body(lp, xc):
        h = rms_norm(xc, lp["ln1"], cfg.norm_eps)
        y, _ = full_attention(lp["attn"], h, cfg, rope=None, causal=False)
        xc = xc + y
        h = rms_norm(xc, lp["ln2"], cfg.norm_eps)
        return xc + mlp_block(lp["mlp"], h, cfg), None

    x, _ = _run(body, params["encoder"], cfg.n_enc_layers, x, cfg.remat)
    return rms_norm(x, params["ln_enc"], cfg.norm_eps)


def _logits(params: Tree, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return (x @ params["lm_head"]).float()


def decode_full(
    params: Tree,
    tokens: torch.Tensor,       # [B, S]
    enc_out: torch.Tensor,      # [B, enc_seq, d]
    cfg: ModelConfig,
    collect_state: bool = False,
):
    """Teacher-forced decoder pass → (logits [B,S,V] float32, states |
    None): per layer ``{"k", "v"}`` over the S positions and the
    encoder's ``{"ek", "ev"}``, stacked ``[L, ...]``."""
    s = tokens.shape[1]
    pos = sinusoidal_positions(torch.arange(s, device=tokens.device), cfg.d_model)
    emb = params["embed"]
    x = (emb[tokens] + pos[None].to(emb.dtype)).to(dtype_of(cfg.compute_dtype))

    def body(lp, xc):
        h = rms_norm(xc, lp["ln1"], cfg.norm_eps)
        y, (k, v) = full_attention(lp["attn"], h, cfg, rope=None, causal=True)
        xc = xc + y
        h = rms_norm(xc, lp["ln_x"], cfg.norm_eps)
        ek, ev = cross_kv(lp["xattn"], enc_out)
        xc = xc + cross_attention(lp["xattn"], h, ek, ev, cfg)
        h = rms_norm(xc, lp["ln2"], cfg.norm_eps)
        xc = xc + mlp_block(lp["mlp"], h, cfg)
        return xc, ({"k": k, "v": v, "ek": ek, "ev": ev} if collect_state else None)

    x, states = _run(body, params["decoder"], cfg.n_layers, x,
                     cfg.remat and not collect_state)
    return _logits(params, x, cfg), (_stack_trees(states) if collect_state else None)


def decode_step(
    params: Tree,
    token: torch.Tensor,        # [B, 1]
    pos_id: int,                # position being written
    caches: Dict[str, torch.Tensor],
    cfg: ModelConfig,
):
    """Single-token decode with the self-attention and cross-attention
    caches → (logits [B, 1, V] float32, caches); ``k``/``v`` are written in
    place and the same dict is returned."""
    pos = sinusoidal_positions(torch.tensor([int(pos_id)], device=token.device), cfg.d_model)
    emb = params["embed"]
    x = (emb[token] + pos[None].to(emb.dtype)).to(dtype_of(cfg.compute_dtype))
    for li in range(cfg.n_layers):
        lp, cc = _index_tree(params["decoder"], li), _index_tree(caches, li)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, _, _ = decode_attention(lp["attn"], h, cfg, None, cc["k"], cc["v"], int(pos_id))
        x = x + y
        h = rms_norm(x, lp["ln_x"], cfg.norm_eps)
        x = x + cross_attention(lp["xattn"], h, cc["ek"], cc["ev"], cfg)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + mlp_block(lp["mlp"], h, cfg)
    return _logits(params, x, cfg), caches


def encdec_cache_defs(cfg: ModelConfig, batch: int, s_max: int) -> Tree:
    hd = cfg.resolved_head_dim
    one = dict(_attn_cache_defs(cfg, batch, s_max))
    one["ek"] = P((batch, cfg.enc_seq, cfg.n_kv_heads, hd),
                  ("batch", None, "kv_heads", "head_dim"), "zeros")
    one["ev"] = P((batch, cfg.enc_seq, cfg.n_kv_heads, hd),
                  ("batch", None, "kv_heads", "head_dim"), "zeros")
    return _stack(one, cfg.n_layers)
