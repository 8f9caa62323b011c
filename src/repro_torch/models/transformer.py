"""Decoder-only stacks: dense, VLM (the VLM prepends patch embeddings in
``model``; its stack is dense) and SSM (mamba).

Parameters keep the reference's stacked layout — every leaf of
``stack`` is ``[L, ...]`` — so converting the reference's parameters is a
copy.  Where the reference scans over the stack (``lax.scan``), the port
runs a Python loop over layers, indexing layer ``l`` of every leaf (a
view, no copy); with ``cfg.remat`` a training pass checkpoints each layer
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).  Decode
caches are stacked ``[L, ...]`` — attention ``{"k", "v"}`` of ``[L, B,
S_max, nkv, hd]``, mamba ``{"conv", "h"}`` of ``[L, B, k-1, d_in]`` and
``[L, B, d_in, N]`` — and each layer writes its slice in place.

The MoE and hybrid stacks are later slices of the port; their branches
raise ``NotImplementedError`` naming the ROADMAP item.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from .attention import attn_defs, decode_attention, full_attention
from .layers import mlp_block, mlp_defs, rms_norm
from .params import P, Tree, tree_map_defs
from .ssm import mamba_block, mamba_decode, mamba_defs

Cache = Any

_LATER = {
    "moe": "the MoE layer (models/moe.py) is ROADMAP.md queue 1, item 2",
    "hybrid": "the hybrid stack needs models/moe.py: ROADMAP.md queue 1, item 2",
}


def _not_ported(kind: str):
    return NotImplementedError(f"not ported yet: {_LATER[kind]}")


# ---------------------------------------------------------------------------
# Definitions
# ---------------------------------------------------------------------------

def _slot_kind(cfg: ModelConfig, layer: int) -> Tuple[str, str]:
    """(mixer, ffn) kind for absolute layer index."""
    mixer = "attn" if cfg.is_attn_layer(layer) else "mamba"
    if cfg.d_ff == 0:
        ffn = "none"
    elif cfg.is_moe_layer(layer):
        ffn = "moe"
    else:
        ffn = "mlp"
    return mixer, ffn


def _check_ported(cfg: ModelConfig) -> Tuple[str, str]:
    if cfg.family == "hybrid":
        raise _not_ported("hybrid")
    mixer, ffn = _slot_kind(cfg, 0)
    if ffn == "moe":
        raise _not_ported("moe")
    return mixer, ffn


def _one_layer_defs(cfg: ModelConfig, mixer: str, ffn: str) -> dict:
    d = cfg.d_model
    defs: dict = {"ln1": P((d,), ("d_model",), "ones")}
    defs[mixer] = attn_defs(cfg) if mixer == "attn" else mamba_defs(cfg)
    if ffn != "none":
        defs["ln2"] = P((d,), ("d_model",), "ones")
        defs[ffn] = mlp_defs(cfg)
    return defs


def _stack(defs: Tree, n: int, axis: str = "layers") -> Tree:
    return tree_map_defs(
        lambda p: P((n,) + p.shape, (axis,) + p.axes, p.init, p.stddev), defs
    )


def stack_defs(cfg: ModelConfig) -> Tree:
    """Layer-stack parameter declaration (see module docstring)."""
    mixer, ffn = _check_ported(cfg)
    return _stack(_one_layer_defs(cfg, mixer, ffn), cfg.n_layers)


def model_defs(cfg: ModelConfig) -> Tree:
    d, v = cfg.d_model, cfg.vocab_size
    defs: Tree = {
        "embed": P((v, d), ("vocab", "d_model")),
        "stack": stack_defs(cfg),
        "ln_f": P((d,), ("d_model",), "ones"),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = P((d, v), ("d_model", "vocab"))
    return defs


def _index_tree(tree: Tree, i: int) -> Tree:
    """Layer ``i`` of every stacked leaf (views)."""
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Layer application (single layer, given its params)
# ---------------------------------------------------------------------------

def _apply_layer_full(lp: dict, x: torch.Tensor, cfg: ModelConfig, rope, mixer: str,
                      ffn: str, collect_state: bool):
    """→ (x, state): the layer's cache contribution — attn: {"k","v"} over
    the S positions seen; mamba: {"conv","h"} final — or None."""
    state = None
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if mixer == "attn":
        y, (k, v) = full_attention(lp["attn"], h, cfg, rope, causal=True)
        if collect_state:
            state = {"k": k, "v": v}
    elif collect_state:
        y, state = mamba_block(lp["mamba"], h, cfg, return_state=True)
    else:
        y = mamba_block(lp["mamba"], h, cfg)
    x = x + y
    if ffn != "none":
        x = x + mlp_block(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)
    return x, state


def _apply_layer_decode(lp: dict, x: torch.Tensor, cfg: ModelConfig, rope, mixer: str,
                        ffn: str, cache: Dict[str, torch.Tensor], pos: int) -> torch.Tensor:
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if mixer == "attn":
        y, _, _ = decode_attention(lp["attn"], h, cfg, rope, cache["k"], cache["v"], pos)
    else:
        y, conv_c, h_c = mamba_decode(lp["mamba"], h, cfg, cache["conv"], cache["h"])
        cache["conv"].copy_(conv_c)
        cache["h"].copy_(h_c)
    x = x + y
    if ffn != "none":
        x = x + mlp_block(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)
    return x


# ---------------------------------------------------------------------------
# Stack application
# ---------------------------------------------------------------------------

def apply_stack_full(
    cfg: ModelConfig,
    stack: Tree,
    x: torch.Tensor,
    rope,
    collect_state: bool = False,
):
    """Full-sequence pass → (x, aux_loss, states_stacked | None).  The
    auxiliary loss is the MoE balance term, zero for the dense and SSM
    stacks.  With ``cfg.remat``, no state to collect and grad enabled,
    each layer is checkpointed: its activations are recomputed in the
    backward pass instead of kept."""
    mixer, ffn = _check_ported(cfg)

    def layer(lp, x):
        return _apply_layer_full(lp, x, cfg, rope, mixer, ffn, collect_state)

    remat = cfg.remat and not collect_state and torch.is_grad_enabled()
    states = []
    for li in range(cfg.n_layers):
        lp = _index_tree(stack, li)
        if remat:
            x, st = checkpoint(layer, lp, x, use_reentrant=False)
        else:
            x, st = layer(lp, x)
        states.append(st)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if not collect_state:
        return x, aux, None
    stacked = {key: torch.stack([st[key] for st in states]) for key in states[0]}
    return x, aux, stacked


def apply_stack_decode(
    cfg: ModelConfig,
    stack: Tree,
    x: torch.Tensor,
    rope,
    caches: Cache,
    pos: int,
):
    """One-token pass → (x, caches); each layer writes its slice of the
    stacked caches in place, and the same dict is returned."""
    mixer, ffn = _check_ported(cfg)
    for li in range(cfg.n_layers):
        x = _apply_layer_decode(_index_tree(stack, li), x, cfg, rope, mixer, ffn,
                                _index_tree(caches, li), pos)
    return x, caches


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def _attn_cache_defs(cfg: ModelConfig, batch: int, s_max: int) -> Dict[str, P]:
    hd = cfg.resolved_head_dim
    return {
        "k": P((batch, s_max, cfg.n_kv_heads, hd),
               ("batch", "kv_seq", "kv_heads", "head_dim"), "zeros"),
        "v": P((batch, s_max, cfg.n_kv_heads, hd),
               ("batch", "kv_seq", "kv_heads", "head_dim"), "zeros"),
    }


def _mamba_cache_defs(cfg: ModelConfig, batch: int) -> Dict[str, P]:
    return {
        "conv": P((batch, cfg.ssm_conv - 1, cfg.d_inner),
                  ("batch", None, "d_inner"), "zeros"),
        "h": P((batch, cfg.d_inner, cfg.ssm_state),
               ("batch", "d_inner", "ssm_state"), "zeros"),
    }


def cache_defs(cfg: ModelConfig, batch: int, s_max: int) -> Tree:
    """Declaration of the decode cache tree (P descriptors)."""
    mixer, _ = _check_ported(cfg)
    one = (_attn_cache_defs(cfg, batch, s_max) if mixer == "attn"
           else _mamba_cache_defs(cfg, batch))
    return _stack(one, cfg.n_layers)

