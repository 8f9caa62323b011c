"""Decoder-only stacks: dense and VLM (the VLM prepends patch embeddings
in ``model``; its stack is dense).

Parameters keep the reference's stacked layout — every leaf of
``stack`` is ``[L, ...]`` — so converting the reference's parameters is a
copy.  Where the reference scans over the stack (``lax.scan``), the port
runs a Python loop over layers, indexing layer ``l`` of every leaf (a
view, no copy).  Decode caches are stacked ``[L, B, S_max, nkv, hd]`` and
each layer writes its slice in place.

The SSM (mamba), MoE and hybrid stacks are later slices of the port; their
branches raise ``NotImplementedError`` naming the ROADMAP item.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.base import ModelConfig
from .attention import attn_defs, decode_attention, full_attention
from .layers import mlp_block, mlp_defs, rms_norm
from .params import P, Tree, tree_map_defs

Cache = Any

_LATER = {
    "mamba": "the SSM stack (models/ssm.py, kernel K4) is ROADMAP.md queue 1, "
             "item 1 (the training slice)",
    "moe": "the MoE layer (models/moe.py) is ROADMAP.md queue 1, item 2",
    "hybrid": "the hybrid stack needs models/ssm.py and models/moe.py: "
              "ROADMAP.md queue 1, items 1 and 2",
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
    if mixer != "attn":
        raise _not_ported("mamba")
    if ffn == "moe":
        raise _not_ported("moe")
    return mixer, ffn


def _one_layer_defs(cfg: ModelConfig, mixer: str, ffn: str) -> dict:
    d = cfg.d_model
    defs: dict = {"ln1": P((d,), ("d_model",), "ones"), mixer: attn_defs(cfg)}
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

def _apply_layer_full(lp: dict, x: torch.Tensor, cfg: ModelConfig, rope, ffn: str,
                      collect_state: bool):
    """→ (x, state): the layer's cache contribution {"k","v"} over the S
    positions seen, or None."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    y, (k, v) = full_attention(lp["attn"], h, cfg, rope, causal=True)
    x = x + y
    if ffn != "none":
        x = x + mlp_block(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)
    return x, ({"k": k, "v": v} if collect_state else None)


def _apply_layer_decode(lp: dict, x: torch.Tensor, cfg: ModelConfig, rope, ffn: str,
                        cache: Dict[str, torch.Tensor], pos: int) -> torch.Tensor:
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    y, _, _ = decode_attention(lp["attn"], h, cfg, rope, cache["k"], cache["v"], pos)
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
    auxiliary loss is the MoE balance term, zero for a dense stack."""
    _, ffn = _check_ported(cfg)
    states = []
    for li in range(cfg.n_layers):
        x, st = _apply_layer_full(_index_tree(stack, li), x, cfg, rope, ffn, collect_state)
        states.append(st)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if not collect_state:
        return x, aux, None
    stacked = {key: torch.stack([st[key] for st in states]) for key in ("k", "v")}
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
    _, ffn = _check_ported(cfg)
    for li in range(cfg.n_layers):
        x = _apply_layer_decode(_index_tree(stack, li), x, cfg, rope, ffn,
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


def cache_defs(cfg: ModelConfig, batch: int, s_max: int) -> Tree:
    """Declaration of the decode cache tree (P descriptors)."""
    _check_ported(cfg)
    return _stack(_attn_cache_defs(cfg, batch, s_max), cfg.n_layers)

