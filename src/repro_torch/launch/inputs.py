"""``input_specs`` — stand-ins for every (arch × shape) cell's inputs.

Each stand-in is a tensor on the ``meta`` device, with the reference's
shape and dtype, so nothing is allocated.  Modality stubs per the
assignment: vlm gets precomputed patch embeddings, audio gets precomputed
frame embeddings — both consume part of the assigned sequence so the
*total* token count per cell is exactly the assigned ``seq_len ×
global_batch``.  Shardings (where a mesh is given) are ``NamedSharding``s
of the port's ``spec_for``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.base import ModelConfig, ShapeSpec
from ..distributed.sharding import ACT_RULES_DECODE, ACT_RULES_TRAIN, NamedSharding, spec_for
from ..models.model import Model
from ..models.params import tree_map_defs

Tree = Any


def _batch_axes(mesh):
    return ("pod", "data") if (mesh is not None and "pod" in mesh.shape) else ("data",)


def _sd(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_inputs(cfg: ModelConfig, shape: ShapeSpec, mesh) -> Tuple[Tree, Tree]:
    """→ (abstract batch, shardings) for the training step."""
    gb, s = shape.global_batch, shape.seq_len
    rules = dict(ACT_RULES_TRAIN)
    rules["batch"] = _batch_axes(mesh)
    batch: Dict[str, Any] = {}
    shard: Dict[str, Any] = {}

    def add(name, shp, dtype, axes):
        batch[name] = _sd(shp, dtype)
        if mesh is not None:
            shard[name] = NamedSharding(mesh, spec_for(shp, axes, mesh, rules))

    if cfg.family == "vlm":
        s_text = s - cfg.n_vision_tokens
        add("tokens", (gb, s_text), torch.int32, ("batch", "seq"))
        add(
            "vision_embeds",
            (gb, cfg.n_vision_tokens, cfg.d_model),
            torch.bfloat16,
            ("batch", None, None),
        )
    elif cfg.family == "encdec":
        add("tokens", (gb, s), torch.int32, ("batch", "seq"))
        add(
            "frames",
            (gb, cfg.enc_seq, cfg.d_model),
            torch.bfloat16,
            ("batch", "seq", None),
        )
    else:
        add("tokens", (gb, s), torch.int32, ("batch", "seq"))
    return batch, shard


def prefill_inputs(cfg: ModelConfig, shape: ShapeSpec, mesh) -> Tuple[Tree, Tree]:
    return train_inputs(cfg, shape, mesh)


def decode_inputs(cfg: ModelConfig, shape: ShapeSpec, mesh) -> Tuple[Tree, Tree]:
    """→ (abstract (token, pos, caches), shardings) for one decode step."""
    gb, s_max = shape.global_batch, shape.seq_len
    model = Model(cfg)
    rules = dict(ACT_RULES_DECODE)
    rules["batch"] = _batch_axes(mesh)

    token = _sd((gb, 1), torch.int32)
    pos = _sd((), torch.int32)
    token_sh = pos_sh = None
    if mesh is not None:
        token_sh = NamedSharding(mesh, spec_for((gb, 1), ("batch", None), mesh, rules))
        pos_sh = NamedSharding(mesh, ())

    cdefs = model.cache_defs(gb, s_max)
    caches = tree_map_defs(
        lambda p: _sd(
            p.shape,
            torch.float32 if ("ssm_state" in p.axes and p.axes[-1] == "ssm_state")
            else torch.bfloat16,
        ),
        cdefs,
    )
    cache_sh = None
    if mesh is not None:
        cache_sh = tree_map_defs(
            lambda p: NamedSharding(mesh, spec_for(p.shape, p.axes, mesh, rules)), cdefs
        )
    return (token, pos, caches), (token_sh, pos_sh, cache_sh)


def input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh) -> Tuple[Tree, Tree]:
    if shape.kind == "decode":
        return decode_inputs(cfg, shape, mesh)
    return train_inputs(cfg, shape, mesh)
