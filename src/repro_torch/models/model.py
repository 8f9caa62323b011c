"""Unified model API over every family: dense, MoE, SSM, hybrid,
encoder-decoder and VLM.

``Model(cfg)`` exposes:

* ``defs()`` / ``init(generator, device)`` / ``abstract()`` — parameters
* ``loss(params, batch)``       — next-token CE (+ MoE aux), f32
* ``prefill(params, batch, s_max)`` — full pass → (last logits, caches)
* ``decode(params, token, pos, caches)`` — one-token step
* ``cache_defs(batch, s_max)`` / ``init_caches(batch, s_max, device)``

Batch keys by family: ``tokens`` (all LM), ``vision_embeds`` (vlm stub),
``frames`` (audio stub), optional ``loss_mask``.  ``decode`` returns
``[B, V]`` logits for every family (the reference's encoder-decoder step
keeps a length-1 sequence axis, ``[B, 1, V]``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig
from . import encdec as ed
from .layers import rms_norm, rope_tables
from .params import P, Tree, abstract_params, dtype_of, init_params, param_axes, tree_map_defs
from .transformer import (
    apply_stack_decode,
    apply_stack_full,
    cache_defs as tf_cache_defs,
    model_defs,
)


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # -- parameters -----------------------------------------------------------
    def defs(self) -> Tree:
        if self.cfg.family == "encdec":
            return ed.encdec_defs(self.cfg)
        return model_defs(self.cfg)

    def init(self, generator: torch.Generator, device="cuda", shard=None) -> Tree:
        """Seeded parameters on ``device``; ``shard`` keeps a rank's blocks
        (``init_params``)."""
        return init_params(self.defs(), generator, self.cfg.param_dtype, device, shard)

    def abstract(self) -> Tree:
        return abstract_params(self.defs(), self.cfg.param_dtype)

    def axes(self) -> Tree:
        return param_axes(self.defs())

    # -- embedding / head -------------------------------------------------------
    def _embed(self, params: Tree, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens].to(dtype_of(self.cfg.compute_dtype))

    def _head(self, params: Tree, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, params["ln_f"], self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            logits = x @ params["embed"].T
        else:
            logits = x @ params["lm_head"]
        return logits.float()

    def _rope(self, positions: torch.Tensor):
        if not self.cfg.use_rope or self.cfg.n_heads == 0:
            return None
        return rope_tables(positions, self.cfg.resolved_head_dim, self.cfg.rope_theta)

    def _assemble_input(self, params: Tree, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Token embeddings with modality-stub prefixes prepended."""
        x = self._embed(params, batch["tokens"])
        if self.cfg.family == "vlm":
            vis = batch["vision_embeds"].to(x.dtype)     # [B, n_vis, d]
            x = torch.cat([vis, x], dim=1)
        return x

    # -- training loss -----------------------------------------------------------
    def loss(
        self, params: Tree, batch: Dict[str, torch.Tensor]
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token cross-entropy in float32 (over ``loss_mask``'s
        positions where given) plus the auxiliary loss → (total, {"ce",
        "aux"})."""
        cfg = self.cfg
        if cfg.family == "encdec":
            enc = ed.encode(params, batch["frames"], cfg)
            logits, _ = ed.decode_full(params, batch["tokens"], enc, cfg)
            aux = torch.zeros((), dtype=torch.float32, device=logits.device)
            n_prefix = 0
        else:
            x = self._assemble_input(params, batch)
            rope = self._rope(torch.arange(x.shape[1], device=x.device))
            x, aux, _ = apply_stack_full(cfg, params["stack"], x, rope)
            logits = self._head(params, x)
            n_prefix = cfg.n_vision_tokens if cfg.family == "vlm" else 0

        tokens = batch["tokens"]
        # predict token t+1 from position (n_prefix + t)
        pred = logits[:, n_prefix: n_prefix + tokens.shape[1] - 1]
        tgt = tokens[:, 1:].long()
        logz = torch.logsumexp(pred, dim=-1)
        gold = torch.gather(pred, -1, tgt[..., None])[..., 0]
        nll = logz - gold
        mask = batch.get("loss_mask")
        if mask is not None:
            m = mask[:, 1:].float()
            ce = (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
        else:
            ce = nll.mean()
        total = ce + cfg.aux_loss_weight * aux
        return total, {"ce": ce, "aux": aux}

    # -- serving ---------------------------------------------------------------
    def cache_defs(self, batch: int, s_max: int) -> Tree:
        if self.cfg.family == "encdec":
            return ed.encdec_cache_defs(self.cfg, batch, s_max)
        return tf_cache_defs(self.cfg, batch, s_max)

    def init_caches(self, batch: int, s_max: int, device="cuda") -> Tree:
        """Zero caches: the SSM state ``h`` in float32, the rest (k, v, the
        conv window) in the compute dtype."""
        def mk(p: P):
            dt = torch.float32 if "ssm_state" in p.axes else dtype_of(self.cfg.compute_dtype)
            return torch.zeros(p.shape, dtype=dt, device=device)

        return tree_map_defs(mk, self.cache_defs(batch, s_max))

    def prefill(
        self, params: Tree, batch: Dict[str, torch.Tensor], s_max: int
    ) -> Tuple[torch.Tensor, Tree]:
        """Full pass over the prompt → (logits at last position, caches)."""
        if self.cfg.family == "encdec":
            enc = ed.encode(params, batch["frames"], self.cfg)
            logits, states = ed.decode_full(params, batch["tokens"], enc, self.cfg,
                                            collect_state=True)
            return logits[:, -1], self._pad_states(states, s_max)
        x = self._assemble_input(params, batch)
        rope = self._rope(torch.arange(x.shape[1], device=x.device))
        x, _, states = apply_stack_full(
            self.cfg, params["stack"], x, rope, collect_state=True
        )
        logits = self._head(params, x[:, -1:])[:, 0]
        return logits, self._pad_states(states, s_max)

    def _pad_states(self, states: Tree, s_max: int) -> Tree:
        """Place prefill k/v (length S) into zero caches of length s_max,
        at any depth of the tree; the other leaves (mamba states, the
        encoder's ek/ev) stay as they are."""

        def pad(name: str, arr: torch.Tensor) -> torch.Tensor:
            if name not in ("k", "v"):
                return arr
            # [L, B, S, nkv, hd] → [L, B, s_max, nkv, hd]
            pad_len = s_max - arr.shape[2]
            if pad_len <= 0:
                return arr[:, :, :s_max]
            zeros = arr.new_zeros(arr.shape[:2] + (pad_len,) + arr.shape[3:])
            return torch.cat([arr, zeros], dim=2)

        return _map_named(pad, states)

    def decode(
        self,
        params: Tree,
        token: torch.Tensor,         # [B, 1] integer
        pos: int,                    # position being written
        caches: Tree,
    ) -> Tuple[torch.Tensor, Tree]:
        """One-token step → (logits [B, V], caches).  The caches are
        updated in place and returned."""
        if self.cfg.family == "encdec":
            logits, caches = ed.decode_step(params, token, int(pos), caches, self.cfg)
            return logits[:, 0], caches
        x = self._embed(params, token)
        rope = self._rope(torch.tensor([int(pos)], device=x.device))
        x, caches = apply_stack_decode(self.cfg, params["stack"], x, rope, caches, int(pos))
        return self._head(params, x)[:, 0], caches


def _map_named(fn, tree):
    """Map over a dict tree passing each leaf's key."""
    if isinstance(tree, dict):
        return {k: (_map_named(fn, v) if isinstance(v, dict) else fn(k, v))
                for k, v in tree.items()}
    return tree


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
