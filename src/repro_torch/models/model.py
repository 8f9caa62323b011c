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

Under an ``activation_sharding`` context whose mesh is a rank mesh of more
than one rank, every family's ``loss`` and ``prefill`` run sharded
(``distributed/actctx.py::rank_layout``), as the
reference's partitioned cell under the baseline, ``opt`` and small-DP
policies: ``params`` are this rank's blocks by the context's parameter
rules (``Model.init(shard=sharding.rank_shard(mesh, param_rules))``,
``convert.shard_params``), ``batch`` the whole batch on every rank.  The
embedding is a vocab-parallel lookup (rows outside this rank's block of
the vocabulary give 0), reduce-scattered into the residual stream's block
(the reference's ``constrain`` at ``_assemble_input``); the layers run on
this rank's heads and ``d_ff`` columns, or its ``d_inner`` channels, or
an MoE layer on its experts (``models/moe.py``: the global gather
dispatch under the baseline, the a2a body on the stream's block where
``moe_impl="a2a"`` applies); a hybrid period runs each slot as its own
family runs its layer, one slot's weights gathered at a time
(``models/transformer.py``); the head is vocab-parallel.  A VLM's
stream holds its vision embeddings before the tokens: the tokens' partial
lookup leaves zeros in the prefix's places before the sum, and the
rank's block of the prefix is added after it (exact: one of the two terms
is zero), so the prefix is never summed over ``model``; the loss predicts
token t + 1 from position ``n_vision_tokens + t``.  An encoder-decoder's
encoder runs on a layout of its own ``enc_seq`` positions, its output
gathered over ``model`` once a pass; its decoder adds the sinusoidal
positions of the rank's block after the lookup's sum, in the parameters'
dtype, and each decoder layer runs the cross-attention on the rank's
heads (``models/encdec.py``, ``attention.cross_attention``).  A tied
head is the embedding's vocab-parallel block, gathered over ``data`` for the
head as for the lookup: its logits are ``x @ block.T``, this rank's block
of the vocabulary, and under autograd the leaf's gradient sums both uses.
``prefill`` returns this rank's block of the last position's logits,
``[B / batch ranks, V / model ranks]`` (the reference's output spec
``(batch, vocab)``), and this rank's blocks of the caches in the layout
the reference's prefill cell writes them (``out_shardings`` under
``ACT_RULES_DECODE``, ``sharding.decode_rules``): its rows, its block of
positions over ``model`` (every position where ``s_max`` does not divide
the axis), every kv head; the mamba states its rows and block of
``d_inner``; a hybrid's nested tree holds both kinds, slot by slot
(:meth:`Model._cache_blocks`); an encoder-decoder's ``ek`` and ``ev``
every encoder position and kv head on its rows (``ACT_RULES_DECODE`` has
no ``kv_heads`` rule: one all-gather of the rank's heads over ``model``,
``prefill/xcache``).  Under the decode rules ``decode`` runs
the reference's decode cell: ``token`` the whole ``[B, 1]``, ``caches``
this rank's blocks in that layout (``s_max`` the attention caches' whole
length; an SSM's caches do not grow), the softmax across the ranks'
blocks of positions (``attention.decode_attention``) or the mamba update
on the rank's channels (``ssm.mamba_decode``), an MoE layer with its
expert stacks' ``d_model`` blocks in place under the gather dispatch
(``RankLayout.experts_stationary``), an encoder-decoder's cross-attention
on the rank's q heads against those heads of the whole ``ek``/``ev``; it
returns this rank's ``[B / batch ranks, V / model ranks]`` logits and
writes its blocks in place.  A dense, VLM, SSM or hybrid tick whose batch
does not split over ``data`` keeps every ``d_model`` block in place
(:data:`STATIONARY_FAMILIES`, ``actctx.keeps_d_blocks``): the lookup's block
gathered over ``data``, every slot's in-projections partial products
summed over it and its output block gathered over it
(``models/transformer.py``), the head's float32 partial products over
``d_model`` summed over it.  ``loss`` takes a vocab-parallel
cross-entropy — each rank's log-sum-exp and gold logit over its block of
the vocabulary, gathered over ``model`` and combined — and returns the
mean over every position of the global batch, the same on every rank,
plus the MoE balance term over the global token population, also the
same on every rank.  Under autograd the loss is the root of the backward
pass through the collectives' transposes
(``distributed/collectives.py``): the cross-entropy and the balance term
each seed their cotangent as shares, and each leaf's gradient comes back
as this rank's share, which ``launch/steps.py::make_train_step`` sums
over the axes the leaf is held alike along.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..obs.device import span
from . import encdec as ed
from .layers import rms_norm, rope_tables, sinusoidal_positions
from .params import (P, Tree, abstract_params, dtype_of, flatten, init_params, param_axes,
                     tree_map_defs)
from .transformer import (
    apply_stack_decode,
    apply_stack_full,
    cache_defs as tf_cache_defs,
    model_defs,
)


#: The families whose decode tick keeps every ``d_model`` block in place
#: where its batch does not split over ``data`` (``RankLayout.stationary``).
STATIONARY_FAMILIES = ("dense", "vlm", "ssm", "hybrid")

#: The model's spans on the timeline (``obs``): a prefill, a decode step,
#: and the prefill's k/v padded to the caches' length.
_PREFILL, _DECODE, _PAD = span("model.prefill"), span("model.decode"), span("prefill.pad")


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
    def _embed(self, params: Tree, tokens: torch.Tensor, lay=None, prefix: int = 0,
               start: int = 0) -> torch.Tensor:
        """The tokens' embeddings in the compute dtype; ``lay``: this
        rank's block of the residual stream, from its rows' tokens (module
        docstring).  ``prefix``: the stream's first positions, which the
        tokens do not fill (a VLM's vision embeddings), zeros before the
        sum.  An encoder-decoder's embedding, from the parameters, takes
        the sinusoidal positions from ``start`` on (``lay``: of its block)
        after the sum, in the parameters' dtype, as the reference adds
        them."""
        cfg = self.cfg
        encdec = cfg.family == "encdec"
        dtype = params["embed"].dtype if encdec else dtype_of(cfg.compute_dtype)
        if lay is None:
            x = params["embed"][tokens].to(dtype)
        else:
            emb = params["embed"]
            if not lay.stationary:
                emb = lay.gather_params({"embed": emb}, self.defs(), "embed")["embed"]
            n_v = emb.shape[0]
            partial = n_v != cfg.vocab_size
            if partial:
                idx = tokens - lay.mi * n_v
                inside = (idx >= 0) & (idx < n_v)
                x = torch.where(inside[..., None], emb[idx.clamp(0, n_v - 1)], 0).to(dtype)
            else:
                x = emb[tokens].to(dtype)
            if prefix:
                x = torch.cat([x.new_zeros(x.shape[0], prefix, x.shape[2]), x], 1)
            x = lay.scatter_seq(x, partial, "embed")
            if lay.stationary:
                x = lay.whole_d(x, "embed/data")
            start += lay.s0
        if encdec:
            pos = sinusoidal_positions(torch.arange(start, start + x.shape[1], device=x.device),
                                       cfg.d_model)
            x = (x + pos[None].to(x.dtype)).to(dtype_of(cfg.compute_dtype))
        return x

    def _head(self, params: Tree, x: torch.Tensor, lay=None) -> torch.Tensor:
        w = "embed" if self.cfg.tie_embeddings else "lm_head"
        if lay is not None and lay.stationary:     # this rank's d_model block
            x = rms_norm(x, params["ln_f"], self.cfg.norm_eps, lay)
            w = params[w].T if self.cfg.tie_embeddings else params[w]
            return lay.contract(x, w, "head").float()
        if lay is not None:
            params = lay.gather_params({k: params[k] for k in ("ln_f", w)}, self.defs(), "head")
        x = rms_norm(x, params["ln_f"], self.cfg.norm_eps)
        logits = x @ (params["embed"].T if self.cfg.tie_embeddings else params["lm_head"])
        return logits.float()

    def _n_prefix(self) -> int:
        """The stream's positions before the tokens': a VLM's vision
        embeddings."""
        return self.cfg.n_vision_tokens if self.cfg.family == "vlm" else 0

    def _layout(self, batch: Dict[str, torch.Tensor]):
        """The rank layout of this batch's residual stream under the active
        context (on a rank mesh), or None: a VLM's stream holds its vision
        prefix; an encoder-decoder's is its decoder's (its encoder takes
        ``rank_layout`` of the frames)."""
        from ..distributed.actctx import rank_layout

        b, s = batch["tokens"].shape
        return rank_layout(b, self._n_prefix() + s, self.cfg.d_model)

    def cache_layout(self, lay, s_max: int, rules):
        """``lay`` with this rank's blocks of the decode caches under
        ``rules``: ``actctx.cache_layout`` of the first attention cache of
        ``s_max`` positions, of the first mamba state and of the first
        cross-attention cache, whichever the model has (a hybrid the first
        two, an encoder-decoder the first and the last, one call each).  The
        layout of a family of :data:`STATIONARY_FAMILIES` keeps every
        ``d_model`` block in place where the batch does not split over
        ``data`` (``stationary``, ``actctx.keeps_d_blocks``); an MoE or
        hybrid model's keeps its expert stacks' ``d_model`` blocks in place
        under the gather dispatch where they split over ``data``
        (``experts_stationary``, ``actctx.keeps_expert_blocks``)."""
        from ..distributed.actctx import cache_layout, keeps_d_blocks, keeps_expert_blocks
        from .moe import a2a_on_ranks

        cfg = self.cfg
        first = {}
        for path, decl in flatten(self.cache_defs(lay.b, s_max)):
            first.setdefault(path[-1], decl)
        for leaf in ("k", "h", "ek"):
            if leaf in first:
                lay = cache_layout(lay, first[leaf], rules)
        experts = (cfg.family in ("moe", "hybrid") and not a2a_on_ranks(cfg, lay.mesh)
                   and keeps_expert_blocks(lay.mesh, lay.param_rules, cfg.d_model))
        return replace(lay, experts_stationary=experts,
                       stationary=(cfg.family in STATIONARY_FAMILIES
                                   and keeps_d_blocks(lay, cfg.d_model)))

    def _rope(self, positions: torch.Tensor):
        if not self.cfg.use_rope or self.cfg.n_heads == 0:
            return None
        return rope_tables(positions, self.cfg.resolved_head_dim, self.cfg.rope_theta)

    def _assemble_input(self, params: Tree, batch: Dict[str, torch.Tensor],
                        lay=None) -> torch.Tensor:
        """Token embeddings with modality-stub prefixes prepended (``lay``:
        this rank's block of the stream, from its rows: the prefix's block
        added after the tokens' sum, to the zeros that left its places
        exact)."""
        tokens = batch["tokens"] if lay is None else lay.rows(batch["tokens"])
        n = self._n_prefix()
        x = self._embed(params, tokens, lay, prefix=n if lay is not None else 0)
        if not n:
            return x
        vis = batch["vision_embeds"] if lay is None else lay.rows(batch["vision_embeds"])
        vis = vis.to(x.dtype)     # [B, n_vis, d]
        if lay is None:
            return torch.cat([vis, x], dim=1)
        vis = torch.cat([vis, vis.new_zeros(vis.shape[0], tokens.shape[1], vis.shape[2])], 1)
        return x + vis[:, lay.s0:lay.s0 + lay.s_loc]

    def _forward(self, params: Tree, batch: Dict[str, torch.Tensor], lay=None,
                 collect_state: bool = False):
        """The stack over the batch → (the last layer's output, the aux
        loss, the states or None): an encoder-decoder's decoder over its
        encoder's output, else the decoder-only stack over the assembled
        input; ``lay``: this rank's block (module docstring)."""
        cfg = self.cfg
        if cfg.family != "encdec":
            x = self._assemble_input(params, batch, lay)
            rope = self._rope(torch.arange(x.shape[1] if lay is None else lay.s,
                                           device=x.device))
            return apply_stack_full(cfg, params["stack"], x, rope, collect_state, lay)
        from ..distributed.actctx import rank_layout

        frames, tokens = batch["frames"], batch["tokens"]
        enc = ed.encode(params, frames, cfg,
                        None if lay is None else rank_layout(*frames.shape[:2], cfg.d_model))
        x = self._embed(params, tokens if lay is None else lay.rows(tokens), lay)
        x, states = ed.decode_full(params, x, enc, cfg, collect_state, lay)
        return x, torch.zeros((), dtype=torch.float32, device=x.device), states

    # -- training loss -----------------------------------------------------------
    def loss(
        self, params: Tree, batch: Dict[str, torch.Tensor]
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token cross-entropy in float32 (over ``loss_mask``'s
        positions where given) plus the auxiliary loss → (total, {"ce",
        "aux"})."""
        cfg = self.cfg
        tokens, mask = batch["tokens"], batch.get("loss_mask")
        lay = self._layout(batch)
        if lay is not None:
            logz, gold, aux = self._sharded_nll(params, batch, lay)
            mask = None if mask is None else lay.rows(mask)
        else:
            x, aux, _ = self._forward(params, batch)
            logits = self._head(params, x)
            # predict token t+1 from position (n_prefix + t)
            n = self._n_prefix()
            pred = logits[:, n: n + tokens.shape[1] - 1]
            logz = torch.logsumexp(pred, dim=-1)
            gold = torch.gather(pred, -1, tokens[:, 1:].long()[..., None])[..., 0]
        nll = logz - gold
        if mask is None and lay is None:
            ce = nll.mean()
        else:
            m = torch.ones_like(nll) if mask is None else mask[:, 1:].float()
            sums = torch.stack([(nll * m).sum(), m.sum()])
            if lay is not None:     # over the batch's ranks
                from ..distributed.collectives import psum

                sums = psum(sums, lay.mesh, lay.batch, "loss/mean")
            ce = sums[0] / torch.clamp(sums[1], min=1.0)
            if lay is not None:     # every rank holds both: each seeds a share
                from ..distributed.collectives import seed_shares

                ce, aux = seed_shares(ce, lay.mesh), seed_shares(aux, lay.mesh)
        total = ce + cfg.aux_loss_weight * aux
        return total, {"ce": ce, "aux": aux}

    def _sharded_nll(self, params: Tree, batch: Dict[str, torch.Tensor], lay):
        """On a rank mesh (module docstring): this rank's rows' (log-sum-exp,
        gold logit) of every next-token prediction over the whole
        vocabulary, by a vocab-parallel cross-entropy, and the aux loss.
        Token t + 1 is predicted from the stream's position ``n_prefix +
        t``."""
        from ..distributed.collectives import all_gather

        x, aux, _ = self._forward(params, batch, lay)
        n, s = self._n_prefix(), batch["tokens"].shape[1]
        pred = self._head(params, lay.gather_seq(x, "loss/x")[:, n:n + s - 1], lay)  # rank's V
        n_v = pred.shape[-1]
        split = n_v != self.cfg.vocab_size
        tgt = lay.rows(batch["tokens"])[:, 1:].long() - (lay.mi * n_v if split else 0)
        inside = (tgt >= 0) & (tgt < n_v)
        gold = torch.gather(pred, -1, tgt.clamp(0, n_v - 1)[..., None])[..., 0]
        part = torch.stack([torch.logsumexp(pred, dim=-1), torch.where(inside, gold, 0.0)])
        if split:
            part = all_gather(part, lay.mesh, "model", 0, "loss/vocab").view(
                lay.n_model, *part.shape)
            part = torch.stack([torch.logsumexp(part[:, 0], dim=0), part[:, 1].sum(dim=0)])
        return part[0], part[1], aux

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
        with _PREFILL():
            lay = self._layout(batch)
            x, _, states = self._forward(params, batch, lay, collect_state=True)
            # one rank's encoder-decoder takes the head at every position, as the reference's does
            last = x if lay is None and self.cfg.family == "encdec" else x[:, -1:]
            if lay is not None and lay.seq_sharded:     # the last position's block: the last rank's
                from ..distributed.collectives import all_gather

                last = all_gather(last, lay.mesh, "model", 1, "prefill/last")[:, -1:]
            logits = self._head(params, last, lay)[:, -1]
            if lay is not None:
                return logits, self._cache_blocks(params, states, s_max, lay)
            return logits, self._pad_states(states, s_max)

    def _cache_blocks(self, params: Tree, states: Tree, s_max: int, lay) -> Tree:
        """The sharded prefill's states → this rank's blocks of the caches
        in the decode layout (module docstring), slot by slot for a
        hybrid.  The mamba states come out of the sharded prefill already
        on this rank's rows and ``d_inner`` block, the decode layout, so
        they are returned as they are, with no collective; the attention
        caches go through :meth:`_kv_blocks`, one op for each kind (``k``
        and ``v``; an encoder-decoder's ``ek`` and ``ev`` too) of a
        stack."""
        from ..distributed.sharding import decode_rules

        cl = self.cache_layout(lay, s_max, decode_rules(lay.mesh))
        if self.cfg.family == "hybrid":
            return {key: self._layer_blocks(params["stack"][key], st, s_max, lay, cl)
                    for key, st in states.items()}
        stack = params["decoder" if self.cfg.family == "encdec" else "stack"]
        return self._layer_blocks(stack, states, s_max, lay, cl)

    def _layer_blocks(self, lp: Tree, states: Tree, s_max: int, lay, cl) -> Tree:
        """One stack's (or slot's) states, its stacked weights ``lp``, in the
        decode layout ``cl`` (:meth:`_cache_blocks`): ``k`` and ``v`` in its
        blocks of positions, the cross-attention's ``ek`` and ``ev`` whole
        (``prefill/xcache``)."""
        if "h" in states:
            if tuple(states["h"].shape[1:3]) != (cl.b_loc, cl.di_loc):
                raise ValueError(f"states {tuple(states['h'].shape)} are not the caches' block")
            return states
        padded = self._pad_states(states, s_max)
        out = dict(zip(("k", "v"), self._kv_blocks(lp["attn"], torch.stack(
            [padded["k"], padded["v"]]), lay, "prefill/cache", cl)))
        if "ek" in states:
            out.update(zip(("ek", "ev"), self._kv_blocks(lp["xattn"], torch.stack(
                [states["ek"], states["ev"]]), lay, "prefill/xcache")))
        return out

    def _kv_blocks(self, attn: Tree, x: torch.Tensor, lay, path: str, cl=None):
        """``x`` ``[2, L, b, S, heads, hd]``: an attention stack's k and v
        (or ``ek`` and ``ev``) from the sharded prefill, this rank's rows
        over the whole sequence on the kv heads ``attention.rank_kv_heads``
        gives it (``attn`` its stacked weights) → (k, v): this rank's block
        of positions in the decode layout ``cl`` (every position without
        it), every kv head.  Where the kv heads split over ``model`` one
        all-to-all over ``model`` (``path``) swaps blocks of positions for
        blocks of heads; where they are whole, each rank sends the heads it
        has at their places and takes each head from the first rank that
        has it; where the positions do not split, an all-gather takes the
        place of the all-to-all.  Where the q heads do not split, every
        rank has every kv head and keeps its positions."""
        from ..distributed.collectives import all_gather, all_to_all
        from .attention import rank_kv_heads

        cfg, n = self.cfg, lay.n_model
        kv0, kv_loc, sharded = ((cl.kv0, cl.kv_loc, cl.kv_sharded) if cl is not None
                                else (0, x.shape[3], False))
        if attn["w_q"].shape[-2] == cfg.n_heads:
            x = x[:, :, :, kv0:kv0 + kv_loc]
            return x[0].contiguous(), x[1].contiguous()
        kv_split = attn["w_k"].shape[-2] != cfg.n_kv_heads
        if not kv_split:
            heads = [rank_kv_heads(cfg, attn["w_q"], attn["w_k"], j) for j in range(n)]
            full = x.new_zeros(x.shape[:-2] + (cfg.n_kv_heads, x.shape[-1]))
            full[..., heads[lay.mi], :] = x
            x = full
        if sharded:       # block j of positions to rank j
            x = all_to_all(x.unflatten(3, (n, kv_loc)).movedim(3, 0), lay.mesh, "model", path)
        else:
            x = all_gather(x[None], lay.mesh, "model", 0, path)
        if kv_split:            # x[j]: rank j's heads at this rank's positions
            x = x.movedim(0, -3).flatten(-3, -2)
        else:
            owner = torch.tensor([min(j for j in range(n) if h in heads[j])
                                  for h in range(cfg.n_kv_heads)], device=x.device)
            x = x[owner, ..., torch.arange(cfg.n_kv_heads, device=x.device), :].movedim(0, -2)
        return x[0].contiguous(), x[1].contiguous()

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

        with _PAD():
            return _map_named(pad, states)

    def decode(
        self,
        params: Tree,
        token: torch.Tensor,         # [B, 1] integer
        pos: int,                    # position being written
        caches: Tree,
        s_max: Optional[int] = None,
    ) -> Tuple[torch.Tensor, Tree]:
        """One-token step → (logits [B, V], caches).  The caches are
        updated in place and returned.  On a rank mesh (module docstring)
        ``s_max`` is the attention caches' whole length, which their blocks
        do not tell (an SSM needs none); every ``k``, ``h`` and ``ek`` leaf
        must be this rank's block."""
        from ..distributed.actctx import active, rank_layout

        with _DECODE():
            cfg = self.cfg
            lay = rank_layout(*token.shape, cfg.d_model)
            if lay is not None:
                if s_max is None and cfg.family != "ssm":
                    raise ValueError("a decode on a rank mesh needs the caches' length, s_max")
                lay = self.cache_layout(lay, s_max or 0, active()[1])
                blocks = {"k": (lay.kv_loc, "positions"), "h": (lay.di_loc, "channels"),
                          "ek": (cfg.enc_seq, "positions")}
                for path, leaf in flatten(caches):
                    if path[-1] in blocks and tuple(leaf.shape[1:3]) != (lay.b_loc,
                                                                         blocks[path[-1]][0]):
                        raise ValueError(f"caches {'/'.join(path)} {tuple(leaf.shape)} are not "
                                         f"this rank's {lay.b_loc} rows and {blocks[path[-1]][0]} "
                                         f"{blocks[path[-1]][1]}")
                token = lay.rows(token)
            x = self._embed(params, token, lay, start=int(pos))
            if cfg.family == "encdec":
                x, caches = ed.decode_step(params, x, int(pos), caches, cfg, lay)
            else:
                rope = self._rope(torch.tensor([int(pos)], device=x.device))
                x, caches = apply_stack_decode(cfg, params["stack"], x, rope, caches, int(pos), lay)
            return self._head(params, x, lay)[:, 0], caches


def _map_named(fn, tree):
    """Map over a dict tree passing each leaf's key."""
    if isinstance(tree, dict):
        return {k: (_map_named(fn, v) if isinstance(v, dict) else fn(k, v))
                for k, v in tree.items()}
    return tree


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
