"""Batched serving engine: continuous-batching decode loop on one replica.

``ServeEngine`` owns params + a slot-based KV cache region: requests are
admitted into free slots (prefill), every engine tick decodes one token for
all active slots, finished requests free their slots.  Cluster-level
dispatch across replicas is ``router.BassRouter`` — the paper's scheduler
deciding *which replica* serves a request based on prefix locality, queue
backlog and the bandwidth needed to migrate context.

The engine runs on ``device`` (``"cuda"`` unless the caller asks for the
CPU); there the prefill's attention goes through the flash-attention
kernel when ``cfg.attn_impl == "pallas"``.

Spans on the timeline (``obs``): ``engine.admit`` keyed by the request's
``rid`` (the prefill and ``engine.write_slot`` in it), ``engine.tick``
keyed by the tick's number (``model.decode`` in it).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np
import torch

from ..models.model import Model
from ..obs.device import span

Tree = Any

_ADMIT, _WRITE_SLOT, _TICK = span("engine.admit"), span("engine.write_slot"), span("engine.tick")


@dataclass
class Request:
    rid: int
    prompt: np.ndarray               # [S] int32
    max_new: int
    prefix_hash: int = 0             # locality key for the router
    submitted_at: float = field(default_factory=time.monotonic)
    tokens_out: List[int] = field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(
        self,
        model: Model,
        params: Tree,
        slots: int,
        s_max: int,
        name: str = "replica0",
        device="cuda",
    ):
        self.model = model
        self.params = params
        self.cfg = model.cfg
        self.slots = slots
        self.s_max = s_max
        self.name = name
        self.device = torch.device(device)
        self.active: Dict[int, Request] = {}      # slot -> request
        self._free = list(range(slots))
        self._caches = model.init_caches(slots, s_max, self.device)
        self._pos = np.zeros(slots, dtype=np.int32)
        self.ticks = 0                            # ticks run, the key of the next one

    # -- queueing -------------------------------------------------------------
    def backlog_seconds(self, per_token_s: float = 0.02) -> float:
        """ΥI for the router: projected seconds to drain current work."""
        remaining = sum(
            r.max_new - len(r.tokens_out) for r in self.active.values()
        )
        return remaining * per_token_s

    def has_capacity(self) -> bool:
        return bool(self._free)

    # -- admission --------------------------------------------------------------
    @torch.no_grad()
    def admit(self, req: Request) -> bool:
        with _ADMIT(req.rid):
            if not self._free:
                return False
            slot = self._free.pop(0)
            # Single-sequence prefill into this slot's cache region.
            batch = {"tokens": torch.as_tensor(req.prompt[None, :], device=self.device).long()}
            if self.cfg.family == "vlm":
                batch["vision_embeds"] = torch.zeros(
                    (1, self.cfg.n_vision_tokens, self.cfg.d_model),
                    dtype=torch.bfloat16, device=self.device,
                )
            if self.cfg.family == "encdec":
                batch["frames"] = torch.zeros(
                    (1, self.cfg.enc_seq, self.cfg.d_model),
                    dtype=torch.bfloat16, device=self.device,
                )
            logits, caches1 = self.model.prefill(self.params, batch, self.s_max)
            # Write the single-sequence cache into the slot of the batched cache.
            with _WRITE_SLOT():
                _write_slot(self._caches, caches1, slot)
            first = int(torch.argmax(logits[0]))
            req.tokens_out.append(first)
            n_prefix = self.cfg.n_vision_tokens if self.cfg.family == "vlm" else 0
            self._pos[slot] = len(req.prompt) + n_prefix
            self.active[slot] = req
            return True

    # -- decode tick --------------------------------------------------------------
    @torch.no_grad()
    def tick(self) -> List[Request]:
        """One decode step for all active slots; → finished requests."""
        if not self.active:
            return []
        self.ticks += 1
        with _TICK(self.ticks - 1):
            tokens = np.zeros((self.slots, 1), dtype=np.int64)
            for slot, req in self.active.items():
                tokens[slot, 0] = req.tokens_out[-1]
            # One position for the whole batch, as the reference keeps its step
            # compiled once: slots with shorter contexts simply have
            # masked-out upper positions.
            pos = int(self._pos.max())
            logits, self._caches = self.model.decode(
                self.params, torch.as_tensor(tokens, device=self.device), pos, self._caches
            )
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
            finished = []
            for slot, req in list(self.active.items()):
                req.tokens_out.append(int(nxt[slot]))
                self._pos[slot] += 1
                if len(req.tokens_out) >= req.max_new or self._pos[slot] >= self.s_max - 1:
                    req.done = True
                    finished.append(req)
                    del self.active[slot]
                    self._free.append(slot)
            return finished


def _write_slot(batched: Tree, single: Tree, slot: int) -> None:
    """Copy a 1-batch cache tree into slot ``slot`` of the batched tree, in
    place, at any depth (the hybrid's caches nest under ``slot{s}``).
    Cache leaves are stacked [L, B, ...]; batch is dim 1."""
    for key, leaf in batched.items():
        if isinstance(leaf, dict):
            _write_slot(leaf, single[key], slot)
        else:
            leaf[:, slot:slot + 1].copy_(single[key])
