"""AdamW with decoupled weight decay, f32 state over bf16 params.

Plain functions over dict trees of tensors (not ``torch.optim``), as the
reference's are over pytrees: ``init`` returns (m, v, count), ``update``
consumes grads and returns new params + state, leaving its inputs as they
were.  The count and every scalar of the update (bias corrections, the
learning rate, the clip scale) stay 0-d tensors on the parameters' device,
so a step reads nothing back to the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from ..models.params import flatten

Tree = Any


class AdamWState(NamedTuple):
    m: Tree
    v: Tree
    count: torch.Tensor


def _map(fn, *trees):
    """``fn`` over the leaves of same-structured dict trees."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


@dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0

    def init(self, params: Tree) -> AdamWState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        device = next(flatten(params))[1].device
        return AdamWState(
            m=_map(zeros, params),
            v=_map(zeros, params),
            count=torch.zeros((), dtype=torch.int32, device=device),
        )

    def _lr(self, count: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(count)
        return torch.full((), self.lr, dtype=torch.float32, device=count.device)

    def update(
        self, grads: Tree, state: AdamWState, params: Tree,
        sq_total: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        donate: bool = False,
    ) -> Tuple[Tree, AdamWState, torch.Tensor]:
        """→ (new_params, new_state, global_grad_norm).

        Clip scaling is folded into the per-leaf update (never materializes
        a second full-precision gradient tree), and each leaf's float32
        temporaries are freed before the next leaf's are made.  On a rank
        mesh the trees hold this rank's blocks (moments inherit the
        parameters' sharding), the update runs on them elementwise, and
        ``sq_total`` makes the norm the whole tree's (:func:`global_norm`).
        ``donate``: ``params`` and ``state`` may be overwritten (the
        reference's jitted step donates them): each leaf is updated in
        place, with the same numbers, and returned.
        """
        gnorm = global_norm(grads, sq_total)
        if self.grad_clip is not None:
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        else:
            scale = torch.ones((), dtype=torch.float32, device=gnorm.device)

        count = state.count + 1
        b1c = 1.0 - self.b1 ** count.float()
        b2c = 1.0 - self.b2 ** count.float()
        lr = self._lr(count)

        def upd(p, g, m, v):
            g = g.float() * scale
            m = m.mul_(self.b1) if donate else m * self.b1
            m.add_(g, alpha=1.0 - self.b1)
            v = v.mul_(self.b2) if donate else v * self.b2
            v.addcmul_(g, g, value=1.0 - self.b2)
            del g
            step = m / b1c
            step.div_((v / b2c).sqrt_().add_(self.eps))
            pf = p.float()
            step.add_(pf, alpha=self.weight_decay).mul_(lr)
            new = step.neg_().add_(pf).to(p.dtype)
            return (p.copy_(new) if donate else new), m, v

        out = _map(upd, params, grads, state.m, state.v)
        pick = lambda i: _map(lambda o: o[i], out)  # noqa: E731
        return pick(0), AdamWState(pick(1), pick(2), count), gnorm


def global_norm(tree: Tree, sq_total: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                ) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in float32, summed leaf by
    leaf in the reference's (sorted-key) order.  ``sq_total`` maps the
    vector of each leaf's sum of squares to the whole leaves' where the
    leaves are this rank's blocks (``distributed/actctx.py::whole_sq_sums``)."""
    sq = torch.stack([torch.sum(torch.square(leaf.float())) for _, leaf in flatten(tree)])
    if sq_total is not None:
        sq = sq_total(sq)
    return torch.sqrt(sum(sq.unbind()))
