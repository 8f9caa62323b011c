"""Train (with microbatch gradient accumulation), prefill, decode and
eval steps — the reference's ``launch/steps.py`` in eager PyTorch.

The train step differentiates ``Model.loss`` with ``torch.autograd.grad``
over the flattened parameter tree: each parameter enters the loss as a
detached leaf that requires grad, so the caller's tensors get no
``.grad`` and no graph outlives the step.  The other steps run without
autograd.

Under a rank mesh's ``activation_sharding`` context the train step runs
sharded (a dense model): ``params`` and the optimizer state are this
rank's blocks (by the context's parameter rules), ``batch`` the whole
global batch on every rank.  Each microbatch is the reference's (the
batch reshaped to ``(accum, B / accum, ...)``), of which ``Model.loss``
takes this rank's rows; the float32 accumulation buffer holds this rank's
blocks.  After the last microbatch each leaf is summed over the axes it
is held alike along (``actctx.sum_replicated``), and AdamW takes the
whole tree's norm (``actctx.whole_sq_sums``) and updates the blocks.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..distributed import actctx
from ..models.model import Model
from ..models.params import flatten, unflatten
from ..optim.adamw import AdamW, AdamWState


def make_train_step(
    model: Model,
    optimizer: AdamW,
    accum: int = 1,
    accum_dtype=torch.float32,
    donate: bool = False,
):
    """→ train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``accum_dtype`` controls the gradient-accumulation buffer: f32 default;
    bf16 halves it for memory-edge cells (≥8 summands at loss scale ~1
    keeps the rounding error well under the gradient noise floor).
    ``donate``: the step updates ``params`` and ``opt_state`` in place
    (``AdamW.update``), as the reference's cell donates them, so a step
    holds one copy of each.
    """

    def grad_fn(params, mb):
        return _loss_and_grads(model, params, mb)

    def train_step(params, opt_state: AdamWState, batch: Dict[str, torch.Tensor]):
        if accum <= 1:
            loss, grads = grad_fn(params, batch)
        else:
            gsum, lsum = None, None
            for i in range(accum):
                mb = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])[i]
                      for k, v in batch.items()}
                l, g = grad_fn(params, mb)
                if gsum is None:
                    gsum = {path: leaf.to(accum_dtype) for path, leaf in flatten(g)}
                    lsum = l.float()
                else:
                    for path, leaf in flatten(g):
                        gsum[path].add_(leaf)
                    lsum = lsum + l
                del g
            grads = unflatten(list(gsum), [g.div_(accum) for g in gsum.values()])
            loss = lsum / accum

        grads, sq_total = _synced(model, grads)
        new_params, new_opt, gnorm = optimizer.update(grads, opt_state, params, sq_total, donate)
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm}

    return train_step


def _loss_and_grads(model: Model, params, batch):
    """(the loss, the gradient tree) of ``Model.loss`` at ``params``."""
    paths, leaves = zip(*flatten(params))
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss, _metrics = model.loss(unflatten(paths, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return loss.detach(), unflatten(paths, grads)


def _synced(model: Model, grads):
    """(the gradient, the map from its leaves' sums of squares to the whole
    leaves', or None): on a rank mesh each leaf summed over the axes it is
    held alike along (``actctx.sum_replicated``), the sums of squares by
    ``actctx.whole_sq_sums``."""
    if (ranks := actctx.rank_params()) is None:
        return grads, None
    defs = model.defs()
    return (actctx.sum_replicated(grads, defs, *ranks),
            lambda sq: actctx.whole_sq_sums(sq, defs, *ranks))


def make_grad_step(model: Model):
    """→ grad_step(params, batch) -> {"loss", "grad_norm"}: the train step's
    gradient of one microbatch and its whole norm (``optim.adamw.
    global_norm``), synced as the train step syncs it, with no optimizer
    state."""
    from ..optim.adamw import global_norm

    def grad_step(params, batch: Dict[str, torch.Tensor]):
        loss, grads = _loss_and_grads(model, params, batch)
        grads, sq_total = _synced(model, grads)
        return {"loss": loss, "grad_norm": global_norm(grads, sq_total)}

    return grad_step


def make_prefill_step(model: Model, s_max: int):
    @torch.no_grad()
    def prefill_step(params, batch):
        return model.prefill(params, batch, s_max)

    return prefill_step


def make_decode_step(model: Model, s_max=None):
    """``s_max``: the attention caches' whole length, which a tick on a
    rank mesh needs (``Model.decode``)."""
    @torch.no_grad()
    def serve_step(params, token, pos, caches):
        return model.decode(params, token, pos, caches, s_max)

    return serve_step


def make_eval_step(model: Model):
    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = model.loss(params, batch)
        return metrics | {"loss": loss}

    return eval_step
