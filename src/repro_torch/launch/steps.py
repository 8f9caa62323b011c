"""Train (with microbatch gradient accumulation), prefill, decode and
eval steps — the reference's ``launch/steps.py`` in eager PyTorch.

The train step differentiates ``Model.loss`` with ``torch.autograd.grad``
over the flattened parameter tree: each parameter enters the loss as a
detached leaf that requires grad, so the caller's tensors get no
``.grad`` and no graph outlives the step.  The other steps run without
autograd.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..models.model import Model
from ..models.params import flatten, unflatten
from ..optim.adamw import AdamW, AdamWState


def make_train_step(
    model: Model,
    optimizer: AdamW,
    accum: int = 1,
    accum_dtype=torch.float32,
):
    """→ train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``accum_dtype`` controls the gradient-accumulation buffer: f32 default;
    bf16 halves it for memory-edge cells (≥8 summands at loss scale ~1
    keeps the rounding error well under the gradient noise floor).
    """

    def grad_fn(params, mb):
        paths, leaves = zip(*flatten(params))
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss, _metrics = model.loss(unflatten(paths, leaves), mb)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), unflatten(paths, grads)

    def train_step(params, opt_state: AdamWState, batch: Dict[str, torch.Tensor]):
        if accum <= 1:
            loss, grads = grad_fn(params, batch)
        else:
            gsum, lsum = None, None
            for i in range(accum):
                mb = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])[i]
                      for k, v in batch.items()}
                l, g = grad_fn(params, mb)
                g = {path: leaf.to(accum_dtype) for path, leaf in flatten(g)}
                if gsum is None:
                    gsum, lsum = g, l.float()
                else:
                    for path in gsum:
                        gsum[path] = gsum[path] + g[path]
                    lsum = lsum + l
            grads = unflatten(list(gsum), [g / accum for g in gsum.values()])
            loss = lsum / accum

        new_params, new_opt, gnorm = optimizer.update(grads, opt_state, params)
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_prefill_step(model: Model, s_max: int):
    @torch.no_grad()
    def prefill_step(params, batch):
        return model.prefill(params, batch, s_max)

    return prefill_step


def make_decode_step(model: Model):
    @torch.no_grad()
    def serve_step(params, token, pos, caches):
        return model.decode(params, token, pos, caches)

    return serve_step


def make_eval_step(model: Model):
    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = model.loss(params, batch)
        return metrics | {"loss": loss}

    return eval_step
