"""The plain reference of both configurations: a dense decoder transformer
(GQA attention with rotary positions, RMSNorm, a SwiGLU MLP, an untied or
tied head, and an optional prefix of given embeddings before the tokens)
written out in plain PyTorch, computed in float32 with TF32 off.

It imports nothing of the program under test.  It takes the weights that
the benchmark made (``harness/weights.py``) by their names in the tree the
program is handed, and the inputs the benchmark made, and works everything
else out itself.

* :func:`serve_logits` runs whole sequences layer by layer (each layer's
  weights upcast once for every sequence) and returns the logits of each
  sequence's last positions.
* :func:`train_reference` follows the first steps of training: the loss,
  its gradient by autograd, and AdamW with the parameters kept in the type
  the configuration states.

``mm`` selects the arithmetic of the projections: :func:`mm_f32`, or
:func:`mm_fp8`, which rounds both operands to float8 e4m3 with a scale per
row of the input and per column of the weight (the control: the nearest
precision below the configuration's bfloat16).  Departures from the
published models: none for mistral-nemo-12b; internvl2-1b's Qwen2 backbone
has biases on q, k and v, which the program does not carry, so neither does
this reference, and its vision encoder is the stub of given patch
embeddings.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


@dataclass(frozen=True)
class Dims:
    """The sizes the reference needs, read from a configuration file."""

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    tied: bool
    rope_theta: float
    norm_eps: float
    n_prefix: int = 0

    @classmethod
    def of(cls, conf: dict) -> "Dims":
        """From a configuration file's ``config`` and ``assumed`` numbers."""
        c = {**conf["config"], **conf.get("assumed", {})}
        return cls(
            n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
            n_heads=c["num_attention_heads"], n_kv_heads=c["num_key_value_heads"],
            head_dim=c.get("head_dim") or c["hidden_size"] // c["num_attention_heads"],
            d_ff=c["intermediate_size"], vocab=c["vocab_size"],
            tied=bool(c.get("tie_word_embeddings", False)), rope_theta=float(c["rope_theta"]),
            norm_eps=float(c["rms_norm_eps"]), n_prefix=int(c.get("num_image_token", 0)))


def param_spec(dims: Dims) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(path, shape, init) of every weight, in the tree's layout: one leaf
    per kind, stacked over the layers; ``init`` is ``normal`` or ``ones``."""
    L, d, nq, nkv = dims.n_layers, dims.d_model, dims.n_heads, dims.n_kv_heads
    hd, f, v = dims.head_dim, dims.d_ff, dims.vocab
    spec = [
        ("embed", (v, d), "normal"),
        ("stack/ln1", (L, d), "ones"),
        ("stack/attn/w_q", (L, d, nq, hd), "normal"),
        ("stack/attn/w_k", (L, d, nkv, hd), "normal"),
        ("stack/attn/w_v", (L, d, nkv, hd), "normal"),
        ("stack/attn/w_o", (L, nq, hd, d), "normal"),
        ("stack/ln2", (L, d), "ones"),
        ("stack/mlp/w_gate", (L, d, f), "normal"),
        ("stack/mlp/w_up", (L, d, f), "normal"),
        ("stack/mlp/w_down", (L, f, d), "normal"),
        ("ln_f", (d,), "ones"),
    ]
    if not dims.tied:
        spec.append(("lm_head", (d, v), "normal"))
    return spec


def leaf(tree: dict, path: str) -> torch.Tensor:
    for key in path.split("/"):
        tree = tree[key]
    return tree


LAYER_LEAVES = ("ln1", "attn/w_q", "attn/w_k", "attn/w_v", "attn/w_o", "ln2",
                "mlp/w_gate", "mlp/w_up", "mlp/w_down")


# -- arithmetic ------------------------------------------------------------------

def mm_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return a @ w


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the scale maps each slice's largest magnitude to 448), back in its
    type; the gradient passes straight through."""
    scale = 448.0 / t.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    q = (t.detach() * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
    return t + (q - t).detach()


def mm_fp8(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _fp8(a, -1) @ _fp8(w, 0)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(n: int, dims: Dims, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos, sin ``[n, head_dim / 2]`` of positions 0 .. n - 1."""
    half = dims.head_dim // 2
    inv = dims.rope_theta ** (-torch.arange(half, dtype=torch.float64, device=device) / half)
    ang = torch.arange(n, dtype=torch.float64, device=device)[:, None] * inv
    return torch.cos(ang).float(), torch.sin(ang).float()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x ``[B, S, H, hd]``: each head's halves rotated by its position."""
    half = x.shape[-1] // 2
    c, s = cos[:, None, :], sin[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     chunk: int = 1024) -> torch.Tensor:
    """Softmax attention of q ``[B, S, nq, hd]`` over k, v ``[B, S, nkv,
    hd]`` (q head j reads kv head j // (nq / nkv)), each row over the keys
    up to its own position; rows ``chunk`` at a time."""
    b, s, nq, hd = q.shape
    nkv = k.shape[2]
    g = nq // nkv
    outs = []
    for r0 in range(0, s, chunk):
        r1 = min(r0 + chunk, s)
        qg = q[:, r0:r1].reshape(b, r1 - r0, nkv, g, hd)
        scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k[:, :r1]) / math.sqrt(hd)
        keep = (torch.arange(r1, device=q.device)[None, :]
                <= torch.arange(r0, r1, device=q.device)[:, None])
        scores = scores.masked_fill(~keep, float("-inf"))
        p = torch.softmax(scores, dim=-1)
        outs.append(torch.einsum("bkgqs,bskh->bqkgh", p, v[:, :r1]).reshape(b, r1 - r0, nq, hd))
    return torch.cat(outs, dim=1)


def layer(x: torch.Tensor, w: Dict[str, torch.Tensor], dims: Dims, cos, sin,
          mm: Callable = mm_f32) -> torch.Tensor:
    """One decoder layer on x ``[B, S, d]`` with the weights ``w`` of one
    layer (``LAYER_LEAVES``)."""
    b, s, d = x.shape
    nq, nkv, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    h = rms_norm(x, w["ln1"], dims.norm_eps)
    q = mm(h, w["attn/w_q"].reshape(d, nq * hd)).view(b, s, nq, hd)
    k = mm(h, w["attn/w_k"].reshape(d, nkv * hd)).view(b, s, nkv, hd)
    v = mm(h, w["attn/w_v"].reshape(d, nkv * hd)).view(b, s, nkv, hd)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    o = causal_attention(q, k, v)
    x = x + mm(o.reshape(b, s, nq * hd), w["attn/w_o"].reshape(nq * hd, d))
    h = rms_norm(x, w["ln2"], dims.norm_eps)
    return x + mm(F.silu(mm(h, w["mlp/w_gate"])) * mm(h, w["mlp/w_up"]), w["mlp/w_down"])


def head_weight(params: dict, dims: Dims) -> torch.Tensor:
    return leaf(params, "embed").T if dims.tied else leaf(params, "lm_head")


# -- serving -----------------------------------------------------------------------

@torch.no_grad()
def serve_logits(params: dict, dims: Dims, sequences: Sequence[torch.Tensor], last: int,
                 mm: Callable = mm_f32) -> List[torch.Tensor]:
    """Float32 logits ``[last, V]`` of the last ``last`` positions of each
    token sequence (1-D integer tensors on the weights' device), layer by
    layer: every sequence's stream is kept, and each layer's weights are
    upcast once."""
    dev = leaf(params, "embed").device
    xs = [leaf(params, "embed")[seq.to(dev).long()][None].float() for seq in sequences]
    tables = {}
    for li in range(dims.n_layers):
        w = {name: leaf(params, "stack/" + name)[li].float() for name in LAYER_LEAVES}
        for i, x in enumerate(xs):
            n = x.shape[1]
            if n not in tables:
                tables[n] = rope(n, dims, dev)
            xs[i] = layer(x, w, dims, *tables[n], mm)
        del w
    head = head_weight(params, dims).float()
    ln_f = leaf(params, "ln_f").float()
    return [mm(rms_norm(x[0, -last:], ln_f, dims.norm_eps), head) for x in xs]


# -- training ------------------------------------------------------------------------

def lm_loss(params: dict, dims: Dims, tokens: torch.Tensor, prefix: torch.Tensor = None,
            mm: Callable = mm_f32) -> torch.Tensor:
    """Mean cross-entropy of each next token, predicted from the position
    before it (after the prefix of given embeddings), in float32; every
    layer recomputed in the backward pass to bound the memory."""
    x = leaf(params, "embed")[tokens.long()]
    n = 0
    if prefix is not None:
        n = prefix.shape[1]
        x = torch.cat([prefix.float(), x], dim=1)
    cos, sin = rope(x.shape[1], dims, x.device)
    for li in range(dims.n_layers):
        w = {name: leaf(params, "stack/" + name)[li] for name in LAYER_LEAVES}
        x = checkpoint(layer, x, w, dims, cos, sin, mm, use_reentrant=False)
    h = rms_norm(x[:, n:n + tokens.shape[1] - 1], leaf(params, "ln_f"), dims.norm_eps)
    logits = mm(h, head_weight(params, dims))
    gold = torch.gather(logits, -1, tokens[:, 1:].long()[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).mean()


def warmup_cosine(step: int, peak: float, warmup: int, total: int, floor: float = 0.1) -> float:
    """Linear warm-up to ``peak``, then a cosine down to ``floor`` × peak."""
    if step < warmup:
        return peak * step / max(warmup, 1)
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * prog)))


def train_reference(params: dict, dims: Dims, batches: Sequence[dict], opt: dict,
                    microbatches: int = 1, mm: Callable = mm_f32,
                    param_dtype=torch.bfloat16) -> dict:
    """Follow ``len(batches)`` steps of training from ``params`` (kept in
    ``param_dtype``, as the configuration states; ``params`` itself is not
    modified) → ``losses`` (each step's), ``grads`` (the first step's
    gradient as the optimizer takes it, after clipping to the global norm
    ``opt["grad_clip"]``, float32, by path), ``global_norm`` (the first
    step's, before clipping) and ``params`` (after the last step, by path).
    AdamW: moments in float32, bias-corrected, weight decay decoupled,
    ``opt["lr"]`` on a linear warm-up and cosine schedule of the step count
    from 1.  A batch holds ``tokens`` and, for a prefix, ``prefix``; a step's
    loss is the mean of its ``microbatches`` equal blocks of rows' mean
    losses, as a step of accumulated microbatches takes it."""
    paths = [p for p, _, _ in param_spec(dims)]
    store = {p: leaf(params, p).detach().to(param_dtype).clone() for p in paths}
    m = {p: torch.zeros(t.shape, dtype=torch.float32, device=t.device) for p, t in store.items()}
    v = {p: torch.zeros_like(m[p]) for p in paths}
    b1, b2 = opt["b1"], opt["b2"]
    out = {"losses": []}
    for step, batch in enumerate(batches):
        f32 = [store[p].float().requires_grad_(True) for p in paths]
        tree = _unflatten(paths, f32)
        grads = [torch.zeros_like(t) for t in f32]
        rows = batch["tokens"].shape[0] // microbatches
        total = 0.0
        for part in range(microbatches):
            sl = slice(part * rows, (part + 1) * rows)
            prefix = batch.get("prefix")
            with torch.enable_grad():
                loss = lm_loss(tree, dims, batch["tokens"][sl],
                               None if prefix is None else prefix[sl], mm)
                gs = torch.autograd.grad(loss, f32)
            for acc, g in zip(grads, gs):
                acc.add_(g, alpha=1.0 / microbatches)
            total += float(loss.detach()) / microbatches
            del loss, gs
        del f32, tree
        out["losses"].append(total)
        norm = math.sqrt(sum(float(g.double().square().sum()) for g in grads))
        scale = min(1.0, opt["grad_clip"] / (norm + 1e-9))
        if step == 0:
            out["global_norm"] = norm
            out["grads"] = {p: g * scale for p, g in zip(paths, grads)}
        t = step + 1
        lr = warmup_cosine(t, opt["lr"], opt["warmup"], opt["total"])
        for p, g in zip(paths, grads):
            g = g * scale
            m[p].mul_(b1).add_(g, alpha=1 - b1)
            v[p].mul_(b2).addcmul_(g, g, value=1 - b2)
            upd = (m[p] / (1 - b1 ** t)) / ((v[p] / (1 - b2 ** t)).sqrt() + opt["eps"])
            pf = store[p].float()
            store[p] = (pf - lr * (upd + opt["weight_decay"] * pf)).to(param_dtype)
        del grads
    out["params"] = store
    return out


def _unflatten(paths: Sequence[str], leaves: Sequence[torch.Tensor]) -> dict:
    tree: dict = {}
    for path, t in zip(paths, leaves):
        node = tree
        *head, last = path.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = t
    return tree
