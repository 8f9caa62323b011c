"""The port's counterpart of ``tests/test_decode_consistency.py``: prefill +
single-token decode must agree with the teacher-forced full forward for
every architecture family (up to bf16 noise, the reference test's bound),
and greedy decoding must be self-consistent under rescoring."""
import pytest
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.models import encdec as ed
from repro_torch.models.model import Model
from repro_torch.models.transformer import apply_stack_full


def full_logits(model, cfg, params, batch):
    if cfg.family == "encdec":
        enc = ed.encode(params, batch["frames"], cfg)
        x, _ = ed.decode_full(params, model._embed(params, batch["tokens"]), enc, cfg)
        return model._head(params, x)
    x = model._assemble_input(params, batch)
    rope = model._rope(torch.arange(x.shape[1]))
    x, _, _ = apply_stack_full(cfg, params["stack"], x, rope)
    return model._head(params, x)


@pytest.mark.parametrize("arch", ARCH_NAMES)
@torch.no_grad()
def test_prefill_decode_matches_forward(arch):
    cfg = get_config(arch, smoke=True).with_(remat=False)
    model = Model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, "cpu")
    B, S, SMAX = 2, 12, 20
    tok = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    batch = {"tokens": tok}
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.randn(
            (B, cfg.n_vision_tokens, cfg.d_model), generator=gen).bfloat16()
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((B, cfg.enc_seq, cfg.d_model), generator=gen).bfloat16()

    lg_full = full_logits(model, cfg, params, batch)

    pb = dict(batch, tokens=tok[:, : S - 1])
    last, caches = model.prefill(params, pb, SMAX)
    n_prefix = cfg.n_vision_tokens if cfg.family == "vlm" else 0
    lg_dec, _ = model.decode(params, tok[:, S - 1: S], n_prefix + S - 1, caches)

    scale = float(lg_full.abs().max()) + 1e-6
    tol = 0.05 * scale + 0.05
    e_prefill = float((last - lg_full[:, n_prefix + S - 2]).abs().max())
    e_decode = float((lg_dec - lg_full[:, n_prefix + S - 1]).abs().max())
    assert e_prefill < tol, (arch, e_prefill, scale)
    assert e_decode < tol, (arch, e_decode, scale)


@pytest.mark.parametrize("arch", ["starcoder2-3b", "moonshot-v1-16b-a3b", "jamba-v0.1-52b",
                                  "whisper-base"])
@torch.no_grad()
def test_multi_step_greedy_decode_matches_rescoring(arch):
    """Greedy-decode 6 tokens, then teacher-force the full sequence — the
    decode path's argmax choices must be self-consistent under rescoring
    (float32, so no bf16 near-tie decides a token)."""
    cfg = get_config(arch, smoke=True).with_(remat=False, param_dtype="float32",
                                             compute_dtype="float32")
    model = Model(cfg)
    gen = torch.Generator().manual_seed(3)
    params = model.init(gen, "cpu")
    B, S, SMAX, NEW = 1, 8, 24, 6
    tok = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = torch.randn((B, cfg.enc_seq, cfg.d_model), generator=gen)
    logits, caches = model.prefill(params, dict(extra, tokens=tok), SMAX)
    seq = [int(logits[0].argmax())]
    for i in range(NEW - 1):
        lg, caches = model.decode(params, torch.tensor([[seq[-1]]]), S + i, caches)
        seq.append(int(lg[0].argmax()))

    full = torch.cat([tok, torch.tensor([seq[:-1]])], dim=1)
    lg_full = full_logits(model, cfg, params, dict(extra, tokens=full))
    for i, t in enumerate(seq):
        assert int(lg_full[0, S - 1 + i].argmax()) == t
