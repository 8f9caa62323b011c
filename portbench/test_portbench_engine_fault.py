"""A witness of a fault of the program that shapes the serving cells'
traffic: ``ServeEngine.tick`` (``serving/engine.py``) decodes every slot
at one position, the largest any slot holds (free slots' stale positions
included), and the decode attends to every cache position up to it.  A
short request beside a longer one then attends to the zeros past its own
prompt and decodes other tokens than it does alone.  The benchmark's
serving cells refill every slot with one prompt length at once, the one
regime in which the engine is exact; a cell of mixed lengths waits for the
program to keep a position per slot.  Strict: the day the engine is mended
this test fails, and the mixed-length cell can be added."""
import numpy as np
import pytest
import torch

from repro_torch.launch.train import TINY
from repro_torch.models.model import Model
from repro_torch.serving import Request, ServeEngine


def _decode(prompts, slots=4, s_max=64, new=6):
    """Admit every prompt into one engine and tick until all are done →
    each request's tokens."""
    cfg = TINY.with_(remat=False)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    engine = ServeEngine(model, params, slots, s_max, device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new=new) for i, p in enumerate(prompts)]
    for r in reqs:
        assert engine.admit(r)
    while engine.active:
        engine.tick()
    return [r.tokens_out for r in reqs]


@pytest.mark.xfail(strict=True, reason="ServeEngine.tick decodes all slots at the largest "
                   "position (serving/engine.py:109-115)")
def test_short_request_beside_a_long_one_decodes_as_it_does_alone():
    rng = np.random.default_rng(7)
    short = rng.integers(2, TINY.vocab_size, size=8).astype(np.int32)
    long = rng.integers(2, TINY.vocab_size, size=40).astype(np.int32)
    alone = _decode([short])[0]
    beside = _decode([short, long])[0]
    assert beside == alone


def test_equal_lengths_decode_as_alone():
    """The regime the serving cells use: every slot at one length."""
    rng = np.random.default_rng(7)
    a, b = (rng.integers(2, TINY.vocab_size, size=8).astype(np.int32) for _ in range(2))
    assert _decode([a, b]) == [_decode([a])[0], _decode([b])[0]]
