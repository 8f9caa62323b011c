"""A frozen copy of the arithmetic of the program's synthetic training
stream (``SyntheticLM``, the copy task), so that the reference makes every
batch of the training cells itself: sample ``i`` of epoch ``e`` is a pure
function of (seed, e, i); a row's second half repeats its first half with
5 % of the tokens redrawn; a VLM's batch carries standard-normal patch
embeddings drawn from (seed, 1, step) and leaves the stream's last
``n_prefix`` positions to them."""
from __future__ import annotations

import hashlib
from typing import Dict

import numpy as np


def _rng(seed: int, epoch: int, index: int) -> np.random.Generator:
    digest = hashlib.blake2b(f"{seed}/{epoch}/{index}".encode(), digest_size=8).digest()
    return np.random.default_rng(int.from_bytes(digest, "little"))


def sample(seed: int, index: int, seq: int, vocab: int) -> np.ndarray:
    rng = _rng(seed, 0, index)
    half = seq // 2
    first = rng.integers(2, vocab, size=half, dtype=np.int64)
    noise = rng.random(seq - half) < 0.05
    second = first[: seq - half].copy()
    second[noise] = rng.integers(2, vocab, size=int(noise.sum()))
    return np.concatenate([first, second]).astype(np.int32)


def batch(seed: int, step: int, rows: int, seq: int, vocab: int, n_prefix: int = 0,
          d_model: int = 0) -> Dict[str, np.ndarray]:
    """Step ``step``'s batch: ``tokens`` ``[rows, seq - n_prefix]`` and, with
    a prefix, ``prefix`` ``[rows, n_prefix, d_model]`` float32."""
    toks = np.stack([sample(seed, step * rows + i, seq, vocab) for i in range(rows)])
    if not n_prefix:
        return {"tokens": toks}
    prefix = _rng(seed, 1, step).standard_normal((rows, n_prefix, d_model), dtype=np.float32)
    return {"tokens": toks[:, : seq - n_prefix], "prefix": prefix}
