"""Deterministic sharded data pipeline.

Design goals (1000+-node deployability):

* **Stateless addressing** — sample ``i`` of epoch ``e`` is a pure function
  of (seed, e, i); restart from a checkpointed ``step`` without replaying.
* **Sharded reads** — each data-parallel group reads only its batch slice.
* **Host-side prefetch** — a double-buffered iterator hides fetch latency;
  *which replica to fetch a shard from and when* is decided by the BASS
  placement layer (``data.placement``), honoring the TS ledger.

Two sources are provided: ``SyntheticLM`` (seeded token streams — used by
tests/examples; no tokenizer dependency) and ``MemmapSource`` (pre-tokenized
``.bin`` shards on disk, the production path).
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..obs.device import span

#: A step's batch on the timeline (``obs``), keyed by the step.
_BATCH = span("data.batch", device=False)


@dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    n_vision_tokens: int = 0
    d_model: int = 0                 # for modality-stub embeddings
    family: str = "dense"
    enc_seq: int = 0
    task: str = "copy"               # copy | increment (increment learns in
                                     # tens of steps — used by fast CI tests)


class SyntheticLM:
    """Seeded synthetic LM stream with learnable structure (a noisy copy
    task: second half of each sequence repeats the first half) so example
    training runs show a *decreasing* loss, not noise-floor flailing."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def _rng(self, epoch: int, index: int) -> np.random.Generator:
        h = hashlib.blake2b(
            f"{self.cfg.seed}/{epoch}/{index}".encode(), digest_size=8
        ).digest()
        return np.random.default_rng(int.from_bytes(h, "little"))

    def sample(self, epoch: int, index: int) -> np.ndarray:
        rng = self._rng(epoch, index)
        s = self.cfg.seq_len
        if self.cfg.task == "increment":
            v = self.cfg.vocab_size - 2
            start = int(rng.integers(0, v))
            return (2 + (start + np.arange(s)) % v).astype(np.int32)
        half = s // 2
        first = rng.integers(2, self.cfg.vocab_size, size=half, dtype=np.int64)
        noise = rng.random(s - half) < 0.05
        second = first[: s - half].copy()
        second[noise] = rng.integers(2, self.cfg.vocab_size, size=int(noise.sum()))
        return np.concatenate([first, second]).astype(np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        with _BATCH(step):
            gb = self.cfg.global_batch
            toks = np.stack([self.sample(0, step * gb + i) for i in range(gb)])
            out: Dict[str, np.ndarray] = {"tokens": toks}
            if self.cfg.family == "vlm" and self.cfg.n_vision_tokens:
                rng = self._rng(1, step)
                out["vision_embeds"] = rng.standard_normal(
                    (gb, self.cfg.n_vision_tokens, self.cfg.d_model), dtype=np.float32
                )
                out["tokens"] = toks[:, : self.cfg.seq_len - self.cfg.n_vision_tokens]
            if self.cfg.family == "encdec":
                rng = self._rng(2, step)
                out["frames"] = rng.standard_normal(
                    (gb, self.cfg.enc_seq, self.cfg.d_model), dtype=np.float32
                )
            return out


class MemmapSource:
    """Pre-tokenized uint16/uint32 shards (``<name>-NNNNN.bin``) — the
    production input format.  Shard→host placement comes from the manifest;
    fetch scheduling from ``data.placement``."""

    def __init__(self, root: str | Path, seq_len: int, dtype=np.uint16):
        self.root = Path(root)
        self.seq_len = seq_len
        self.dtype = dtype
        self.shards = sorted(self.root.glob("*.bin"))
        if not self.shards:
            raise FileNotFoundError(f"no .bin shards under {root}")
        self._sizes = [p.stat().st_size // np.dtype(dtype).itemsize for p in self.shards]

    def n_sequences(self) -> int:
        return sum(sz // self.seq_len for sz in self._sizes)

    def read(self, shard_idx: int, seq_idx: int) -> np.ndarray:
        mm = np.memmap(self.shards[shard_idx], dtype=self.dtype, mode="r")
        off = seq_idx * self.seq_len
        return np.asarray(mm[off : off + self.seq_len], dtype=np.int32)


class Prefetcher:
    """Double-buffered host-side prefetch around any ``batch(step)`` source."""

    def __init__(self, source, depth: int = 2):
        import queue
        import threading

        self.source = source
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = False
        self._step = 0
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        while not self._stop:
            batch = self.source.batch(self._step)
            self._q.put((self._step, batch))
            self._step += 1

    def __iter__(self) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        while True:
            yield self._q.get()

    def close(self):
        self._stop = True
