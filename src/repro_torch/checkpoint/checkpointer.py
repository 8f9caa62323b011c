"""Async, fault-tolerant checkpointing of torch trees.

Layout (one directory per step), the reference's byte layout::

    <root>/step_000123/
        manifest.json          # step, every leaf's shape and dtype, hosts
        shard_host0.npz        # one array per leaf, keyed by its tree path
    <root>/LATEST              # atomic pointer (written last)

A leaf's key is its tree path as the reference's ``jax.tree_util`` spells
it: dict keys in sorted order, sequence indices, and a NamedTuple field as
``.name`` — ``(params, AdamWState(m, v, count))`` gives ``0/embed/w``,
``1/.m/embed/w``, ``1/.v/embed/w`` and ``1/.count`` — so a checkpoint
written by either package restores in the port.  bfloat16 is stored as its
``uint16`` bit pattern with ``"dtype": "bfloat16"`` in the manifest.

* **Async** — ``save()`` copies every leaf to host memory (a copy that
  shares nothing with the caller's tensors) before it returns; a daemon
  thread then writes the files.  One checkpoint is in flight at a time.
* **Atomic** — the step is written to ``.tmp_step_*`` and renamed into
  place, and ``LATEST`` is flipped last: a crash mid-write leaves the
  previous checkpoint intact.  The newest ``keep`` steps are kept.
* **Restore** — ``restore()`` rebuilds the template's tree and puts each
  leaf on its template leaf's device, or on the device that a
  ``shardings`` tree names for it (a device, or a ``NamedSharding`` over
  a one-device mesh) — what the reference's ``jax.device_put(arr,
  sharding)`` is on one card.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

Tree = Any


def _children(tree: Tree):
    """(path element, child) pairs of an inner node in ``jax.tree_util``'s
    order, or None for a leaf.  ``None`` is an empty subtree, as in jax."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return None


def _flat_with_paths(tree: Tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(key, leaf) for every leaf, keys joined with ``/``."""
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for name, child in kids:
        yield from _flat_with_paths(child, f"{prefix}/{name}" if prefix else name)


def _rebuild(tree: Tree, fn: Callable[[str, Any], Any], prefix: str = "") -> Tree:
    """``tree`` with each leaf replaced by ``fn(key, leaf)``."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    out = [_rebuild(c, fn, f"{prefix}/{n}" if prefix else n) for n, c in kids]
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), out))
    if hasattr(tree, "_fields"):
        return type(tree)(*out)
    return type(tree)(out)


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A host copy of ``leaf`` that aliases nothing → (array, dtype name)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def _device_of(sharding) -> torch.device:
    if isinstance(sharding, (str, torch.device)):
        return torch.device(sharding)
    return sharding.device


class Checkpointer:
    def __init__(self, root: str | Path, keep: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        #: Host seconds each finished write took (files, renames, gc).
        self.write_s: List[float] = []

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Tree, blocking: bool = False) -> None:
        """Snapshot to host, write in the background (unless blocking)."""
        self.wait()  # one in-flight checkpoint at a time
        host_shards: Dict[str, np.ndarray] = {}
        meta: Dict[str, dict] = {}
        for key, leaf in _flat_with_paths(tree):
            arr, dtype = _to_host(leaf)
            host_shards[key] = arr
            meta[key] = {"shape": list(arr.shape), "dtype": dtype}

        def write():
            t0 = time.perf_counter()
            d = self.root / f"step_{step:09d}"
            tmp = self.root / f".tmp_step_{step:09d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / "shard_host0.npz", **host_shards)
            (tmp / "manifest.json").write_text(
                json.dumps({"step": step, "leaves": meta, "hosts": 1})
            )
            if d.exists():
                shutil.rmtree(d)
            os.replace(tmp, d)
            latest_tmp = self.root / ".LATEST.tmp"
            latest_tmp.write_text(d.name)
            os.replace(latest_tmp, self.root / "LATEST")
            self._gc()
            self.write_s.append(time.perf_counter() - t0)

        if blocking:
            write()
            return

        def run():
            try:
                write()
            except Exception as exc:  # handed to the caller by wait()
                self._error = exc

        self._pending = threading.Thread(target=run, daemon=True)
        self._pending.start()

    def wait(self) -> None:
        """Join the in-flight write; raise what it raised."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(self.root.glob("step_*"))
        for old in steps[: -self.keep]:
            shutil.rmtree(old, ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        ptr = self.root / "LATEST"
        if not ptr.exists():
            return None
        return int(ptr.read_text().strip().split("_")[-1])

    def restore(
        self,
        template: Tree,
        step: Optional[int] = None,
        shardings: Optional[Tree] = None,
    ) -> Tuple[int, Tree]:
        """Rebuild ``template``-shaped tree on its leaves' devices (or on
        the devices ``shardings`` names)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.root}")
        d = self.root / f"step_{step:09d}"
        manifest = json.loads((d / "manifest.json").read_text())
        devices = (dict(_flat_with_paths(shardings)) if shardings is not None else {})

        with np.load(d / "shard_host0.npz") as payload:
            def load(key, tmpl):
                raw = payload[key]
                if manifest["leaves"][key]["dtype"] == "bfloat16":
                    t = torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
                else:
                    t = torch.from_numpy(raw)
                if tuple(t.shape) != tuple(np.shape(tmpl)):
                    raise ValueError(f"{key}: stored shape {tuple(t.shape)}, template "
                                     f"{tuple(np.shape(tmpl))}")
                if key in devices:
                    dev = _device_of(devices[key])
                else:
                    dev = tmpl.device if torch.is_tensor(tmpl) else torch.device("cpu")
                return t.to(dev)

            return step, _rebuild(template, load)
