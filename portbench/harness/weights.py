"""The weights of a cell, made by the benchmark from ``--seed``: every
normally drawn leaf is a view into one buffer in the type the weights are
served in, filled on the device by one generator in a few large calls
(standard deviation 0.02, as the program's own initialisation draws them),
and the norms' weights are ones.  The same seed gives the same bits, so the
reference can make them again."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

STD = 0.02
#: Elements drawn a call: 1 Gi elements, 2 GB in bfloat16.
CHUNK = 1 << 30


def make(spec: List[Tuple[str, Tuple[int, ...], str]], seed: int, device,
         dtype=torch.bfloat16) -> Tuple[dict, torch.Tensor]:
    """→ (the tree of weights by ``spec``'s paths, the buffer behind its
    normally drawn leaves)."""
    total = sum(math.prod(shape) for _, shape, init in spec if init == "normal")
    flat = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    for a in range(0, total, CHUNK):
        flat[a:a + CHUNK].normal_(0.0, STD, generator=gen)
    tree: Dict = {}
    off = 0
    for path, shape, init in spec:
        if init == "normal":
            n = math.prod(shape)
            t = flat[off:off + n].view(shape)
            off += n
        elif init == "ones":
            t = torch.ones(shape, dtype=dtype, device=device)
        else:
            raise ValueError(f"unknown init {init!r} for {path}")
        node = tree
        *head, last = path.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = t
    return tree, flat


def fingerprint(flat: torch.Tensor, chunk: int = 1 << 26) -> float:
    """A float64 sum of the buffer, ``chunk`` elements at a time (a float64
    copy of one chunk at a time): the same bits give the same number."""
    return sum(float(flat[a:a + chunk].sum(dtype=torch.float64))
               for a in range(0, flat.numel(), chunk))


def check_layout(tree: dict, abstract: dict, path: str = "") -> None:
    """Raise unless ``tree`` has exactly the leaves and shapes of the
    program's declared parameters ``abstract``."""
    if isinstance(abstract, dict):
        if not isinstance(tree, dict) or set(tree) != set(abstract):
            raise ValueError(f"weights at {path or '/'}: {sorted(tree) if isinstance(tree, dict) else tree} "
                             f"where the program declares {sorted(abstract)}")
        for key in abstract:
            check_layout(tree[key], abstract[key], f"{path}/{key}")
        return
    if tuple(tree.shape) != tuple(abstract.shape):
        raise ValueError(f"weights at {path}: {tuple(tree.shape)} where the program declares "
                         f"{tuple(abstract.shape)}")
