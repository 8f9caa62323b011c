"""Production meshes, and meshes over the ranks of a process group.

A mesh here is a small record: its axis names, their sizes, and the
devices it spans where they exist.  The production meshes describe the
(16, 16) and (2, 16, 16) layouts without devices, for the sharding rules;
the smoke mesh spans the devices of this machine.  A rank mesh
(:func:`_make_mesh`, the counterpart of the reference's) lays the ranks of
the initialised default ``torch.distributed`` group out over the axes,
row-major as ``jax.make_mesh`` lays out devices (rank ``di · n_model + mi``
is ``(di, mi)`` of a ``("data", "model")`` mesh), and carries this rank's
coordinates and a process group for every set of axes, over which the
expert-parallel MoE block (``models/moe.py``) issues its collectives.
Kept as functions (never module-level constants), so importing this module
touches no device state.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch


@dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Optional[Tuple[torch.device, ...]] = None
    #: On a rank mesh: this process's rank, and its process group for each
    #: tuple of axes (in mesh order), ranks ordered row-major over them.
    rank: Optional[int] = None
    groups: Optional[Dict[Tuple[str, ...], Any]] = field(default=None, compare=False)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def device(self) -> torch.device:
        """The mesh's one device (a one-device mesh places a whole tensor;
        a rank mesh names this rank's device)."""
        if self.devices is None or len(self.devices) != 1:
            raise ValueError(f"a mesh of {self.shape} over {self.devices} has no single "
                             "device: the port places no tensor across devices")
        return self.devices[0]

    @property
    def is_rank_mesh(self) -> bool:
        return self.groups is not None

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's index along each axis (row-major in rank order)."""
        if self.rank is None:
            raise ValueError(f"a mesh of {self.shape} without ranks has no coordinates")
        return dict(zip(self.axis_names, _unravel(self.rank, self.axis_sizes)))

    def group(self, axes: Tuple[str, ...]):
        """This rank's process group over ``axes`` (their mesh order)."""
        return self.groups[tuple(a for a in self.axis_names if a in axes)]


def _unravel(rank: int, sizes) -> Tuple[int, ...]:
    out = []
    for size in reversed(sizes):
        out.append(rank % size)
        rank //= size
    return tuple(reversed(out))


def _ravel(idx, sizes) -> int:
    rank = 0
    for i, size in zip(idx, sizes):
        rank = rank * size + i
    return rank


def _make_mesh(shape, axes, device=None) -> Mesh:
    """A mesh of ``shape`` over the ranks of the initialised default group,
    row-major.  Every rank must call it, with the same arguments: it makes
    one process group per set of axes and per position of the other axes,
    in the same order on every rank (``dist.new_group`` is collective), and
    keeps those this rank belongs to.  ``device`` is this rank's device
    (``Mesh.device``).  Raises unless the world size is the mesh's size."""
    import torch.distributed as dist

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    world, rank = dist.get_world_size(), dist.get_rank()
    size = mesh_device_count(Mesh(axes, shape))
    if size != world:
        raise ValueError(f"a mesh of {dict(zip(axes, shape))} needs {size} ranks; "
                         f"the world has {world}")
    groups = {}
    for n in range(1, len(axes) + 1):
        for sub in itertools.combinations(range(len(axes)), n):
            rest = [i for i in range(len(axes)) if i not in sub]
            for fixed in itertools.product(*(range(shape[i]) for i in rest)):
                ranks = []
                for moving in itertools.product(*(range(shape[i]) for i in sub)):
                    idx = dict(zip(rest, fixed)) | dict(zip(sub, moving))
                    ranks.append(_ravel([idx[i] for i in range(len(axes))], shape))
                group = dist.new_group(ranks)
                if rank in ranks:
                    groups[tuple(axes[i] for i in sub)] = group
    devices = None if device is None else (torch.device(device),)
    return Mesh(axes, shape, devices, rank, groups)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_smoke_mesh(data: int = 1, model: int = 1, device="cuda") -> Mesh:
    """Tiny mesh over the cards of this machine, or over one CPU device
    when ``device`` is the CPU.  Raises when a card is asked for and there
    is none."""
    if torch.device(device).type == "cpu":
        devs = [torch.device("cpu")]
    else:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device for the mesh (pass device='cpu')")
        devs = [torch.device("cuda", i) for i in range(n)]
    n = len(devs)
    data = min(data, n)
    model = max(1, min(model, n // data))
    return Mesh(("data", "model"), (data, model), tuple(devs[: data * model]))


def mesh_device_count(mesh) -> int:
    n = 1
    for v in mesh.shape.values():
        n *= v
    return n
