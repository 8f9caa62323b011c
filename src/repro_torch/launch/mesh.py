"""Production meshes.

A mesh here is a small record: its axis names, their sizes, and the
devices it spans where they exist.  The production meshes describe the
(16, 16) and (2, 16, 16) layouts without devices, for the sharding rules;
the smoke mesh spans the devices of this machine.  Kept as functions
(never module-level constants), so importing this module touches no
device state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch


@dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Optional[Tuple[torch.device, ...]] = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def device(self) -> torch.device:
        """The mesh's one device (a one-device mesh places a whole tensor)."""
        if self.devices is None or len(self.devices) != 1:
            raise ValueError(f"a mesh of {self.shape} over {self.devices} has no single "
                             "device: the port places no tensor across devices")
        return self.devices[0]


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
