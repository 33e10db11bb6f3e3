"""Device meshes (port of ``pyslam_tpu/parallel/mesh.py``).

A ``Mesh`` is a tuple of ``torch.device``s along one named axis.  Where the
reference's GSPMD places an array by a ``NamedSharding``, here a tensor is
split into row shards, one a mesh device (``obs_sharding``), or copied to
each (``replicated``).  Unlike the reference, which falls back to CPU
devices when its backend has too few, ``make_mesh`` raises when asked for
more devices than there are; several shards share a device only through an
explicit device list (``Mesh([torch.device("cuda", 0)] * 4)``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Mesh:
    devices: tuple
    axis: str = "obs"

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, axis: str = "obs", *,
              device: torch.device | str = "cuda") -> Mesh:
    """A 1-D mesh over the first ``n_devices`` visible devices of
    ``device``'s type (every one by default): the card's unless the caller
    asks for the CPU, which is one device."""
    kind = torch.device(device).type
    if kind == "cuda":
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(kind)]
    n = len(devs) if n_devices is None else n_devices
    if n < 1 or n > len(devs):
        raise ValueError(f"requested {n} {kind} mesh devices but {len(devs)} are visible")
    return Mesh(tuple(devs[:n]), axis)


def obs_sharding(x: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """``x`` split into ``mesh.size`` equal row blocks, block i on device i
    (the caller pads the rows to a multiple of the mesh size)."""
    if x.shape[0] % mesh.size:
        raise ValueError(f"{x.shape[0]} rows do not split over {mesh.size} devices")
    return [c.to(d) for c, d in zip(torch.chunk(x, mesh.size), mesh.devices)]


def replicated(x: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """A copy of ``x`` on every mesh device."""
    return [x.to(d) for d in mesh.devices]
