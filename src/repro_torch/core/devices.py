"""Virtual devices and gang meshes: the port's device pool.

The JAX fabric's pool is ``jax.devices()``, one entry per chip, and a
gang's mesh is a ``jax.sharding.Mesh`` over its devices.  The port runs a
gang as ``pods × data`` virtual ranks on one torch device, so its pool is
a list of **virtual devices**: each names its index in the pool, its kind
(``torch.cuda.get_device_name`` or ``"cpu"``, what the fabric's
generation table reads) and the one torch device it runs on.  A gang's
mesh is its ordered virtual devices and its ``(pods, data)`` shape,
exactly what the port's virtual-rank train step takes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class VirtualDevice:
    """One slot of the fabric's pool (a Granule's device)."""
    index: int
    device_kind: str
    device: torch.device

    @property
    def id(self) -> int:
        """The pool index (``jax.Device.id``'s counterpart)."""
        return self.index


def virtual_devices(n: int, device="cuda") -> List[VirtualDevice]:
    """``n`` virtual devices on one torch ``device`` (CUDA unless the
    caller asks for another; raises on a machine without a GPU).  Their
    kind is the CUDA device's name, or the device type (``"cpu"``)."""
    if n < 1:
        raise ValueError(f"virtual_devices: need n >= 1, got {n}")
    dev = resolve_device(device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else dev.type)
    return [VirtualDevice(i, kind, dev) for i in range(n)]


@dataclasses.dataclass(frozen=True)
class GangMesh:
    """A gang's mesh: its ordered devices, as ``pods`` rows of ``data``
    (``pods == 1`` is the 1-D ``(data,)`` mesh)."""
    devices: Tuple[Any, ...]
    pods: int = 1

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def data(self) -> int:
        return self.size // self.pods

    @property
    def shape(self) -> Dict[str, int]:
        return ({"pod": self.pods, "data": self.data} if self.pods > 1
                else {"data": self.data})

    @property
    def device(self) -> torch.device:
        """The torch device every rank of the gang runs on."""
        return self.devices[0].device


def make_gang_mesh(devices: Sequence[Any], pods: int = 1) -> GangMesh:
    """Gang mesh: 1-D ``(data,)``, or two-level ``(pod, data)`` when the
    gang divides into ``pods`` equal pods."""
    devs = tuple(devices)
    if pods > 1 and len(devs) % pods == 0:
        return GangMesh(devs, pods)
    return GangMesh(devs, 1)
