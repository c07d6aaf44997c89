"""Device mesh and its collectives (port of the JAX package's
``parallel/mesh.py``, with the counterparts of ``shard_map`` and of the
``lax`` collectives the distribution tier runs under it).

A ``Mesh`` is named axes over a list of ``torch.device``s, outer to inner
(``dcn`` across hosts, ``data`` across cards: the axis the exchange
rides, ``model`` for intra-op sharding). One controller owns the mesh
and runs a shard's body once for each device along the named axis, as
``shard_map`` does; on a mesh with more axes, the devices of the other
axes hold replicas, and the port computes one replica (index 0 on every
other axis). ``make_mesh()`` puts every CUDA device on one ``data`` axis.

A device may repeat in the list: one card, or the CPU, then holds P
shards. That is how the port's tests stand in for the reference's forced
host devices (8 shards on ``cpu``) and how one card runs an 8-shard
exchange; it is not a feature the reference lacks.

A row-sharded tensor is a global [N, ...] tensor whose contiguous row
block i belongs to shard i (``in_specs=P(axis)``): ``shard_rows`` splits
it, block i onto device i. Between distinct devices a block moves with
``.to(device)``; on a repeated device it is a view, and the collectives
are local stacks. Outputs concatenate in shard order (``cat``) on the
mesh's first device along the axis, where the controller keeps its
global tensors.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..columnar import Column, Table
from ..utils.errors import FatalDeviceError

__all__ = [
    "Mesh",
    "make_mesh",
    "row_sharding",
    "replicated",
    "shard_table_rows",
    "shard_rows",
    "all_to_all",
    "all_gather",
    "cat",
]


class Mesh:
    """Named axes over devices: ``devices`` is an object array of
    ``torch.device`` of the axes' shape."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str = "data") -> List[torch.device]:
        """The devices along ``axis``, index 0 on every other axis (the
        replica the port computes)."""
        k = self.axis_names.index(axis)
        idx = [0] * len(self.axis_names)
        idx[k] = slice(None)
        return list(self.devices[tuple(idx)])

    def home(self, axis: str = "data") -> torch.device:
        """Where the controller keeps global tensors: the first device
        along ``axis``."""
        return self.axis_devices(axis)[0]

    def __repr__(self):
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.reshape(-1)]})"


def make_mesh(axes: Optional[Dict[str, int]] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``axes`` ({name: size}, outer first) over ``devices``
    (default: every CUDA device; raises without a card). With no axes,
    all devices lie on one ``data`` axis. Raises ValueError when the axes'
    product differs from the number of devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise FatalDeviceError("no CUDA device is available; pass "
                                   "devices=[torch.device('cpu')] * n for a "
                                   "mesh on the CPU")
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
    if axes is None:
        axes = {"data": len(devs)}
    shape = tuple(axes.values())
    total = int(np.prod(shape))
    if total != len(devs):
        raise ValueError(f"mesh axes {axes} need {total} devices, have {len(devs)}")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), tuple(axes.keys()))


class Sharding(NamedTuple):
    """Where a global tensor's shards go: rows split along ``axis``, or
    replicated when ``axis`` is None."""

    mesh: Mesh
    axis: Optional[str]

    def shard(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The per-device pieces of ``x``: row blocks, or whole copies."""
        if self.axis is None:
            return [x.to(d) for d in self.mesh.devices.reshape(-1)]
        return shard_rows(x, self.mesh, self.axis)


def row_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """Rows split along ``axis``, other dims whole."""
    return Sharding(mesh, axis)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def shard_rows(x: torch.Tensor, mesh: Mesh, axis: str = "data") -> List[torch.Tensor]:
    """Split a global [N, ...] tensor into the axis' P contiguous row
    blocks, block i on device i (``shard_map``'s ``in_specs=P(axis)``).
    N must divide by P."""
    devs = mesh.axis_devices(axis)
    p = len(devs)
    if x.shape[0] % p:
        raise ValueError(f"{x.shape[0]} rows do not divide over the {p} shards of axis {axis!r}")
    per = x.shape[0] // p
    return [x[i * per:(i + 1) * per].to(d) for i, d in enumerate(devs)]


def all_to_all(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``lax.all_to_all(x, axis, split_axis=0, concat_axis=0, tiled=True)``
    over P shards: ``parts[s]`` is shard s's [P, cap, ...] tensor; shard d
    receives the sources' ``[d]`` slices stacked source-major, a
    [P, cap, ...] tensor on d's device."""
    devs = [p.device for p in parts]
    if all(d == devs[0] for d in devs):
        return list(torch.stack(list(parts)).transpose(0, 1).contiguous().unbind(0))
    return [torch.stack([p[d].to(dev) for p in parts]) for d, dev in enumerate(devs)]


def all_gather(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``lax.all_gather(x, axis)`` over P shards: every shard receives the
    [P, ...] stack of all shards' pieces, on its own device."""
    devs = [p.device for p in parts]
    if all(d == devs[0] for d in devs):
        whole = torch.stack(list(parts))
        return [whole] * len(parts)
    return [torch.stack([p.to(dev) for p in parts]) for dev in devs]


def cat(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """Shard outputs concatenated in shard order on ``device`` (the
    global view of an ``out_specs=P(axis)`` output)."""
    return torch.cat([p.to(device) for p in parts])


def shard_table_rows(table, mesh: Mesh, axis: str = "data"):
    """A Table whose fixed-width columns are row-sharded over the mesh
    axis: their buffers go to the mesh's home device, where the exchange
    splits them into the shards' row blocks. Rows must divide the axis
    size (pad upstream); STRING and nested columns stay as they are (their
    payloads exchange through the dictionary paths of ``table_ops``)."""
    p = mesh.shape[axis]
    if table.num_rows % p:
        raise ValueError(f"{table.num_rows} rows do not divide over the {p} shards of axis "
                         f"{axis!r}")
    home = mesh.home(axis)
    cols = []
    for c in table.columns:
        if c.data is not None:
            validity = None if c.validity is None else c.validity.to(home)
            cols.append(Column(c.dtype, data=c.data.to(home), validity=validity))
        else:
            cols.append(c)
    return Table(cols, table.names)
