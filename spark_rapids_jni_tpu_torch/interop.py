"""State carry-over between the JAX package and the port, through numpy.

``carry_table`` takes the host arrays of a JAX-package ``Table`` (its
columns' ``np.asarray(col.data)`` and ``np.asarray(col.validity)``, in the
JAX package's storage: FLOAT64 as uint64 IEEE bits, DECIMAL128 as [N, 4]
uint32 limbs, STRING as the host pair ``(offsets, chars)`` of its
``np.asarray(col.offsets)`` and ``np.asarray(col.chars)``) and builds the
port's ``Table`` holding the same bits. Nested columns come as dicts:
LIST as ``{"offsets": offsets, "child": (array, dtype, validity)}`` and
STRUCT as ``{"children": [(array, dtype, validity), ...], "names": [...]}``,
each child in the same host form. ``table_to_numpy`` gives the same host
arrays back. Neither imports the JAX package: the caller hands over
plain numpy arrays.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .columnar import Column, Table
from .columnar.column import _host_to_tensor, _mask_to, resolve_device
from .columnar.dtype import DType, TypeId

__all__ = ["carry_table", "table_to_numpy"]


def _carry_column(arr, d: DType, v, dev: torch.device) -> Column:
    vt = _mask_to(v, dev)
    if d.id == TypeId.STRING:
        offsets, chars = arr
        return Column.strings_from_parts(offsets, chars, vt, device=dev)
    if d.id == TypeId.LIST:
        return Column.list_from_parts(arr["offsets"], _carry_column(*arr["child"], dev), vt,
                                      device=dev)
    if d.id == TypeId.STRUCT:
        kids = [_carry_column(*c, dev) for c in arr["children"]]
        return Column.struct_from_parts(kids, arr["names"], vt, device=dev)
    arr = np.asarray(arr)
    if d.id == TypeId.FLOAT64 and arr.dtype == np.float64:
        arr = arr.view(np.uint64)
    host = arr.astype(d.np_dtype, copy=False)
    return Column(d, data=_host_to_tensor(host, d.torch_dtype, dev), validity=vt)


def carry_table(
    arrays: Sequence,
    dtypes: Sequence[DType],
    validity: Optional[Sequence[Optional[np.ndarray]]] = None,
    device=None,
) -> Table:
    """Storage arrays (+ optional validity masks) -> a port Table with the
    same bits; ``device=None`` means the card."""
    dev = resolve_device(device)
    validity = list(validity) if validity is not None else [None] * len(arrays)
    return Table([_carry_column(a, d, v, dev) for a, d, v in zip(arrays, dtypes, validity)])


def _column_to_numpy(c: Column):
    if c.dtype.id == TypeId.STRING:
        return c.offsets.cpu().numpy(), c.chars.cpu().numpy()
    if c.dtype.id == TypeId.LIST:
        return {"offsets": c.offsets.cpu().numpy(), "child": _spec(c.child)}
    if c.dtype.id == TypeId.STRUCT:
        names = c.child_names or tuple(f"f{j}" for j in range(len(c.children)))
        return {"children": [_spec(k) for k in c.children], "names": list(names)}
    return c.to_numpy()


def _spec(c: Column):
    return (_column_to_numpy(c), c.dtype, None if c.validity is None else c.validity.cpu().numpy())


def table_to_numpy(table: Table) -> Tuple[List[Union[np.ndarray, tuple, dict]],
                                           List[Optional[np.ndarray]]]:
    """Port Table -> (storage arrays, validity masks or None), the inverse
    of ``carry_table``; a STRING column gives its (offsets int32, chars
    uint8) host pair, LIST and STRUCT columns their dicts."""
    arrays = [_column_to_numpy(c) for c in table.columns]
    validity = [None if c.validity is None else c.validity.cpu().numpy() for c in table.columns]
    return arrays, validity
