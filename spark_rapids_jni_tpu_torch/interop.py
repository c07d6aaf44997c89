"""State carry-over between the JAX package and the port, through numpy.

``carry_table`` takes the host arrays of a JAX-package ``Table`` (its
columns' ``np.asarray(col.data)`` and ``np.asarray(col.validity)``, in the
JAX package's storage: FLOAT64 as uint64 IEEE bits, DECIMAL128 as [N, 4]
uint32 limbs, STRING as the host pair ``(offsets, chars)`` of its
``np.asarray(col.offsets)`` and ``np.asarray(col.chars)``) and builds the
port's ``Table`` holding the same bits. ``table_to_numpy`` gives the
same host arrays back. Neither imports the JAX package: the caller hands
over plain numpy arrays.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .columnar import Column, Table
from .columnar.column import _host_to_tensor, resolve_device
from .columnar.dtype import DType, TypeId

__all__ = ["carry_table", "table_to_numpy"]


def carry_table(
    arrays: Sequence[np.ndarray],
    dtypes: Sequence[DType],
    validity: Optional[Sequence[Optional[np.ndarray]]] = None,
    device=None,
) -> Table:
    """Storage arrays (+ optional validity masks) -> a port Table with the
    same bits; ``device=None`` means the card."""
    dev = resolve_device(device)
    validity = list(validity) if validity is not None else [None] * len(arrays)
    cols = []
    for arr, d, v in zip(arrays, dtypes, validity):
        vt = None if v is None else torch.from_numpy(np.asarray(v).astype(bool)).to(dev)
        if d.id == TypeId.STRING:
            offsets, chars = arr
            cols.append(Column.strings_from_parts(offsets, chars, vt, device=dev))
            continue
        arr = np.asarray(arr)
        if d.id == TypeId.FLOAT64 and arr.dtype == np.float64:
            arr = arr.view(np.uint64)
        host = arr.astype(d.np_dtype, copy=False)
        cols.append(Column(d, data=_host_to_tensor(host, d.torch_dtype, dev), validity=vt))
    return Table(cols)


def table_to_numpy(table: Table) -> Tuple[List[Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]],
                                           List[Optional[np.ndarray]]]:
    """Port Table -> (storage arrays, validity masks or None), the inverse
    of ``carry_table``; a STRING column gives its (offsets int32, chars
    uint8) host pair."""
    arrays = [
        (c.offsets.cpu().numpy(), c.chars.cpu().numpy()) if c.dtype.id == TypeId.STRING
        else c.to_numpy()
        for c in table.columns
    ]
    validity = [None if c.validity is None else c.validity.cpu().numpy() for c in table.columns]
    return arrays, validity
