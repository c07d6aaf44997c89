"""Table: an ordered collection of equal-length Columns (port of the JAX
package's ``columnar/table.py``)."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .column import Column, resolve_device
from .dtype import DType

__all__ = ["Table"]


class Table:
    def __init__(self, columns: Sequence[Column], names: Optional[Sequence[str]] = None):
        columns = list(columns)
        if columns:
            n = len(columns[0])
            for c in columns[1:]:
                if len(c) != n:
                    raise ValueError("all columns in a Table must have equal length")
        self.columns: List[Column] = columns
        self.names = list(names) if names is not None else [f"c{i}" for i in range(len(columns))]

    @classmethod
    def from_numpy(
        cls,
        arrays: Sequence[np.ndarray],
        dtypes: Optional[Sequence[DType]] = None,
        validity: Optional[Sequence[Optional[np.ndarray]]] = None,
        names: Optional[Sequence[str]] = None,
        device=None,
    ) -> "Table":
        """Host arrays -> device table; ``device=None`` means the card."""
        dev = resolve_device(device)
        k = len(arrays)
        dtypes = list(dtypes) if dtypes is not None else [None] * k
        validity = list(validity) if validity is not None else [None] * k
        cols = [
            Column.from_numpy(a, d, v, device=dev)
            for a, d, v in zip(arrays, dtypes, validity)
        ]
        return cls(cols, names)

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    @property
    def num_rows(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    def column(self, i) -> Column:
        """Column by position or by name."""
        if isinstance(i, str):
            return self.columns[self.names.index(i)]
        return self.columns[i]

    def dtypes(self):
        return [c.dtype for c in self.columns]

    def to_pydict(self) -> dict:
        """{name: the column's ``to_pylist()``}."""
        return {n: c.to_pylist() for n, c in zip(self.names, self.columns)}

    def select(self, idxs) -> "Table":
        """The columns named or numbered in ``idxs``, in that order."""
        idxs = [self.names.index(i) if isinstance(i, str) else i for i in idxs]
        return Table([self.columns[i] for i in idxs], [self.names[i] for i in idxs])

    def with_column(self, name: str, col: Column) -> "Table":
        """A new table: these columns, then ``col`` named ``name``."""
        return Table(self.columns + [col], self.names + [name])

    def __repr__(self):
        cols = ", ".join(f"{n}: {c.dtype!r}" for n, c in zip(self.names, self.columns))
        return f"Table(rows={self.num_rows}, [{cols}])"
