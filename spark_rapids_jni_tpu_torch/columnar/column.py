"""Device columns over torch tensors: the port of the JAX package's
``columnar/column.py`` (fixed width, STRING and LIST<INT8>).

- fixed width:  ``data``     [N]        (DECIMAL128: [N, 4] int32 limbs, LE)
- validity:     ``validity`` [N] bool   (True == valid; None == all valid)
- STRING:       ``offsets``  [N+1] int32, ``chars`` [nbytes] uint8
- LIST<INT8>:   ``offsets``  [N+1] int32, ``child`` Column (JCUDF row batches)

Storage types follow ``DType.torch_dtype``: unsigned widths above 8 bits
sit in the signed torch type of the same width, FLOAT64 as IEEE bits in
int64. ``from_numpy``/``to_numpy`` round-trip bits exactly.

Entry points that build device data take ``device=None``, which means
``"cuda"``; without a card they raise instead of moving to the CPU.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from .dtype import DType, TypeId, np_view_of_torch

__all__ = ["Column", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raises when there is no card: the port
    never falls back to the CPU unless the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to build CPU tensors"
        )
    return torch.device("cuda")


def _host_to_tensor(host: np.ndarray, t_dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Copy a numpy array into a tensor of ``t_dtype`` with the same bits."""
    view = np.ascontiguousarray(host).view(np_view_of_torch(t_dtype))
    return torch.from_numpy(view.copy()).to(device)


_OFFSET_TYPES = (TypeId.STRING, TypeId.LIST)


class Column:
    """A device column (fixed-width data, a STRING column or a LIST<INT8>
    row batch)."""

    def __init__(
        self,
        dtype: DType,
        data: Optional[torch.Tensor] = None,
        validity: Optional[torch.Tensor] = None,
        offsets: Optional[torch.Tensor] = None,
        chars: Optional[torch.Tensor] = None,
        child: Optional["Column"] = None,
    ):
        if dtype.id == TypeId.STRUCT:
            raise NotImplementedError(
                f"{dtype!r} columns are not ported yet "
                "(ROADMAP.md, Open items, section 1, item 1: STRUCT handles)"
            )
        self.dtype = dtype
        self.data = data
        self.validity = validity
        self.offsets = offsets
        self.chars = chars
        self.child = child

    # -- shape --------------------------------------------------------------
    def __len__(self) -> int:
        if self.dtype.id in _OFFSET_TYPES:
            return int(self.offsets.shape[0]) - 1
        return int(self.data.shape[0])

    @property
    def num_rows(self) -> int:
        return len(self)

    @property
    def device(self) -> torch.device:
        return (self.offsets if self.dtype.id in _OFFSET_TYPES else self.data).device

    @property
    def max_char_len(self) -> int:
        """Longest string in bytes (STRING columns): the padded width the
        string encode sizes its matrices by. Cached on the host: at most
        one device read per column, none for columns built from host
        values."""
        ml = self.__dict__.get("_max_char_len")
        if ml is None:
            ml = 0 if len(self) == 0 else int((self.offsets[1:] - self.offsets[:-1]).max())
            self._max_char_len = ml
        return ml

    @property
    def null_count(self) -> int:
        if self.validity is None:
            return 0
        return int((~self.validity).sum())

    def valid_mask(self) -> torch.Tensor:
        """Materialized [N] bool validity (all-True when validity is None)."""
        if self.validity is not None:
            return self.validity
        return torch.ones((len(self),), dtype=torch.bool, device=self.device)

    # -- construction -------------------------------------------------------
    @classmethod
    def from_numpy(
        cls,
        arr: np.ndarray,
        dtype: Optional[DType] = None,
        validity: Optional[np.ndarray] = None,
        device=None,
    ) -> "Column":
        """Host array -> device column. Values convert to the type's
        storage as in the JAX package (a float64 array becomes its IEEE
        bits for FLOAT64); ``device=None`` means the card."""
        dev = resolve_device(device)
        if dtype is None:
            dtype = _infer_dtype(arr.dtype)
        if dtype.id == TypeId.LIST:
            raise ValueError("build LIST columns with Column.list_from_parts")
        if dtype.id == TypeId.FLOAT64:
            host = arr.astype(np.float64, copy=False).view(np.uint64)
        else:
            host = arr.astype(dtype.np_dtype, copy=False)
        if dtype.id == TypeId.DECIMAL128 and (host.ndim != 2 or host.shape[1] != 4):
            raise ValueError("DECIMAL128 data must be [N, 4] 32-bit limbs")
        v = None
        if validity is not None:
            v = torch.from_numpy(np.asarray(validity).astype(bool)).to(dev)
        return cls(dtype, data=_host_to_tensor(host, dtype.torch_dtype, dev), validity=v)

    @classmethod
    def from_pylist(cls, values: Sequence[Any], dtype: DType, device=None) -> "Column":
        """Host python values -> device column; None is null. STRING takes
        str (UTF-8 encoded) or bytes; fixed-width types take what numpy
        converts to their storage (FLOAT64 as a float). ``device=None``
        means the card."""
        dev = resolve_device(device)
        validity = None
        if any(v is None for v in values):
            validity = np.array([v is not None for v in values], dtype=bool)
        if dtype.id == TypeId.STRING:
            encoded = [b"" if v is None else (v.encode() if isinstance(v, str) else bytes(v))
                       for v in values]
            lens = np.array([len(e) for e in encoded], dtype=np.int32)
            offsets = np.zeros(len(values) + 1, dtype=np.int32)
            np.cumsum(lens, out=offsets[1:])
            chars = np.frombuffer(b"".join(encoded), dtype=np.uint8)
            return cls.strings_from_parts(offsets, chars, validity, device=dev)
        if not dtype.is_fixed_width or dtype.id == TypeId.DECIMAL128:
            raise ValueError(f"from_pylist takes STRING or a one-word fixed-width type, got {dtype!r}")
        host = np.array([0 if v is None else v for v in values])
        return cls.from_numpy(host, dtype, validity, device=dev)

    @classmethod
    def strings_from_parts(cls, offsets, chars, validity=None, device=None) -> "Column":
        """STRING column from (offsets [N+1] int32, chars [nbytes] uint8),
        numpy arrays or tensors; numpy parts go to ``device`` (None means
        the card), tensors stay where they are."""
        from . import dtype as dt

        def _to(x, np_dtype, t_dtype):
            if isinstance(x, torch.Tensor):
                return x.to(t_dtype)
            return _host_to_tensor(np.asarray(x).astype(np_dtype, copy=False), t_dtype,
                                   resolve_device(device))

        if validity is not None and not isinstance(validity, torch.Tensor):
            validity = torch.from_numpy(np.asarray(validity).astype(bool)).to(resolve_device(device))
        col = cls(dt.STRING, validity=validity, offsets=_to(offsets, np.int32, torch.int32),
                  chars=_to(chars, np.uint8, torch.uint8))
        if not isinstance(offsets, torch.Tensor):
            offs = np.asarray(offsets, dtype=np.int64)
            col._max_char_len = int(np.diff(offs).max()) if offs.shape[0] > 1 else 0
        return col

    @classmethod
    def list_from_parts(cls, offsets: torch.Tensor, child: "Column", validity=None) -> "Column":
        from . import dtype as dt

        return cls(dt.LIST, validity=validity, offsets=offsets, child=child)

    # -- host round trip ------------------------------------------------------
    def to_numpy(self) -> np.ndarray:
        """Data as a host array in the JAX package's storage dtype (the
        bits are those on the device: FLOAT64 comes back as uint64 bits)."""
        if self.dtype.id in _OFFSET_TYPES:
            raise ValueError(f"{self.dtype!r} columns have no flat data; read offsets and chars/child")
        return self.data.cpu().numpy().view(self.dtype.np_dtype)

    def to_pylist(self) -> list:
        """Host python values, None for nulls: STRING as str (invalid
        UTF-8 replaced), FLOAT64 as float, other one-word types as their
        numpy scalar's value."""
        valid = self.valid_mask().cpu().numpy()
        if self.dtype.id == TypeId.STRING:
            offs = self.offsets.cpu().numpy()
            chars = self.chars.cpu().numpy().tobytes()
            return [chars[offs[i]:offs[i + 1]].decode("utf-8", errors="replace") if valid[i] else None
                    for i in range(len(self))]
        if not self.dtype.is_fixed_width or self.dtype.id == TypeId.DECIMAL128:
            raise ValueError(f"to_pylist takes STRING or a one-word fixed-width type, got {self.dtype!r}")
        host = self.to_numpy()
        if self.dtype.id == TypeId.FLOAT64:
            host = host.view(np.float64)
        return [host[i].item() if valid[i] else None for i in range(len(self))]

    def __repr__(self):
        return f"Column({self.dtype!r}, rows={len(self)}, nulls={self.null_count})"


def _infer_dtype(np_dt: np.dtype) -> DType:
    from . import dtype as dt

    table = {
        np.dtype(np.int8): dt.INT8,
        np.dtype(np.int16): dt.INT16,
        np.dtype(np.int32): dt.INT32,
        np.dtype(np.int64): dt.INT64,
        np.dtype(np.uint8): dt.UINT8,
        np.dtype(np.uint16): dt.UINT16,
        np.dtype(np.uint32): dt.UINT32,
        np.dtype(np.uint64): dt.UINT64,
        np.dtype(np.float32): dt.FLOAT32,
        np.dtype(np.float64): dt.FLOAT64,
        np.dtype(np.bool_): dt.BOOL8,
    }
    if np_dt not in table:
        raise ValueError(f"cannot infer DType from {np_dt}")
    return table[np_dt]
