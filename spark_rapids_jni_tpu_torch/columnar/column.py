"""Device columns over torch tensors: the port of the JAX package's
``columnar/column.py``.

- fixed width:  ``data``     [N]        (DECIMAL128: [N, 4] int32 limbs, LE)
- validity:     ``validity`` [N] bool   (True == valid; None == all valid)
- STRING:       ``offsets``  [N+1] int32, ``chars`` [nbytes] uint8
- LIST:         ``offsets``  [N+1] int32, ``child`` Column of any type
                (LIST<INT8> holds JCUDF row batches)
- STRUCT:       ``children`` tuple of Columns (+ ``child_names``), all
                length N (cudf's struct_column layout)

Storage types follow ``DType.torch_dtype``: unsigned widths above 8 bits
sit in the signed torch type of the same width, FLOAT64 as IEEE bits in
int64. ``from_numpy``/``to_numpy`` round-trip bits exactly.

Entry points that build device data take ``device=None``, which means
``"cuda"``; without a card they raise instead of moving to the CPU.
"""

from __future__ import annotations

import decimal
import threading
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


H2D = {"copies": 0, "bytes": 0}  # host -> CUDA uploads made through ``upload``
_H2D_LOCK = threading.Lock()  # the exchange's pull threads upload concurrently


def upload(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """One copy of a host array (read-only buffers too) into a tensor on
    ``device``; copies to a CUDA device count in ``H2D``."""
    t = torch.from_numpy(np.array(host, copy=True, order="C"))
    if device.type == "cuda":
        with _H2D_LOCK:
            H2D["copies"] += 1
            H2D["bytes"] += t.numel() * t.element_size()
    return t.to(device)


def _host_to_tensor(host: np.ndarray, t_dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Copy a numpy array into a tensor of ``t_dtype`` with the same bits."""
    return upload(np.ascontiguousarray(host).view(np_view_of_torch(t_dtype)), device)


def _mask_to(validity, device) -> Optional[torch.Tensor]:
    """A validity mask as a bool tensor: tensors stay where they are, host
    masks go to ``device`` (None means the card)."""
    if validity is None or isinstance(validity, torch.Tensor):
        return validity
    return upload(np.asarray(validity).astype(bool), resolve_device(device))


_OFFSET_TYPES = (TypeId.STRING, TypeId.LIST)


class Column:
    """A device column: fixed-width data, STRING, LIST of any child, or
    STRUCT of children."""

    def __init__(
        self,
        dtype: DType,
        data: Optional[torch.Tensor] = None,
        validity: Optional[torch.Tensor] = None,
        offsets: Optional[torch.Tensor] = None,
        chars: Optional[torch.Tensor] = None,
        child: Optional["Column"] = None,
        children: Optional[Sequence["Column"]] = None,
        child_names: Optional[Sequence[str]] = None,
    ):
        self.dtype = dtype
        self.data = data
        self.validity = validity
        self.offsets = offsets
        self.chars = chars
        self.child = child
        self.children = tuple(children) if children is not None else None
        self.child_names = tuple(child_names) if child_names is not None else None

    # -- shape --------------------------------------------------------------
    def __len__(self) -> int:
        if self.dtype.id in _OFFSET_TYPES:
            return int(self.offsets.shape[0]) - 1
        if self.dtype.id == TypeId.STRUCT:
            if self.validity is not None:
                return int(self.validity.shape[0])
            return len(self.children[0]) if self.children else 0
        return int(self.data.shape[0])

    @property
    def num_rows(self) -> int:
        return len(self)

    @property
    def device(self) -> torch.device:
        if self.dtype.id == TypeId.STRUCT:
            if self.validity is not None:
                return self.validity.device
            if not self.children:
                raise ValueError("a STRUCT column with no children and no validity has no device")
            return self.children[0].device
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

    def has_nulls(self) -> bool:
        return self.validity is not None and self.null_count > 0

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
        if not dtype.is_fixed_width:
            raise ValueError(f"build {dtype!r} columns with Column.*_from_parts")
        if dtype.id == TypeId.FLOAT64:
            host = arr.astype(np.float64, copy=False).view(np.uint64)
        else:
            host = arr.astype(dtype.np_dtype, copy=False)
        if dtype.id == TypeId.DECIMAL128 and (host.ndim != 2 or host.shape[1] != 4):
            raise ValueError("DECIMAL128 data must be [N, 4] 32-bit limbs")
        return cls(dtype, data=_host_to_tensor(host, dtype.torch_dtype, dev),
                   validity=_mask_to(validity, dev))

    @classmethod
    def from_pylist(cls, values: Sequence[Any], dtype: DType, device=None) -> "Column":
        """Host python values -> device column; None is null. STRING takes
        str (UTF-8 encoded) or bytes; decimals take unscaled ints or
        ``decimal.Decimal`` values (rounded half up to the scale); other
        fixed-width types take what numpy converts to their storage
        (FLOAT64 as a float). ``device=None`` means the card."""
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
        if not dtype.is_fixed_width:
            raise ValueError(f"from_pylist takes STRING or a fixed-width type, got {dtype!r}")
        if dtype.is_decimal:
            unscaled = [0 if v is None else _to_unscaled(v, dtype.scale) for v in values]
            host = (_pack_decimal128_host(unscaled) if dtype.id == TypeId.DECIMAL128
                    else np.array(unscaled, dtype=dtype.np_dtype))
            return cls.from_numpy(host, dtype, validity, device=dev)
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

        col = cls(dt.STRING, validity=_mask_to(validity, device),
                  offsets=_to(offsets, np.int32, torch.int32),
                  chars=_to(chars, np.uint8, torch.uint8))
        if not isinstance(offsets, torch.Tensor):
            offs = np.asarray(offsets, dtype=np.int64)
            col._max_char_len = int(np.diff(offs).max()) if offs.shape[0] > 1 else 0
        return col

    @classmethod
    def list_from_parts(cls, offsets, child: "Column", validity=None, device=None) -> "Column":
        """LIST column from offsets [N+1] int32 and a child column of any
        type; numpy parts go to ``device`` (None means the card), tensors
        stay where they are."""
        from . import dtype as dt

        if not isinstance(offsets, torch.Tensor):
            offsets = upload(np.asarray(offsets).astype(np.int32, copy=False), resolve_device(device))
        return cls(dt.LIST, validity=_mask_to(validity, device), offsets=offsets, child=child)

    @classmethod
    def struct_from_parts(cls, children: Sequence["Column"], names: Sequence[str],
                          validity=None, device=None) -> "Column":
        """STRUCT column from equal-length children; a numpy validity goes
        to ``device`` (None means the card)."""
        from . import dtype as dt

        return cls(dt.STRUCT, validity=_mask_to(validity, device), children=tuple(children),
                   child_names=tuple(names))

    # -- host round trip ------------------------------------------------------
    def to_numpy(self) -> np.ndarray:
        """Data as a host array in the JAX package's storage dtype (the
        bits are those on the device: FLOAT64 comes back as uint64 bits)."""
        if not self.dtype.is_fixed_width:
            raise ValueError(f"{self.dtype!r} columns have no flat data; read offsets, chars, "
                             "child or children")
        return self.data.cpu().numpy().view(self.dtype.np_dtype)

    def to_pylist(self) -> list:
        """Host python values, None for nulls: STRING as str (invalid
        UTF-8 replaced), LIST as lists, STRUCT as dicts by child name
        (``f<j>`` when unnamed), BOOL8 as bool, FLOAT64 as float, decimals
        as their unscaled ints, other one-word types as their numpy
        scalar's value."""
        valid = self.valid_mask().cpu().numpy()
        tid = self.dtype.id
        if tid == TypeId.STRING:
            offs = self.offsets.cpu().numpy()
            chars = self.chars.cpu().numpy().tobytes()
            return [chars[offs[i]:offs[i + 1]].decode("utf-8", errors="replace") if valid[i] else None
                    for i in range(len(self))]
        if tid == TypeId.LIST:
            offs = self.offsets.cpu().numpy()
            child_vals = self.child.to_pylist()
            return [child_vals[offs[i]:offs[i + 1]] if valid[i] else None for i in range(len(self))]
        if tid == TypeId.STRUCT:
            names = self.child_names or tuple(f"f{j}" for j in range(len(self.children)))
            per_child = [c.to_pylist() for c in self.children]
            return [{nm: per_child[j][i] for j, nm in enumerate(names)} if valid[i] else None
                    for i in range(len(self))]
        host = self.to_numpy()
        if tid == TypeId.DECIMAL128:
            unscaled = _unpack_decimal128_host(host)
            return [unscaled[i] if valid[i] else None for i in range(len(self))]
        if tid == TypeId.BOOL8:
            return [bool(host[i]) if valid[i] else None for i in range(len(self))]
        if tid == TypeId.FLOAT64:
            host = host.view(np.float64)
        return [host[i].item() if valid[i] else None for i in range(len(self))]

    def to_decimal_pylist(self) -> list:
        """Decimal columns as ``decimal.Decimal`` values (scaled)."""
        assert self.dtype.is_decimal
        scale = self.dtype.scale
        return [
            None if v is None else decimal.Decimal(v).scaleb(scale)
            for v in self.to_pylist()
        ]

    def __repr__(self):
        return f"Column({self.dtype!r}, rows={len(self)}, nulls={self.null_count})"


def _to_unscaled(v, scale: int) -> int:
    """A python int (already unscaled) or a ``decimal.Decimal`` (scaled to
    ``10**-scale``, rounded half up) -> the unscaled int."""
    if isinstance(v, decimal.Decimal):
        return int(v.scaleb(-scale).to_integral_value(rounding=decimal.ROUND_HALF_UP))
    return int(v)


def _pack_decimal128_host(values: Sequence[int]) -> np.ndarray:
    """Unscaled python ints -> [N, 4] uint32 little-endian limbs (two's
    complement)."""
    out = np.empty((len(values), 4), dtype=np.uint32)
    for i, v in enumerate(values):
        u = v & ((1 << 128) - 1)
        for j in range(4):
            out[i, j] = (u >> (32 * j)) & 0xFFFFFFFF
    return out


def _unpack_decimal128_host(limbs: np.ndarray) -> list:
    """[N, 4] uint32 limbs -> unscaled python ints (signed)."""
    vals = []
    for row in limbs:
        u = sum(int(row[j]) << (32 * j) for j in range(4))
        vals.append(u - (1 << 128) if u >= 1 << 127 else u)
    return vals


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
