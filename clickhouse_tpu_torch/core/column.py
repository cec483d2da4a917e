"""Device-resident columns (reference: clickhouse_tpu/core/column.py).

* A column owns a padded tensor of ``capacity`` elements on the session's
  device; the number of valid rows is tracked by the enclosing Block.
* Strings are dictionary codes (int32) on device + a host-side numpy array
  of the unique values (the reference's ColumnLowCardinality made
  mandatory).
* Nullability is a separate uint8 validity mask (1 = valid).
* Storage is narrowed to the smallest exact width (``narrow_storage``), so
  an Int64 column whose values fit in 32 bits costs 4 bytes a row.

Array and AggregateFunction columns are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import dtypes as dt
from .errors import NotImplementedError_

__all__ = ["Column", "Dictionary", "column_from_numpy", "PAD_MULTIPLE",
           "pad_to", "narrow_storage"]

# Pad every column to a multiple of 1024 rows, as the reference does.
PAD_MULTIPLE = 1024


def pad_to(n: int, multiple: int = PAD_MULTIPLE) -> int:
    if n <= 0:
        return multiple
    return ((n + multiple - 1) // multiple) * multiple


class Dictionary:
    """Host-side dictionary for String columns: unique values.

    values[code] -> python str.  Code -1 is reserved for NULL at the storage
    boundary (device-side NULLs use the validity mask).  `sorted_` marks
    dictionaries produced by np.unique (lookups become binary searches).
    """

    __slots__ = ("values", "_index", "sorted_", "_values_str")

    def __init__(self, values: np.ndarray, sorted_: bool = False):
        self.values = np.asarray(values, dtype=object)
        self._index: Optional[dict] = None
        self.sorted_ = sorted_
        self._values_str: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.values)

    def values_str(self) -> np.ndarray:
        if self._values_str is None:
            self._values_str = self.values.astype(str)
        return self._values_str

    def index(self) -> dict:
        if self._index is None:
            self._index = {v: i for i, v in enumerate(self.values)}
        return self._index

    def lookup(self, value: str) -> int:
        """Code for value, or -1 if absent."""
        if self.sorted_ and len(self) > 4096:
            vs = self.values_str()
            i = int(np.searchsorted(vs, value))
            return i if i < len(vs) and vs[i] == value else -1
        return self.index().get(value, -1)

    @staticmethod
    def unify(a: "Dictionary", b: "Dictionary"):
        """(merged, recode_a, recode_b): recode_x maps old codes to merged
        codes."""
        if a is b:
            ident = np.arange(len(a), dtype=np.int32)
            return a, ident, ident
        merged_vals = list(a.values)
        idx = dict(a.index())
        recode_b = np.empty(len(b), dtype=np.int32)
        for i, v in enumerate(b.values):
            j = idx.get(v)
            if j is None:
                j = len(merged_vals)
                merged_vals.append(v)
                idx[v] = j
            recode_b[i] = j
        merged = Dictionary(np.asarray(merged_vals, dtype=object))
        merged._index = idx
        return merged, np.arange(len(a), dtype=np.int32), recode_b


@dataclasses.dataclass
class Column:
    """A typed, padded device tensor (+ optional validity, dictionary)."""

    dtype: dt.DType
    data: torch.Tensor                   # (capacity,)
    validity: Optional[torch.Tensor] = None  # (capacity,) uint8, 1=valid
    dictionary: Optional[Dictionary] = None

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])


def narrow_storage(data_np: np.ndarray) -> np.ndarray:
    """Pick the narrowest exact physical dtype for a host column.

    A narrower column moves fewer bytes in every scan; consumers widen the
    values to the logical type.  Unsigned narrowings keep the unsigned rule
    of dtypes.py (a uint16 result rides in int32, a uint32 one in int64).
    """
    k = data_np.dtype.kind
    if k == "i" and data_np.dtype.itemsize > 1 and len(data_np):
        lo, hi = int(data_np.min()), int(data_np.max())
        for cand in (np.int8, np.int16, np.int32):
            info = np.iinfo(cand)
            if cand().itemsize < data_np.dtype.itemsize \
                    and info.min <= lo and hi <= info.max:
                return data_np.astype(cand)
    elif k == "u" and data_np.dtype.itemsize > 1 and len(data_np):
        hi = int(data_np.max())
        for cand in (np.uint8, np.uint16, np.uint32):
            if cand().itemsize < data_np.dtype.itemsize \
                    and hi <= np.iinfo(cand).max:
                return data_np.astype(cand)
    elif data_np.dtype == np.float64 and len(data_np):
        f32 = data_np.astype(np.float32)
        if np.array_equal(f32.astype(np.float64), data_np):
            return f32
    return data_np


def factorize_strings(values: np.ndarray):
    """-> (codes int32 (n,), sorted Dictionary)."""
    uniq, codes = np.unique(values.astype(str), return_inverse=True)
    return codes.astype(np.int32), Dictionary(uniq.astype(object),
                                              sorted_=True)


def column_from_numpy(values: np.ndarray, dtype: Optional[dt.DType] = None,
                      capacity: Optional[int] = None, *,
                      device) -> Column:
    """Build a Column on `device` from host data, dictionary-encoding
    strings."""
    values = np.asarray(values)
    n = len(values)
    cap = capacity or pad_to(n)
    if dtype is not None and (dtype.agg_state is not None or dtype.is_array
                              or dt.is_composite(dtype)):
        raise NotImplementedError_(
            f"{dtype} columns are not ported to the CUDA engine yet")
    if values.ndim != 1:
        raise NotImplementedError_(
            "Array columns are not ported to the CUDA engine yet")

    validity_np = None
    if values.dtype == object:
        none_mask = np.array([v is None for v in values], dtype=bool)
        if none_mask.any():
            validity_np = (~none_mask).astype(np.uint8)
            values = values.copy()
            sample = next((v for v in values if v is not None), "")
            values[none_mask] = sample if isinstance(sample, str) else 0
        import datetime as _dtime
        if all(isinstance(v, str) for v in values):
            values = values.astype(object)
        elif len(values) and all(isinstance(v, (list, tuple, np.ndarray))
                                 for v in values):
            raise NotImplementedError_(
                "Array columns are not ported to the CUDA engine yet")
        elif len(values) and all(isinstance(v, (_dtime.datetime,
                                                _dtime.date)) for v in values):
            import calendar as _cal
            scale = 1
            if dtype is not None and dtype.name.startswith("DateTime64"):
                scale = 10 ** (dtype.decimal_scale or 3)

            def to_num(v):
                if isinstance(v, _dtime.datetime):
                    return int(_cal.timegm(v.timetuple())) * scale \
                        + (v.microsecond * scale // 1_000_000)
                return (v - _dtime.date(1970, 1, 1)).days
            values = np.asarray([to_num(v) for v in values], np.int64)
        else:
            values = values.astype(np.float64)

    if values.dtype.kind in ("U", "S", "O"):
        if dtype is None:
            dtype = dt.String
        codes, dic = factorize_strings(values)
        data_np = np.full(cap, -1, dtype=np.int32)
        data_np[:n] = codes
        col = Column(dtype if validity_np is None else dt.make_nullable(dtype),
                     dt.tensor_from_numpy(data_np, device), dictionary=dic)
    else:
        if dtype is None:
            if values.dtype.kind == "b":
                dtype = dt.Boolean
                values = values.astype(np.uint8)
            else:
                dtype = dt.from_numpy_dtype(values.dtype)
        storage = dtype.np_dtype
        data_np = np.zeros(cap, dtype=storage)
        data_np[:n] = values.astype(storage)
        data_np = narrow_storage(data_np)
        col = Column(dtype if validity_np is None else dt.make_nullable(dtype),
                     dt.tensor_from_numpy(data_np, device))

    if validity_np is not None:
        v = np.zeros(cap, dtype=np.uint8)
        v[:n] = validity_np
        col.validity = dt.tensor_from_numpy(v, device)
    elif col.dtype.nullable:
        v = np.zeros(cap, dtype=np.uint8)
        v[:n] = 1
        col.validity = dt.tensor_from_numpy(v, device)
    return col
