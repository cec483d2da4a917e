"""Bound (typed) expressions and their evaluation over blocks (reference:
clickhouse_tpu/exprs/expr.py).

Evaluation runs eagerly on the block's tensors.  Dictionary-encoded string
columns carry a host-side Dictionary; string functions compute per-code
lookup tables with numpy and emit device gathers.  Literals are created on
the device of the block they are evaluated against.

By convention a ColVal's tensor carries the values of its DType's storage
type under the unsigned rule of core/dtypes.py (u16 in int32, u32 and u64
in int64).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import dtypes as dt
from ..core.column import Column, Dictionary
from ..core.errors import NotImplementedError_, TypeError_, UnknownIdentifier

__all__ = ["ColVal", "StoredColVal", "TermColVal", "GatheredColVal",
           "BoundExpr", "BoundColumn",
           "BoundLiteral", "BoundCall", "BoundInList", "evaluate",
           "colval_from_column", "storage_np", "DEVICE_KEY"]

# reserved environment key: a ColVal whose (empty) tensor names the block's
# device, for literals
DEVICE_KEY = "__device__"


@dataclasses.dataclass
class ColVal:
    """A column value during evaluation: device data + metadata.

    data may be a full (capacity,) tensor or a 0-d tensor (constants
    broadcast lazily, the reference's ColumnConst analog).  An Array(T)
    value is a (capacity, max_len) matrix with (capacity,) int32 lengths,
    or, as a constant, a (max_len,) row with 0-d lengths.
    """
    dtype: dt.DType
    data: Any                          # torch tensor (0-d or (cap,))
    validity: Optional[Any] = None     # None = all valid
    dictionary: Optional[Dictionary] = None
    bounds: Optional[tuple] = None     # proven integer value range
    host: Any = None                   # python value of a literal
    lengths: Optional[Any] = None      # Array(T): elements a row (int32)

    @property
    def is_const(self) -> bool:
        nd = getattr(self.data, "ndim", 0)
        return nd <= 1 if self.dtype.is_array else nd == 0

    @property
    def storage(self):
        """The tensor as stored (StoredColVal: narrower than `data`)."""
        return self.data

    def broadcast(self, capacity: int) -> "ColVal":
        data, lengths = self.data, self.lengths
        if self.is_const:
            if self.dtype.is_array:
                data = data.expand(capacity, data.shape[-1])
                if lengths is not None and lengths.dim() == 0:
                    lengths = lengths.expand(capacity)
            else:
                data = data.expand(capacity)
        v = self.validity
        if v is not None and getattr(v, "ndim", 0) == 0:
            v = v.expand(capacity)
        if data is self.data and v is self.validity \
                and lengths is self.lengths:
            return self
        return ColVal(self.dtype, data, v, self.dictionary, self.bounds,
                      lengths=lengths)


def storage_np(cv: ColVal) -> np.dtype:
    """Logical numpy storage type of a ColVal's values."""
    return dt.remove_nullable(cv.dtype).np_dtype


class _LazyColVal(ColVal):
    """A full column whose `data` is built (by `_build`) at its first read
    and kept."""

    def __init__(self, dtype: dt.DType, validity=None):
        super().__init__(dtype, None, validity)

    @property
    def data(self):
        if self._wide is None:
            self._wide = self._build()
        return self._wide

    @data.setter
    def data(self, value):
        self._wide = value

    def _build(self):
        raise NotImplementedError

    @property
    def is_const(self) -> bool:
        return False

    def broadcast(self, capacity: int) -> "ColVal":
        return self              # a full column, validity full or None


class StoredColVal(_LazyColVal):
    """A scanned column stored narrower than its logical type
    (core/column.py narrow_storage).  `storage` is the narrow tensor, which
    K1's filter terms read as it is; `data` widens it to the logical type
    at its first read."""

    def __init__(self, dtype: dt.DType, storage, validity=None):
        self._storage = storage
        super().__init__(dtype, validity)

    def _build(self):
        return self._storage.to(dt.remove_nullable(self.dtype).torch_dtype)

    @property
    def storage(self):
        return self._storage


class TermColVal(_LazyColVal):
    """intDiv or modulo of a StoredColVal by an integer constant, kept as
    its term (`term`: a scan_ops.Term over the column's narrow storage) so
    that K6 can form it in registers from the gathered storage; `data`
    builds the widened column at its first read, as every other reader
    takes it."""

    def __init__(self, dtype: dt.DType, term, validity=None):
        self._term = term
        super().__init__(dtype, validity)

    def _build(self):
        return self._term.build()

    @property
    def term(self):
        return self._term


class GatheredColVal(_LazyColVal):
    """An Array column's rows at `rows` (an expansion's slots), gathered at
    the first read of its data or lengths; arrayElement reads the one
    element a row it needs from `source` instead (the executor's ARRAY
    JOIN carries the arrays it expands this way)."""

    def __init__(self, source: ColVal, rows):
        self.source = source
        self.rows = rows
        self._lengths = None
        validity = None if source.validity is None \
            else source.validity.index_select(0, rows)
        super().__init__(source.dtype, validity)
        self.dictionary = source.dictionary

    def _build(self):
        return self.source.data.index_select(0, self.rows)

    @property
    def lengths(self):
        if self._lengths is None and self.source.lengths is not None:
            self._lengths = self.source.lengths.index_select(0, self.rows)
        return self._lengths

    @lengths.setter
    def lengths(self, value):
        self._lengths = value


def colval_from_column(col: Column) -> ColVal:
    if not col.dtype.is_dictionary and not col.dtype.is_array \
            and col.data.dtype != dt.remove_nullable(col.dtype).torch_dtype:
        return StoredColVal(col.dtype, col.data, col.validity)
    return ColVal(col.dtype, col.data, col.validity, col.dictionary,
                  lengths=col.lengths)


# -- bound expression nodes --------------------------------------------------

class BoundExpr:
    """Base: every node knows its result dtype after analysis."""
    dtype: dt.DType

    def children(self) -> Sequence["BoundExpr"]:
        return ()


@dataclasses.dataclass
class BoundColumn(BoundExpr):
    name: str
    dtype: dt.DType


@dataclasses.dataclass
class BoundLiteral(BoundExpr):
    value: Any
    dtype: dt.DType


@dataclasses.dataclass
class BoundCall(BoundExpr):
    name: str                      # resolved function name
    args: List[BoundExpr]
    dtype: dt.DType

    def children(self):
        return self.args


@dataclasses.dataclass
class BoundDictGet(BoundExpr):
    """dictGet('dict', 'attr', key) (not ported: evaluation raises)."""
    key: BoundExpr
    sorted_keys: "np.ndarray"
    values: "np.ndarray"
    default: Any
    dtype: dt.DType

    def children(self):
        return (self.key,)


@dataclasses.dataclass
class BoundArrayLambda(BoundExpr):
    """Higher-order array function (not ported: evaluation raises)."""
    op: str
    param_ids: List[str]
    body: BoundExpr
    arrays: List[BoundExpr]
    dtype: dt.DType

    def children(self):
        return [self.body] + list(self.arrays)


@dataclasses.dataclass
class BoundInList(BoundExpr):
    """expr IN (v1, v2, ...) with a materialized host-side value set."""
    arg: BoundExpr
    values: "np.ndarray"
    negated: bool
    dtype: dt.DType

    def children(self):
        return (self.arg,)


def _env_device(env: Dict[str, ColVal]) -> torch.device:
    marker = env.get(DEVICE_KEY)
    if marker is not None:
        return marker.data.device
    for cv in env.values():
        if isinstance(cv.data, torch.Tensor):
            return cv.data.device
    return torch.device("cpu")


def evaluate(expr: BoundExpr, env: Dict[str, ColVal],
             max_bytes: Optional[int] = None) -> ColVal:
    """Evaluate a bound expression against a block environment
    (column name -> ColVal).  max_bytes: the device bytes a function may
    build beside the query's working set (a dictionary's chars; the
    budget the governor's estimate leaves), None for no limit."""
    if isinstance(expr, BoundColumn):
        if expr.name not in env:
            raise UnknownIdentifier(f"Column '{expr.name}' not in block "
                                    f"(have: {list(env)})")
        return env[expr.name]
    if isinstance(expr, BoundLiteral):
        return _literal_colval(expr, _env_device(env))
    if isinstance(expr, BoundCall):
        if expr.name == "array" and expr.args and all(
                isinstance(a, BoundLiteral) and a.value is not None
                for a in expr.args):
            # an array of literals: one row built on the host, one copy
            return _literal_colval(BoundLiteral(
                [a.value for a in expr.args], expr.dtype),
                _env_device(env))
        from . import functions
        fn = functions.get(expr.name)
        args = [evaluate(a, env, max_bytes) for a in expr.args]
        out = fn.execute(args, expr.dtype, max_bytes)
        if not args:            # built on the host (now(), pi())
            dev = _env_device(env)
            out = dataclasses.replace(out, data=out.data.to(dev))
        return out
    if isinstance(expr, BoundInList):
        return _evaluate_in_list(expr, env, max_bytes)
    if isinstance(expr, BoundDictGet):
        raise NotImplementedError_(
            "dictGet is not ported to the CUDA engine yet")
    if isinstance(expr, BoundArrayLambda):
        raise NotImplementedError_(
            "higher-order array functions are not ported to the CUDA "
            "engine yet")
    raise TypeError_(f"Cannot evaluate expression node {expr!r}")


def _evaluate_in_list(expr: BoundInList, env: Dict[str, ColVal],
                      max_bytes: Optional[int]) -> ColVal:
    arg = evaluate(expr.arg, env, max_bytes)
    vals = expr.values
    data = arg.data
    dev = data.device
    if arg.dtype.is_dictionary:
        d = arg.dictionary
        codes = [d.lookup(str(v)) for v in vals] if d is not None else []
        codes = [c for c in codes if c >= 0]
        set_arr = torch.tensor(codes, dtype=data.dtype, device=dev) \
            if codes else None
    else:
        t0 = dt.remove_nullable(arg.dtype)
        clean = [v for v in vals if v is not None]
        if clean:
            from ..core import typed
            if typed.needs_decode(t0):
                enc = typed.encode_for_storage(t0, np.asarray(clean, object))
            else:
                enc = np.asarray(clean).astype(t0.np_dtype)
            set_arr = dt.tensor_from_numpy(np.asarray(enc), dev).to(
                data.dtype)
        else:
            set_arr = None
    if set_arr is None:
        member = torch.zeros(data.shape, dtype=torch.bool, device=dev)
    else:
        member = torch.isin(data, set_arr)
    if expr.negated:
        member = ~member
    return ColVal(expr.dtype, member.to(torch.uint8), arg.validity)


def _literal_colval(expr: BoundLiteral, device) -> ColVal:
    v = expr.value
    t = expr.dtype
    if v is None:
        return ColVal(t, torch.zeros((), dtype=t.torch_dtype, device=device),
                      torch.zeros((), dtype=torch.uint8, device=device))
    if t.is_dictionary:
        d = Dictionary(np.asarray([v], dtype=object))
        return ColVal(t, torch.zeros((), dtype=torch.int32, device=device),
                      None, d, host=v)
    if dt.is_composite(t):
        raise NotImplementedError_(
            f"{t} literals are not ported to the CUDA engine yet")
    if t.is_array:
        # a (max_len,) row, zero past its length, as the array constructor
        # makes it
        from ..core.column import array_width
        vals = np.asarray(list(v), dt.array_inner(t).np_dtype)
        row = np.zeros(array_width(len(vals)), vals.dtype)
        row[:len(vals)] = vals
        return ColVal(t, dt.tensor_from_numpy(row, device), host=list(v),
                      lengths=torch.tensor(len(vals), dtype=torch.int32,
                                           device=device))
    bounds = (int(v), int(v)) if isinstance(v, (int, np.integer)) \
        and not isinstance(v, bool) else None
    arr = np.asarray(v).astype(t.np_dtype).reshape(())
    return ColVal(t, dt.tensor_from_numpy(arr, device), bounds=bounds,
                  host=v)
