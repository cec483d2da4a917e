"""Tables and the catalog (reference: clickhouse_tpu/storage/table.py).

A table is a schema plus a list of immutable host parts (numpy) and a
device block cache: ``read_block`` concatenates the parts into padded
tensors on the table's device once after each insert.

Ported: in-memory tables of any engine name (no merges, replication,
persistence, skip indexes, JSON/Variant shredding, remote sources or
system tables).  An Array column's part is a 2-D numpy matrix (a vector
column, kept as it is) or an object array of a list a row.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import dtypes as dt
from ..core.block import Block
from ..core.column import Column, column_from_numpy, pad_to
from ..core.errors import AnalysisError, NotImplementedError_, UnknownTable

__all__ = ["Catalog", "Database", "Part", "Table"]


@dataclasses.dataclass
class Part:
    """Immutable insert unit (IMergeTreeDataPart analog)."""
    columns: Dict[str, np.ndarray]       # host values (object for strings)
    num_rows: int
    minmax: Dict[str, Tuple[float, float]] = dataclasses.field(
        default_factory=dict)
    # lazy per-column uniqueness stat (absent = not computed yet)
    _unique: Dict[str, bool] = dataclasses.field(default_factory=dict)

    # columns larger than this skip the uniqueness stat (host np.unique cost)
    UNIQUE_STAT_MAX_ROWS = 64_000_000

    def is_unique(self, name: str) -> Optional[bool]:
        """True iff this part's values in `name` are all distinct (the
        planner's N:1-join statistic; computed lazily, cached).  None when
        unknown (too large / non-numeric)."""
        if name in self._unique:
            return self._unique[name]
        v = self.columns.get(name)
        if v is None or v.dtype == object or v.ndim != 1 \
                or v.dtype.kind not in ("i", "u", "f") \
                or len(v) > self.UNIQUE_STAT_MAX_ROWS:
            return None
        u = bool(len(np.unique(v)) == len(v))
        self._unique[name] = u
        return u

    @staticmethod
    def from_pydict(data: Dict[str, np.ndarray]) -> "Part":
        n = len(next(iter(data.values()))) if data else 0
        minmax = {}
        for name, vals in data.items():
            v = np.asarray(vals)
            if v.dtype != object and v.ndim == 1 and v.dtype.kind in "iuf" \
                    and len(v):
                minmax[name] = (float(v.min()), float(v.max()))
        return Part({k: np.asarray(v) for k, v in data.items()}, n, minmax)


class Table:
    """A named table: schema + list of parts + device cache."""

    def __init__(self, name: str, schema: List[Tuple[str, dt.DType]],
                 engine: str = "Memory",
                 order_by: Optional[List[str]] = None, *, device):
        self.name = name
        self.schema: Dict[str, dt.DType] = dict(schema)
        self.engine = engine
        self.order_by = order_by or []
        self.parts: List[Part] = []
        self.device = device
        self._device_cache: Optional[Block] = None
        self._lock = threading.Lock()

    def schema_items(self) -> List[Tuple[str, dt.DType]]:
        return list(self.schema.items())

    @property
    def num_rows(self) -> int:
        return sum(p.num_rows for p in self.parts)

    # -- writes --------------------------------------------------------------
    def insert_pydict(self, data: Dict[str, np.ndarray]):
        if self.engine == "Null":
            return                        # StorageNull: writes vanish
        n = None
        for name in self.schema:
            if name in data:
                n = len(np.asarray(data[name]))
                break
        n = 0 if n is None else n
        cols = {}
        for name, ctype in self.schema.items():
            if ctype.is_json or ctype.variant_types is not None:
                raise NotImplementedError_(
                    f"{ctype} columns are not ported to the CUDA engine yet")
            if name in data:
                v = np.asarray(data[name])
                if len(v) != n:
                    raise AnalysisError("INSERT column length mismatch")
            elif ctype.is_dictionary:
                v = np.asarray([""] * n, dtype=object)
            elif ctype.is_array:
                v = np.zeros((n, 0), ctype.np_dtype)     # empty arrays
            else:
                v = np.zeros(n, ctype.np_dtype)
            cols[name] = v
        with self._lock:
            self.parts.append(Part.from_pydict(cols))
            self._device_cache = None

    # -- reads ---------------------------------------------------------------
    def read_block(self, columns: Optional[Sequence[str]] = None) -> Block:
        """Whole-table device block (concatenated parts, padded), cached
        until the next insert."""
        with self._lock:
            if self._device_cache is None:
                self._device_cache = self._build_device_block()
            blk = self._device_cache
        if columns is not None:
            return blk.select(list(columns))
        return blk

    def _build_device_block(self) -> Block:
        total = self.num_rows
        cap = pad_to(total)
        cols: Dict[str, Column] = {}
        for name, ctype in self.schema.items():
            pieces = [p.columns[name] for p in self.parts] or \
                [np.zeros(0, ctype.np_dtype if not ctype.is_dictionary
                          else object)]
            if ctype.is_dictionary and all(
                    np.asarray(p).dtype.kind == "U" for p in pieces):
                # numpy str parts stay str (no Python object a value)
                merged = np.concatenate(pieces)
            elif ctype.is_dictionary:
                merged = np.concatenate([np.asarray(p, dtype=object)
                                         for p in pieces])
            elif ctype.is_array:
                merged = _array_rows(pieces)
            else:
                merged = np.concatenate(pieces)
            cols[name] = column_from_numpy(merged, ctype, capacity=cap,
                                           device=self.device)
        return Block(cols, total)

    def physical_bytes(self, columns: Optional[Sequence[str]] = None) -> int:
        """Estimated device bytes of a full-table scan (narrow storage)."""
        n = self.num_rows
        total = 0
        for name, t in self.schema.items():
            if columns is not None and name not in columns:
                continue
            if t.is_dictionary:
                total += 4 * n
            elif t.is_array:
                total += 8 * n * 8
            else:
                b = self.column_bounds(name)
                if b is not None:
                    total += _narrow_itemsize(t.np_dtype, b) * n
                else:
                    total += t.np_dtype.itemsize * n
        return total

    def column_unique(self, name: str) -> bool:
        """Whole-table uniqueness of a column: every part unique AND part
        minmax ranges pairwise disjoint (cheap conservative check)."""
        if not self.parts:
            return True
        ranges = []
        for p in self.parts:
            if p.num_rows == 0:
                continue
            if p.is_unique(name) is not True:
                return False
            mm = p.minmax.get(name)
            if mm is None:
                return len([q for q in self.parts if q.num_rows]) == 1
            ranges.append(mm)
        ranges.sort()
        for (lo_a, hi_a), (lo_b, hi_b) in zip(ranges, ranges[1:]):
            if lo_b <= hi_a:
                return False
        return True

    def column_bounds(self, name: str):
        """Integer (lo, hi) over all parts, or None (minmax-index analog)."""
        t = self.schema.get(name)
        if t is None or t.is_dictionary or t.np_dtype.kind not in ("i", "u"):
            return None
        lo = hi = None
        for p in self.parts:
            mm = p.minmax.get(name)
            if mm is None:
                if p.num_rows:
                    return None
                continue
            lo = mm[0] if lo is None else min(lo, mm[0])
            hi = mm[1] if hi is None else max(hi, mm[1])
        if lo is None:
            return None
        return (int(lo), int(hi))


def _array_rows(pieces: List[np.ndarray]) -> np.ndarray:
    """An Array column's parts as one host array: one 2-D matrix as it is,
    2-D matrices of one width stacked (no loop a row), else an object
    array of a list a row."""
    if len(pieces) == 1:
        return pieces[0]
    if all(p.ndim == 2 and p.dtype != object for p in pieces) \
            and len({p.shape[1] for p in pieces}) == 1:
        return np.concatenate(pieces)
    rows = [list(r) if r is not None else [] for p in pieces for r in p]
    out = np.empty(len(rows), object)
    for i, r in enumerate(rows):
        out[i] = r
    return out


def _pick_narrow_int(base: np.dtype, bounds: Tuple[int, int]):
    """Narrowest exact integer dtype for the proven [lo, hi] interval."""
    lo, hi = bounds
    if base.kind == "i":
        for cand in (np.int8, np.int16, np.int32):
            info = np.iinfo(cand)
            if cand().itemsize < base.itemsize \
                    and info.min <= lo and hi <= info.max:
                return cand
    elif base.kind == "u":
        for cand in (np.uint8, np.uint16, np.uint32):
            if cand().itemsize < base.itemsize \
                    and hi <= np.iinfo(cand).max:
                return cand
    return base.type


def _narrow_itemsize(np_dtype: np.dtype, bounds: Tuple[int, int]) -> int:
    return np.dtype(_pick_narrow_int(np_dtype, bounds)).itemsize


class Database:
    def __init__(self, name: str):
        self.name = name
        self.tables: Dict[str, Table] = {}
        self.dictionaries: Dict[str, object] = {}   # read by the analyzer


class Catalog:
    """Databases/tables registry (DatabaseCatalog analog)."""

    def __init__(self, device):
        self.databases: Dict[str, Database] = {"default": Database("default"),
                                               "system": Database("system")}
        self.current_database = "default"
        self.device = device

    def get_table(self, database: str, name: str) -> Table:
        db = self.databases.get(database)
        if db is None:
            raise UnknownTable(f"Unknown database '{database}'")
        t = db.tables.get(name)
        if t is None:
            raise UnknownTable(f"Unknown table '{database}.{name}'")
        return t

    def get_view(self, database: str, name: str):
        return None

    def has_table(self, database: str, name: str) -> bool:
        try:
            self.get_table(database, name)
            return True
        except UnknownTable:
            return False

    def create_table(self, database: str, table: Table,
                     if_not_exists: bool = False):
        db = self.databases.get(database)
        if db is None:
            raise UnknownTable(f"Unknown database '{database}'")
        if table.name in db.tables:
            if if_not_exists:
                return
            raise AnalysisError(
                f"Table '{database}.{table.name}' already exists")
        db.tables[table.name] = table

    def drop_table(self, database: str, name: str, if_exists: bool = False):
        db = self.databases.get(database)
        if db is None or name not in db.tables:
            if if_exists:
                return
            raise UnknownTable(f"Unknown table '{database}.{name}'")
        db.tables.pop(name)

    def create_database(self, name: str, if_not_exists: bool = False):
        if name in self.databases:
            if if_not_exists:
                return
            raise AnalysisError(f"Database '{name}' already exists")
        self.databases[name] = Database(name)

    def drop_database(self, name: str, if_exists: bool = False):
        if name not in self.databases:
            if if_exists:
                return
            raise UnknownTable(f"Unknown database '{name}'")
        del self.databases[name]
