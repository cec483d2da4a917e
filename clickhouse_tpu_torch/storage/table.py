"""Tables and the catalog (reference: clickhouse_tpu/storage/table.py).

A table is a schema plus a list of immutable host parts (numpy) and a
device block cache: ``read_block`` concatenates the parts into padded
tensors on the table's device once after each insert.

A table too large for one device block is read in chunks instead
(``chunk_source`` -> :class:`ChunkSource`, the out-of-core streaming
path, exec/streaming.py): every chunk has the same capacity, the same
physical type a column (narrowed from the parts' min/max, table-wide) and
the same global dictionary a String column, so one per-chunk plan serves
them all.  A bounded integer column rides the host->device link
bit-packed (the "half" layout of :meth:`ChunkSource.encode_column`,
unpacked on the device by K13, ops/chunk_ops.py); encoded chunks are kept
in a host cache, in page-locked memory for a CUDA table, so a repeated
scan copies them straight to the card.

Ported: in-memory tables of any engine name (no merges, replication,
persistence, skip indexes, JSON/Variant shredding, remote sources or
system tables).  An Array column's part is a 2-D numpy matrix (a vector
column, kept as it is) or an object array of a list a row.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import dtypes as dt
from ..core.block import Block
from ..core.column import (ArrayRows, Column, Dictionary, column_from_numpy,
                           state_matrix,
                           hash_tokens128, pad_to)
from ..core.errors import AnalysisError, NotImplementedError_, UnknownTable

__all__ = ["Catalog", "ChunkSource", "Database", "NotStreamable", "Part",
           "Table"]


@dataclasses.dataclass
class Part:
    """Immutable insert unit (IMergeTreeDataPart analog)."""
    columns: Dict[str, np.ndarray]       # host values (object for strings)
    num_rows: int
    minmax: Dict[str, Tuple[float, float]] = dataclasses.field(
        default_factory=dict)
    # lazy per-column uniqueness stat (absent = not computed yet)
    _unique: Dict[str, bool] = dataclasses.field(default_factory=dict)
    # lazy streaming stats: float32 losslessness, granule min/max
    _stats: Dict[tuple, object] = dataclasses.field(default_factory=dict)

    # columns larger than this skip the uniqueness stat (host np.unique cost)
    UNIQUE_STAT_MAX_ROWS = 64_000_000

    def is_unique(self, name: str) -> Optional[bool]:
        """True iff this part's values in `name` are all distinct (the
        planner's N:1-join statistic; computed lazily, cached).  None when
        unknown (non-numeric, or too large to sort and not strictly
        increasing: a part of increasing values is unique at any size,
        found in one pass)."""
        if name in self._unique:
            return self._unique[name]
        v = self.columns.get(name)
        if v is None or v.dtype == object or v.ndim != 1 \
                or v.dtype.kind not in ("i", "u", "f"):
            return None
        if len(v) > 1 and bool(np.all(v[1:] > v[:-1])):
            self._unique[name] = True
            return True
        if len(v) > self.UNIQUE_STAT_MAX_ROWS:
            return None
        u = bool(len(np.unique(v)) == len(v))
        self._unique[name] = u
        return u

    def f32_lossless(self, name: str) -> bool:
        """True iff this part's float64 column round-trips through float32
        (the streamed chunks' narrow storage; computed once, cached)."""
        key = ("f32", name)
        if key not in self._stats:
            v = self.columns.get(name)
            self._stats[key] = v is not None and v.dtype == np.float64 \
                and bool(np.array_equal(v.astype(np.float32).astype(
                    np.float64), v, equal_nan=True))
        return self._stats[key]

    def granule_minmax(self, name: str, granule_rows: int):
        """(min, max) of each granule of granule_rows rows of a numeric
        column (the minmax skip index's granules; computed once, cached)."""
        key = ("granules", name, granule_rows)
        if key not in self._stats:
            v = self.columns[name]
            starts = np.arange(0, len(v), granule_rows)
            self._stats[key] = list(zip(np.minimum.reduceat(v, starts),
                                        np.maximum.reduceat(v, starts))) \
                if len(v) else []
        return self._stats[key]

    @staticmethod
    def from_pydict(data: Dict[str, np.ndarray]) -> "Part":
        n = len(next(iter(data.values()))) if data else 0
        minmax = {}
        cols = {k: v if isinstance(v, ArrayRows) else np.asarray(v)
                for k, v in data.items()}
        for name, v in cols.items():
            if v.dtype != object and v.ndim == 1 and v.dtype.kind in "iuf" \
                    and len(v):
                minmax[name] = (float(v.min()), float(v.max()))
        return Part(cols, n, minmax)


def base_engine(name: str) -> str:
    """Replicated<X> merges like <X> locally (coordination is orthogonal)
    (reference: storage/table.py:base_engine)."""
    if name.startswith("Replicated"):
        return name[len("Replicated"):] or "MergeTree"
    return name


class Table:
    """A named table: schema + list of parts + device cache."""

    _uids = itertools.count(1)

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
        # bumped by every insert: the stream cache and the chunk source
        # cache key on it; uid tells this table from one dropped and
        # created again under its name, whose version starts at 0 too
        self.version = 0
        self.uid = next(Table._uids)
        self._chunk_source_cache = None

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
                n = len(data[name])
                break
        n = 0 if n is None else n
        cols = {}
        for name, ctype in self.schema.items():
            if ctype.is_json or ctype.variant_types is not None:
                raise NotImplementedError_(
                    f"{ctype} columns are not ported to the CUDA engine yet")
            if name in data:
                v = data[name]
                if ctype.agg_state is not None:
                    # one (rows, B) matrix, never a bytes object a row (a
                    # list of bytes as objects: numpy's bytes type drops
                    # trailing NULs)
                    v = state_matrix(v if isinstance(v, np.ndarray)
                                     else np.asarray(v, dtype=object), ctype)
                elif not (ctype.is_array and isinstance(v, ArrayRows)):
                    v = np.asarray(v)
                if len(v) != n:
                    raise AnalysisError("INSERT column length mismatch")
            elif ctype.is_dictionary:
                v = np.asarray([""] * n, dtype=object)
            elif ctype.is_array:
                v = np.zeros((n, 0), ctype.np_dtype)     # empty arrays
            elif ctype.agg_state is not None:
                v = state_matrix([None] * n, ctype)      # zero states
            else:
                v = np.zeros(n, ctype.np_dtype)
            cols[name] = v
        with self._lock:
            self.parts.append(Part.from_pydict(cols))
            self._device_cache = None
            self.version += 1
            self._chunk_source_cache = None

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

    # -- chunked (out-of-core) reads ------------------------------------------
    def chunk_source(self, columns: Sequence[str], chunk_rows: int,
                     part_idx: Optional[tuple] = None,
                     spans: Optional[tuple] = None,
                     row_sel: Optional[list] = None,
                     sel_key=None) -> "ChunkSource":
        """The chunked read of `columns` (the reference's
        Table.chunk_source): chunks of chunk_rows capacity over the parts
        `part_idx` (None: all), the row spans `spans` ((part position, lo,
        hi), ...) or the per-part row selection `row_sel`.  The last source
        is cached (its encoded chunks with it) under the table's version
        and the arguments; a row selection without `sel_key` is not."""
        if row_sel is not None and sel_key is None:
            return ChunkSource(self, list(columns), chunk_rows,
                               part_idx=part_idx, row_sel=row_sel)
        key = (self.version, tuple(sorted(columns)), chunk_rows, part_idx,
               spans, sel_key)
        cached = self._chunk_source_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        src = ChunkSource(self, list(columns), chunk_rows,
                          part_idx=part_idx, spans=spans, row_sel=row_sel)
        self._chunk_source_cache = (key, src)
        return src

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
    if any(isinstance(p, ArrayRows) for p in pieces):
        return ArrayRows.concat(pieces)
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


class NotStreamable(Exception):
    """The table cannot be read in chunks for this plan (the caller tries
    another table or no streaming at all)."""


def check_streamable(table: "Table", name: str) -> None:
    """Raise NotStreamable for a column that chunks cannot carry: one not
    stored in the table (a derived subcolumn), an Array or an
    AggregateFunction column."""
    t = table.schema.get(name)
    if t is None:
        raise NotStreamable(f"derived subcolumn '{name}'")
    if t.is_array:
        raise NotStreamable(f"Array column '{name}'")
    if t.agg_state is not None:
        raise NotStreamable(f"AggregateFunction column '{name}'")


def _tensor_np(np_dtype) -> np.dtype:
    """The numpy type of the tensor that carries values of a storage type
    (dtypes.tensor_from_numpy's unsigned rule: uint16 in int32, uint32 and
    uint64 in int64)."""
    return np.dtype(torch.empty(0, dtype=dt.torch_dtype_of(
        np_dtype)).numpy().dtype)


class ChunkSource:
    """Chunked host reads of a table with one physical layout for every
    chunk (the reference's ChunkSource, storage/table.py:844).

    Table-wide decisions are made once here: each integer column's narrow
    type from the parts' min/max (``storage``), a String column's global
    dictionary (sorted values; above HASH_DICT_MIN_ROWS, hash tokens), a
    column's validity (``nullable``) and the bit-packed transport of a
    bounded, non-NULL integer column (``packed``: name -> (w4, lo, bpp)).
    Reading whole parts, a chunk never crosses a part, so its raw columns
    are zero-copy views of the part.  Encoded chunks are cached up to
    ENCODE_CACHE_BYTES (the page cache's role); for a table on a CUDA
    device in page-locked memory (``pin``), from which the card copies
    without a staging copy.  ``pack=False`` sends every column in its
    storage type (the transport measured against the packing).  A
    ``layout_donor`` (another source of the table) lends its layout: a
    grace join's bucket sources share one.
    """

    # host bytes of encoded chunks kept for repeated scans
    ENCODE_CACHE_BYTES = 8 << 30
    # String columns of at least this many rows take the hash-token
    # dictionary (no sort of the values)
    HASH_DICT_MIN_ROWS = 8_000_000

    def __init__(self, table: "Table", columns: List[str], chunk_rows: int,
                 part_idx: Optional[tuple] = None,
                 spans: Optional[tuple] = None,
                 row_sel: Optional[list] = None, pack: bool = True,
                 layout_donor: Optional["ChunkSource"] = None):
        chunk_rows += chunk_rows & 1      # even: the packing pairs values
        self.table = table
        self.columns = columns
        self.chunk_rows = chunk_rows
        self.pin = torch.device(table.device).type == "cuda"
        self.parts = table.parts if part_idx is None \
            else [table.parts[i] for i in part_idx]
        self.spans = None if spans is None else list(spans)
        self.row_sel = row_sel
        self._chunk_plan = None            # [(part position, lo, hi)]
        if row_sel is not None:
            self.spans = None
            self.total_rows = sum(len(x) for x in row_sel)
        elif self.spans is not None:
            self.total_rows = sum(hi - lo for _, lo, hi in self.spans)
        else:
            self.total_rows = sum(p.num_rows for p in self.parts)
            plan = [(pi, lo, min(lo + chunk_rows, p.num_rows))
                    for pi, p in enumerate(self.parts)
                    for lo in range(0, p.num_rows, chunk_rows)]
            self._chunk_plan = plan or [(0, 0, 0)]
        self.num_chunks = len(self._chunk_plan) \
            if self._chunk_plan is not None \
            else max(1, -(-self.total_rows // chunk_rows))
        self._enc_cache: Dict[int, tuple] = {}
        self._enc_cache_bytes = 0
        self._enc_lock = threading.Lock()
        if layout_donor is not None:
            d = layout_donor
            self.storage, self.dictionaries = d.storage, d.dictionaries
            self._sorted_dict_values = d._sorted_dict_values
            self._dict_hashes, self.nullable = d._dict_hashes, d.nullable
            self.packed = d.packed
            return
        self.storage: Dict[str, np.dtype] = {}
        self.dictionaries: Dict[str, Dictionary] = {}
        self._sorted_dict_values: Dict[str, np.ndarray] = {}
        self._dict_hashes: Dict[str, np.ndarray] = {}
        self.nullable: Dict[str, bool] = {}
        self.packed: Dict[str, tuple] = {}
        for name in columns:
            self._plan_column(name, pack)

    def _plan_column(self, name: str, pack: bool) -> None:
        check_streamable(self.table, name)
        t = self.table.schema[name]
        parts = [p for p in self.parts if p.num_rows]
        obj = any(p.columns[name].dtype == object for p in parts)
        self.nullable[name] = bool(t.nullable) or obj
        if t.is_dictionary:
            flat = np.concatenate([np.asarray(p.columns[name], object)
                                   for p in parts]) if parts \
                else np.zeros(0, object)
            if self.nullable[name]:
                flat = flat[np.asarray([v is not None for v in flat], bool)]
            self.storage[name] = np.dtype(np.int32)
            if len(flat) >= self.HASH_DICT_MIN_ROWS:
                hv = hash_tokens128(flat)
                uniq_h, first = np.unique(hv, return_index=True)
                self.dictionaries[name] = Dictionary(
                    np.asarray(flat, object)[first])
                self._dict_hashes[name] = uniq_h
                return
            uniq = np.unique(flat.astype(str)) if len(flat) \
                else np.zeros(0, str)
            self._sorted_dict_values[name] = uniq
            d = Dictionary(uniq.astype(object), sorted_=True)
            d._values_str = uniq
            self.dictionaries[name] = d
            return
        base = t.np_dtype
        if obj:
            self.storage[name] = _tensor_np(base)   # ragged: not narrowed
        elif base.kind in ("i", "u"):
            b = self.table.column_bounds(name)
            if b is None:
                self.storage[name] = _tensor_np(base)
                return
            nar = np.dtype(_pick_narrow_int(base, b))
            self.storage[name] = _tensor_np(nar)
            lo, hi = b
            w4 = -(-max((hi - lo).bit_length(), 1) // 4) * 4
            bpp = w4 // 4                   # bytes a pair of values
            if pack and not self.nullable[name] and w4 <= 28 \
                    and bpp < nar.itemsize * 2 and -2**63 <= lo \
                    and hi < 2**63:
                self.packed[name] = (w4, int(lo), bpp)
        elif base == np.float64:
            self.storage[name] = np.dtype(np.float32) if all(
                p.f32_lossless(name) for p in parts) else base
        else:
            self.storage[name] = _tensor_np(base)

    # -- reads ---------------------------------------------------------------
    def chunk(self, i: int):
        """-> ({name: (data (cap,) or the packed bytes, validity or
        None)}, rows): chunk i encoded, from the cache where it is."""
        hit = self._enc_cache.get(i)
        if hit is not None:
            return hit
        out, n = self._chunk_uncached(i)
        sz = sum(d.nbytes + (v.nbytes if v is not None else 0)
                 for d, v in out.values())
        with self._enc_lock:
            if self._enc_cache_bytes + sz <= self.ENCODE_CACHE_BYTES:
                self._enc_cache[i] = (out, n)
                self._enc_cache_bytes += sz
        return out, n

    def _empty_raw(self, name: str) -> np.ndarray:
        t = self.table.schema[name]
        return np.zeros(0, object if t.is_dictionary else t.np_dtype)

    def _chunk_uncached(self, i: int):
        cap = self.chunk_rows
        if self._chunk_plan is not None:
            pi, lo, hi = self._chunk_plan[i]
            n = hi - lo
            return {name: self.encode_column(
                name, self.parts[pi].columns[name][lo:hi] if n
                else self._empty_raw(name), cap)
                for name in self.columns}, n
        lo = i * cap
        hi = min(lo + cap, self.total_rows)
        return {name: self.encode_column(
            name, self._slice_column(name, lo, hi), cap)
            for name in self.columns}, max(hi - lo, 0)

    def _host(self, n: int, dtype) -> np.ndarray:
        """A zeroed host buffer of n values (page-locked under pin)."""
        dtype = np.dtype(dtype)
        if not self.pin:
            return np.zeros(n, dtype)
        t = torch.zeros(n, dtype=dt.torch_dtype_of(dtype), pin_memory=True)
        return t.numpy()

    def encode_column(self, name: str, raw: np.ndarray, cap: int):
        """A raw host slice in this source's layout: (data, validity or
        None); data is (cap,) of the column's storage type, or, packed,
        the half layout's cap / 2 * bpp bytes: value j and value j + cap / 2
        (less the column's lower bound lo) are one little-endian pair of
        2 * w4 bits, j's in the low w4."""
        n = len(raw)
        t = self.table.schema[name]
        validity = None
        if self.nullable[name]:
            validity = self._host(cap, np.uint8)
            if raw.dtype == object:
                none = np.asarray([v is None for v in raw], bool)
                validity[:n] = ~none
                raw = raw.copy()
                raw[none] = "" if t.is_dictionary else 0
            else:
                validity[:n] = 1
        if t.is_dictionary:
            data = self._host(cap, np.int32)
            if n:
                hs = self._dict_hashes.get(name)
                if hs is not None:
                    data[:n] = np.searchsorted(
                        hs, hash_tokens128(np.asarray(raw, object)))
                else:
                    data[:n] = np.searchsorted(
                        self._sorted_dict_values[name], raw.astype(str))
        elif name in self.packed:
            w4, off, bpp = self.packed[name]
            half = cap // 2
            data = self._host(half * bpp, np.uint8)
            if n:
                v = np.zeros(cap, np.uint64)
                with np.errstate(over="ignore"):
                    v[:n] = (np.asarray(raw).astype(np.int64) - off
                             ).astype(np.uint64)
                pairs = v[:half] | (v[half:] << np.uint64(w4))
                by = pairs.astype("<u8", copy=False).view(np.uint8)
                data.reshape(half, bpp)[:] = by.reshape(half, 8)[:, :bpp]
        else:
            storage = self.storage[name]
            if n == cap and not self.pin:
                # a full chunk: one cast at most, none where the part is
                # stored in the chunk's type
                data = np.ascontiguousarray(
                    np.asarray(raw).astype(storage, copy=False))
            else:
                data = self._host(cap, storage)
                if n:
                    data[:n] = np.asarray(raw).astype(storage, copy=False)
        return data, validity

    def _slice_column(self, name: str, lo: int, hi: int) -> np.ndarray:
        """Rows [lo, hi) of the source's logical row space (the selected
        rows, or the spans, one part after another)."""
        pieces = []
        off = 0
        if self.row_sel is not None:
            for p, sel in zip(self.parts, self.row_sel):
                a, b = off, off + len(sel)
                off = b
                if b > lo and a < hi:
                    pieces.append(p.columns[name][
                        sel[max(lo - a, 0):min(hi - a, len(sel))]])
        else:
            ranges = self.spans if self.spans is not None else [
                (pi, 0, p.num_rows) for pi, p in enumerate(self.parts)]
            for pi, s_lo, s_hi in ranges:
                a, b = off, off + (s_hi - s_lo)
                off = b
                if b > lo and a < hi:
                    pieces.append(self.parts[pi].columns[name][
                        s_lo + max(lo - a, 0):s_lo + min(hi - a,
                                                         s_hi - s_lo)])
        if not pieces:
            return self._empty_raw(name)
        return pieces[0] if len(pieces) == 1 else np.concatenate(pieces)


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
