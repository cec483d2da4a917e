"""Device-resident columns (reference: clickhouse_tpu/core/column.py).

* A column owns a padded tensor of ``capacity`` elements on the session's
  device; the number of valid rows is tracked by the enclosing Block.
* Strings are dictionary codes (int32) on device + a host-side numpy array
  of the unique values (the reference's ColumnLowCardinality made
  mandatory).  A dictionary's values also go to the device on demand as
  ClickHouse's ColumnString keeps them (``Dictionary.device_chars``: one
  chars buffer of the concatenated UTF-8 bytes and U + 1 offsets), for the
  string kernels.
* Nullability is a separate uint8 validity mask (1 = valid).
* Storage is narrowed to the smallest exact width (``narrow_storage``), so
  an Int64 column whose values fit in 32 bits costs 4 bytes a row.
* Array(T) of a numeric T is the reference's layout: a (capacity,
  max_len) matrix, max_len a multiple of 8, zero past each row's length,
  and int32 ``lengths`` (ClickHouse's size0 + data substreams with a
  static width).  A 2-D numpy matrix becomes one without a Python loop a
  row (10M x 128 embeddings), and so do ragged rows given as
  ``ArrayRows`` (a padded matrix and each row's length).

* AggregateFunction(fn, T...) is the reference's layout: a (capacity, B)
  uint8 matrix, each row one packed state of B bytes (exprs/aggregates.py
  state_spec); it comes in as a (rows, B) uint8 matrix or a bytes object
  a row, whose length must be B.

Array(String), Array(Tuple) and arrays of other inner types are not
ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from . import dtypes as dt
from .errors import NotImplementedError_

__all__ = ["ArrayRows", "Column", "Dictionary", "column_from_numpy",
           "PAD_MULTIPLE",
           "pad_to", "narrow_storage", "check_array_type", "array_width",
           "state_matrix", "state_width",
           "hash_tokens128"]

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

    __slots__ = ("values", "_index", "sorted_", "_values_str", "_chars")

    def __init__(self, values: np.ndarray, sorted_: bool = False):
        self.values = np.asarray(values, dtype=object)
        self._index: Optional[dict] = None
        self.sorted_ = sorted_
        self._values_str: Optional[np.ndarray] = None
        # device -> (chars, offsets) of device_chars
        self._chars: dict = {}

    def append(self, value: str) -> int:
        """Add a value at the end (the dictionary is no longer sorted);
        -> its code."""
        self.values = np.append(self.values, value)
        self._index = None
        self._values_str = None
        self._chars = {}
        self.sorted_ = False
        return len(self.values) - 1

    def __len__(self) -> int:
        return len(self.values)

    def values_str(self) -> np.ndarray:
        if self._values_str is None:
            self._values_str = self.values.astype(str)
        return self._values_str

    def device_chars(self, device, check=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The values on `device` as ClickHouse's ColumnString keeps them:
        (chars, offsets), chars one uint8 buffer of the values' UTF-8 bytes
        back to back, offsets U + 1 int32 (int64 once the chars pass 2^31
        bytes) with value u at chars[offsets[u]:offsets[u + 1]].  Nothing
        is truncated.  Built once per device from values_str() (vectorized
        numpy, a chunk of values at a time) and cached; check(nbytes), when
        given, is called with their device bytes before they are copied
        there (not when cached), and may raise."""
        key = str(torch.device(device))
        got = self._chars.get(key)
        if got is None:
            chars, offsets = utf8_chars(self.values_str())
            if check is not None:
                check(chars.nbytes + offsets.nbytes)
            got = (torch.from_numpy(chars).to(device),
                   torch.from_numpy(offsets).to(device))
            self._chars[key] = got
        return got

    def cached_chars_bytes(self, device) -> int:
        """Device bytes of the chars and offsets cached on `device` (0
        before device_chars built them there)."""
        got = self._chars.get(str(torch.device(device)))
        return 0 if got is None else sum(t.nbytes for t in got)

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


# code points a chunk of utf8_chars (bounds its host temporaries to a few
# hundred MB)
_UTF8_CHUNK = 1 << 24


def _offset_itemsize(total: int) -> int:
    return 4 if total < 2**31 else 8


def _code_points(vs: np.ndarray, i: int, step: int):
    """Rows i..i+step of a numpy str array as a (rows, width) uint32 code
    point matrix, and each row's length in code points (a str array pads
    with NUL; a value ends after its last non-NUL code point)."""
    w = vs.dtype.itemsize // 4
    cp = np.ascontiguousarray(vs[i:i + step]).view(np.uint32).reshape(-1, w)
    nz = cp != 0
    n = np.where(nz.any(axis=1), w - np.argmax(nz[:, ::-1], axis=1), 0)
    return cp, n


def _utf8_widths(cp: np.ndarray, n: np.ndarray) -> np.ndarray:
    """UTF-8 bytes of each code point (0 past a row's length)."""
    nb = 1 + (cp >= 0x80).astype(np.uint8) + (cp >= 0x800) + (cp >= 0x10000)
    return np.where(np.arange(cp.shape[1]) < n[:, None], nb, 0)


def utf8_chars(vs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(chars uint8, offsets) of a numpy str array, ColumnString's layout:
    each value's UTF-8 bytes back to back, and U + 1 offsets, int32 while
    the chars fit in 2^31 bytes, else int64."""
    vs = np.asarray(vs, dtype=str)
    pieces, lens = [], np.zeros(len(vs), np.int64)
    step = max(1, _UTF8_CHUNK // max(vs.dtype.itemsize // 4, 1))
    for i in range(0, len(vs), step):
        cp, n = _code_points(vs, i, step)
        inside = np.arange(cp.shape[1]) < n[:, None]
        if cp.size == 0 or int(cp.max()) < 0x80:      # ASCII: a byte each
            pieces.append(cp.astype(np.uint8)[inside])
            lens[i:i + len(cp)] = n
            continue
        nb = _utf8_widths(cp, n)
        c = cp.astype(np.uint32)
        cont = lambda x: 0x80 | (x & 0x3F)            # a continuation byte
        b0 = np.where(nb == 1, c, np.where(nb == 2, 0xC0 | (c >> 6),
                      np.where(nb == 3, 0xE0 | (c >> 12), 0xF0 | (c >> 18))))
        b1 = np.where(nb == 2, cont(c),
                      np.where(nb == 3, cont(c >> 6), cont(c >> 12)))
        b2 = np.where(nb == 3, cont(c), cont(c >> 6))
        b3 = cont(c)
        planes = np.stack([b0, b1, b2, b3], axis=-1).astype(np.uint8)
        pieces.append(planes[np.arange(4) < nb[..., None]])
        lens[i:i + len(cp)] = nb.sum(axis=1)
    chars = np.concatenate(pieces) if pieces else np.zeros(0, np.uint8)
    offsets = np.zeros(len(vs) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    if _offset_itemsize(int(offsets[-1])) == 4:
        offsets = offsets.astype(np.int32)
    return chars, offsets


@dataclasses.dataclass
class Column:
    """A typed, padded device tensor (+ optional validity, dictionary;
    an Array's per-row lengths)."""

    dtype: dt.DType
    data: torch.Tensor                   # (capacity,) or (capacity, max_len)
    validity: Optional[torch.Tensor] = None  # (capacity,) uint8, 1=valid
    dictionary: Optional[Dictionary] = None
    lengths: Optional[torch.Tensor] = None   # (capacity,) int32, arrays only

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
    dic = Dictionary(uniq.astype(object), sorted_=True)
    dic._values_str = uniq
    return codes.astype(np.int32), dic


def _mix64(z: np.ndarray) -> np.ndarray:
    """splitmix64's finalizer over uint64 (wrapping)."""
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def hash_tokens128(values: np.ndarray) -> np.ndarray:
    """A 128-bit token a string ((lo, hi) uint64 records, which compare
    and sort as pairs): two seeded splitmix64 chains over each value's
    UTF-8 bytes, eight at a time, and its length.  Equal strings give
    equal tokens; the hash-token dictionary of a streamed String column
    (storage/table.py ChunkSource) keys its codes by them."""
    b = np.char.encode(np.asarray(values).astype(str), "utf-8")
    n = len(b)
    width = max(-(-b.dtype.itemsize // 8) * 8, 8)
    words = np.zeros((n, width), np.uint8)
    if n and b.dtype.itemsize:
        words[:, :b.dtype.itemsize] = np.frombuffer(
            b.tobytes(), np.uint8).reshape(n, b.dtype.itemsize)
    words = words.view("<u8")
    lens = np.char.str_len(b).astype(np.uint64)
    out = np.empty(n, [("lo", "<u8"), ("hi", "<u8")])
    with np.errstate(over="ignore"):
        for field, seed in (("lo", 0x9E3779B97F4A7C15),
                            ("hi", 0xD1B54A32D192ED03)):
            h = _mix64(lens + np.uint64(seed))
            for j in range(words.shape[1]):
                h = _mix64(h ^ (words[:, j] * np.uint64(
                    0xC2B2AE3D27D4EB4F) + np.uint64(seed)))
            out[field] = h
    return out


_ARRAY_INNER = {"Int8", "Int16", "Int32", "Int64", "UInt8", "UInt16",
                "UInt32", "UInt64", "Float32", "Float64"}


def check_array_type(t: dt.DType) -> None:
    """Raise NotImplementedError_ naming an Array type whose inner type is
    not a plain number (Array(String), Array(Tuple(...)), ...)."""
    inner = dt.array_inner(dt.remove_nullable(t))
    if inner.name not in _ARRAY_INNER or inner.nullable:
        raise NotImplementedError_(
            f"{t} columns are not ported to the CUDA engine yet (Array "
            f"columns hold a plain number type)")


@dataclasses.dataclass
class ArrayRows:
    """Array(T) rows as a (rows, width) numpy matrix, zero past each row's
    length, and the int lengths: ClickHouse's ColumnArray (its offsets and
    data) padded.  ``insert_pydict`` takes it for an Array column and
    copies it in with no Python loop a row."""
    matrix: np.ndarray
    lengths: np.ndarray

    def __post_init__(self):
        self.matrix = np.asarray(self.matrix)
        self.lengths = np.asarray(self.lengths, np.int32)
        if self.matrix.ndim != 2 or self.lengths.shape != (
                self.matrix.shape[0],) or (self.lengths < 0).any() \
                or (self.lengths > self.matrix.shape[1]).any():
            raise ValueError("ArrayRows: a 2-d matrix and a length a row "
                             "within its width")

    dtype = np.dtype(object)        # not a plain column: no part stats
    ndim = 2

    def __len__(self) -> int:
        return self.matrix.shape[0]

    @staticmethod
    def of(piece) -> "ArrayRows":
        """A part's Array column (ArrayRows, a 2-D matrix of full rows, or
        a list a row) as ArrayRows."""
        if isinstance(piece, ArrayRows):
            return piece
        piece = np.asarray(piece)
        if piece.ndim == 2 and piece.dtype != object:
            return ArrayRows(piece, np.full(len(piece), piece.shape[1]))
        lists = [list(v) if v is not None else [] for v in piece]
        lens = np.asarray([len(v) for v in lists], np.int32)
        mat = np.zeros((len(lists), int(lens.max(initial=0))))
        if any(isinstance(x, int) for v in lists for x in v) \
                and not any(isinstance(x, float) for v in lists for x in v):
            mat = mat.astype(np.int64)
        for i, v in enumerate(lists):
            mat[i, :len(v)] = v
        return ArrayRows(mat, lens)

    @staticmethod
    def concat(pieces) -> "ArrayRows":
        rows = [ArrayRows.of(p) for p in pieces]
        width = max((r.matrix.shape[1] for r in rows), default=0)
        dtype = np.result_type(*[r.matrix.dtype for r in rows])
        mat = np.zeros((sum(len(r) for r in rows), width), dtype)
        at = 0
        for r in rows:
            mat[at:at + len(r), :r.matrix.shape[1]] = r.matrix
            at += len(r)
        return ArrayRows(mat, np.concatenate([r.lengths for r in rows]))


def array_width(k: int) -> int:
    """The padded width of arrays of at most k elements (a multiple of
    8, at least 8)."""
    return max(((k + 7) // 8) * 8, 8)


def _array_column(values: np.ndarray, dtype: Optional[dt.DType], n: int,
                  cap: int, device) -> Column:
    """An Array(T) column: a (cap, max_len) matrix and int32 lengths.  A
    2-D numeric matrix is copied in once, with no loop a row; a list a row
    goes through a loop, as the reference's."""
    two_d = values.ndim == 2 and values.dtype != object \
        and not isinstance(values, ArrayRows)
    if dtype is None:
        if isinstance(values, ArrayRows):
            kind = values.matrix.dtype.kind
            dtype = dt.Array(dt.Float64 if kind == "f" else dt.Int64)
        elif two_d:
            kind = values.dtype.kind
        else:
            flat = [x for v in values if v is not None for x in v]
            if any(isinstance(x, str) for x in flat):
                raise NotImplementedError_(
                    "Array(String) columns are not ported to the CUDA "
                    "engine yet")
            kind = "f" if any(isinstance(x, float) for x in flat) else "i"
        if dtype is None:
            dtype = dt.Array(dt.Float64 if kind == "f" else dt.Int64)
    check_array_type(dtype)
    inner = dt.array_inner(dtype)
    lens = np.zeros(cap, np.int32)
    if isinstance(values, ArrayRows):
        d = values.matrix.shape[1]
        mat = np.zeros((cap, array_width(int(values.lengths.max(
            initial=0)))), inner.np_dtype)
        w = min(d, mat.shape[1])
        mat[:n, :w] = values.matrix[:, :w]
        lens[:n] = values.lengths
    elif two_d:
        d = values.shape[1]
        mat = np.zeros((cap, array_width(d)), inner.np_dtype)
        mat[:n, :d] = values
        lens[:n] = d
    else:
        lists = [list(v) if v is not None else [] for v in values]
        lens[:n] = [len(v) for v in lists]
        mat = np.zeros((cap, array_width(int(lens.max(initial=0)))),
                       inner.np_dtype)
        for i, v in enumerate(lists):
            if v:
                mat[i, :len(v)] = np.asarray(v, inner.np_dtype)
    return Column(dtype, dt.tensor_from_numpy(mat, device), None,
                  lengths=dt.tensor_from_numpy(lens, device))


def state_width(dtype: dt.DType) -> int:
    """B: the bytes of one state of an AggregateFunction(...) type."""
    from ..exprs.aggregates import make_merge_for_dtype, state_width_bytes
    return state_width_bytes(make_merge_for_dtype(dtype).spec)


def state_matrix(values, dtype: dt.DType) -> np.ndarray:
    """An AggregateFunction column's host values as its (rows, B) uint8
    matrix: a matrix as it is, a bytes object a row stacked (None: a zero
    state).  A row of another width than B raises TypeError_, naming the
    layout."""
    from .errors import TypeError_
    width = state_width(dtype)
    if isinstance(values, np.ndarray) and values.ndim == 2 \
            and values.dtype != object:
        if values.shape[1] != width:
            raise TypeError_(
                f"{dtype} states are {width} bytes in the CUDA engine's "
                f"layout; got rows of {values.shape[1]}")
        return values.astype(np.uint8, copy=False)
    mat = np.zeros((len(values), width), np.uint8)
    for i, v in enumerate(values):
        if v is None:
            continue
        if not isinstance(v, (bytes, bytearray)) or len(v) != width:
            raise TypeError_(
                f"{dtype} states are {width} bytes in the CUDA engine's "
                f"layout; got {type(v).__name__} of "
                f"{len(v) if hasattr(v, '__len__') else '?'} bytes")
        mat[i] = np.frombuffer(bytes(v), np.uint8)
    return mat


def column_from_numpy(values: np.ndarray, dtype: Optional[dt.DType] = None,
                      capacity: Optional[int] = None, *,
                      device) -> Column:
    """Build a Column on `device` from host data, dictionary-encoding
    strings."""
    if not isinstance(values, ArrayRows):
        values = np.asarray(values)
    n = len(values)
    cap = capacity or pad_to(n)
    if dtype is not None and dtype.agg_state is not None:
        mat = state_matrix(values, dtype)
        out = np.zeros((cap, mat.shape[1]), np.uint8)
        out[:n] = mat
        return Column(dtype, dt.tensor_from_numpy(out, device), None)
    if dtype is not None and dt.is_composite(dtype):
        raise NotImplementedError_(
            f"{dtype} columns are not ported to the CUDA engine yet")
    if (dtype is not None and dtype.is_array) or values.ndim == 2 or (
            dtype is None and values.dtype == object and n
            and all(isinstance(v, (list, tuple, np.ndarray))
                    for v in values)):
        return _array_column(values, dtype, n, cap, device)
    if values.ndim != 1:
        raise NotImplementedError_(
            f"{values.ndim}-d columns are not ported to the CUDA engine yet")

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
