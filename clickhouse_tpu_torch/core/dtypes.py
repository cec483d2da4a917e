"""Data types of the CUDA engine (reference: clickhouse_tpu/core/dtypes.py).

Role model: the reference's ``IDataType`` hierarchy (src/DataTypes/IDataType.h:29)
with the crucial TPU-first difference that *all* device-resident data is
fixed-width.  Variable-width strings are dictionary-encoded at the storage
boundary (the reference's LowCardinality concept, src/Columns/ColumnLowCardinality.h,
promoted to the default string strategy per SURVEY.md §7 "Hard parts").

A DType describes the logical type; the physical device representation is
a torch tensor of ``torch_dtype`` plus, for Nullable, a separate uint8
validity mask (reference: ColumnNullable = value column + null mask,
src/Columns/ColumnNullable.h).

Torch cannot compute on uint16/uint32/uint64 tensors (no add, compare,
sort or reduce), so unsigned values ride as signed bit patterns: u16 in
int32, u32 in int64 and u64 as int64 bits.  ``storage_dtype`` stays the
logical numpy type; :func:`torch_dtype_of` gives the tensor type and
:func:`to_numpy_storage` views a tensor back as the logical numpy array.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

__all__ = [
    "DType",
    "Int8", "Int16", "Int32", "Int64",
    "UInt8", "UInt16", "UInt32", "UInt64",
    "Float32", "Float64",
    "Boolean", "String", "JSON", "Date", "DateTime", "Nothing",
    "Decimal", "DateTime64", "Enum8", "Enum16", "FixedString",
    "UUID", "IPv4", "IPv6",
    "Nullable", "make_nullable", "remove_nullable",
    "parse_type_name", "common_supertype", "is_numeric", "is_integer",
    "is_float", "is_string", "is_decimal", "is_enum", "NUMERIC_ORDER",
]


@dataclasses.dataclass(frozen=True)
class DType:
    """Logical data type.

    name            -- SQL-visible name (ClickHouse-compatible spelling)
    storage_dtype   -- numpy dtype string of the device representation
    nullable        -- whether a validity mask accompanies the values
    is_dictionary   -- True for String: device holds int32 codes into a
                       host-side dictionary of unique byte strings
    is_array        -- True for Array(T): device holds a (rows, max_len)
                       padded matrix + per-row lengths (the reference's
                       size0 + data substream layout, statically shaped)
    """

    name: str
    storage_dtype: str
    nullable: bool = False
    is_dictionary: bool = False
    is_array: bool = False
    # Decimal(P, S) / DateTime64(S): device holds int64 scaled by 10^S
    # (reference: src/DataTypes/DataTypeDecimalBase.h — same scaled-integer
    # representation; we cap at Decimal64 range, see Decimal())
    decimal_scale: Optional[int] = None
    decimal_prec: Optional[int] = None
    # Enum8/Enum16: device holds the numeric code; names map on the host
    # (reference: src/DataTypes/DataTypeEnum.h)
    enum_values: Optional[tuple] = None     # ((name, value), ...)
    # FixedString(N)
    fixed_len: Optional[int] = None
    # AggregateFunction(fn, T...): device holds a (rows, state_bytes) uint8
    # matrix of packed mergeable state (the reference's
    # ColumnAggregateFunction, src/Columns/ColumnAggregateFunction.h — its
    # arena-allocated variable states become fixed-width byte rows here).
    # (fn_name, (arg type names...), (params...))
    agg_state: Optional[tuple] = None
    # Tuple(T1, T2, ...): evaluation-time composite — a ColVal carries one
    # sub-ColVal per element (reference: ColumnTuple is a struct-of-columns,
    # src/Columns/ColumnTuple.h — same layout, expressed as nesting)
    tuple_types: Optional[tuple] = None     # element type names
    # Map(K, V): evaluation-time composite of two Array sub-ColVals (keys,
    # values) sharing lengths (reference: ColumnMap wraps
    # Array(Tuple(K, V)), src/Columns/ColumnMap.h — same nested layout,
    # struct-of-arrays instead of array-of-structs)
    map_types: Optional[tuple] = None       # (key type name, value type name)
    # JSON (semi-structured): parts hold canonical serialized documents;
    # discovered scalar paths shred into ordinary typed device subcolumns
    # at block build (reference: src/Columns/ColumnObject.h — typed path
    # subcolumns + shared-data residue; here the full document IS the
    # residue and doubles as the printable value).  The base column itself
    # is dictionary-encoded serialized text (device codes), so whole-doc
    # GROUP BY / DISTINCT / equality work like any String.
    is_json: bool = False

    # Variant(T1, T2, ...) / Dynamic: canonical serialized values
    # dictionary-encode as the base column (device codes — whole-value
    # GROUP BY/equality work like String); a per-row discriminator and
    # per-type decoded subcolumns shred at block build (reference:
    # src/Columns/ColumnVariant.h discriminators+variants,
    # ColumnDynamic.h).  () = Dynamic (open set, discovered from data).
    variant_types: Optional[Tuple[str, ...]] = None

    # -- helpers -------------------------------------------------------------
    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(self.storage_dtype)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype_of(self.np_dtype)

    @property
    def itemsize(self) -> int:
        return self.np_dtype.itemsize

    def __str__(self) -> str:  # ClickHouse-style rendering
        return f"Nullable({self.name})" if self.nullable else self.name

    def with_nullable(self, nullable: bool = True) -> "DType":
        return dataclasses.replace(self, nullable=nullable)


# numpy storage type -> torch tensor type (the unsigned rule above)
_TORCH_OF_NP = {
    np.dtype("bool"): torch.bool, np.dtype("int8"): torch.int8,
    np.dtype("uint8"): torch.uint8, np.dtype("int16"): torch.int16,
    np.dtype("uint16"): torch.int32, np.dtype("int32"): torch.int32,
    np.dtype("uint32"): torch.int64, np.dtype("int64"): torch.int64,
    np.dtype("uint64"): torch.int64, np.dtype("float32"): torch.float32,
    np.dtype("float64"): torch.float64,
}


def torch_dtype_of(np_dtype) -> torch.dtype:
    """Tensor type that carries values of a numpy storage type."""
    return _TORCH_OF_NP[np.dtype(np_dtype)]


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """Host array -> tensor on `device` under the unsigned rule (u64 keeps
    its bits in int64)."""
    a = np.require(a, requirements="C")       # keeps 0-d arrays 0-d
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    elif a.dtype == np.uint16:
        a = a.astype(np.int32)
    elif a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(a).to(device)


def to_numpy_storage(t: torch.Tensor, np_dtype=None) -> np.ndarray:
    """Tensor -> host numpy; an unsigned logical `np_dtype` views signed
    storage back as unsigned (int64 bits -> uint64 wrap exactly)."""
    a = t.detach().cpu().numpy()
    if np_dtype is not None:
        want = np.dtype(np_dtype)
        if want.kind == "u" and a.dtype.kind == "i":
            a = a.astype(want)
    return a


_U_MASK = {np.dtype("uint16"): 0xFFFF, np.dtype("uint32"): 0xFFFFFFFF}


def u64_to_f64(t: torch.Tensor) -> torch.Tensor:
    """UInt64 bits (an int64 tensor) -> float64 of the unsigned value,
    rounded once, as numpy's astype: each 32-bit half is exact in float64,
    so their sum is the only rounding."""
    hi = ((t >> 32) & 0xFFFFFFFF).to(torch.float64)
    return hi * 4294967296.0 + (t & 0xFFFFFFFF).to(torch.float64)


def cast_tensor(t: torch.Tensor, src, dst) -> torch.Tensor:
    """numpy's ``astype(dst)`` on a tensor holding values of logical type
    `src`, under the unsigned rule (integers wrap, floats truncate toward
    zero when cast to integers, u64 bits read as unsigned)."""
    src, dst = np.dtype(src), np.dtype(dst)
    want = torch_dtype_of(dst)
    if dst.kind == "f":
        if src == np.uint64 and t.dtype == torch.int64:
            # via the correctly rounded float64: float32 has fewer than
            # half of its bits, so rounding twice gives the same float32
            return u64_to_f64(t).to(want)
        return t.to(want)
    if dst.kind == "b":
        return t != 0
    if t.is_floating_point():
        t = t.to(torch.int64)
    if dst in _U_MASK:
        return (t.to(torch.int64) & _U_MASK[dst]).to(want)
    return t if t.dtype == want else t.to(want)


def is_unsigned(t: "DType") -> bool:
    """Logical unsigned integer storage (UInt8..UInt64, Bool, IPv4)."""
    return t.np_dtype.kind == "u" and not t.is_dictionary


# -- concrete types ----------------------------------------------------------
Int8 = DType("Int8", "int8")
Int16 = DType("Int16", "int16")
Int32 = DType("Int32", "int32")
Int64 = DType("Int64", "int64")
UInt8 = DType("UInt8", "uint8")
UInt16 = DType("UInt16", "uint16")
UInt32 = DType("UInt32", "uint32")
UInt64 = DType("UInt64", "uint64")
Float32 = DType("Float32", "float32")
Float64 = DType("Float64", "float64")
Boolean = DType("Bool", "uint8")
# Strings: dictionary codes on device (int32), dictionary on host.
String = DType("String", "int32", is_dictionary=True)
JSON = DType("JSON", "int32", is_dictionary=True, is_json=True)
# Days since epoch / seconds since epoch, like the reference's Date/DateTime.
Date = DType("Date", "int32")
DateTime = DType("DateTime", "int64")
Nothing = DType("Nothing", "int8")

# Interval types (reference: DataTypeInterval) — int64 counts of their unit.
INTERVAL_UNITS = ["Nanosecond", "Microsecond", "Millisecond",
                  "Second", "Minute", "Hour", "Day", "Week", "Month",
                  "Quarter", "Year"]
INTERVALS = {u: DType(f"Interval{u}", "int64") for u in INTERVAL_UNITS}

_BY_NAME = {
    t.name: t
    for t in [
        Int8, Int16, Int32, Int64, UInt8, UInt16, UInt32, UInt64,
        Float32, Float64, Boolean, String, Date, DateTime, Nothing,
        *INTERVALS.values(),
    ]
}


def Decimal(precision: int, scale: int) -> DType:
    """Decimal(P, S): scaled int64 on device.

    Reference: src/DataTypes/DataTypesDecimal.h.  All precisions share the
    int64 physical type (Decimal128/256 values beyond ~1.8e18 scaled units
    are out of range — a documented cap; the reference's wide-decimal limbs
    do not map to TPU-efficient layouts).
    """
    if not (0 <= scale <= precision):
        raise ValueError(f"Invalid Decimal scale {scale} for precision "
                         f"{precision}")
    return DType(f"Decimal({precision}, {scale})", "int64",
                 decimal_scale=scale, decimal_prec=precision)


def DateTime64(scale: int = 3) -> DType:
    """DateTime64(S): int64 ticks of 10^-S seconds since epoch."""
    return DType(f"DateTime64({scale})", "int64", decimal_scale=scale)


def Enum8(values) -> DType:
    vals = tuple((str(k), int(v)) for k, v in values)
    body = ", ".join(f"'{k}' = {v}" for k, v in vals)
    return DType(f"Enum8({body})", "int8", enum_values=vals)


def Enum16(values) -> DType:
    vals = tuple((str(k), int(v)) for k, v in values)
    body = ", ".join(f"'{k}' = {v}" for k, v in vals)
    return DType(f"Enum16({body})", "int16", enum_values=vals)


def FixedString(n: int) -> DType:
    """FixedString(N): dictionary-encoded like String; values are exactly
    N bytes, zero-padded (reference: src/Columns/ColumnFixedString.h)."""
    return DType(f"FixedString({n})", "int32", is_dictionary=True,
                 fixed_len=int(n))


# UUID / IPv6: 128-bit identity types; equality/grouping/sorting dominate
# their usage, so the dictionary-code layout (device int32 codes, canonical
# text on host) serves them like String.  IPv4 is a true u32.
UUID = DType("UUID", "int32", is_dictionary=True)
IPv6 = DType("IPv6", "int32", is_dictionary=True)
IPv4 = DType("IPv4", "uint32")


_BY_NAME["Date32"] = Date
# Wide integers map to 64-bit storage (documented cap: values beyond the
# int64/uint64 range are out of scope — the reference's 128/256-bit limbs
# have no TPU-efficient layout; most test traffic stays in range)
_BY_NAME["Int128"] = DType("Int128", "int64")
_BY_NAME["Int256"] = DType("Int256", "int64")
_BY_NAME["UInt128"] = DType("UInt128", "uint64")
_BY_NAME["UInt256"] = DType("UInt256", "uint64")
_BY_NAME["UUID"] = UUID
_BY_NAME["IPv4"] = IPv4
_BY_NAME["IPv6"] = IPv6


def AggregateState(fn_name: str, arg_types, params=()) -> DType:
    """AggregateFunction(fn, T...): packed mergeable-state bytes."""
    arg_names = tuple(str(t) for t in arg_types)
    if params:
        ptxt = ", ".join(repr(p) if isinstance(p, str) else str(p)
                         for p in params)
        head = f"{fn_name}({ptxt})"
    else:
        head = fn_name
    body = ", ".join([head] + list(arg_names))
    return DType(f"AggregateFunction({body})", "uint8",
                 agg_state=(fn_name, arg_names, tuple(params or ())))


def Tuple(element_types) -> DType:
    names = tuple(str(t) for t in element_types)
    return DType(f"Tuple({', '.join(names)})", "int8", tuple_types=names)


def _split_named_member(part: str):
    """'a UInt64' -> ('a', 'UInt64'); 'UInt64' -> (None, 'UInt64').

    A leading identifier counts as a member name only when the remainder
    itself parses as a type (so `Nullable (x)`-style spellings survive)."""
    p = part.strip()
    if p and (p[0].isalpha() or p[0] in "_`\""):
        quote = p[0] if p[0] in "`\"" else None
        if quote:
            end = p.find(quote, 1)
            if end > 0:
                return p[1:end], p[end + 1:].strip()
        i = 0
        while i < len(p) and (p[i].isalnum() or p[i] == "_"):
            i += 1
        head, rest = p[:i], p[i:].strip()
        if rest and not rest.startswith("("):
            try:
                parse_type_name(rest)
                return head, rest
            except ValueError:
                pass
    return None, p


def tuple_member_names(t: DType):
    """Member names of a named Tuple/Nested dtype (None where unnamed)."""
    return [(_split_named_member(n)[0]) for n in (t.tuple_types or ())]


def tuple_inner(t: DType):
    out = []
    for n in t.tuple_types:
        nm, tp = _split_named_member(n)
        out.append(parse_type_name(tp))
    return out


def is_nested(t: DType) -> bool:
    return t.tuple_types is not None and t.name.startswith("Nested(")


def nested_members(t: DType):
    """[(member_name, element DType)] of a Nested(...) marker type."""
    out = []
    for n in t.tuple_types:
        nm, tp = _split_named_member(n)
        out.append((nm, parse_type_name(tp)))
    return out


def is_tuple(t: DType) -> bool:
    return t.tuple_types is not None


def Map(key: DType, value: DType) -> DType:
    return DType(f"Map({key}, {value})", "int8",
                 map_types=(str(key), str(value)))


def map_inner(t: DType):
    return parse_type_name(t.map_types[0]), parse_type_name(t.map_types[1])


def is_map(t: DType) -> bool:
    return t.map_types is not None


def is_composite(t: DType) -> bool:
    """Composite ColVals (Tuple/Map) carry sub-columns and do not flatten
    into the compiled-leaves pytree."""
    return t.tuple_types is not None or t.map_types is not None


def is_agg_state(t: DType) -> bool:
    return t.agg_state is not None


def Variant(types: Tuple[str, ...]) -> DType:
    """Variant(T1, ...) — or Dynamic when `types` is empty."""
    nm = "Dynamic" if not types else f"Variant({', '.join(types)})"
    return DType(nm, "int32", is_dictionary=True,
                 variant_types=tuple(types))


def is_variant(t: DType) -> bool:
    return t.variant_types is not None


def is_decimal(t: DType) -> bool:
    return t.decimal_scale is not None and t.name.startswith("Decimal")


def is_datetime64(t: DType) -> bool:
    return t.name.startswith("DateTime64")


def is_enum(t: DType) -> bool:
    return t.enum_values is not None


def enum_name_to_value(t: DType, name: str) -> int:
    for k, v in t.enum_values:
        if k == name:
            return v
    raise ValueError(f"Unknown element '{name}' of {t.name}")


def is_interval(t: DType) -> bool:
    return t.name.startswith("Interval")


def is_datetime_like(t: DType) -> bool:
    return t.name in ("Date", "DateTime")
_BY_NAME["Float"] = Float64
_BY_NAME["Int"] = Int64
_BY_NAME["Boolean"] = Boolean


def Nullable(inner: DType) -> DType:
    return inner.with_nullable(True)


def make_nullable(t: DType) -> DType:
    return t.with_nullable(True)


def remove_nullable(t: DType) -> DType:
    return t.with_nullable(False)


def Array(inner: DType) -> DType:
    if inner.is_array:
        raise ValueError("Nested arrays are not supported yet")
    return DType(f"Array({inner})", inner.storage_dtype,
                 is_dictionary=inner.is_dictionary, is_array=True)


def array_inner(t: DType) -> DType:
    assert t.is_array
    return parse_type_name(t.name[len("Array("):-1])


def _strip_call(name: str, *heads: str):
    """If name is Head(args) for one of heads (case-insensitive), return the
    inner args text, else None."""
    for h in heads:
        if name[:len(h)].lower() == h.lower() and len(name) > len(h) \
                and name[len(h)] == "(" and name.endswith(")"):
            return name[len(h) + 1:-1]
    return None


def _parse_enum_body(body: str):
    """'a' = 1, 'b' = 2  ->  (("a", 1), ("b", 2)); values optional."""
    out = []
    i, n = 0, len(body)
    nxt = 1          # reference auto-assign starts at 1 (DataTypeEnum.cpp:207)
    while i < n:
        while i < n and body[i] in " ,":
            i += 1
        if i >= n:
            break
        if body[i] != "'":
            raise ValueError(f"Bad Enum element at {body[i:]!r}")
        j = i + 1
        buf = []
        while j < n:
            if body[j] == "\\" and j + 1 < n:
                buf.append(body[j + 1])
                j += 2
            elif body[j] == "'":
                break
            else:
                buf.append(body[j])
                j += 1
        name = "".join(buf)
        i = j + 1
        while i < n and body[i] == " ":
            i += 1
        if i < n and body[i] == "=":
            i += 1
            j = i
            while j < n and body[j] not in ",":
                j += 1
            val = int(body[i:j].strip())
            i = j
        else:
            val = nxt
        nxt = val + 1
        out.append((name, val))
    return tuple(out)


def _split_args(text: str):
    """Split 'a, b(c, d), e' on top-level commas."""
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return parts


def parse_type_name(name: str) -> DType:
    """Parse ``Int64``, ``Nullable(Float64)``, ``Decimal(18, 4)``,
    ``Enum8('a' = 1)``, ``FixedString(16)``, ``LowCardinality(String)``."""
    name = name.strip()
    for head in ("Nullable",):
        inner = _strip_call(name, head)
        if inner is not None:
            return make_nullable(parse_type_name(inner))
    inner = _strip_call(name, "LowCardinality")
    if inner is not None:
        # Dictionary encoding is our default physical layout already.
        return parse_type_name(inner)
    if name == "JSON" or name.startswith("JSON("):
        return JSON        # path type hints parse but shredding discovers
    inner = _strip_call(name, "Variant")
    if inner is not None:
        ts = tuple(t.strip() for t in _split_args(inner))
        return Variant(ts)
    if name == "Dynamic" or name.startswith("Dynamic("):
        return Variant(())
    inner = _strip_call(name, "Object")
    if inner is not None:          # legacy Object('json') spelling
        return JSON
    inner = _strip_call(name, "Array")
    if inner is not None:
        return Array(parse_type_name(inner))
    inner = _strip_call(name, "Tuple")
    if inner is not None:
        # named tuples — Tuple(a UInt64, s String) — keep "name Type"
        # member spellings; tuple_inner/tuple_member_names split them
        # (ref: src/DataTypes/DataTypeTuple.cpp named elements)
        parts = _split_args(inner)
        members = []
        for p in parts:
            nm, tp = _split_named_member(p)
            members.append(f"{nm} {parse_type_name(tp).name}" if nm
                           else parse_type_name(tp).name)
        return DType(f"Tuple({', '.join(members)})", "int8",
                     tuple_types=tuple(members))
    inner = _strip_call(name, "Nested")
    if inner is not None:
        # Nested(x UInt32, y String): a column-level macro for parallel
        # arrays n.x Array(UInt32), n.y Array(String) — CREATE expands it
        # (ref: src/DataTypes/DataTypeNested.cpp); the marker type itself
        # carries the member list
        parts = _split_args(inner)
        members = []
        for p in parts:
            nm, tp = _split_named_member(p)
            if not nm:
                raise ValueError(f"Nested members need names: {name!r}")
            members.append(f"{nm} {parse_type_name(tp).name}")
        return DType(f"Nested({', '.join(members)})", "int8",
                     tuple_types=tuple(members))
    inner = _strip_call(name, "SimpleAggregateFunction")
    if inner is not None:
        # storage is the plain value type; the function applies at merge
        # (ref: src/DataTypes/DataTypeCustomSimpleAggregateFunction.cpp)
        parts = _split_args(inner)
        if len(parts) < 2:
            raise ValueError(f"SimpleAggregateFunction needs a value "
                             f"type: {name!r}")
        return parse_type_name(parts[1])
    inner = _strip_call(name, "Map")
    if inner is not None:
        parts = _split_args(inner)
        if len(parts) != 2:
            raise ValueError(f"Map expects two type arguments: {name!r}")
        return Map(parse_type_name(parts[0]), parse_type_name(parts[1]))
    inner = _strip_call(name, "AggregateFunction")
    if inner is not None:
        parts = _split_args(inner)
        head = parts[0].strip()
        params: tuple = ()
        if "(" in head and head.endswith(")"):
            fn_name, ptxt = head[:-1].split("(", 1)
            params = tuple(
                p.strip().strip("'") for p in ptxt.split(",") if p.strip())
        else:
            fn_name = head
        return AggregateState(fn_name,
                              [parse_type_name(p) for p in parts[1:]],
                              params)
    inner = _strip_call(name, "Decimal", "Dec", "Numeric", "Fixed")
    if inner is not None:
        parts = [x.strip() for x in inner.split(",")]
        p = int(parts[0])
        s = int(parts[1]) if len(parts) > 1 else 0
        return Decimal(p, s)
    for head, prec in (("Decimal32", 9), ("Decimal64", 18),
                       ("Decimal128", 38), ("Decimal256", 76)):
        inner = _strip_call(name, head)
        if inner is not None:
            return Decimal(prec, int(inner.strip()))
    inner = _strip_call(name, "DateTime64")
    if inner is not None:
        scale = inner.split(",")[0].strip()   # ignore timezone argument
        return DateTime64(int(scale))
    inner = _strip_call(name, "DateTime")
    if inner is not None:
        return DateTime                       # DateTime('tz'): tz ignored
    inner = _strip_call(name, "FixedString")
    if inner is not None:
        return FixedString(int(inner.strip()))
    inner = _strip_call(name, "Enum8")
    if inner is not None:
        return Enum8(_parse_enum_body(inner))
    inner = _strip_call(name, "Enum16", "Enum")
    if inner is not None:
        return Enum16(_parse_enum_body(inner))
    if name in _BY_NAME:
        return _BY_NAME[name]
    lowered = {k.lower(): v for k, v in _BY_NAME.items()}
    if name.lower() in lowered:
        return lowered[name.lower()]
    if name.lower() in ("decimal", "dec", "numeric"):
        return Decimal(10, 0)       # bare DECIMAL defaults to (10, 0)
    if name == "DateTime64":
        return DateTime64(3)        # bare spelling: default scale
    if name.lower() in ("integer", "int signed", "integer signed"):
        return _BY_NAME["Int32"]
    if name == "BFloat16":
        return DType("BFloat16", "float32")
    if name == "Point":             # geo: Tuple(Float64, Float64)
        return Tuple([_BY_NAME["Float64"], _BY_NAME["Float64"]])
    if name == "Ring":
        return Array(parse_type_name("Point"))
    raise ValueError(f"Unknown data type: {name!r}")


def is_numeric(t: DType) -> bool:
    return not t.is_dictionary and not t.is_array \
        and t.name not in ("Nothing",)


def is_integer(t: DType) -> bool:
    """Semantically integer (not merely integer-backed: Date/DateTime/
    Decimal/Enum/Interval store ints but are not Int types)."""
    return t.np_dtype.kind in ("i", "u") and not t.is_dictionary \
        and t.decimal_scale is None and t.enum_values is None \
        and not is_datetime_like(t) and not t.name.startswith("Interval") \
        and not is_datetime64(t)


def is_float(t: DType) -> bool:
    return t.np_dtype.kind == "f"


def is_string(t: DType) -> bool:
    return t.is_dictionary


# Numeric promotion lattice (reference: src/DataTypes/getLeastSupertype.cpp,
# simplified to the width/sign rules that matter for arithmetic).
NUMERIC_ORDER = [
    UInt8, Int8, UInt16, Int16, UInt32, Int32, UInt64, Int64, Float32, Float64,
]


def common_supertype(a: DType, b: DType) -> DType:
    """Least common supertype for binary operations.

    Mirrors getLeastSupertype's behaviour for the numeric lattice; strings
    only unify with strings.
    """
    nullable = a.nullable or b.nullable
    a0, b0 = remove_nullable(a), remove_nullable(b)
    if a0 == b0:
        out = a0
    elif is_decimal(a0) or is_decimal(b0):
        if is_float(a0) or is_float(b0):
            out = Float64            # Decimal op Float -> Float64
        elif is_decimal(a0) and is_decimal(b0):
            out = Decimal(max(a0.decimal_prec, b0.decimal_prec),
                          max(a0.decimal_scale, b0.decimal_scale))
        elif is_integer(a0) or is_integer(b0):
            d = a0 if is_decimal(a0) else b0
            out = Decimal(max(d.decimal_prec, 18), d.decimal_scale)
        else:
            raise TypeError(f"No common supertype of {a0} and {b0}")
    elif is_enum(a0) or is_enum(b0):
        e = a0 if is_enum(a0) else b0
        o = b0 if is_enum(a0) else a0
        if is_string(o) or is_enum(o):
            out = e
        else:
            raise TypeError(f"No common supertype of {a0} and {b0}")
    elif is_string(a0) or is_string(b0):
        if is_string(a0) and is_string(b0):
            out = String
        else:
            raise TypeError(f"No common supertype of {a0} and {b0}")
    elif is_float(a0) or is_float(b0):
        out = Float64 if Float64 in (a0, b0) else Float32
        if (is_integer(a0) and a0.itemsize >= 4) or (is_integer(b0) and b0.itemsize >= 4):
            out = Float64
    else:
        # integer/integer: numpy's promote, mapped back to our registry
        np_out = np.promote_types(a0.np_dtype, b0.np_dtype)
        out = from_numpy_dtype(np_out)
    return make_nullable(out) if nullable else out


def from_numpy_dtype(dt: Any) -> DType:
    dt = np.dtype(dt)
    for t in NUMERIC_ORDER:
        if t.np_dtype == dt:
            return t
    if dt.kind == "b":
        return Boolean
    if dt.kind in ("U", "S", "O"):
        return String
    if dt == np.dtype("float64"):
        return Float64
    raise TypeError(f"No engine dtype for numpy dtype {dt}")
