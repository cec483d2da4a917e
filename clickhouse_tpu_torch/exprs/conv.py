"""CAST machine (reference: clickhouse_tpu/exprs/conv.py).

One `_cast` scalar function covers the ported (source, target) pairs:
numeric <-> numeric and Bool, Date/DateTime from numbers and between each
other, String <-> numbers (host dictionary lookup tables; numbers become
strings on the host, since execution is eager).  Decimal, DateTime64,
Enum, FixedString, UUID and IP targets raise ``NotImplementedError_``.
"""
from __future__ import annotations

import datetime

import numpy as np
import torch

from ..core import dtypes as dt
from ..core import typed
from ..core.column import Dictionary
from ..core.errors import NotImplementedError_, TypeError_
from .expr import ColVal, storage_np
from .functions import _and_validity, register

__all__ = ["cast_exec", "literal_typed_target"]


def _dict_lut(a: ColVal, host_fn, out_np_dtype):
    """LUT over the argument's dictionary values (host work)."""
    vals = a.dictionary.values if a.dictionary else np.asarray([], object)
    lut_np = np.asarray([host_fn(str(v)) for v in vals] or [host_fn("")],
                        dtype=out_np_dtype)
    lut = dt.tensor_from_numpy(lut_np, a.data.device)
    return lut[a.data.clamp(min=0).long()]


def _date_parse(s: str) -> int:
    try:
        return typed._parse_date(s.rstrip('\x00'))
    except (ValueError, TypeError):
        return 0


def _datetime_parse(s: str) -> int:
    try:
        return typed._parse_datetime(s.rstrip('\x00'))
    except (ValueError, TypeError):
        return 0


def cast_exec(args, out_dtype: dt.DType) -> ColVal:
    a = args[0]
    src = dt.remove_nullable(a.dtype)
    dst = dt.remove_nullable(out_dtype)
    v = _and_validity(args)
    if src == dst:
        return ColVal(out_dtype, a.data, v, a.dictionary)
    for t in (src, dst):
        if dt.is_decimal(t) or dt.is_datetime64(t) or dt.is_enum(t) \
                or t.fixed_len is not None or t.is_array \
                or dt.is_composite(t) \
                or t.name in ("UUID", "IPv4", "IPv6"):
            raise NotImplementedError_(
                f"CAST from {src} to {dst} is not ported to the CUDA "
                f"engine yet")

    if dst.name == "Date":
        if src.is_dictionary:
            data = _dict_lut(a, _date_parse, np.int32)
        elif src.name == "DateTime":
            data = torch.div(a.data.to(torch.int64), 86400,
                             rounding_mode="floor").to(torch.int32)
        else:
            data = dt.cast_tensor(a.data, storage_np(a), np.int32)
        return ColVal(out_dtype, data, v)
    if dst.name == "DateTime":
        if src.is_dictionary:
            data = _dict_lut(a, _datetime_parse, np.int64)
        elif src.name == "Date":
            data = a.data.to(torch.int64) * 86400
        else:
            data = dt.cast_tensor(a.data, storage_np(a), np.int64)
        return ColVal(out_dtype, data, v)

    if dst.is_dictionary:
        if src.is_dictionary:
            return ColVal(out_dtype, a.data, v, a.dictionary)
        return _materialize_strings(src, a, v, out_dtype)

    if dst.name == "Bool":
        data = dt.cast_tensor(a.data, storage_np(a), np.float64) != 0 \
            if not src.is_dictionary else _dict_lut(
                a, lambda s: _parse_number(s, np.dtype("float64")),
                np.float64) != 0
        return ColVal(out_dtype, data.to(torch.uint8), v)
    if dt.is_numeric(dst):
        if src.is_dictionary:
            data = _dict_lut(a, lambda s: _parse_number(s, dst.np_dtype),
                             dst.np_dtype)
            return ColVal(out_dtype, data, v)
        return ColVal(out_dtype,
                      dt.cast_tensor(a.data, storage_np(a), dst.np_dtype), v)
    raise NotImplementedError_(f"CAST from {src} to {dst} not supported")


def _parse_number(s: str, target: np.dtype):
    try:
        f = float(s.strip().rstrip('\x00') or 0)
    except ValueError:
        f = 0.0
    return f if target.kind == "f" else int(f)


def _materialize_strings(src: dt.DType, a: ColVal, v, out_dtype) -> ColVal:
    """Numbers -> sorted dictionary + codes, stringified on the host."""
    vals = dt.to_numpy_storage(a.data, src.np_dtype)
    if vals.ndim == 0:
        text = _const_to_text(src, vals.item())
        return ColVal(out_dtype, torch.zeros((), dtype=torch.int32,
                                             device=a.data.device), v,
                      Dictionary(np.asarray([text], object)))
    texts = np.asarray([_const_to_text(src, x) for x in vals.tolist()],
                       object)
    uniq, codes = np.unique(texts.astype(str), return_inverse=True)
    return ColVal(out_dtype, torch.from_numpy(codes.astype(np.int32))
                  .to(a.data.device), v,
                  Dictionary(uniq.astype(object), sorted_=True))


def _const_to_text(src: dt.DType, raw) -> str:
    if src.name == "Date":
        return (datetime.date(1970, 1, 1)
                + datetime.timedelta(days=int(raw))).isoformat()
    if src.name == "DateTime":
        return (datetime.datetime(1970, 1, 1)
                + datetime.timedelta(seconds=int(raw))) \
            .strftime("%Y-%m-%d %H:%M:%S")
    x = np.asarray(raw).item()
    if isinstance(x, float):
        if x != x:
            return "nan"
        if x == float("inf"):
            return "inf"
        if x == float("-inf"):
            return "-inf"
        return repr(x) if x != int(x) else str(int(x))
    return str(x)


def _resolve_cast(ts):
    raise TypeError_("_cast result type is set by the analyzer")


register("_cast", _resolve_cast, cast_exec)


def literal_typed_target(name: str, arg_types, literals):
    """Result dtype for literal-parameterized constructors, or None
    (toDecimalNN(x, S), toDateTime64(x, S), toFixedString(s, N))."""
    lname = name.lower()
    for suf in ("orzero", "ornull"):
        if lname.endswith(suf) and lname[:-len(suf)] in (
                "todecimal32", "todecimal64", "todecimal128",
                "todecimal256", "todatetime64"):
            lname = lname[:-len(suf)]
            break
    if lname in ("todecimal32", "todecimal64", "todecimal128",
                 "todecimal256"):
        prec = {"todecimal32": 9, "todecimal64": 18, "todecimal128": 38,
                "todecimal256": 76}[lname]
        s = int(literals[1]) if len(literals) > 1 and literals[1] is not None \
            else 0
        return dt.Decimal(prec, s)
    if lname == "todatetime64":
        s = int(literals[1]) if len(literals) > 1 and literals[1] is not None \
            else 3
        return dt.DateTime64(s)
    if lname == "tofixedstring":
        if len(literals) < 2 or literals[1] is None:
            raise TypeError_("toFixedString requires a constant length")
        return dt.FixedString(int(literals[1]))
    return None


def _conv_to(target: dt.DType):
    def resolve(ts):
        return target.with_nullable(ts[0].nullable)

    def ex(args, out_dtype):
        return cast_exec(args[:1], out_dtype)
    return resolve, ex


for _name, _t in [("toDate", dt.Date), ("toDate32", dt.Date),
                  ("toDateTime", dt.DateTime)]:
    _res, _ex = _conv_to(_t)
    register(_name, _res, _ex)
