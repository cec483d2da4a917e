"""Scalar function registry (reference: clickhouse_tpu/exprs/functions.py).

Ported families: comparison, arithmetic (with Date/DateTime +/- an
interval), the bit operations, logic, conditional / NULL handling, math,
dates and times, casts, the dictionary strings (length, lower, LIKE,
startsWith, substring, concat, ...), the array() constructor over
numbers, and (functions_ext.py, functions_ext5.py) the math, bit and date
extras, the relative date numbers and the vector distances and norms.
Numbers run as plain elementwise torch on the block's tensors; every
calendar function is one op of K12 (ops/calendar_ops.calendar_part) over
the argument's storage; string functions compute a lookup table a
dictionary value (host numpy, or K10 on the device for a prefix or
suffix) that the rows gather by code.  A function that is not ported
surfaces as the reference's typed ``UnknownFunction`` when the analyzer
resolves it; a ported function meeting a type it does not handle yet
(Decimal arithmetic, DateTime64, Enum) raises ``NotImplementedError_``.

Values follow the unsigned rule of core/dtypes.py: a ColVal's tensor holds
its DType's storage values, with u16 in int32 and u32/u64 in int64, so
arithmetic and comparisons go through ``dt.cast_tensor`` on the logical
numpy types (numpy's promotion rules, as the reference's jnp ops).
"""
from __future__ import annotations

import math
import re
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import dtypes as dt
from ..core.column import Dictionary
from ..core.errors import NotImplementedError_, TypeError_, UnknownFunction
from ..ops import calendar_ops, scan_ops
from .expr import (ColVal, GatheredColVal, StoredColVal, TermColVal,
                   storage_np)

__all__ = ["get", "exists", "register", "ScalarFunction", "FUNCTIONS",
           "canonical_name"]

FUNCTIONS: Dict[str, "ScalarFunction"] = {}
_CASE_INSENSITIVE: Dict[str, str] = {}
_SIGN = -(1 << 63)                 # int64 bits of 1 << 63


class ScalarFunction:
    """A scalar function; with device_bytes, its execute also takes
    max_bytes, the device bytes it may build beside the query's working
    set (the budget the governor's estimate leaves; None: no limit)."""

    def __init__(self, name: str, resolve: Callable, execute: Callable,
                 case_insensitive: bool = False, device_bytes: bool = False):
        self.name = name
        self._resolve = resolve
        self._execute = execute
        self.case_insensitive = case_insensitive
        self.device_bytes = device_bytes

    def resolve(self, arg_types: List[dt.DType]) -> dt.DType:
        return self._resolve(arg_types)

    def execute(self, args: List[ColVal], out_dtype: dt.DType,
                max_bytes: Optional[int] = None) -> ColVal:
        if self.device_bytes:
            return self._execute(args, out_dtype, max_bytes)
        return self._execute(args, out_dtype)


def register(name: str, resolve, execute, case_insensitive=False,
             device_bytes=False):
    fn = ScalarFunction(name, resolve, execute, case_insensitive,
                        device_bytes)
    FUNCTIONS[name] = fn
    if case_insensitive:
        _CASE_INSENSITIVE[name.lower()] = name
    return fn


def canonical_name(name: str) -> str:
    if name in FUNCTIONS:
        return name
    lower = name.lower()
    if lower in _CASE_INSENSITIVE:
        return _CASE_INSENSITIVE[lower]
    raise UnknownFunction(f"Unknown function '{name}'")


def get(name: str) -> ScalarFunction:
    return FUNCTIONS[canonical_name(name)]


def exists(name: str) -> bool:
    try:
        canonical_name(name)
        return True
    except UnknownFunction:
        return False


# -- helpers -----------------------------------------------------------------

def _and_validity(args: Sequence[ColVal]):
    v = None
    for a in args:
        if a.validity is not None:
            av = a.validity.to(torch.bool)
            v = av if v is None else (v & av)
    return v


def _numeric_data(a: ColVal):
    if a.dtype.is_dictionary:
        raise TypeError_("Expected a numeric argument, got String")
    return a.data


def _as(a: ColVal, target) -> torch.Tensor:
    """The argument's values as logical numpy type `target`."""
    return dt.cast_tensor(_numeric_data(a), storage_np(a), target)


def _no_decimal_or_dates(name, *ts):
    for t in ts:
        t0 = dt.remove_nullable(t)
        if dt.is_decimal(t0) or dt.is_datetime64(t0) or dt.is_enum(t0) \
                or dt.is_interval(t0):
            raise NotImplementedError_(
                f"{name} over {t0} is not ported to the CUDA engine yet")


def _signed(t: dt.DType) -> dt.DType:
    if t.np_dtype.kind == "u":
        mapping = {1: dt.Int16, 2: dt.Int32, 4: dt.Int64, 8: dt.Int64}
        return mapping[t.itemsize].with_nullable(t.nullable)
    return t


def _check_numeric(ts, name):
    for t in ts:
        if t.is_dictionary:
            raise TypeError_(f"Function '{name}' expects numeric arguments")


def _resolve_arith(promote=None):
    def r(ts):
        _check_numeric(ts, "arithmetic")
        out = ts[0]
        for t in ts[1:]:
            out = dt.common_supertype(out, t)
        if promote:
            out = promote(out)
        return out
    return r


def _resolve_float(ts):
    _check_numeric(ts, "math")
    return dt.Float64.with_nullable(any(t.nullable for t in ts))


def _binary_numeric(op, name):
    def ex(args, out_dtype):
        _no_decimal_or_dates(name, *(a.dtype for a in args))
        target = dt.remove_nullable(out_dtype).np_dtype
        a, b = args
        data = op(_as(a, target), _as(b, target))
        return ColVal(out_dtype, dt.cast_tensor(data, target, target),
                      _and_validity(args))
    return ex


# -- arithmetic --------------------------------------------------------------

_INT_BY_SIGN_SIZE = {
    (False, 1): dt.UInt8, (False, 2): dt.UInt16,
    (False, 4): dt.UInt32, (False, 8): dt.UInt64,
    (True, 1): dt.Int8, (True, 2): dt.Int16,
    (True, 4): dt.Int32, (True, 8): dt.Int64,
}


def _resolve_plusminus(ts):
    a, b = ts
    a0, b0 = dt.remove_nullable(a), dt.remove_nullable(b)
    nullable = a.nullable or b.nullable
    for x, y in ((a0, b0), (b0, a0)):
        if dt.is_datetime_like(x) and (dt.is_interval(y) or dt.is_integer(y)):
            return x.with_nullable(nullable)
    if dt.is_datetime_like(a0) and dt.is_datetime_like(b0):
        return dt.Int32.with_nullable(nullable)
    return None


def _resolve_addsubmul(signed_force=False):
    """Integer +/-/* widen to the next size (UInt8+UInt8 -> UInt16,
    Int32*Int32 -> Int64, capped at 64 bits); subtraction is signed."""
    base = _resolve_arith(_signed if signed_force else None)

    def r(ts):
        if len(ts) == 2:
            a0, b0 = (dt.remove_nullable(t) for t in ts)
            if dt.is_integer(a0) and dt.is_integer(b0):
                signed = signed_force or a0.np_dtype.kind == "i" \
                    or b0.np_dtype.kind == "i"
                size = min(8, 2 * max(a0.itemsize, b0.itemsize))
                out = _INT_BY_SIGN_SIZE[(signed, size)]
                return out.with_nullable(any(t.nullable for t in ts))
        return base(ts)
    return r


def _resolve_arith_dates(signed_force=False):
    base = _resolve_addsubmul(signed_force)

    def r(ts):
        special = _resolve_plusminus(ts) if len(ts) == 2 else None
        if special is not None:
            return special
        return base(ts)
    return r


def _resolve_multiply(ts):
    a0, b0 = (dt.remove_nullable(t) for t in ts)
    nullable = any(t.nullable for t in ts)
    if dt.is_decimal(a0) and dt.is_decimal(b0):
        return dt.Decimal(min(a0.decimal_prec + b0.decimal_prec, 76),
                          a0.decimal_scale + b0.decimal_scale) \
            .with_nullable(nullable)
    return _resolve_addsubmul()(ts)


def _plus_exec(args, out_dtype):
    a0, b0 = (dt.remove_nullable(a.dtype) for a in args)
    if (dt.is_datetime_like(a0) and (dt.is_interval(b0) or dt.is_integer(b0))) \
            or (dt.is_datetime_like(b0)
                and (dt.is_interval(a0) or dt.is_integer(a0))):
        return _datetime_arith(1)(args, out_dtype)
    return _binary_numeric(torch.add, "plus")(args, out_dtype)


def _minus_exec(args, out_dtype):
    a, b = args
    a0, b0 = dt.remove_nullable(a.dtype), dt.remove_nullable(b.dtype)
    if dt.is_datetime_like(a0) and dt.is_datetime_like(b0):
        if a0.name != b0.name:
            # the reference subtracts a day number from seconds
            raise TypeError_(f"Illegal types {a0} and {b0} of arguments of "
                             f"function minus")
        diff = _as(a, np.int64) - _as(b, np.int64)
        return ColVal(out_dtype, dt.cast_tensor(
            diff, np.int64, dt.remove_nullable(out_dtype).np_dtype),
            _and_validity(args))
    if dt.is_datetime_like(a0) and (dt.is_interval(b0) or dt.is_integer(b0)):
        return _datetime_arith(-1)(args, out_dtype)
    return _binary_numeric(torch.sub, "minus")(args, out_dtype)


_MONTHS_A_UNIT = {"Month": 1, "Quarter": 3, "Year": 12}
_SUBSECOND = {"Nanosecond": 10**9, "Microsecond": 10**6, "Millisecond": 10**3}
_SECONDS_A_UNIT = {"Second": 1, "Minute": 60, "Hour": 3600, "Day": 86400,
                   "Week": 7 * 86400}


def _datetime_arith(sign: int):
    """Date/DateTime +/- an interval (or an integer: days of a Date,
    seconds of a DateTime).  Month, quarter and year steps clamp the day
    to the target month's length on K12 (a constant step only)."""
    def ex(args, out_dtype):
        a, b = args
        date_cv, iv_cv = (a, b) if dt.is_datetime_like(
            dt.remove_nullable(a.dtype)) else (b, a)
        d0 = dt.remove_nullable(date_cv.dtype)
        iv0 = dt.remove_nullable(iv_cv.dtype)
        unit = iv0.name[len("Interval"):] if dt.is_interval(iv0) \
            else ("Day" if d0.name == "Date" else "Second")
        is_date = d0.name == "Date"
        if is_date and unit not in ("Day", "Week") \
                and unit not in _MONTHS_A_UNIT:
            # ClickHouse makes a DateTime of it; the reference adds 0 or
            # n // 10^k days to the Date
            raise NotImplementedError_(
                f"Date {'+' if sign > 0 else '-'} Interval{unit} is not "
                f"ported to the CUDA engine yet")
        out_np = dt.remove_nullable(out_dtype).np_dtype
        if unit in _MONTHS_A_UNIT:
            if not iv_cv.is_const:
                raise NotImplementedError_(
                    f"a non-constant Interval{unit} is not ported to the "
                    f"CUDA engine yet")
            months = _const_int(iv_cv, np.int64) * sign \
                * _MONTHS_A_UNIT[unit]
            data = calendar_ops.calendar_part(
                _calendar_storage(date_cv), "add_months", not is_date,
                out_np, c0=months)
        else:
            n = _as(iv_cv, np.int64) * sign
            base = _as(date_cv, np.int64)
            if unit in _SUBSECOND:
                data = base + torch.div(n, _SUBSECOND[unit],
                                        rounding_mode="floor")
            else:
                step = _SECONDS_A_UNIT[unit] // (86400 if is_date else 1)
                data = base + n * step
            data = dt.cast_tensor(data, np.int64, out_np)
        return ColVal(out_dtype, data, _and_validity(args))
    return ex


register("plus", _resolve_arith_dates(), _plus_exec)
register("minus", _resolve_arith_dates(signed_force=True), _minus_exec)
register("multiply", _resolve_multiply,
         _binary_numeric(torch.mul, "multiply"))


def _div_exec(args, out_dtype):
    _no_decimal_or_dates("divide", *(a.dtype for a in args))
    a, b = args
    data = _as(a, np.float64) / _as(b, np.float64)
    return ColVal(out_dtype, data.to(dt.remove_nullable(out_dtype)
                                     .torch_dtype), _and_validity(args))


def _resolve_divide(ts):
    a0, b0 = (dt.remove_nullable(t) for t in ts)
    nullable = any(t.nullable for t in ts)
    if (dt.is_decimal(a0) or dt.is_decimal(b0)) \
            and not (dt.is_float(a0) or dt.is_float(b0)):
        sa = a0.decimal_scale if dt.is_decimal(a0) else 0
        prec = a0.decimal_prec if dt.is_decimal(a0) else 18
        return dt.Decimal(prec, sa).with_nullable(nullable)
    return _resolve_float(ts)


register("divide", _resolve_divide, _div_exec)


def _host_number(b: ColVal):
    """A literal's Python number, else None (then the value is on the
    device, and reading it waits for the device)."""
    h = b.host
    return h if isinstance(h, (int, float, np.number)) else None


def _const_nonzero(b: ColVal) -> bool:
    """True when the divisor is a nonzero constant (`x % 1024`)."""
    if not b.is_const:
        return False
    h = _host_number(b)
    return float(b.data.item() if h is None else h) != 0.0


def _const_int(b: ColVal, st) -> int:
    """A constant divisor's value in the signed computation type `st`."""
    h = _host_number(b)
    if isinstance(h, (int, np.integer)):
        return int(h)
    return int(_as(b, st).item())


def _udivmod64(x, y):
    """Unsigned 64-bit quotient/remainder of int64 bit patterns, y != 0."""
    big = y < 0                                    # divisor >= 2^63
    ys = torch.where(big, torch.ones_like(y), y)
    half = (x >> 1) & ((1 << 63) - 1)              # logical shift
    q = torch.div(half, ys, rounding_mode="trunc") << 1
    r = x - q * ys
    fix = (r ^ _SIGN) >= (ys ^ _SIGN)              # r >= y, unsigned
    q = torch.where(fix, q + 1, q)
    r = torch.where(fix, r - ys, r)
    ge = (x ^ _SIGN) >= (y ^ _SIGN)
    q = torch.where(big, ge.to(x.dtype), q)
    r = torch.where(big, torch.where(ge, x - y, x), r)
    return q, r


def _div_rem(x, y, unsigned64: bool):
    """Truncating quotient and remainder (C semantics, as lax.div/lax.rem)
    of integer tensors; y must be nonzero."""
    if unsigned64:
        return _udivmod64(x, y)
    neg1 = y == -1                  # MIN / -1 must wrap, not trap
    ys = torch.where(neg1, torch.ones_like(y), y)
    q = torch.div(x, ys, rounding_mode="trunc")
    r = torch.fmod(x, ys)
    return torch.where(neg1, -x, q), torch.where(neg1, torch.zeros_like(r), r)


def _div_rem_const(x, b: ColVal, st, which: int):
    """The quotient (which 0) or the remainder (1) of _div_rem by the
    nonzero constant b, built alone: one result a row, no divisor column;
    a UInt64 by a power of two a shift or a mask (cityHash64(x) % 16)."""
    if st == np.uint64:
        c = _const_int(b, st) & ((1 << 64) - 1)
        if c & (c - 1) == 0:
            k = c.bit_length() - 1
            return ((x >> k) & ((1 << (64 - k)) - 1) if k else x) \
                if which == 0 else x & (c - 1)
        return _udivmod64(x, _as(b, st))[which]
    c = _const_int(b, st)
    if c == -1:                     # MIN / -1 wraps, as in _div_rem
        return -x if which == 0 else torch.zeros_like(x)
    return torch.div(x, c, rounding_mode="trunc") if which == 0 \
        else torch.fmod(x, c)


_NARROW_INTS = (torch.int8, torch.int16, torch.int32)


def _narrow_div_rem(a: ColVal, b: ColVal, st, which: int):
    """_div_rem_const over a scanned column's narrow storage, as a
    scan_ops.Term, or None.

    For a column stored in a signed integer type narrower than the
    computation type `st` (signed) and an integer constant c that fits the
    storage type, c not in {0, -1}: truncating division in the storage type
    cannot overflow (only MIN / -1 does), so it equals the wide result.
    The result is the term itself: K6 forms it in registers from the
    gathered storage (4 bytes a row for int32 storage); any other reader
    builds it, dividing the storage and widening only the result, where
    the wide path reads the widened column (cached on the StoredColVal).
    """
    if not isinstance(a, StoredColVal) or np.dtype(st).kind != "i" \
            or storage_np(b).kind not in "iu":
        return None
    s = a.storage
    wide = dt.torch_dtype_of(np.dtype(st))
    if s.dtype not in _NARROW_INTS or s.element_size() >= wide.itemsize:
        return None
    c = _const_int(b, st)
    info = torch.iinfo(s.dtype)
    if c in (0, -1) or not info.min <= c <= info.max:
        return None
    return scan_ops.Term(s, "div" if which == 0 else "mod", c, wide)


def _intdiv_like(which: int, name: str):
    def ex(args, out_dtype):
        _no_decimal_or_dates(name, *(a.dtype for a in args))
        a, b = args
        st = dt.remove_nullable(out_dtype).np_dtype
        if _const_nonzero(b):
            dtype = dt.remove_nullable(out_dtype).with_nullable(
                a.dtype.nullable)
            term = _narrow_div_rem(a, b, st, which)
            if term is not None:
                return TermColVal(dtype, term, _and_validity(args))
            out = _div_rem_const(_as(a, st), b, st, which)
            return ColVal(dtype, out, _and_validity(args))
        x, y = _as(a, st), _as(b, st)
        if x.dim() < y.dim():
            x = x.expand(y.shape)
        uns = st == np.uint64
        y = y.expand(x.shape) if y.dim() < x.dim() else y
        zero = y == 0
        safe = torch.where(zero, torch.ones_like(y), y)
        out = _div_rem(x, safe, uns)[which]
        data = torch.where(zero, torch.zeros_like(out), out)
        v = _and_validity(args)
        v = (v & ~zero) if v is not None else ~zero
        return ColVal(out_dtype.with_nullable(True), data, v)
    return ex


def _resolve_intdiv(ts):
    _check_numeric(ts, "intDiv")
    out = ts[0]
    for t in ts[1:]:
        out = dt.common_supertype(out, t)
    if dt.is_float(dt.remove_nullable(out)):
        out = dt.Int64.with_nullable(out.nullable)
    return out.with_nullable(True)


def _or_zero(base_exec):
    """xOrZero variants: zero result (and valid) where the divisor is 0."""
    def ex(args, out_dtype):
        out = base_exec(args, out_dtype)
        if _const_nonzero(args[1]):
            data = out.data
        else:
            zero = args[1].data == 0
            data = torch.where(zero, torch.zeros_like(out.data), out.data)
        return ColVal(dt.remove_nullable(out.dtype).with_nullable(
            any(a.dtype.nullable for a in args)), data, _and_validity(args))
    return ex


def _intdiv_orzero_exec(args, out_dtype):
    out = _or_zero(_intdiv_like(0, "intDivOrZero"))(args, out_dtype)
    st = dt.remove_nullable(out_dtype).np_dtype
    b = args[1]
    if st.kind != "i" or (b.is_const and _const_int(b, st) != -1):
        return out
    # signed MIN / -1 overflows: the reference returns 0
    ovf = (_as(args[0], st) == np.iinfo(st).min) & (_as(b, st) == -1)
    return ColVal(out.dtype, torch.where(
        ovf, torch.zeros((), dtype=out.data.dtype, device=out.data.device),
        out.data), out.validity)


register("intDiv", _resolve_intdiv, _intdiv_like(0, "intDiv"))
register("intDivOrZero", _resolve_intdiv, _intdiv_orzero_exec)
# modulo truncates (sign of the dividend), as the reference's lax.rem
register("modulo", _resolve_intdiv, _intdiv_like(1, "modulo"))
register("moduloOrZero", _resolve_intdiv,
         _or_zero(_intdiv_like(1, "moduloOrZero")))


def _negate_exec(args, out_dtype):
    _no_decimal_or_dates("negate", args[0].dtype)
    st = dt.remove_nullable(out_dtype).np_dtype
    return ColVal(out_dtype, -_as(args[0], st), _and_validity(args))


register("negate", lambda ts: _signed(_resolve_arith()(ts)), _negate_exec)


def _abs_exec(args, out_dtype):
    _no_decimal_or_dates("abs", args[0].dtype)
    st = dt.remove_nullable(out_dtype).np_dtype
    x = _as(args[0], st)
    data = x if st.kind == "u" else torch.abs(x)
    return ColVal(out_dtype, data, _and_validity(args))


register("abs", _resolve_arith(), _abs_exec, case_insensitive=True)


# -- bit operations ----------------------------------------------------------
# On the integer image of the arguments: a float truncates (saturating, as
# XLA's convert), the second operand takes the first one's type, and the
# result is cast to the common type.

def _int_image(a: ColVal):
    """(values, logical numpy type) of an argument of a bit operation."""
    t = storage_np(a)
    x = _numeric_data(a)
    if t.kind == "f":
        return _f64_to_i64(x.to(torch.float64)), np.dtype(np.int64)
    return x, t


def _f64_to_i64(x: torch.Tensor) -> torch.Tensor:
    """float64 -> int64 truncating toward zero and saturating, NaN -> 0 (XLA's
    convert; torch's cast of a value out of range is undefined)."""
    big = x >= 9223372036854775807.0
    small = x < -9223372036854775808.0
    ok = torch.where(big | small | torch.isnan(x), torch.zeros_like(x), x)
    out = ok.to(torch.int64)
    out = torch.where(big, torch.full_like(out, (1 << 63) - 1), out)
    return torch.where(small, torch.full_like(out, -(1 << 63)), out)


def _f64_to_u64(x: torch.Tensor) -> torch.Tensor:
    """float64 -> uint64 bits (int64) truncating and saturating: NaN and
    values below 0 give 0, values from 2^64 all ones (XLA's convert)."""
    hi = x >= 9223372036854775808.0
    over = x >= 18446744073709551616.0
    low = _f64_to_i64(torch.where(hi, x - 9223372036854775808.0, x))
    low = torch.where(x > 0, low, torch.zeros_like(low))
    out = torch.where(hi, low ^ _SIGN, low)
    return torch.where(over, torch.full_like(out, -1), out)


def _bitwise(op):
    def ex(args, out_dtype):
        (x, tx), (y, ty) = (_int_image(a) for a in args)
        if ty != tx:
            y = dt.cast_tensor(y, ty, tx)
        return ColVal(out_dtype, dt.cast_tensor(
            op(x, y), tx, dt.remove_nullable(out_dtype).np_dtype),
            _and_validity(args))
    return ex


for _n, _op in (("bitAnd", torch.bitwise_and), ("bitOr", torch.bitwise_or),
                ("bitXor", torch.bitwise_xor)):
    register(_n, _resolve_arith(), _bitwise(_op))


def _bit_not_exec(args, out_dtype):
    t = storage_np(args[0])
    if t.kind == "f":
        raise TypeError_(f"Illegal type {args[0].dtype} of argument of "
                         f"function bitNot")
    st = dt.remove_nullable(out_dtype).np_dtype
    return ColVal(out_dtype, dt.cast_tensor(
        torch.bitwise_not(_numeric_data(args[0])), t, st),
        _and_validity(args))


register("bitNot", _resolve_arith(), _bit_not_exec)


def _shift_exec(left: bool):
    """bitShiftLeft/Right in the common type: a shift by its width or more
    (or by a negative count, read unsigned) gives 0, or the sign for an
    arithmetic right shift, as XLA's shifts; an unsigned type shifts
    right logically."""
    def ex(args, out_dtype):
        st = dt.remove_nullable(out_dtype).np_dtype
        if st.kind == "f":
            raise TypeError_("bit shift expects integer arguments")
        x = _as(args[0], st).to(torch.int64)
        y = _as(args[1], st).to(torch.int64)
        bits = st.itemsize * 8
        out_of_range = (y < 0) | (y >= bits)
        s = torch.where(out_of_range, torch.zeros_like(y), y)
        if left:
            r = torch.where(out_of_range, torch.zeros_like(x), x << s)
        elif st.kind == "u":
            if st == np.uint64:                 # logical, of int64 bits
                half = (x >> 1) & ((1 << 63) - 1)
                r = torch.where(s == 0, x, half >> (s - 1).clamp(min=0))
            else:
                r = x >> s
            r = torch.where(out_of_range, torch.zeros_like(r), r)
        else:
            r = torch.where(out_of_range, x >> 63, x >> s)
        return ColVal(out_dtype, dt.cast_tensor(r, np.int64, st),
                      _and_validity(args))
    return ex


register("bitShiftLeft", _resolve_arith(), _shift_exec(True))
register("bitShiftRight", _resolve_arith(), _shift_exec(False))


def _minmax2(pick_min: bool):
    def ex(args, out_dtype):
        _no_decimal_or_dates("least/greatest", *(a.dtype for a in args))
        st = dt.remove_nullable(out_dtype).np_dtype
        x, y = (_as(a, st) for a in args)
        if st == np.uint64:
            take_x = (x ^ _SIGN) <= (y ^ _SIGN) if pick_min \
                else (x ^ _SIGN) >= (y ^ _SIGN)
            data = torch.where(take_x, x, y)
        else:
            data = torch.minimum(x, y) if pick_min else torch.maximum(x, y)
        return ColVal(out_dtype, data, _and_validity(args))
    return ex


register("least", _resolve_arith(), _minmax2(True), case_insensitive=True)
register("greatest", _resolve_arith(), _minmax2(False), case_insensitive=True)


# -- comparisons -------------------------------------------------------------

def _resolve_cmp(ts):
    a, b = ts
    return dt.UInt8.with_nullable(a.nullable or b.nullable)


def _string_codes_common(a: ColVal, b: ColVal):
    """Bring two string ColVals onto one merged dictionary (host op)."""
    da = a.dictionary or Dictionary(np.asarray([], object))
    db = b.dictionary or Dictionary(np.asarray([], object))
    merged, ra, rb = Dictionary.unify(da, db)
    dev = a.data.device

    def recode(cv, r):
        if not len(r):
            return torch.full_like(cv.data, -1)
        lut = torch.from_numpy(np.asarray(r, np.int32)).to(dev)
        c = lut[cv.data.clamp(min=0).long()]
        return torch.where(cv.data < 0, torch.full_like(c, -1), c)
    return recode(a, ra), recode(b, rb), merged


def _dict_rank_lut(d: Dictionary, device) -> torch.Tensor:
    """rank[code] = lexicographic rank of the dictionary value."""
    if d.sorted_:
        return torch.arange(len(d), dtype=torch.int64, device=device)
    vals = d.values.astype(str)
    order = np.argsort(vals, kind="stable")
    rank = np.empty(len(vals), np.int64)
    rank[order] = np.arange(len(vals))
    return torch.from_numpy(rank).to(device)


_CMP_MIRROR = {torch.eq: torch.eq, torch.ne: torch.ne, torch.lt: torch.gt,
               torch.gt: torch.lt, torch.le: torch.ge, torch.ge: torch.le}


def _narrow_values(cv: ColVal):
    """An integer column's values in the type they are kept in (a scanned
    column's narrow storage, an intDiv/modulo term formed in its source's
    type), or None."""
    if isinstance(cv, TermColVal):
        return cv.term.build_narrow()
    if isinstance(cv, StoredColVal) and not cv.storage.is_floating_point() \
            and cv.storage.dtype != torch.bool:
        return cv.storage
    return None


def _narrow_cmp(op, a: ColVal, b: ColVal, ct: np.dtype):
    """A comparison of a narrow-kept integer column with an integer
    constant that its type holds, in that type (no widened column), or
    None.  Signed comparisons only (ct a signed integer type), so the
    values compare as they would widened."""
    if ct.kind != "i":
        return None
    if a.is_const and not b.is_const:
        a, b, op = b, a, _CMP_MIRROR[op]
    if not b.is_const or b.dtype.nullable or storage_np(b).kind not in "iu":
        return None
    x = _narrow_values(a)
    if x is None:
        return None
    c = int(b.data.item())
    info = torch.iinfo(x.dtype)
    if not info.min <= c <= info.max:
        return None
    return op(x, c)


def _cmp_exec(op, equality: bool, name: str):
    def ex(args, out_dtype):
        a, b = args
        if a.dtype.is_dictionary and b.dtype.is_dictionary:
            ca, cb, merged = _string_codes_common(a, b)
            if equality or len(merged) == 0:
                data = op(ca, cb)
            else:
                rank = _dict_rank_lut(merged, ca.device)
                data = op(rank[ca.clamp(min=0).long()],
                          rank[cb.clamp(min=0).long()])
            return ColVal(out_dtype, data.to(torch.uint8),
                          _and_validity(args))
        a0 = dt.remove_nullable(a.dtype)
        b0 = dt.remove_nullable(b.dtype)
        _no_decimal_or_dates(name, a0, b0)
        if a0.is_dictionary != b0.is_dictionary:
            # String vs typed side: parse the string side into its domain
            from .conv import cast_exec
            if a0.is_dictionary:
                a = cast_exec([a], b0.with_nullable(a.dtype.nullable))
            else:
                b = cast_exec([b], a0.with_nullable(b.dtype.nullable))
        sa, sb = storage_np(a), storage_np(b)
        ct = np.promote_types(sa, sb)
        narrow = _narrow_cmp(op, a, b, ct)
        if narrow is not None:
            return ColVal(out_dtype, narrow.to(torch.uint8),
                          _and_validity(args))
        x = dt.cast_tensor(a.data, sa, ct)
        y = dt.cast_tensor(b.data, sb, ct)
        if ct == np.uint64:              # unsigned order of int64 bits
            x, y = x ^ _SIGN, y ^ _SIGN
        return ColVal(out_dtype, op(x, y).to(torch.uint8),
                      _and_validity(args))
    return ex


register("equals", _resolve_cmp, _cmp_exec(torch.eq, True, "equals"))
register("notEquals", _resolve_cmp, _cmp_exec(torch.ne, True, "notEquals"))
register("less", _resolve_cmp, _cmp_exec(torch.lt, False, "less"))
register("greater", _resolve_cmp, _cmp_exec(torch.gt, False, "greater"))
register("lessOrEquals", _resolve_cmp,
         _cmp_exec(torch.le, False, "lessOrEquals"))
register("greaterOrEquals", _resolve_cmp,
         _cmp_exec(torch.ge, False, "greaterOrEquals"))


# -- logical -----------------------------------------------------------------

def _resolve_bool(ts):
    return dt.UInt8.with_nullable(any(t.nullable for t in ts))


def _bool_data(a: ColVal):
    d = _numeric_data(a)
    if d.dtype == torch.bool:
        return d
    return d != 0


def _and_exec(args, out_dtype):
    data = _bool_data(args[0])
    for a in args[1:]:
        data = data & _bool_data(a)
    v = _and_validity(args)
    if v is not None:
        data = data & v           # NULL-as-false inside conjunctions
    return ColVal(out_dtype, data.to(torch.uint8), None)


def _or_exec(args, out_dtype):
    data = None
    for a in args:
        d = _bool_data(a)
        if a.validity is not None:
            d = d & a.validity.to(torch.bool)
        data = d if data is None else data | d
    return ColVal(out_dtype, data.to(torch.uint8), None)


register("and", _resolve_bool, _and_exec)
register("or", _resolve_bool, _or_exec)
register("xor", _resolve_bool,
         lambda args, t: ColVal(t, (_bool_data(args[0]) ^ _bool_data(args[1]))
                                .to(torch.uint8), _and_validity(args)))
register("not", _resolve_bool,
         lambda args, t: ColVal(t, (~_bool_data(args[0])).to(torch.uint8),
                                _and_validity(args)))


# -- conditionals / NULL handling -------------------------------------------

def _resolve_if(ts):
    cond, a, b = ts
    return dt.common_supertype(a, b)


def _valid_or_true(cv: ColVal, like):
    if cv.validity is None:
        return torch.ones((), dtype=torch.bool, device=like.device)
    return cv.validity.to(torch.bool)


def _if_exec(args, out_dtype):
    cond, a, b = args
    c = _bool_data(cond)
    if cond.validity is not None:
        c = c & cond.validity.to(torch.bool)
    st = dt.remove_nullable(out_dtype)
    v = None
    if st.is_dictionary:
        ca, cb, merged = _string_codes_common(a, b)
        data = torch.where(c, ca, cb)
        if a.validity is not None or b.validity is not None:
            v = torch.where(c, _valid_or_true(a, c), _valid_or_true(b, c))
        return ColVal(out_dtype, data, v, merged)
    _no_decimal_or_dates("if", st)
    x, y = _as(a, st.np_dtype), _as(b, st.np_dtype)
    data = torch.where(c, x, y)
    if a.validity is not None or b.validity is not None:
        v = torch.where(c, _valid_or_true(a, c), _valid_or_true(b, c))
    return ColVal(out_dtype, data, v)


register("if", _resolve_if, _if_exec, case_insensitive=True)


def _resolve_multiif(ts):
    branches = [ts[i] for i in range(1, len(ts), 2)]
    if len(ts) % 2 == 1:
        branches.append(ts[-1])
    out = branches[0]
    for b in branches[1:]:
        out = dt.common_supertype(out, b)
    return out


def _multiif_exec(args, out_dtype):
    # multiIf(c1, v1, c2, v2, ..., default)
    pairs = [(args[i], args[i + 1]) for i in range(0, len(args) - 1, 2)]
    default = args[-1] if len(args) % 2 == 1 else None
    if default is None:
        dev = args[0].data.device
        default = ColVal(out_dtype, torch.zeros(
            (), dtype=dt.remove_nullable(out_dtype).torch_dtype, device=dev),
            torch.zeros((), dtype=torch.uint8, device=dev))
    result = default
    for cond, val in reversed(pairs):
        result = _if_exec([cond, val, result], out_dtype)
    return result


register("multiIf", _resolve_multiif, _multiif_exec)


def _is_null_exec(negate: bool):
    def ex(args, out_dtype):
        a = args[0]
        if a.validity is None:
            fill = torch.ones_like if negate else torch.zeros_like
            return ColVal(out_dtype, fill(a.data, dtype=torch.uint8), None)
        v = a.validity.to(torch.bool)
        return ColVal(out_dtype, (v if negate else ~v).to(torch.uint8), None)
    return ex


register("isNull", lambda ts: dt.UInt8, _is_null_exec(False))
register("isNotNull", lambda ts: dt.UInt8, _is_null_exec(True))


def _resolve_coalesce(ts):
    out = ts[0]
    for t in ts[1:]:
        out = dt.common_supertype(out, t)
    if not all(t.nullable for t in ts):
        out = dt.remove_nullable(out)
    return out


def _coalesce_exec(args, out_dtype):
    result = args[-1]
    for a in reversed(args[:-1]):
        cond = ColVal(dt.UInt8, _valid_or_true(a, a.data).to(torch.uint8))
        result = _if_exec([cond, a, result], out_dtype)
    return result


register("coalesce", _resolve_coalesce, _coalesce_exec, case_insensitive=True)
register("ifNull", lambda ts: _resolve_coalesce(list(ts)), _coalesce_exec,
         case_insensitive=True)


def _nullif_exec(args, out_dtype):
    a, b = args
    eq = _cmp_exec(torch.eq, True, "nullIf")([a, b], dt.UInt8)
    v = eq.data == 0
    if a.validity is not None:
        v = v & a.validity.to(torch.bool)
    return ColVal(out_dtype, a.data, v, a.dictionary)


register("nullIf", lambda ts: dt.make_nullable(ts[0]), _nullif_exec,
         case_insensitive=True)
register("assumeNotNull", lambda ts: dt.remove_nullable(ts[0]),
         lambda args, t: ColVal(t, args[0].data, None, args[0].dictionary))
register("toNullable", lambda ts: dt.make_nullable(ts[0]),
         lambda args, t: ColVal(t, args[0].data, args[0].validity,
                                args[0].dictionary))


# -- math --------------------------------------------------------------------
# Plain elementwise torch in float64 (the reference's jnp ops; torch's and
# XLA's transcendental functions may differ in the last bits).

def _float_unary(op):
    def ex(args, out_dtype):
        return ColVal(out_dtype, op(_as(args[0], np.float64)),
                      _and_validity(args))
    return ex


def _cbrt(x):
    y = torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)
    # one Newton step rounds pow's result to the nearest cube root
    step = y - (y * y * y - x) / (3.0 * y * y)
    return torch.where((y == 0) | ~torch.isfinite(y), y, step)


for _n, _op in [
    ("sqrt", torch.sqrt), ("cbrt", _cbrt), ("exp", torch.exp),
    ("log", torch.log), ("ln", torch.log), ("exp2", torch.exp2),
    ("log2", torch.log2), ("exp10", lambda x: torch.pow(10.0, x)),
    ("log10", torch.log10), ("sin", torch.sin), ("cos", torch.cos),
    ("tan", torch.tan), ("asin", torch.asin), ("acos", torch.acos),
    ("atan", torch.atan), ("sigmoid", torch.sigmoid), ("tanh", torch.tanh),
    ("erf", torch.erf), ("erfc", lambda x: 1.0 - torch.erf(x)),
    ("lgamma", torch.lgamma),
    ("tgamma", lambda x: torch.where(x > 0, torch.exp(torch.lgamma(x)),
                                     torch.full_like(x, math.nan))),
]:
    register(_n, _resolve_float, _float_unary(_op), case_insensitive=True)


def _float_binary(op):
    def ex(args, out_dtype):
        return ColVal(out_dtype, op(_as(args[0], np.float64),
                                    _as(args[1], np.float64)),
                      _and_validity(args))
    return ex


register("pow", _resolve_float, _float_binary(torch.pow),
         case_insensitive=True)
register("power", _resolve_float, _float_binary(torch.pow),
         case_insensitive=True)
register("atan2", _resolve_float, _float_binary(torch.atan2),
         case_insensitive=True)


def _float_const(v: float):
    # built on the host; evaluate() moves a call of no argument to the
    # block's device
    return lambda args, t: ColVal(t, torch.tensor(v, dtype=torch.float64))


register("pi", lambda ts: dt.Float64, _float_const(math.pi),
         case_insensitive=True)
register("e", lambda ts: dt.Float64, _float_const(math.e),
         case_insensitive=True)


def _resolve_rounding(ts):
    _check_numeric(ts, "round")
    return ts[0] if len(ts) else dt.Float64


def _decimal_round(kind: str, xi: torch.Tensor, q) -> torch.Tensor:
    """Round scaled Decimal integers xi to multiples of q (exact)."""
    ax = torch.abs(xi)
    sgn = torch.sign(xi)
    if kind == "trunc":
        return sgn * torch.div(ax, q, rounding_mode="floor") * q
    if kind == "floor":
        return torch.where(xi >= 0, torch.div(ax, q, rounding_mode="floor") * q,
                           -torch.div(ax + q - 1, q, rounding_mode="floor") * q)
    if kind == "ceil":
        return torch.where(xi >= 0,
                           torch.div(ax + q - 1, q, rounding_mode="floor") * q,
                           -torch.div(ax, q, rounding_mode="floor") * q)
    if kind == "bankers":                  # half to even
        base = torch.div(ax, q, rounding_mode="floor")
        rem = ax - base * q
        up = (2 * rem > q) | ((2 * rem == q) & (torch.remainder(base, 2) == 1))
        return sgn * (base + up.to(torch.int64)) * q
    # half away from zero (the Decimal rule)
    return sgn * torch.div(ax + torch.div(q, 2, rounding_mode="floor"), q,
                           rounding_mode="floor") * q


_FLOAT_ROUND = {"floor": torch.floor, "ceil": torch.ceil, "trunc": torch.trunc,
                "round": torch.round, "bankers": torch.round}  # half to even


def _round_exec(kind: str):
    def ex(args, out_dtype):
        out0 = dt.remove_nullable(out_dtype)
        x = _numeric_data(args[0])
        if dt.is_decimal(out0):
            n = _as(args[1], np.int64) if len(args) >= 2 \
                else torch.zeros((), dtype=torch.int64, device=x.device)
            q = torch.pow(10, torch.clamp(out0.decimal_scale - n, 0, 18))
            return ColVal(out_dtype, _decimal_round(kind, x.to(torch.int64),
                                                    q), _and_validity(args))
        if dt.is_integer(out0) and len(args) < 2:
            return ColVal(out_dtype, x, _and_validity(args))
        k = _FLOAT_ROUND[kind]
        xf = _as(args[0], np.float64)
        if len(args) >= 2:
            scale = torch.pow(10.0, _as(args[1], np.float64))
            data = k(xf * scale) / scale
        else:
            data = k(xf)
        return ColVal(out_dtype, _from_f64(data, out0.np_dtype),
                      _and_validity(args))
    return ex


def _from_f64(x: torch.Tensor, st) -> torch.Tensor:
    """float64 values as logical type st, truncating; a value out of the
    integer type's range saturates and NaN gives 0 (XLA's convert)."""
    st = np.dtype(st)
    if st.kind == "f":
        return x.to(dt.torch_dtype_of(st))
    if st == np.uint64:
        return _f64_to_u64(x)
    if st.itemsize < 8:
        info = np.iinfo(st)
        x = torch.clamp(x, float(info.min), float(info.max))
    return dt.cast_tensor(_f64_to_i64(x), np.int64, st)


register("floor", _resolve_rounding, _round_exec("floor"),
         case_insensitive=True)
register("ceil", _resolve_rounding, _round_exec("ceil"), case_insensitive=True)
register("ceiling", _resolve_rounding, _round_exec("ceil"),
         case_insensitive=True)
register("round", _resolve_rounding, _round_exec("round"),
         case_insensitive=True)
register("trunc", _resolve_rounding, _round_exec("trunc"),
         case_insensitive=True)
register("truncate", _resolve_rounding, _round_exec("trunc"),
         case_insensitive=True)
register("roundBankers", _resolve_rounding, _round_exec("bankers"))


def _sign_exec(args, out_dtype):
    s = torch.sign(_as(args[0], np.float64))
    return ColVal(out_dtype, torch.nan_to_num(s, nan=0.0).to(torch.int8),
                  _and_validity(args))


register("sign", lambda ts: dt.Int8.with_nullable(any(t.nullable for t in ts)),
         _sign_exec, case_insensitive=True)


def _float_test(test):
    return lambda args, t: ColVal(t, test(_as(args[0], np.float64)).to(
        torch.uint8), _and_validity(args))


register("isNaN", _resolve_bool, _float_test(torch.isnan))
register("isFinite", _resolve_bool, _float_test(torch.isfinite))
register("isInfinite", _resolve_bool, _float_test(torch.isinf))


# -- date / time -------------------------------------------------------------
# Every calendar function is one op of K12 (ops/calendar_ops.calendar_part)
# over the argument's storage as it is stored: one launch over the rows on
# the card.  A Date is a day number, a DateTime seconds since 1970-01-01;
# an integer argument reads as the reference reads it (mode below).

def _calendar_storage(a: ColVal) -> torch.Tensor:
    """The argument's integer storage, as K12 reads it."""
    t = dt.remove_nullable(a.dtype)
    if t.is_dictionary or t.np_dtype.kind not in "iu":
        raise TypeError_(f"Illegal type {t} of argument of a date/time "
                         f"function")
    x = a.storage
    return x.to(torch.int16) if x.dtype in (torch.bool, torch.uint8) else x


def _in_seconds(a: ColVal, mode: str, name: str) -> bool:
    """Whether K12 reads the argument as seconds.  mode "days": a Date or
    an integer is days, a DateTime seconds (the reference's _as_days);
    "secs": a Date is its midnight, any other value seconds; "time" (a
    function of the time of day): as "secs", and a Date is refused, as
    ClickHouse refuses it (the reference reads its day number as
    seconds)."""
    tname = dt.remove_nullable(a.dtype).name
    if mode == "days":
        return tname == "DateTime"
    if mode == "time" and tname == "Date":
        raise TypeError_(f"Illegal type Date of argument of function "
                         f"{name}: a Date has no time of day")
    return tname != "Date"


def _cal(a: ColVal, op: str, out_dtype, mode="days", c0=0, c1=0,
         name="") -> ColVal:
    data = calendar_ops.calendar_part(
        _calendar_storage(a), op, _in_seconds(a, mode, name),
        dt.remove_nullable(out_dtype).np_dtype, c0, c1)
    return ColVal(out_dtype, data, _and_validity([a]))


def _register_cal(name, out_t: dt.DType, op: str, mode="days", c0=0, c1=0,
                  **kw):
    register(name, lambda ts: out_t.with_nullable(ts[0].nullable),
             lambda args, t: _cal(args[0], op, t, mode, c0, c1, name), **kw)


_register_cal("toYear", dt.UInt16, "year")
_register_cal("toMonth", dt.UInt8, "month")
_register_cal("toDayOfMonth", dt.UInt8, "day_of_month")
_register_cal("toHour", dt.UInt8, "hour", mode="time")
_register_cal("toMinute", dt.UInt8, "minute", mode="time")
_register_cal("toSecond", dt.UInt8, "second", mode="time")


def _unix_timestamp_exec(args, out_dtype):
    a = args[0]
    secs = _as(a, np.int64)
    if dt.remove_nullable(a.dtype).name == "Date":
        secs = secs * 86400            # the reference gives the day number
    return ColVal(out_dtype, dt.cast_tensor(secs, np.int64, np.uint32),
                  _and_validity(args))


register("toUnixTimestamp", lambda ts: dt.UInt32.with_nullable(ts[0].nullable),
         _unix_timestamp_exec)
_register_cal("toDayOfWeek", dt.UInt8, "day_of_week")
_register_cal("toYYYYMM", dt.UInt32, "yyyymm")
_register_cal("toYYYYMMDD", dt.UInt32, "yyyymmdd")
_register_cal("toYYYYMMDDhhmmss", dt.UInt64, "yyyymmddhhmmss", mode="secs")
_register_cal("toStartOfYear", dt.Date, "start_of_months", c0=12)
_register_cal("toStartOfMonth", dt.Date, "start_of_months", c0=1)

MONDAY, SUNDAY = 3, 4       # K12's anchor: day 0 (1970-01-01) is a Thursday


def _week_anchor(args) -> int:
    """toStartOfWeek's mode (toWeek's): an odd mode starts the week on a
    Monday, an even one (0 by default) on a Sunday; the reference always
    takes Monday."""
    return MONDAY if len(args) > 1 and _host_int(args[1]) & 1 else SUNDAY


register("toStartOfWeek", lambda ts: dt.Date.with_nullable(ts[0].nullable),
         lambda args, t: _cal(args[0], "start_of_days", t, c0=7,
                              c1=_week_anchor(args)))


def _interval_exec(unit: str):
    t = dt.INTERVALS[unit]

    def ex(args, out_dtype):
        return ColVal(t, _as(args[0], np.int64), _and_validity(args),
                      host=args[0].host)
    return ex


for _unit in dt.INTERVAL_UNITS:
    register(f"toInterval{_unit}",
             (lambda u: lambda ts: dt.INTERVALS[u])(_unit),
             _interval_exec(_unit))


def _host_clock_const(days_back=None):
    """now() (days_back None: seconds), today() (0) or yesterday() (1)
    from the host clock; built on the host (evaluate() moves a call of no
    argument to the block's device)."""
    def ex(args, out_dtype):
        secs = int(time.time())
        if days_back is None:
            return ColVal(out_dtype, torch.tensor(secs, dtype=torch.int64))
        return ColVal(out_dtype, torch.tensor(secs // 86400 - days_back,
                                              dtype=torch.int32))
    return ex


register("now", lambda ts: dt.DateTime, _host_clock_const(),
         case_insensitive=True)
register("today", lambda ts: dt.Date, _host_clock_const(0),
         case_insensitive=True)
register("yesterday", lambda ts: dt.Date, _host_clock_const(1),
         case_insensitive=True)


def _add_unit(unit: str, sign: int):
    def ex(args, out_dtype):
        iv = ColVal(dt.INTERVALS[unit], _as(args[1], np.int64),
                    args[1].validity, host=args[1].host)
        return _datetime_arith(sign)([args[0], iv], out_dtype)
    return ex


for _unit in dt.INTERVAL_UNITS:
    register(f"add{_unit}s", lambda ts: ts[0], _add_unit(_unit, 1))
    register(f"subtract{_unit}s", lambda ts: ts[0], _add_unit(_unit, -1))


def _days_of(cv: ColVal) -> torch.Tensor:
    if dt.remove_nullable(cv.dtype).name == "Date":
        return _as(cv, np.int64)
    return calendar_ops.calendar_part(_calendar_storage(cv), "day_number",
                                      True, np.int64)


def _secs_of(cv: ColVal) -> torch.Tensor:
    x = _as(cv, np.int64)
    return x * 86400 if dt.remove_nullable(cv.dtype).name == "Date" else x


def _month_number(cv: ColVal) -> torch.Tensor:
    """y * 12 + m of the argument's day (dateDiff's months)."""
    return calendar_ops.calendar_part(
        _calendar_storage(cv), "relative_month",
        dt.remove_nullable(cv.dtype).name != "Date", np.int64)


_DIFF_UNITS = {"second": (_secs_of, 1), "minute": (_secs_of, 60),
               "hour": (_secs_of, 3600), "day": (_days_of, 1),
               "week": (_days_of, 7), "month": (_month_number, 1),
               "quarter": (_month_number, 3), "year": (_month_number, 12)}


def _date_diff_exec(args, out_dtype):
    unit_cv, a, b = args
    unit = str(unit_cv.dictionary.values[0]).lower() \
        if unit_cv.dictionary is not None else "day"
    if unit not in _DIFF_UNITS:
        raise TypeError_(f"dateDiff: unknown unit '{unit}'")
    of, scale = _DIFF_UNITS[unit]
    data = torch.div(of(b) - of(a), scale, rounding_mode="floor")
    return ColVal(out_dtype, data, _and_validity(args[1:]))


register("dateDiff", lambda ts: dt.Int64.with_nullable(
    any(t.nullable for t in ts[1:])), _date_diff_exec)
_register_cal("toStartOfDay", dt.DateTime, "start_of_seconds", c0=86400)
_register_cal("toStartOfHour", dt.DateTime, "start_of_seconds", mode="time",
              c0=3600)
_register_cal("toStartOfMinute", dt.DateTime, "start_of_seconds",
              mode="time", c0=60)


# -- strings (dictionary-LUT execution) --------------------------------------
# A string function is computed once a dictionary value on the host (numpy,
# as the reference), into a lookup table the rows gather by code; a String
# result is a new sorted dictionary.  startsWith, endsWith and LIKE 'p%' /
# '%s' compute their table on the device from the dictionary's bytes (K10,
# ops/string_ops.prefix_match), for every dictionary size.

def _string_fn_lut(host_fn, out_np_dtype, vec_fn=None):
    """Apply host_fn to each dictionary value, gather the LUT by code.

    vec_fn, when given, is a numpy-vectorized implementation over the whole
    unique-value array, taken for dictionaries of more than 512 values (a
    Python loop a value for the smaller ones, as the reference)."""
    def ex(args, out_dtype):
        a = args[0]
        if not a.dtype.is_dictionary:
            raise TypeError_("String function expects a String argument")
        vals = a.dictionary.values if a.dictionary else np.asarray([], object)
        if vec_fn is not None and len(vals) > 512:
            lut_np = np.asarray(vec_fn(a.dictionary.values_str()),
                                dtype=out_np_dtype)
        else:
            lut_np = np.asarray(
                [host_fn(str(v)) for v in vals] or [host_fn("")],
                dtype=out_np_dtype)
        if out_np_dtype == object:
            # produces a new string dictionary
            uniq, codes = np.unique(lut_np.astype(str), return_inverse=True)
            lut = torch.from_numpy(codes.astype(np.int32)).to(a.data.device)
            return ColVal(out_dtype, _by_code(lut, a.data),
                          _and_validity(args),
                          Dictionary(uniq.astype(object), sorted_=True))
        lut = dt.tensor_from_numpy(lut_np, a.data.device)
        return ColVal(out_dtype, _by_code(lut, a.data), _and_validity(args))
    return ex


def _by_code(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """lut[code] of each row (a NULL's code -1 reads entry 0; its validity
    hides it), gathered with the codes as stored (int32)."""
    codes = codes.clamp(min=0)
    if codes.dim() == 0:
        return lut[codes.long()]
    return lut.index_select(0, codes)


def _const_str(cv: ColVal, what: str) -> str:
    """The value of a constant String argument; TypeError_ for a column (a
    needle or pattern a row is not supported, as the reference's LIKE)."""
    if not cv.is_const or cv.dictionary is None or not cv.dtype.is_dictionary:
        raise TypeError_(f"{what} must be a constant string")
    vals = cv.dictionary.values
    return str(vals[0] if len(vals) == 1 else vals[int(cv.data.clamp(min=0))])


def _prefix_lut(a: ColVal, needle: str, suffix: bool, negate: bool,
                out_dtype, max_bytes: Optional[int]) -> ColVal:
    """startsWith / endsWith (XOR negate) of a String over its dictionary's
    bytes on the device (K10), gathered by code."""
    from ..ops import string_ops
    d = a.dictionary
    # built at the first use, held (with the LUT) to max_bytes
    chars, offsets = d.device_chars(
        a.data.device, check=lambda nbytes: string_ops.check_chars_bytes(
            nbytes + len(d), max_bytes))
    lut = string_ops.prefix_match(chars, offsets, needle.encode("utf-8"),
                                  suffix=suffix, negate=negate)
    return ColVal(out_dtype, _by_code(lut, a.data), _and_validity([a]))


def _on_device_dict(a: ColVal) -> bool:
    return a.dtype.is_dictionary and a.dictionary is not None \
        and len(a.dictionary) > 0


def _sized_type(out: dt.DType):
    def resolve(ts):
        if ts and dt.is_map(dt.remove_nullable(ts[0])):
            raise NotImplementedError_(
                "length of a Map is not ported to the CUDA engine yet")
        return out.with_nullable(ts[0].nullable)
    return resolve


def _array_or_string(of_lengths, string_exec):
    """A function of a String (its LUT) or of an Array's lengths."""
    def run(args, out_dtype):
        a = args[0]
        if not a.dtype.is_array:
            return string_exec(args, out_dtype)
        lens = a.lengths if a.lengths is not None else torch.full(
            a.data.shape[:-1], a.data.shape[-1], dtype=torch.int32,
            device=a.data.device)
        return ColVal(out_dtype, of_lengths(lens.to(torch.int64)).to(
            dt.remove_nullable(out_dtype).torch_dtype), a.validity)
    return run


register("length", _sized_type(dt.UInt64), _array_or_string(
    lambda n: n, _string_fn_lut(lambda s: len(s.encode()), np.uint64,
                                vec_fn=lambda sv: np.char.str_len(
                                    np.char.encode(sv, "utf-8")))),
         case_insensitive=True)
register("lengthUTF8", lambda ts: dt.UInt64.with_nullable(ts[0].nullable),
         _string_fn_lut(len, np.uint64, vec_fn=np.char.str_len))
register("empty", _sized_type(dt.UInt8), _array_or_string(
    lambda n: n == 0, _string_fn_lut(
        lambda s: np.uint8(len(s) == 0), np.uint8,
        vec_fn=lambda sv: np.char.str_len(sv) == 0)))
register("notEmpty", _sized_type(dt.UInt8), _array_or_string(
    lambda n: n != 0, _string_fn_lut(
        lambda s: np.uint8(len(s) != 0), np.uint8,
        vec_fn=lambda sv: np.char.str_len(sv) != 0)))
register("lower", lambda ts: dt.String.with_nullable(ts[0].nullable),
         _string_fn_lut(str.lower, object, vec_fn=np.char.lower),
         case_insensitive=True)
register("upper", lambda ts: dt.String.with_nullable(ts[0].nullable),
         _string_fn_lut(str.upper, object, vec_fn=np.char.upper),
         case_insensitive=True)
register("reverse", lambda ts: dt.String.with_nullable(ts[0].nullable),
         _string_fn_lut(lambda s: s[::-1], object), case_insensitive=True)
register("trim", lambda ts: dt.String.with_nullable(ts[0].nullable),
         _string_fn_lut(str.strip, object, vec_fn=np.char.strip),
         case_insensitive=True)


def _like_to_regex(pattern: str) -> str:
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return "^" + "".join(out) + "$"


def _like_exec(negate=False, icase=False):
    def ex(args, out_dtype, max_bytes=None):
        a, pat = args
        pattern = _const_str(pat, "LIKE pattern")
        rx = re.compile(_like_to_regex(pattern),
                        re.IGNORECASE if icase else 0)
        fn = lambda s: np.uint8((rx.match(s) is not None) != negate)
        # %-only patterns: a prefix or suffix on the device (K10), the
        # others vectorized on the host; escapes, '_' and an inner '%' take
        # the regex
        vec = None
        core = pattern.strip("%")
        plain = "%" not in core and "_" not in core and "\\" not in core
        if plain and not icase:
            if _on_device_dict(a) and pattern in (f"{core}%", f"%{core}"):
                return _prefix_lut(a, core, pattern != f"{core}%", negate,
                                   out_dtype, max_bytes)
            if pattern == f"%{core}%":
                vec = lambda sv: (np.char.find(sv, core) >= 0) != negate
            elif "%" not in pattern and "_" not in pattern:
                vec = lambda sv: (sv == pattern) != negate
        return _string_fn_lut(fn, np.uint8, vec_fn=vec)([a], out_dtype)
    return ex


register("like", lambda ts: dt.UInt8.with_nullable(ts[0].nullable),
         _like_exec(False), device_bytes=True)
register("notLike", lambda ts: dt.UInt8.with_nullable(ts[0].nullable),
         _like_exec(True), device_bytes=True)
register("ilike", lambda ts: dt.UInt8.with_nullable(ts[0].nullable),
         _like_exec(False, True), device_bytes=True)
register("notILike", lambda ts: dt.UInt8.with_nullable(ts[0].nullable),
         _like_exec(True, True), device_bytes=True)


def _match_exec(args, out_dtype):
    rx = re.compile(_const_str(args[1], "match pattern"))
    return _string_fn_lut(lambda s: np.uint8(rx.search(s) is not None),
                          np.uint8)([args[0]], out_dtype)


register("match", lambda ts: dt.UInt8.with_nullable(ts[0].nullable),
         _match_exec)


def _affix_exec(suffix: bool):
    def ex(args, out_dtype, max_bytes=None):
        a, pref = args
        p = _const_str(pref, "endsWith suffix" if suffix
                       else "startsWith prefix")
        if _on_device_dict(a):
            return _prefix_lut(a, p, suffix, False, out_dtype, max_bytes)
        # an empty dictionary (no value to read): a one-entry LUT
        return _string_fn_lut(
            lambda s: np.uint8(s.endswith(p) if suffix else s.startswith(p)),
            np.uint8)([a], out_dtype)
    return ex


register("startsWith", lambda ts: dt.UInt8.with_nullable(ts[0].nullable),
         _affix_exec(suffix=False), device_bytes=True)
register("endsWith", lambda ts: dt.UInt8.with_nullable(ts[0].nullable),
         _affix_exec(suffix=True), device_bytes=True)


def _position_exec(args, out_dtype):
    sub = _const_str(args[1], "position needle")
    return _string_fn_lut(lambda s: np.uint64(s.find(sub) + 1),
                          np.uint64)([args[0]], out_dtype)


register("position", lambda ts: dt.UInt64.with_nullable(ts[0].nullable),
         _position_exec)


def _host_int(cv: ColVal) -> int:
    h = cv.host
    return int(h) if isinstance(h, (int, np.integer)) else int(cv.data)


def _substring_exec(args, out_dtype):
    a = args[0]
    start = _host_int(args[1])
    length = _host_int(args[2]) if len(args) > 2 else None

    def fn(s):
        b = start - 1 if start > 0 else len(s) + start
        return s[b:b + length] if length is not None else s[b:]
    return _string_fn_lut(fn, object)([a], out_dtype)


register("substring", lambda ts: dt.String.with_nullable(ts[0].nullable),
         _substring_exec, case_insensitive=True)
register("substr", lambda ts: dt.String.with_nullable(ts[0].nullable),
         _substring_exec, case_insensitive=True)


def _const_text(a: ColVal) -> str:
    return str(a.dictionary.values[0])


def _concat_exec(args, out_dtype):
    # every constant is folded into a neighbouring column's LUT (the ones
    # before the first column into its prefix, every other one into the
    # suffix of the column before it); the columns then concatenate by the
    # product of their (small) dictionaries, pairwise
    dev = args[0].data.device
    cols = [i for i, a in enumerate(args) if not a.is_const]
    if not cols:
        d = Dictionary(np.asarray(["".join(_const_text(a) for a in args)],
                                  object))
        return ColVal(out_dtype, torch.zeros((), dtype=torch.int32,
                                             device=dev), None, d)
    folded = []
    for j, i in enumerate(cols):
        pre = "".join(_const_text(a) for a in args[:i]) if j == 0 else ""
        end = cols[j + 1] if j + 1 < len(cols) else len(args)
        post = "".join(_const_text(a) for a in args[i + 1:end])
        col = args[i]
        if pre or post:
            col = _string_fn_lut(
                lambda s, pre=pre, post=post: pre + s + post, object,
                vec_fn=lambda sv, pre=pre, post=post: np.char.add(
                    np.char.add(pre, sv), post))([col], out_dtype)
        folded.append(col)
    out = folded[0]
    for b in folded[1:]:
        out = _concat_pair(out, b, out_dtype)
    return out


def _concat_pair(a: ColVal, b: ColVal, out_dtype) -> ColVal:
    """Two String columns concatenated: a LUT over the product of their
    dictionaries, gathered by both codes."""
    da = a.dictionary.values if a.dictionary else np.asarray([], object)
    db = b.dictionary.values if b.dictionary else np.asarray([], object)
    if len(da) * len(db) > 1 << 20:
        raise TypeError_("concat of two high-cardinality string columns is "
                         "not supported yet")
    prod = np.asarray([str(x) + str(y) for x in da for y in db] or [""],
                      object)
    uniq, codes = np.unique(prod.astype(str), return_inverse=True)
    lut = torch.from_numpy(codes.astype(np.int32).reshape(
        max(len(da), 1), max(len(db), 1))).to(a.data.device)
    data = lut[a.data.clamp(min=0).long(), b.data.clamp(min=0).long()]
    return ColVal(out_dtype, data, _and_validity([a, b]),
                  Dictionary(uniq.astype(object), sorted_=True))


register("concat", lambda ts: dt.String.with_nullable(
    any(t.nullable for t in ts)), _concat_exec, case_insensitive=True)


# -- hashing (reference functions.py:1495-1507) ------------------------------
# cityHash64 and sipHash64 are the reference's splitmix64 row hash
# (ops/hash_ops.hash_columns) of their arguments' values, through K15.  A
# String argument raises (S3: the reference hashes its dictionary code;
# a hash over the bytes waits for the byte-hash slice), as do the byte
# hashes (xxHash64 is the reference's byte-wise host function).

def _hash_exec(args, out_dtype):
    from ..ops import hash_ops
    from .agg_sketch import hash_arg
    for a in args:
        if a.dtype.is_dictionary:
            raise NotImplementedError_(
                "cityHash64/sipHash64 of a String: a hash of the bytes is "
                "not ported to the CUDA engine yet (S3: the reference "
                "hashes the dictionary code)")
    hargs = [hash_arg(a) for a in args]
    n = next((h.tensor().shape[0] for h in hargs if h.tensor().dim()), None)
    h = hash_ops.row_hash(hargs, n)
    return ColVal(out_dtype, h if n is not None else h.reshape(()),
                  _and_validity(args))


register("cityHash64", lambda ts: dt.UInt64, _hash_exec)
register("sipHash64", lambda ts: dt.UInt64, _hash_exec)


# -- arrays (padded (rows, max_len) + lengths; SURVEY §2.1 ColumnArray) ------
# The base of the reference's array section: the element mask, the array()
# constructor over numbers, and the argument check the vector functions of
# functions_ext.py use.  Array(String) and arrays of tuples are not ported.

def _elem_mask(cv: ColVal) -> torch.Tensor:
    """Bool mask of the elements inside each row's length."""
    ml = cv.data.shape[-1]
    idx = torch.arange(ml, device=cv.data.device)
    if cv.lengths is None:       # no lengths recorded: full-width rows
        return torch.ones(cv.data.shape, dtype=torch.bool,
                          device=cv.data.device)
    return idx < cv.lengths[..., None].to(torch.int64)


def _resolve_array_ctor(ts):
    from ..core.column import check_array_type
    if not ts:
        return dt.Array(dt.Int64)
    inner = ts[0]
    for t in ts[1:]:
        inner = dt.common_supertype(inner, t)
    out = dt.Array(dt.remove_nullable(inner))
    check_array_type(out)
    return out


def _array_ctor_exec(args, out_dtype):
    """array(x1, ..., xk) over numbers: each row's k values, zero-padded
    to a multiple of 8; a constant when every argument is one (1-d data,
    0-d lengths), as the reference builds it."""
    from ..core.column import array_width
    inner = dt.array_inner(out_dtype)
    k = len(args)
    dev = args[0].data.device if args else torch.device("cpu")
    ml = array_width(k)
    if k == 0:
        return ColVal(out_dtype, torch.zeros(ml, dtype=inner.torch_dtype,
                                             device=dev),
                      lengths=torch.zeros((), dtype=torch.int32, device=dev))
    vals = torch.broadcast_tensors(*[_as(a, inner.np_dtype) for a in args])
    stacked = torch.stack(vals, dim=-1)
    pad = torch.zeros(stacked.shape[:-1] + (ml - k,), dtype=stacked.dtype,
                      device=dev)
    data = torch.cat([stacked, pad], dim=-1)
    lengths = torch.full(stacked.shape[:-1], k, dtype=torch.int32,
                         device=dev)
    # a literal list of integers carries its values' bounds, as the
    # reference's host-concrete constant does
    hosts = [_host_number(a) for a in args]
    bounds = None
    if data.dim() == 1 and inner.np_dtype.kind in "iu" \
            and all(isinstance(h, (int, np.integer)) for h in hosts):
        bounds = (int(min(hosts)), int(max(hosts)))
    return ColVal(out_dtype, data, _and_validity(args), bounds=bounds,
                  lengths=lengths)


register("array", _resolve_array_ctor, _array_ctor_exec)


def _array_arg(a: ColVal) -> ColVal:
    if not a.dtype.is_array:
        raise TypeError_("Expected an Array argument")
    return a


def _array_lengths(a: ColVal) -> torch.Tensor:
    """An Array's lengths (full-width rows where none are recorded)."""
    if a.lengths is not None:
        return a.lengths
    return torch.full(a.data.shape[:-1], a.data.shape[-1], dtype=torch.int32,
                      device=a.data.device)


def _no_map(name: str, a: ColVal) -> None:
    if dt.is_map(a.dtype):
        raise NotImplementedError_(
            f"{name} of a {a.dtype} is not ported to the CUDA engine yet "
            f"(Map columns)")


def _array_element_exec(args, out_dtype):
    """arr[i]: 1-based, a negative index counting from the end, the type's
    default (0) outside the array."""
    a, i = args
    _no_map("arrayElement", a)
    _array_arg(a)
    # an expansion's gathered rows: the element read from their source
    src, rows = (a.source, a.rows) if isinstance(a, GatheredColVal) \
        else (a, None)
    idx = _as(i, np.int64)
    lens = _array_lengths(src).to(torch.int64)
    if rows is not None:
        lens = lens.index_select(0, rows)
    pos = torch.where(idx > 0, idx - 1, lens + idx)
    ok = (pos >= 0) & (pos < lens)
    width = src.data.shape[-1]
    pos_c = pos.clamp(0, max(width - 1, 0))
    if src.data.dim() == 1:         # a constant array
        data = src.data[pos_c]
    elif rows is not None:
        flat = rows * width + pos_c.expand(rows.shape)
        data = src.data.contiguous().view(-1).index_select(0, flat)
    else:
        pos_c = pos_c.expand(src.data.shape[:-1])
        data = torch.gather(src.data, -1, pos_c[..., None])[..., 0]
    data = torch.where(ok, data, torch.zeros((), dtype=data.dtype,
                                             device=data.device))
    return ColVal(out_dtype, data, _and_validity(args))


def _resolve_array_element(ts):
    if dt.is_map(ts[0]):
        return dt.map_inner(ts[0])[1]
    return dt.array_inner(ts[0])


register("arrayElement", _resolve_array_element, _array_element_exec)


def _element_eq(a: ColVal, v: ColVal) -> torch.Tensor:
    """Each element of `a` against the row's needle `v` (numbers compared
    in their common type), inside each row's length."""
    _array_arg(a)
    if v.dtype.is_dictionary:
        raise TypeError_("has/indexOf of a String needle in an Array of "
                         "numbers")
    inner = dt.array_inner(dt.remove_nullable(a.dtype)).np_dtype
    ct = np.promote_types(inner, storage_np(v))
    x = dt.cast_tensor(a.data, inner, ct)
    y = dt.cast_tensor(v.data, storage_np(v), ct)
    eq = x == (y[..., None] if y.dim() else y)
    return eq & _elem_mask(ColVal(a.dtype, a.data,
                                  lengths=_array_lengths(a)))


def _has_exec(args, out_dtype):
    hit = _element_eq(*args).any(dim=-1)
    return ColVal(out_dtype, hit.to(torch.uint8), _and_validity(args))


register("has", lambda ts: dt.UInt8.with_nullable(any(t.nullable
                                                      for t in ts)),
         _has_exec)


def _index_of_exec(args, out_dtype):
    eq = _element_eq(*args)
    ml = eq.shape[-1]
    idx = torch.arange(ml, dtype=torch.int64, device=eq.device)
    first = torch.where(eq, idx, ml).amin(dim=-1) if ml else \
        torch.zeros(eq.shape[:-1], dtype=torch.int64, device=eq.device)
    return ColVal(out_dtype, torch.where(first < ml, first + 1, 0),
                  _and_validity(args))


register("indexOf", lambda ts: dt.UInt64.with_nullable(
    any(t.nullable for t in ts)), _index_of_exec)


def _arr_reduce(op, out_type_fn):
    """arraySum/arrayAvg/arrayMin/arrayMax over each row's elements (an
    empty array gives 0)."""
    def resolve(ts):
        return out_type_fn(dt.array_inner(ts[0])).with_nullable(
            ts[0].nullable)

    def ex(args, out_dtype):
        a = _array_arg(args[0])
        lens = _array_lengths(a)
        m = _elem_mask(ColVal(a.dtype, a.data, lengths=lens))
        inner = dt.array_inner(dt.remove_nullable(a.dtype)).np_dtype
        st = dt.remove_nullable(out_dtype).np_dtype
        x = dt.cast_tensor(a.data, inner, st)
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        if op in ("sum", "avg"):
            data = torch.where(m, x, zero).sum(dim=-1, dtype=x.dtype)
            if op == "avg":
                data = data / lens.clamp(min=1).to(x.dtype)
        else:
            if x.is_floating_point():
                ident = float("inf") if op == "min" else float("-inf")
            else:
                ii = torch.iinfo(x.dtype)
                ident = int(ii.max if op == "min" else ii.min)
            filled = torch.where(m, x, torch.full((), ident, dtype=x.dtype,
                                                  device=x.device))
            if st == np.uint64 and op != "sum":     # unsigned order
                key = filled ^ torch.tensor(-(1 << 63), device=x.device)
                key = torch.where(m, key, torch.full(
                    (), (1 << 63) - 1 if op == "min" else -(1 << 63),
                    dtype=x.dtype, device=x.device))
                red = key.amin(-1) if op == "min" else key.amax(-1)
                data = red ^ torch.tensor(-(1 << 63), device=x.device)
            elif filled.shape[-1]:
                data = filled.amin(-1) if op == "min" else filled.amax(-1)
            else:
                data = torch.zeros(filled.shape[:-1], dtype=x.dtype,
                                   device=x.device)
            data = torch.where(lens > 0, data, zero)
        return ColVal(out_dtype, data, _and_validity(args))
    return resolve, ex


for _n, _op, _ot in [("arraySum", "sum",
                      lambda t: dt.Float64 if dt.is_float(t) else dt.Int64),
                     ("arrayAvg", "avg", lambda t: dt.Float64),
                     ("arrayMin", "min", lambda t: t),
                     ("arrayMax", "max", lambda t: t)]:
    _r, _e = _arr_reduce(_op, _ot)
    register(_n, _r, _e)


def _empty_array_int64_exec(args, out_dtype):
    dev = args[0].data.device if args else torch.device("cpu")
    return ColVal(out_dtype, torch.zeros(8, dtype=torch.int64, device=dev),
                  lengths=torch.zeros((), dtype=torch.int32, device=dev))


register("emptyArrayInt64", lambda ts: dt.Array(dt.Int64),
         _empty_array_int64_exec)


def _exec_range(args, out_dtype):
    """range(n): [0, 1, ..., n - 1] as UInt64, n a constant or a column
    whose proven bound is at most 2^16 (the reference's limit)."""
    a = args[0]
    if len(args) > 1:
        raise NotImplementedError_("range(start, end[, step]) with multiple "
                                   "arguments is not supported yet")
    hi = None
    if a.is_const:
        h = _host_number(a)
        hi = int(h) if h is not None else int(_as(a, np.int64).item())
    if hi is None and a.bounds is not None:
        hi = int(a.bounds[1])
    if hi is None or hi > (1 << 16):
        raise NotImplementedError_("range() needs a bounded length")
    width = max(hi, 1)
    dev = a.data.device
    elems = torch.arange(width, dtype=torch.int64, device=dev)
    if a.is_const:
        return ColVal(out_dtype, elems[:max(hi, 0)], None,
                      lengths=torch.tensor(max(hi, 0), dtype=torch.int32,
                                           device=dev))
    lens = _as(a, np.int64).clamp(0, width).to(torch.int32)
    mat = torch.where(elems[None, :] < lens[:, None], elems[None, :],
                      torch.zeros((), dtype=torch.int64, device=dev))
    return ColVal(out_dtype, mat, a.validity, lengths=lens)


register("range", lambda ts: dt.Array(dt.UInt64), _exec_range,
         case_insensitive=True)


# -- type conversions --------------------------------------------------------

def _conv(name, target: dt.DType):
    def resolve(ts):
        return target.with_nullable(ts[0].nullable)

    def ex(args, out_dtype):
        from .conv import cast_exec
        return cast_exec(args[:1], out_dtype)

    register(name, resolve, ex)


for _t in [dt.Int8, dt.Int16, dt.Int32, dt.Int64, dt.UInt8, dt.UInt16,
           dt.UInt32, dt.UInt64, dt.Float32, dt.Float64]:
    _conv(f"to{_t.name}", _t)
register("toBool", lambda ts: dt.Boolean.with_nullable(ts[0].nullable),
         lambda args, t: ColVal(t, _bool_data(args[0]).to(torch.uint8),
                                _and_validity(args)))


def _to_string_exec(args, out_dtype):
    a = args[0]
    if a.dtype.is_dictionary:
        if dt.remove_nullable(a.dtype).fixed_len is not None:
            raise NotImplementedError_(
                "toString(FixedString) is not ported to the CUDA engine yet")
        return ColVal(out_dtype, a.data, a.validity, a.dictionary)
    from .conv import cast_exec
    return cast_exec(args[:1], out_dtype)


register("toString", lambda ts: dt.String.with_nullable(ts[0].nullable),
         _to_string_exec)

from . import conv as _conv_module  # noqa: E402,F401  (registers _cast etc.)
from . import functions_ext as _ext_module  # noqa: E402,F401
from . import functions_ext5 as _ext5_module  # noqa: E402,F401
from . import functions_state as _state_module  # noqa: E402,F401
