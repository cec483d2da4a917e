"""Scalar function registry (reference: clickhouse_tpu/exprs/functions.py).

Ported families: comparison, arithmetic, logic, conditional / NULL
handling and casts.  Everything runs as plain elementwise torch on the
block's tensors; string functions work on host dictionaries.  A function
that is not ported surfaces as the reference's typed ``UnknownFunction``
when the analyzer resolves it; a ported function meeting a type it does
not handle yet (Decimal, date arithmetic, Enum) raises
``NotImplementedError_``.

Values follow the unsigned rule of core/dtypes.py: a ColVal's tensor holds
its DType's storage values, with u16 in int32 and u32/u64 in int64, so
arithmetic and comparisons go through ``dt.cast_tensor`` on the logical
numpy types (numpy's promotion rules, as the reference's jnp ops).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from ..core import dtypes as dt
from ..core.column import Dictionary
from ..core.errors import NotImplementedError_, TypeError_, UnknownFunction
from .expr import ColVal, storage_np

__all__ = ["get", "exists", "register", "ScalarFunction", "FUNCTIONS",
           "canonical_name"]

FUNCTIONS: Dict[str, "ScalarFunction"] = {}
_CASE_INSENSITIVE: Dict[str, str] = {}
_SIGN = -(1 << 63)                 # int64 bits of 1 << 63


class ScalarFunction:
    def __init__(self, name: str, resolve: Callable, execute: Callable,
                 case_insensitive: bool = False):
        self.name = name
        self._resolve = resolve
        self._execute = execute
        self.case_insensitive = case_insensitive

    def resolve(self, arg_types: List[dt.DType]) -> dt.DType:
        return self._resolve(arg_types)

    def execute(self, args: List[ColVal], out_dtype: dt.DType) -> ColVal:
        return self._execute(args, out_dtype)


def register(name: str, resolve, execute, case_insensitive=False):
    fn = ScalarFunction(name, resolve, execute, case_insensitive)
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


def _dates_checked(name, op):
    inner = _binary_numeric(op, name)

    def ex(args, out_dtype):
        if any(dt.is_datetime_like(dt.remove_nullable(a.dtype))
               for a in args):
            raise NotImplementedError_(
                f"{name} over Date/DateTime is not ported to the CUDA "
                f"engine yet")
        return inner(args, out_dtype)
    return ex


register("plus", _resolve_arith_dates(), _dates_checked("plus", torch.add))
register("minus", _resolve_arith_dates(signed_force=True),
         _dates_checked("minus", torch.sub))
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


def _const_nonzero(b: ColVal) -> bool:
    """True when the divisor is a nonzero constant (`x % 1024`)."""
    if not b.is_const:
        return False
    return float(b.data.item()) != 0.0


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


def _intdiv_like(which: int, name: str):
    def ex(args, out_dtype):
        _no_decimal_or_dates(name, *(a.dtype for a in args))
        a, b = args
        st = dt.remove_nullable(out_dtype).np_dtype
        x, y = _as(a, st), _as(b, st)
        if x.dim() < y.dim():
            x = x.expand(y.shape)
        uns = st == np.uint64
        if _const_nonzero(b):
            out = _div_rem(x, y.expand(x.shape), uns)[which]
            return ColVal(dt.remove_nullable(out_dtype).with_nullable(
                a.dtype.nullable), out, _and_validity(args))
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
        zero = args[1].data == 0
        data = torch.where(zero, torch.zeros_like(out.data), out.data)
        return ColVal(dt.remove_nullable(out.dtype).with_nullable(
            any(a.dtype.nullable for a in args)), data, _and_validity(args))
    return ex


register("intDiv", _resolve_intdiv, _intdiv_like(0, "intDiv"))
register("intDivOrZero", _resolve_intdiv,
         _or_zero(_intdiv_like(0, "intDivOrZero")))
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
