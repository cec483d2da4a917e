"""Extended scalar functions (reference: clickhouse_tpu/exprs/
functions_ext.py), in its file order: the math extras (:24-110), the bit
extras (:110-170), the date extras (:517-650), toMonday, toTimeZone and
toStartOfInterval (:1774-1830), and the vector math over Array columns
(:2174-2320).

Vector math (ClickHouse's src/Functions/array/arrayDistance.cpp):
L2Distance, L2SquaredDistance, L1Distance, LinfDistance, dotProduct and
cosineDistance of two arrays, and L2Norm and L1Norm of one.  The result is
Float32 when every argument is Array(Float32), else Float64 (the
reference's type rule, which keeps ORDER BY distance LIMIT k on K3's
32-bit entry).

Two forms, chosen as the reference chooses them:
  * a column of at least MXU_DISTANCE_MIN_ROWS rows (the block's
    capacity) against one constant query vector: cosine, L2, L2Squared and
    dotProduct are computed in float32 from the parts dot, |a|^2 and the
    length-masked |q|^2 by K11 (ops/vector_ops.vector_distance) and cast to
    the result type;
  * every other case: float64 elementwise over the rows masked by the first
    argument's lengths.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import dtypes as dt
from ..core.column import Dictionary
from ..core.errors import TypeError_
from ..ops import vector_ops
from .expr import ColVal
from .functions import (_MONTHS_A_UNIT, _SECONDS_A_UNIT, _SIGN, MONDAY,
                        _and_validity, _array_arg, _as, _cal, _elem_mask,
                        _f64_to_i64, _f64_to_u64, _float_binary,
                        _float_unary, _host_int, _register_cal,
                        _resolve_arith, _resolve_float, register)

__all__ = ["MXU_DISTANCE_MIN_ROWS"]

# the block capacity from which a distance to a constant query takes the
# float32 form (the reference's _MXU_DISTANCE_MIN_ROWS)
MXU_DISTANCE_MIN_ROWS = 1 << 16


# -- math extras -------------------------------------------------------------

for _n, _op in [
    ("sinh", torch.sinh), ("cosh", torch.cosh), ("asinh", torch.asinh),
    ("acosh", torch.acosh), ("atanh", torch.atanh), ("log1p", torch.log1p),
    ("expm1", torch.expm1), ("degrees", torch.rad2deg),
    ("radians", torch.deg2rad),
]:
    register(_n, _resolve_float, _float_unary(_op), case_insensitive=True)

register("hypot", _resolve_float, _float_binary(torch.hypot),
         case_insensitive=True)


def _u64_of(a: ColVal) -> torch.Tensor:
    """The argument as uint64 bits (int64): an integer wraps, a float
    truncates and saturates (numpy's astype, XLA's convert)."""
    if dt.remove_nullable(a.dtype).np_dtype.kind == "f":
        return _f64_to_u64(_as(a, np.float64))
    return _as(a, np.uint64)


def _i64_of(a: ColVal) -> torch.Tensor:
    if dt.remove_nullable(a.dtype).np_dtype.kind == "f":
        return _f64_to_i64(_as(a, np.float64))
    return _as(a, np.int64)


def _int_exp2_exec(args, out_dtype):
    x = _u64_of(args[0])                      # clip(x, 0, 63), unsigned
    s = torch.where((x < 0) | (x > 63), torch.full_like(x, 63), x)
    return ColVal(out_dtype, torch.ones_like(s) << s, _and_validity(args))


def _int_exp10_exec(args, out_dtype):
    x = torch.clamp(_as(args[0], np.float64), 0, 19)
    return ColVal(out_dtype, _f64_to_u64(torch.pow(10.0, x)),
                  _and_validity(args))


register("intExp2", lambda ts: dt.UInt64.with_nullable(ts[0].nullable),
         _int_exp2_exec)
register("intExp10", lambda ts: dt.UInt64.with_nullable(ts[0].nullable),
         _int_exp10_exec)

_FACTORIALS = [math.factorial(i) for i in range(21)]


def _factorial_exec(args, out_dtype):
    x = torch.clamp(_i64_of(args[0]), 0, 20)
    lut = torch.tensor(_FACTORIALS, dtype=torch.int64, device=x.device)
    return ColVal(out_dtype, lut[x], _and_validity(args))


register("factorial", lambda ts: dt.UInt64.with_nullable(ts[0].nullable),
         _factorial_exec, case_insensitive=True)


def _gcd_abs(args):
    a, b = torch.broadcast_tensors(torch.abs(_i64_of(args[0])),
                                   torch.abs(_i64_of(args[1])))
    return a, b


def _gcd_of(a, b):
    # the reference's 63 Euclid steps, with its floor modulo
    for _ in range(63):
        nz = b != 0
        a, b = torch.where(nz, b, a), torch.where(
            nz, torch.remainder(a, torch.where(nz, b, torch.ones_like(b))), b)
    return a


def _gcd_exec(args, out_dtype):
    return ColVal(out_dtype, _gcd_of(*_gcd_abs(args)), _and_validity(args))


def _lcm_exec(args, out_dtype):
    a, b = _gcd_abs(args)
    g = _gcd_of(a, b)
    safe = torch.clamp(g, min=1)
    data = torch.where(g > 0, torch.div(a, safe, rounding_mode="floor") * b,
                       torch.zeros_like(g))
    return ColVal(out_dtype, data, _and_validity(args))


register("gcd", lambda ts: dt.Int64.with_nullable(
    ts[0].nullable or ts[1].nullable), _gcd_exec, case_insensitive=True)
register("lcm", lambda ts: dt.Int64.with_nullable(
    ts[0].nullable or ts[1].nullable), _lcm_exec, case_insensitive=True)


def _if_not_finite_exec(args, out_dtype):
    x, y = _as(args[0], np.float64), _as(args[1], np.float64)
    return ColVal(out_dtype, torch.where(torch.isfinite(x), x, y),
                  _and_validity(args))


register("ifNotFinite", lambda ts: dt.Float64.with_nullable(
    ts[0].nullable or ts[1].nullable), _if_not_finite_exec)


def _round_to_exp2_exec(args, out_dtype):
    """The greatest power of two <= x's integer image (2^62 at most), 0
    below 1: exact (the reference's float log2 of XLA gives 2^(k-1) at some
    powers 2^k)."""
    x = _i64_of(args[0])
    e = torch.floor(torch.log2(torch.clamp(x, min=1).to(torch.float64)))
    p = torch.ones_like(x) << torch.clamp(_f64_to_i64(e), 0, 62)
    p = torch.where(p > x, p >> 1, p)            # x rounded up to 2^k
    data = torch.where(x <= 0, torch.zeros_like(p), p)
    return ColVal(out_dtype, dt.cast_tensor(
        data, np.int64, dt.remove_nullable(out_dtype).np_dtype),
        _and_validity(args))


register("roundToExp2", _resolve_arith(), _round_to_exp2_exec)


# -- bit extras --------------------------------------------------------------

_BYTE_BITS = torch.tensor([bin(i).count("1") for i in range(256)],
                          dtype=torch.uint8)


def _popcount64(x: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 words, uint8."""
    lut = _BYTE_BITS.to(x.device)
    out = torch.zeros(x.shape, dtype=torch.uint8, device=x.device)
    for i in range(8):
        out += lut[(x >> (8 * i)) & 0xFF]
    return out


def _bit_count_exec(args, out_dtype):
    a = args[0]
    if dt.remove_nullable(a.dtype).np_dtype.kind == "f":
        bits = _as(a, np.float64).view(torch.int64)
    else:
        bits = _as(a, np.int64)
    return ColVal(out_dtype, _popcount64(bits), _and_validity(args))


register("bitCount", lambda ts: dt.UInt8.with_nullable(ts[0].nullable),
         _bit_count_exec)


def _rotate_exec(left: bool):
    def ex(args, out_dtype):
        x = _u64_of(args[0])
        s = _u64_of(args[1]) & 63
        r = (64 - s) & 63

        def lsr(v, k):                    # logical shift right of bits
            return torch.where(k == 0, v, ((v >> 1) & ~_SIGN)
                               >> (k - 1).clamp(min=0))
        data = (x << s) | lsr(x, r) if left else lsr(x, s) | (x << r)
        return ColVal(out_dtype, dt.cast_tensor(
            data, np.uint64, dt.remove_nullable(out_dtype).np_dtype),
            _and_validity(args))
    return ex


register("bitRotateLeft", _resolve_arith(), _rotate_exec(True))
register("bitRotateRight", _resolve_arith(), _rotate_exec(False))


def _bit_test_exec(args, out_dtype):
    s = torch.clamp(_i64_of(args[1]), 0, 63)
    return ColVal(out_dtype, ((_i64_of(args[0]) >> s) & 1).to(torch.uint8),
                  _and_validity(args))


register("bitTest", lambda ts: dt.UInt8.with_nullable(
    ts[0].nullable or ts[1].nullable), _bit_test_exec)
register("bitHammingDistance", lambda ts: dt.UInt8.with_nullable(
    ts[0].nullable or ts[1].nullable),
    lambda args, t: ColVal(t, _popcount64(_i64_of(args[0])
                                          ^ _i64_of(args[1])),
                           _and_validity(args)))


def _byte_swap_exec(args, out_dtype):
    st = dt.remove_nullable(out_dtype).np_dtype
    nbytes = st.itemsize
    x = _u64_of(args[0])
    out = torch.zeros_like(x)
    for i in range(nbytes):
        out = out | (((x >> (8 * i)) & 0xFF) << (8 * (nbytes - 1 - i)))
    return ColVal(out_dtype, dt.cast_tensor(out, np.uint64, st),
                  _and_validity(args))


register("byteSwap", _resolve_arith(), _byte_swap_exec)


# -- date extras -------------------------------------------------------------
# Each a K12 op (functions._cal).

_register_cal("toQuarter", dt.UInt8, "quarter", case_insensitive=True)
_register_cal("toDayOfYear", dt.UInt16, "day_of_year")
_register_cal("toISOYear", dt.UInt16, "iso_year")
_register_cal("toISOWeek", dt.UInt8, "iso_week")
_register_cal("toStartOfQuarter", dt.Date, "start_of_months", c0=3)
_register_cal("toLastDayOfMonth", dt.Date, "last_day_of_month")
for _n, _secs in (("toStartOfFiveMinutes", 300), ("toStartOfTenMinutes", 600),
                  ("toStartOfFifteenMinutes", 900), ("toStartOfSecond", 1),
                  ("timeSlot", 1800)):
    _register_cal(_n, dt.DateTime, "start_of_seconds", mode="time", c0=_secs)

_MONTHS = ["January", "February", "March", "April", "May", "June", "July",
           "August", "September", "October", "November", "December"]


def _month_name_exec(args, out_dtype):
    m = _cal(args[0], "month", dt.UInt8)
    codes = torch.clamp(m.data.to(torch.int32) - 1, 0, 11)
    return ColVal(out_dtype, codes, m.validity,
                  Dictionary(np.asarray(_MONTHS, object)))


register("monthName", lambda ts: dt.String.with_nullable(ts[0].nullable),
         _month_name_exec)

# dateTrunc's units of a day and up: the K12 op that gives the period's
# first day
_TRUNC_DAYS = {"year": ("start_of_months", 12, 0),
               "quarter": ("start_of_months", 3, 0),
               "month": ("start_of_months", 1, 0),
               "week": ("start_of_days", 7, MONDAY),
               "day": ("day_number", 0, 0)}
_BELOW_A_DAY = ("second", "minute", "hour")


def _date_trunc_exec(args, out_dtype):
    """The period's start in the argument's type: a DateTime its first
    second, a Date its first day (the reference passes the day number of a
    year, quarter, month or week through as seconds, and a Date's seconds
    through as days)."""
    unit = str(args[0].dictionary.values[0]).lower()
    x = args[1]
    tname = dt.remove_nullable(x.dtype).name
    if tname not in ("Date", "DateTime"):
        raise TypeError_(f"Illegal type {x.dtype} of argument of function "
                         f"dateTrunc")
    if unit in _BELOW_A_DAY and tname == "DateTime":
        return _cal(x, "start_of_seconds", out_dtype,
                    c0=_SECONDS_A_UNIT[unit.capitalize()])
    if unit in _BELOW_A_DAY:
        unit = "day"                        # a Date is its own midnight
    if unit not in _TRUNC_DAYS:
        raise TypeError_(f"dateTrunc: unsupported unit '{unit}'")
    op, c0, c1 = _TRUNC_DAYS[unit]
    if tname == "DateTime" and unit == "day":
        return _cal(x, "start_of_seconds", out_dtype, c0=86400)
    day = _cal(x, op, dt.Date, c0=c0, c1=c1)
    data = day.data if tname == "Date" else day.data.to(torch.int64) * 86400
    return ColVal(out_dtype, data, day.validity)


register("dateTrunc", lambda ts: ts[1], _date_trunc_exec,
         case_insensitive=True)
register("date_trunc", lambda ts: ts[1], _date_trunc_exec,
         case_insensitive=True)
register("fromUnixTimestamp",
         lambda ts: dt.DateTime.with_nullable(ts[0].nullable),
         lambda args, t: ColVal(t, _as(args[0], np.int64),
                                _and_validity(args)),
         case_insensitive=True)


# -- date-time batch (reference :1774-1830) ----------------------------------

register("toMonday", lambda ts: dt.Date.with_nullable(ts[0].nullable),
         lambda args, t: _cal(args[0], "start_of_days", t, c0=7, c1=MONDAY),
         case_insensitive=True)
# the engine stores civil time as is (one zone a session): toTimeZone
# relabels
register("toTimeZone", lambda ts: ts[0],
         lambda args, t: ColVal(t, args[0].data, args[0].validity),
         case_insensitive=True)

def _start_of_interval_exec(args, out_dtype):
    x, iv = args
    unit = dt.remove_nullable(iv.dtype).name.replace("Interval", "").lower()
    n = max(_host_int(iv), 1)
    is_date = dt.remove_nullable(x.dtype).name == "Date"
    if unit in _BELOW_A_DAY and not is_date:
        return _cal(x, "start_of_seconds", out_dtype, mode="secs",
                    c0=_SECONDS_A_UNIT[unit.capitalize()] * n)
    if unit == "day":
        return _cal(x, "start_of_days", out_dtype, mode="secs", c0=n)
    if unit == "week":
        return _cal(x, "start_of_days", out_dtype, mode="secs", c0=7 * n,
                    c1=MONDAY)
    if unit.capitalize() in _MONTHS_A_UNIT:
        return _cal(x, "start_of_months", out_dtype,
                    c0=_MONTHS_A_UNIT[unit.capitalize()] * n)
    raise TypeError_(f"toStartOfInterval: unsupported unit '{unit}'")


def _resolve_start_of_interval(ts):
    unit = ts[1].name.replace("Interval", "").lower()
    out = dt.DateTime if unit in _BELOW_A_DAY else dt.Date
    return out.with_nullable(ts[0].nullable)


register("toStartOfInterval", _resolve_start_of_interval,
         _start_of_interval_exec, case_insensitive=True)


# -- vector math over Array columns ------------------------------------------

def _arrfn(ex):
    """Give a constant (1-d) array argument a row dimension (and 1-d
    lengths) for the exec, and a column without lengths full-width ones;
    return a constant when every array argument was one."""
    def wrapped(args, out_dtype):
        new_args = []
        all_const = True
        saw_array = False
        for a in args:
            if not dt.remove_nullable(a.dtype).is_array:
                new_args.append(a)
                continue
            saw_array = True
            if a.data.dim() == 1:
                lens = a.lengths
                if lens is None:
                    lens = torch.full((1,), a.data.shape[0],
                                      dtype=torch.int32,
                                      device=a.data.device)
                a = ColVal(a.dtype, a.data[None, :], a.validity,
                           a.dictionary, host=a.host,
                           lengths=lens.reshape(1))
            else:
                if a.lengths is None:
                    a = ColVal(a.dtype, a.data, a.validity, a.dictionary,
                               host=a.host, lengths=torch.full(
                                   (a.data.shape[0],), a.data.shape[1],
                                   dtype=torch.int32, device=a.data.device))
                all_const = False
            new_args.append(a)
        out = ex(new_args, out_dtype)
        if saw_array and all_const and out.data.dim() >= 1 \
                and out.data.shape[0] == 1:
            lens = out.lengths
            return ColVal(out.dtype, out.data[0], out.validity,
                          out.dictionary, lengths=None if lens is None
                          else lens.reshape(()))
        return out
    return wrapped


# -- array functions of ARRAY JOIN (reference: functions_ext.py:929-1182) --

def _arr_same(ts):
    return ts[0]


def _exec_array_concat(args, out_dtype):
    """arrayConcat(a, b, ...): each row's elements one array after
    another, in a matrix as wide as the arguments' together."""
    arrs = [_array_arg(a) for a in args]
    inner = dt.array_inner(dt.remove_nullable(out_dtype)).np_dtype
    cap = max(a.data.shape[0] for a in arrs)
    width = sum(a.data.shape[1] for a in arrs)
    dev = arrs[0].data.device
    j = torch.arange(width, dtype=torch.int64, device=dev)[None, :]
    out = torch.zeros((cap, width), dtype=dt.torch_dtype_of(inner),
                      device=dev)
    offset = torch.zeros((cap, 1), dtype=torch.int64, device=dev)
    for a in arrs:
        w = a.data.shape[1]
        data = dt.cast_tensor(a.data, dt.array_inner(
            dt.remove_nullable(a.dtype)).np_dtype, inner).expand(cap, w)
        lens = a.lengths.to(torch.int64).expand(cap)[:, None]
        rel = j - offset
        take = torch.gather(data, 1, rel.clamp(0, max(w - 1, 0)).expand(
            cap, width))
        out = torch.where((rel >= 0) & (rel < lens), take, out)
        offset = offset + lens
    lens = sum(a.lengths.to(torch.int64).expand(cap) for a in arrs)
    return ColVal(out_dtype, out, _and_validity(args),
                  lengths=lens.clamp(max=width).to(torch.int32))


register("arrayConcat", _arr_same, _arrfn(_exec_array_concat))


def _exec_array_enumerate(args, out_dtype):
    """arrayEnumerate(arr) -> [1, 2, ..., length(arr)]."""
    a = _array_arg(args[0])
    w = max(a.data.shape[1], 1)
    j = torch.arange(1, w + 1, dtype=torch.int64, device=a.data.device)
    data = torch.where(j[None, :] <= a.lengths[:, None].to(torch.int64),
                       j[None, :], torch.zeros((), dtype=torch.int64,
                                               device=j.device))
    return ColVal(out_dtype, data, a.validity, lengths=a.lengths)


register("arrayEnumerate",
         lambda ts: dt.Array(dt.UInt32).with_nullable(ts[0].nullable),
         _arrfn(_exec_array_enumerate))


def _exec_empty_array_to_single(args, out_dtype):
    """emptyArrayToSingle: an empty array becomes [default element] (the
    LEFT ARRAY JOIN primitive)."""
    a = _array_arg(args[0])
    return ColVal(out_dtype, a.data, a.validity,
                  lengths=a.lengths.clamp(min=1))


register("emptyArrayToSingle", _arr_same,
         _arrfn(_exec_empty_array_to_single))


def _rows(x: ColVal) -> torch.Tensor:
    return x.data if x.data.dim() == 2 else x.data[None, :]


def _vec_pair(args):
    """Both arrays as float64 (rows, W) matrices padded to the wider one
    and masked by the first argument's lengths."""
    a, b = _array_arg(args[0]), _array_arg(args[1])
    w = max(a.data.shape[-1], b.data.shape[-1])

    def pad2(x):
        d = _rows(x)
        if d.shape[-1] < w:
            d = torch.nn.functional.pad(d, (0, w - d.shape[-1]))
        return d.to(torch.float64)
    da, db = pad2(a), pad2(b)
    lens = a.lengths
    if lens.dim() == 0:
        lens = lens.expand(max(da.shape[0], db.shape[0]))
    mask = torch.arange(w, device=da.device)[None, :] \
        < lens[:, None].to(torch.int64)
    return da * mask, db * mask


def _kernel_args(args):
    """(A, lengths, q) of K11's form: the first argument a column of at
    least MXU_DISTANCE_MIN_ROWS rows (its capacity) and the second one
    constant query vector; None otherwise.  A is the column as float32
    (a copy only for another element type); q is cut or zero-padded to
    A's width (A is zero past each row's length, which is at most that
    width, so the parts are the reference's, which pads both to the wider
    of the two)."""
    a0, b0 = _array_arg(args[0]), _array_arg(args[1])
    if a0.data.dim() != 2 or _rows(b0).shape[0] != 1 \
            or a0.data.shape[0] < MXU_DISTANCE_MIN_ROWS:
        return None
    A = a0.data.to(torch.float32).contiguous()
    w = A.shape[1]
    q = _rows(b0)[0].to(torch.float32)
    q = q[:w] if q.shape[0] >= w else torch.nn.functional.pad(
        q, (0, w - q.shape[0]))
    return A, a0.lengths.to(torch.int32).contiguous(), q


def _register_distance(name, fn, op=None):
    def exec_(args, out):
        st = dt.remove_nullable(out).torch_dtype
        if op is not None:
            kargs = _kernel_args(args)
            if kargs is not None:
                return ColVal(out, vector_ops.vector_distance(
                    *kargs, op).to(st), _and_validity(args))
        a, b = _vec_pair(args)
        return ColVal(out, fn(a, b).to(st), _and_validity(args))

    def resolve(ts):
        # all-Float32 vectors keep a Float32 result (the reference's rule)
        def inner_f32(t):
            t = dt.remove_nullable(t)
            return t.is_array and dt.array_inner(t).name == "Float32"
        base = dt.Float32 if all(inner_f32(t) for t in ts) else dt.Float64
        return base.with_nullable(any(t.nullable for t in ts))
    register(name, resolve, _arrfn(exec_))


def _cosine(a, b):
    den = torch.sqrt((a * a).sum(-1)) * torch.sqrt((b * b).sum(-1))
    return 1.0 - (a * b).sum(-1) / torch.where(
        den < 1e-300, torch.full_like(den, 1e-300), den)


_register_distance("L2Distance",
                   lambda a, b: torch.sqrt(((a - b) ** 2).sum(-1)), op="l2")
_register_distance("L2SquaredDistance", lambda a, b: ((a - b) ** 2).sum(-1),
                   op="l2squared")
_register_distance("L1Distance", lambda a, b: (a - b).abs().sum(-1))
_register_distance("LinfDistance", lambda a, b: (a - b).abs().amax(-1))
_register_distance("dotProduct", lambda a, b: (a * b).sum(-1), op="dot")
_register_distance("cosineDistance", _cosine, op="cosine")


def _norm_exec(fn):
    def ex(args, out_dtype):
        a = _array_arg(args[0])
        return ColVal(out_dtype, fn(a.data.to(torch.float64) * _elem_mask(a)),
                      _and_validity(args))
    return ex


register("L2Norm", lambda ts: dt.Float64.with_nullable(ts[0].nullable),
         _arrfn(_norm_exec(lambda x: torch.sqrt((x * x).sum(-1)))))
register("L1Norm", lambda ts: dt.Float64.with_nullable(ts[0].nullable),
         _arrfn(_norm_exec(lambda x: x.abs().sum(-1))))
