"""The civil calendar over a Date or DateTime column (K12).

Every calendar function of the scalar registry (the parts ``toYear`` …
``toSecond``, the packed ``toYYYYMMDD`` numbers, the relative numbers, the
starts of a period, ``toDate``, the month step of ``plus``/``minus`` and
``dateDiff``'s month number) is one op of :func:`calendar_part`: one pass
over the column's storage as it is stored (int8/int16/int32/int64 under
``core/column.narrow_storage``), the result written in its type's storage.

Reference: ``_civil_from_days`` (clickhouse_tpu/exprs/functions.py:1043),
``_days_from_civil`` (:1059) and ``_days_in_month`` (:230), Howard
Hinnant's integer algorithms, which XLA fuses into the query's one jitted
program.  Run eagerly in plain torch, each of their ≈25 int64 operations is
a pass over the column; K12 (``csrc/calendar_part.cu``) computes one op a
row in registers.  Division and modulo floor, as ``jnp.floor_divide``.

The kernel is one instance for each (op, output storage) pair of
:data:`INSTANCES` and each input storage.  int8/int16/int32 storage runs
in 32-bit arithmetic; a divisor known only at run time comes with the
multiplier :func:`magic` computes, and the other constants folded
(:func:`fold`).  A constant the 32-bit path cannot hold exactly
(:func:`narrow_ok`: a period above 2^31 units, months above 2^30) takes
the int64 instance over the column widened to int64.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ..core import dtypes as dt
from . import _native

__all__ = ["OPS", "INSTANCES", "civil_from_days", "days_from_civil",
           "days_in_month", "calendar_part", "magic", "fold", "narrow_ok",
           "K12Args"]

# op name -> code (CalOp of csrc/calendar_part.cu).  c0 and c1 are the
# op's int64 constants where it takes them.
OPS = {
    "year": 0, "quarter": 1, "month": 2, "day_of_month": 3,
    "day_of_year": 4, "day_of_week": 5, "iso_year": 6, "iso_week": 7,
    "hour": 8, "minute": 9, "second": 10,
    "yyyymm": 11, "yyyymmdd": 12, "yyyymmddhhmmss": 13,
    "relative_quarter": 14,
    "relative_month": 15,       # y * 12 + m (also dateDiff's month index)
    "relative_week": 16,
    "floor_seconds": 17,        # floor(seconds / c0)
    "day_number": 18,           # the day + c0
    "start_of_months": 19,      # first day of the c0-month period (days)
    "start_of_days": 20,        # d - mod(d + c1, c0) (days)
    "last_day_of_week": 21,     # d - mod(d + c0, 7) + 6 (days)
    "start_of_seconds": 22,     # s - mod(s + c1, c0) (seconds)
    "last_day_of_month": 23,
    "add_months": 24,           # c0 months on, the day clamped (input unit)
}

_SECS_A_DAY = 86400


# the (op, output storage) pairs that have a kernel instance (K12_INSTANCES
# of csrc/calendar_part.cu): every use the functions make of K12
INSTANCES = {
    "year": (torch.int32,), "quarter": (torch.uint8,),
    "month": (torch.uint8,), "day_of_month": (torch.uint8,),
    "day_of_year": (torch.int32,), "day_of_week": (torch.uint8,),
    "iso_year": (torch.int32,), "iso_week": (torch.uint8,),
    "hour": (torch.uint8,), "minute": (torch.uint8,),
    "second": (torch.uint8,), "yyyymm": (torch.int64,),
    "yyyymmdd": (torch.int64,), "yyyymmddhhmmss": (torch.int64,),
    "relative_quarter": (torch.int64,), "relative_month": (torch.int64,),
    "relative_week": (torch.int64,), "floor_seconds": (torch.int64,),
    "day_number": (torch.int32, torch.int64),
    "start_of_months": (torch.int32,), "start_of_days": (torch.int32,),
    "last_day_of_week": (torch.int32,), "start_of_seconds": (torch.int64,),
    "last_day_of_month": (torch.int32,),
    "add_months": (torch.int32, torch.int64)}
# the ops that divide by c0 at run time
_DIVIDES = ("floor_seconds", "start_of_days", "start_of_seconds",
            "start_of_months")


class K12Args(ctypes.Structure):
    """ChttCalArgs of csrc/calendar_part.cu (one call of K12)."""
    _fields_ = [("x", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("c0", ctypes.c_longlong),
                ("c1", ctypes.c_longlong), ("f0", ctypes.c_longlong),
                ("f1", ctypes.c_longlong), ("div64", ctypes.c_ulonglong),
                ("mul64", ctypes.c_ulonglong), ("div32", ctypes.c_uint),
                ("mul32", ctypes.c_uint), ("log32", ctypes.c_int),
                ("log64", ctypes.c_int), ("in_dtype", ctypes.c_int),
                ("out_dtype", ctypes.c_int), ("op", ctypes.c_int),
                ("seconds", ctypes.c_int), ("mask_bits", ctypes.c_int),
                ("vec", ctypes.c_int)]


def magic(d: int, bits: int) -> Tuple[int, int]:
    """(m, l) for dividing by d, 1 <= d < 2^bits, with one multiply-high
    (Granlund and Montgomery, "Division by invariant integers using
    multiplication", PLDI 1994, Figure 4.1): l = ceil(log2 d), m =
    floor(2^bits (2^l - d) / d) + 1 (the low bits of the bits + 1-bit
    multiplier 2^bits + m), and for every n < 2^bits, t = (m n) >> bits:
    n // d = (t + ((n - t) >> min(l, 1))) >> max(l - 1, 0)."""
    if not 1 <= d < 1 << bits:
        raise ValueError(f"magic: divisor {d} outside [1, 2^{bits})")
    l = (d - 1).bit_length()
    return ((1 << bits) * ((1 << l) - d)) // d + 1, l


def narrow_ok(op: str, c0: int, c1: int) -> bool:
    """Whether K12's 32-bit path holds op's constants exactly: a period
    (start_of_days, start_of_seconds) of at most 2^31, months of at most
    2^30 (start_of_months), a month step of at most 2^30 years, anchors
    below 2^62 (so c + x never leaves int64 in the plain version)."""
    if op in ("start_of_days", "start_of_seconds"):
        return c0 <= 1 << 31 and abs(c1) < 1 << 62
    if op == "start_of_months":
        return c0 <= 1 << 30
    if op == "add_months":
        return abs(c0) <= 12 << 30
    if op == "last_day_of_week":
        return abs(c0) < 1 << 62
    return True


def fold(op: str, c0: int, c1: int) -> Tuple[int, int]:
    """(f0, f1): the 32-bit path's constants.  The anchor of a period
    modulo its width (c1 mod c0), of a week modulo 7 (c0 mod 7), and a
    month step as whole years and the months left (c0 = 12 f0 + f1)."""
    if op in ("start_of_days", "start_of_seconds"):
        return 0, c1 % c0
    if op == "last_day_of_week":
        return c0 % 7, 0
    if op == "add_months":
        return c0 // 12, c0 % 12
    return 0, 0


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def civil_from_days(z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """(year, month, day) int64 of day numbers z (days since 1970-01-01)."""
    z = z.to(torch.int64) + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    return y + (m <= 2).to(torch.int64), m, d


def days_from_civil(y: torch.Tensor, m: torch.Tensor,
                    d: torch.Tensor) -> torch.Tensor:
    """Day numbers of (year, month, day), int64."""
    y = y - (m <= 2).to(torch.int64)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


_MONTH_DAYS = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def days_in_month(y: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The length of month m of year y, int64."""
    leap = ((torch.remainder(y, 4) == 0) & (torch.remainder(y, 100) != 0)) \
        | (torch.remainder(y, 400) == 0)
    base = torch.tensor(_MONTH_DAYS, dtype=torch.int64, device=m.device)
    d = base[torch.clamp(m - 1, 0, 11)]
    return torch.where((m == 2) & leap, torch.full_like(d, 29), d)


def _plain_op(v: torch.Tensor, op: int, seconds: bool, c0: int,
              c1: int) -> torch.Tensor:
    """The op over int64 values v (seconds, or days), int64."""
    secs = v if seconds else v * _SECS_A_DAY
    days = _fdiv(v, _SECS_A_DAY) if seconds else v
    one = torch.ones_like(days)
    if op == OPS["hour"]:
        return torch.remainder(_fdiv(secs, 3600), 24)
    if op == OPS["minute"]:
        return torch.remainder(_fdiv(secs, 60), 60)
    if op == OPS["second"]:
        return torch.remainder(secs, 60)
    if op == OPS["floor_seconds"]:
        return _fdiv(secs, c0)
    if op == OPS["day_number"]:
        return days + c0
    if op == OPS["day_of_week"]:
        return torch.remainder(days + 3, 7) + 1
    if op == OPS["relative_week"]:
        return _fdiv(days + 4, 7)
    if op == OPS["start_of_days"]:
        return days - torch.remainder(days + c1, c0)
    if op == OPS["last_day_of_week"]:
        return days - torch.remainder(days + c0, 7) + 6
    if op == OPS["start_of_seconds"]:
        return secs - torch.remainder(secs + c1, c0)
    if op in (OPS["iso_year"], OPS["iso_week"]):
        thursday = days - torch.remainder(days + 3, 7) + 3
        y = civil_from_days(thursday)[0]
        if op == OPS["iso_year"]:
            return y
        return _fdiv(thursday - days_from_civil(y, one, one), 7) + 1
    y, m, d = civil_from_days(days)
    if op == OPS["year"]:
        return y
    if op == OPS["quarter"]:
        return _fdiv(m + 2, 3)
    if op == OPS["month"]:
        return m
    if op == OPS["day_of_month"]:
        return d
    if op == OPS["day_of_year"]:
        return days - days_from_civil(y, one, one) + 1
    if op == OPS["yyyymm"]:
        return y * 100 + m
    if op == OPS["yyyymmdd"]:
        return y * 10000 + m * 100 + d
    if op == OPS["yyyymmddhhmmss"]:
        rem = secs - days * _SECS_A_DAY
        hms = _fdiv(rem, 3600) * 10000 \
            + torch.remainder(_fdiv(rem, 60), 60) * 100 \
            + torch.remainder(rem, 60)
        return (y * 10000 + m * 100 + d) * 1000000 + hms
    if op == OPS["relative_quarter"]:
        return y * 4 + _fdiv(m - 1, 3)
    if op == OPS["relative_month"]:
        return y * 12 + m
    if op == OPS["start_of_months"]:
        months = _fdiv(y * 12 + (m - 1), c0) * c0
        ny = _fdiv(months, 12)
        return days_from_civil(ny, months - ny * 12 + 1, one)
    if op == OPS["last_day_of_month"]:
        ny = torch.where(m == 12, y + 1, y)
        nm = torch.where(m == 12, one, m + 1)
        return days_from_civil(ny, nm, one) - 1
    if op == OPS["add_months"]:
        tot = y * 12 + (m - 1) + c0
        ny = _fdiv(tot, 12)
        nm = tot - ny * 12 + 1
        out = days_from_civil(ny, nm, torch.minimum(d, days_in_month(ny, nm)))
        return out * _SECS_A_DAY + (secs - days * _SECS_A_DAY) if seconds \
            else out
    raise ValueError(f"calendar_part: no op {op}")


_IN_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64)
_OP_NAMES = {v: k for k, v in OPS.items()}
_MASK_BITS = {np.dtype("uint8"): 8, np.dtype("uint16"): 16,
              np.dtype("uint32"): 32}


def calendar_part(x: torch.Tensor, op: str, seconds: bool, out_np,
                  c0: int = 0, c1: int = 0) -> torch.Tensor:
    """Calendar op `op` (a name of OPS) of each value of x: seconds since
    1970-01-01 (seconds=True, a DateTime) or days (a Date), in any signed
    integer storage.  The result is op's int64 value cast to the logical
    numpy type `out_np` (wrapping, as numpy's astype), in its storage
    under the unsigned rule of core/dtypes.py; x's shape (0-d for a
    constant) is kept."""
    if x.dtype not in _IN_DTYPES:
        raise ValueError(f"calendar_part: no kernel input type {x.dtype}")
    code = OPS[op]
    if op in ("floor_seconds", "start_of_days", "start_of_seconds") \
            and c0 <= 0:
        raise ValueError(f"calendar_part: {op} needs a width c0 > 0")
    out_np = np.dtype(out_np)
    if x.device.type == "cpu":
        return _calendar_part_plain(x, op, seconds, out_np, c0, c1)
    if x.device.type != "cuda":
        raise RuntimeError(f"calendar_part: no kernel for {x.device}")
    return _calendar_part_cuda(x, code, seconds, out_np, int(c0), int(c1))


def _calendar_part_plain(x: torch.Tensor, op: str, seconds: bool, out_np,
                         c0: int = 0, c1: int = 0) -> torch.Tensor:
    """calendar_part in plain torch, on x's device: ≈25 int64 passes."""
    r = _plain_op(x.to(torch.int64), OPS[op], seconds, int(c0), int(c1))
    return dt.cast_tensor(r, np.int64, np.dtype(out_np))


def _calendar_part_cuda(x, code: int, seconds: bool, out_np, c0: int,
                        c1: int) -> torch.Tensor:
    dev = x.device
    op = _OP_NAMES[code]
    want = dt.torch_dtype_of(out_np)
    if want not in INSTANCES[op]:
        raise ValueError(f"calendar_part: no kernel instance of {op} into "
                         f"{want}")
    if op in _DIVIDES and c0 <= 0:
        raise ValueError(f"calendar_part: {op} needs a width c0 > 0")
    flat = x.reshape(-1)
    if flat.dtype != torch.int64 and not narrow_ok(op, c0, c1):
        flat = flat.to(torch.int64)             # the 64-bit instance
    if not flat.is_contiguous():
        flat = flat.contiguous()
    out = torch.empty(flat.shape, dtype=want, device=dev)
    n = flat.numel()
    if n == 0:
        return out.reshape(x.shape)             # no launch
    f0, f1 = fold(op, c0, c1) if flat.dtype != torch.int64 else (0, 0)
    d64 = c0 if op in _DIVIDES else 1
    d32 = min(d64, 1 << 31)
    mul32, log32 = magic(d32, 32)
    mul64, log64 = magic(d64, 64)
    args = K12Args(flat.data_ptr(), out.data_ptr(), n, c0, c1, f0, f1, d64,
                   mul64, d32, mul32, log32, log64,
                   _native.dtype_code(flat.dtype),
                   _native.dtype_code(out.dtype), code, int(seconds),
                   _MASK_BITS.get(out_np, 0),
                   int(flat.data_ptr() % 16 == 0))
    rc = _native.library().chtt_calendar_part(
        ctypes.byref(args), _native.grid_blocks(dev, (n + 7) // 8),
        _native.stream_ptr(dev))
    _native.check(rc, "calendar_part")
    _native.count_launch("calendar_part", n)
    return out.reshape(x.shape)
