"""Scalar functions of the reference's sixth batch
(clickhouse_tpu/exprs/functions_ext5.py): the relative date numbers
(:36-118: toRelative{Year,Quarter,Month,Week,Day,Hour,Minute,Second}Num,
toLastDayOfWeek, to/fromDaysSinceYearZero, timezoneOffset, UTCTimestamp,
nowInBlock, serverTimezone) and roundDown (:118-137).

The relative numbers read a Date as its midnight and any other argument
as seconds, as the reference does; each is one K12 op (functions._cal).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtypes as dt
from ..core.column import Dictionary
from .expr import ColVal
from .functions import (FUNCTIONS, SUNDAY, _and_validity, _array_arg, _as,
                        _elem_mask, _register_cal, register)

__all__ = []


def _num(out_t: dt.DType):
    return lambda ts: out_t.with_nullable(any(t.nullable for t in ts))


for _n, _t, _op, _c0 in (
        ("toRelativeYearNum", dt.UInt16, "year", 0),
        ("toRelativeQuarterNum", dt.UInt32, "relative_quarter", 0),
        ("toRelativeMonthNum", dt.UInt32, "relative_month", 0),
        ("toRelativeWeekNum", dt.UInt32, "relative_week", 0),
        ("toRelativeDayNum", dt.UInt32, "day_number", 0),
        ("toRelativeHourNum", dt.UInt32, "floor_seconds", 3600),
        ("toRelativeMinuteNum", dt.UInt32, "floor_seconds", 60),
        ("toRelativeSecondNum", dt.UInt32, "floor_seconds", 1)):
    _register_cal(_n, _t, _op, mode="secs", c0=_c0)

register("UTCTimestamp", FUNCTIONS["now"]._resolve, FUNCTIONS["now"]._execute)
register("nowInBlock", FUNCTIONS["now"]._resolve, FUNCTIONS["now"]._execute)


def _utc(args, out_dtype):
    return ColVal(out_dtype, torch.zeros((), dtype=torch.int32), None,
                  Dictionary(np.asarray(["UTC"], object)))


# the engine's clock is UTC (the reference's timezone())
register("serverTimezone", lambda ts: dt.String, _utc)
register("timezoneOffset", _num(dt.Int32),
         lambda args, t: ColVal(t, torch.zeros_like(args[0].data,
                                                    dtype=torch.int32),
                                _and_validity(args)))

# toLastDayOfWeek(t): the Saturday that ends t's week, which starts on a
# Sunday in ClickHouse's default mode 0 (the reference ends it on Sunday)
_register_cal("toLastDayOfWeek", dt.Date, "last_day_of_week", c0=SUNDAY)

_YEAR_ZERO_OFFSET = 719528          # days from 0000-01-01 to 1970-01-01

_register_cal("toDaysSinceYearZero", dt.UInt32, "day_number",
              c0=_YEAR_ZERO_OFFSET)
register("fromDaysSinceYearZero",
         lambda ts: dt.Date.with_nullable(ts[0].nullable),
         lambda args, t: ColVal(t, dt.cast_tensor(
             _as(args[0], np.int64) - _YEAR_ZERO_OFFSET, np.int64,
             np.int32), _and_validity(args)))


def _round_down_exec(args, out_dtype):
    """roundDown(x, [b1, b2, ...]): the greatest boundary <= x, the first
    one where x lies below all; the boundaries are the array's first row
    within its length (the reference also reads the row's zero padding as
    boundaries)."""
    x = _as(args[0], np.float64)
    b = _array_arg(args[1])
    row, keep = b.data, _elem_mask(b)
    if row.dim() == 2:
        row, keep = row[0], keep[0]
    bounds = row.to(torch.float64)[keep]
    out = torch.full_like(x, float(bounds[0]))
    for i in range(bounds.shape[0]):
        out = torch.where(x >= bounds[i], bounds[i], out)
    return ColVal(out_dtype, out, _and_validity(args))


register("roundDown", _num(dt.Float64), _round_down_exec)
