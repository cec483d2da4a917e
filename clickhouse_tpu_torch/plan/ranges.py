"""Trace-time interval analysis of bound expressions.

The role of the reference's key-type dispatch (AggregatedDataVariants.h picks
FixedHashMap for UInt8/UInt16 keys, src/Common/HashTable/FixedHashMap.h):
when a GROUP BY key's value range is statically provable small — from column
min/max statistics, dictionary sizes, or the shape of the expression
(`k % 1024`, `bitAnd(k, 255)`) — the executor uses a *dense direct-array*
grouping (one segment-reduce, no sort).  This module proves the bounds.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..exprs.expr import BoundCall, BoundColumn, BoundExpr, BoundLiteral

__all__ = ["infer_bounds", "Bounds"]

Bounds = Tuple[int, int]            # inclusive [lo, hi]

_INT_KINDS = ("i", "u")
_CAST_BITS = {"toInt8": 8, "toInt16": 16, "toInt32": 32, "toInt64": 64,
              "toUInt8": 8, "toUInt16": 16, "toUInt32": 32, "toUInt64": 64}


def _dtype_bounds(e: BoundColumn) -> Optional[Bounds]:
    t = e.dtype
    if t.is_dictionary:
        return None                 # the executor knows the dictionary size
    kind = t.np_dtype.kind
    if kind == "u":
        return (0, (1 << (8 * t.itemsize)) - 1)
    if kind == "i":
        half = 1 << (8 * t.itemsize - 1)
        return (-half, half - 1)
    if kind == "b":
        return (0, 1)
    return None


def infer_bounds(e: BoundExpr, field_bounds: Dict[str, Bounds]
                 ) -> Optional[Bounds]:
    """Integer value bounds of a bound expression, or None if unprovable."""
    if isinstance(e, BoundColumn):
        fb = field_bounds.get(e.name)
        if fb is not None:
            return fb
        return _dtype_bounds(e)
    if isinstance(e, BoundLiteral):
        if isinstance(e.value, bool):
            return (int(e.value), int(e.value))
        if isinstance(e.value, int):
            return (e.value, e.value)
        return None
    if isinstance(e, BoundCall):
        return _call_bounds(e, field_bounds)
    return None


def _call_bounds(e: BoundCall, fb: Dict[str, Bounds]) -> Optional[Bounds]:
    name = e.name
    args = e.args

    def b(i):
        return infer_bounds(args[i], fb)

    if name == "plus" and len(args) == 2:
        a, c = b(0), b(1)
        if a and c:
            return (a[0] + c[0], a[1] + c[1])
    elif name == "minus" and len(args) == 2:
        a, c = b(0), b(1)
        if a and c:
            return (a[0] - c[1], a[1] - c[0])
    elif name == "multiply" and len(args) == 2:
        a, c = b(0), b(1)
        if a and c:
            prods = [a[0] * c[0], a[0] * c[1], a[1] * c[0], a[1] * c[1]]
            return (min(prods), max(prods))
    elif name == "negate":
        a = b(0)
        if a:
            return (-a[1], -a[0])
    elif name == "abs":
        a = b(0)
        if a:
            lo = 0 if a[0] <= 0 <= a[1] else min(abs(a[0]), abs(a[1]))
            return (lo, max(abs(a[0]), abs(a[1])))
    elif name == "modulo" and len(args) == 2:
        c = b(1)
        a = b(0)
        if c and c[0] == c[1] and c[0] != 0:
            m = abs(c[0])
            if a and a[0] >= 0:
                return (0, min(m - 1, a[1]))
            # C-style truncated remainder keeps the dividend's sign
            return (-(m - 1), m - 1)
    elif name == "bitAnd" and len(args) == 2:
        for i in (0, 1):
            c = b(i)
            if c and c[0] == c[1] and c[0] >= 0:
                return (0, c[0])
    elif name == "intDiv" and len(args) == 2:
        a, c = b(0), b(1)
        if a and c and c[0] == c[1] and c[0] > 0:
            return (a[0] // c[0] if a[0] >= 0 else -((-a[0]) // c[0]),
                    a[1] // c[0] if a[1] >= 0 else -((-a[1]) // c[0]))
    elif name in _CAST_BITS:
        a = b(0)
        if a is None:
            return None
        bits = _CAST_BITS[name]
        t = (0, (1 << bits) - 1) if name.startswith("toUInt") \
            else (-(1 << (bits - 1)), (1 << (bits - 1)) - 1)
        # a cast that wraps some value of the interval can give any value
        # of its type
        return a if t[0] <= a[0] and a[1] <= t[1] else t
    elif name in ("identity", "materialize", "assumeNotNull", "toNullable"):
        return b(0)
    elif name in ("least",) and len(args) == 2:
        a, c = b(0), b(1)
        if a and c:
            return (min(a[0], c[0]), min(a[1], c[1]))
    elif name in ("greatest",) and len(args) == 2:
        a, c = b(0), b(1)
        if a and c:
            return (max(a[0], c[0]), max(a[1], c[1]))
    elif name == "if" and len(args) == 3:
        a, c = b(1), b(2)
        if a and c:
            return (min(a[0], c[0]), max(a[1], c[1]))
    elif name in ("toYear",):
        return (1900, 2300)
    elif name in ("toMonth",):
        return (1, 12)
    elif name in ("toDayOfMonth",):
        return (1, 31)
    elif name in ("toDayOfWeek",):
        return (1, 7)
    elif name in ("toHour",):
        return (0, 23)
    elif name in ("toMinute", "toSecond"):
        return (0, 59)
    elif name in ("toYYYYMM",):
        return (190001, 230012)
    return None


def predicate_may_hold(e: BoundExpr,
                       field_bounds: Dict[str, Bounds]) -> bool:
    """Conservative interval check: False ONLY when the predicate is
    provably false for every row whose columns lie in field_bounds — the
    per-part pruning test (KeyCondition::checkInRange analog,
    src/Storages/MergeTree/KeyCondition.cpp)."""
    if isinstance(e, BoundCall):
        n = e.name
        a = e.args
        if n == "and":
            return all(predicate_may_hold(x, field_bounds) for x in a)
        if n == "or":
            return any(predicate_may_hold(x, field_bounds) for x in a)
        if len(a) == 2:
            lb = infer_bounds(a[0], field_bounds)
            rb = infer_bounds(a[1], field_bounds)
            if lb is not None and rb is not None:
                if n == "greater":
                    return lb[1] > rb[0]
                if n == "less":
                    return lb[0] < rb[1]
                if n == "greaterOrEquals":
                    return lb[1] >= rb[0]
                if n == "lessOrEquals":
                    return lb[0] <= rb[1]
                if n == "equals":
                    return lb[0] <= rb[1] and rb[0] <= lb[1]
                if n == "notEquals":
                    return not (lb[0] == lb[1] == rb[0] == rb[1])
    return True
