"""Sequence and behavioural aggregates (reference:
clickhouse_tpu/exprs/agg_ext2.py): windowFunnel, sequenceMatch,
retention, rankCorr and boundingRatio.

windowFunnel and sequenceMatch take the reference's K passes: pass k
finds each group's earliest masked-in row of condition k later than pass
k - 1's time (and, for windowFunnel, within the window of pass 1's), a
min and a count of K6's sorted entry (K1 under GROUP BY ()) over the
query's own grouping, whose order does not matter to a min.  That is the
reference's reading, anchored at each group's earliest first-condition
event; ClickHouse slides the window over every first-condition event
(ROADMAP queue 3 records it, mirrored).  retention is a max a condition,
mergeable.  rankCorr ranks each argument within its own sort grouping
(K4, K5; ties by their runs' mean rank) and sums the rank products in the
second one's order; boundingRatio reads the value at each group's first
row of least and greatest order value, as argMin/argMax do.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from ..core import dtypes as dt
from ..core.errors import NotImplementedError_, TypeError_
from ..ops import agg_ops, scan_ops, sort_ops
from .agg_ext import _INF, Rows, f64_of, group_starts
from .aggregates import (AggregateFunction, _numeric as numeric, _rows_of,
                         _take, _take_mask, notm_key, value_key)

__all__ = ["WindowFunnelAgg", "SequenceMatchAgg", "RetentionAgg",
           "RankCorrAgg", "BoundingRatioAgg"]


class _Funnel(AggregateFunction):
    """The reference's earliest chain (agg_ext2.py:38-64) over the query's
    own grouping: each pass a min and a count of K6's sorted entry over
    the rows gathered into its order (K1 under GROUP BY ())."""
    holistic = True
    two_step = True

    def __init__(self, arg_types):
        super().__init__(arg_types)
        if len(arg_types) < 2:
            raise TypeError_(f"{self.name} takes a time and one or more "
                             f"conditions")
        numeric(self, *range(len(arg_types)))

    def result_type(self):
        return dt.UInt8

    def secondary(self, ctx, args, cond):
        return None          # the query's own grouping, in any row order

    def reductions(self, ctx, args, cond):
        return [], list

    def _levels(self, ctx, g, args, cond, conds, window=None):
        """Each group's levels reached by the earliest chain of `conds`
        (indices into args)."""
        mask = self._row_mask(ctx, args, cond)
        r = Rows(ctx, g, mask, self.name)
        ctx.hold(r.n * (9 + 2 * len(conds)), f"{self.name}'s passes")
        t = r.col(args[0]).to(torch.int64)
        m = r.mask
        levels = None
        tprev = t1 = None
        for i, k in enumerate(conds):
            el = m & (r.col(args[k]) != 0)
            if i:
                el &= t > r.group(tprev)
                if window is not None:
                    el &= t <= r.group(t1) + window
            tk, nk = r.reduce([("min", t, el, False),
                               ("count", None, el, False)])
            hit = nk > 0
            tk = torch.where(hit, tk, torch.full_like(tk, _INF))
            levels = hit.to(torch.uint8) if levels is None \
                else levels + hit.to(torch.uint8)
            if i == 0:
                t1 = tk
            tprev = tk
        return levels

    def finalize(self, states):
        return states[0], None


class WindowFunnelAgg(_Funnel):
    """windowFunnel(window)(time, cond1, ..., condK): the levels of each
    group's earliest chain within `window` of its first event.  A mode
    (ClickHouse's 'strict_order', ...) is refused: the reference ignores
    it."""
    name = "windowFunnel"

    def __init__(self, arg_types, params=None):
        super().__init__(arg_types)
        params = list(params or [])
        self.window = int(float(params[0])) if params else 0
        if len(params) > 1:
            raise NotImplementedError_(
                f"windowFunnel mode {params[1]!r} is not ported to the CUDA "
                f"engine yet")

    def sorted_step(self, ctx, g, args, cond, states):
        return [self._levels(ctx, g, args, cond,
                             list(range(1, len(args))), self.window)]


class SequenceMatchAgg(_Funnel):
    """sequenceMatch('(?1)(?2)...')(time, cond1, ...): 1 where a group's
    earliest chain of the pattern's steps, in order and each strictly
    later than the one before, reaches its last step.  A time operator
    (?t...) raises, as in the reference."""
    name = "sequenceMatch"

    def __init__(self, arg_types, params=None):
        super().__init__(arg_types)
        pat = str(params[0]) if params else ""
        if re.search(r"\(\?t", pat):
            raise NotImplementedError_(
                "sequenceMatch: time-bound (?t...) operators are not "
                "supported yet")
        self.steps = [int(x) for x in re.findall(r"\(\?(\d+)\)", pat)]
        if not self.steps:
            raise TypeError_(f"sequenceMatch: no (?N) steps in '{pat}'")
        if max(self.steps) >= len(arg_types) or min(self.steps) < 1:
            raise TypeError_(f"sequenceMatch: the pattern '{pat}' names a "
                             f"condition it is not given")

    def sorted_step(self, ctx, g, args, cond, states):
        levels = self._levels(ctx, g, args, cond, self.steps)
        return [(levels >= len(self.steps)).to(torch.uint8)]


class RetentionAgg(AggregateFunction):
    """retention(cond1, ..., condK) -> Array(UInt8): r[0] whether cond1
    held on a masked-in row of the group, r[k] whether cond1 and
    cond(k + 1) did (each anywhere in the group).  A max a condition (K6,
    K1); the states merge by max."""
    name = "retention"

    def __init__(self, arg_types):
        super().__init__(arg_types)
        if not arg_types:
            raise TypeError_("retention takes one or more conditions")
        numeric(self, *range(len(arg_types)))

    def result_type(self):
        return dt.Array(dt.UInt8)

    def merge_ops(self):
        return [("max", False)] * len(self.arg_types)

    def reductions(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        cap = ctx.capacity
        ctx.hold(cap * len(args), f"{self.name}'s conditions")
        specs = [("max", (a.broadcast(cap).data != 0).to(torch.uint8), mask,
                  False) for a in args]
        return specs, list

    def finalize(self, states):
        first = states[0].to(torch.uint8)
        cols = [first] + [s.to(torch.uint8) * first for s in states[1:]]
        k = len(cols)
        mat = torch.zeros((first.shape[0], -(-k // 8) * 8), dtype=torch.uint8,
                          device=first.device)
        mat[:, :k] = torch.stack(cols, dim=1)
        return mat, None, torch.full(first.shape, k, dtype=torch.int32,
                                     device=first.device)


def _token(cv, v: torch.Tensor) -> torch.Tensor:
    """A column's order tokens (u64 bits), as the reference compares
    ranks."""
    unsigned = dt.remove_nullable(cv.dtype).np_dtype == np.uint64 \
        and v.dtype == torch.int64
    return sort_ops.order_value(sort_ops.SortKey(v, unsigned=unsigned))


def _mean_ranks(ctx, g, cv, mask, what) -> torch.Tensor:
    """Each row's mean rank (1-based) of its value among its group's
    masked-in rows, in g's sorted order (g sorted by (keys, masked-out
    flag, the value)): a run of equal tokens takes its rows' mean rank."""
    n = g.perm.shape[0]
    ms = _take_mask(ctx, g, mask)
    tok = _token(cv, _take(ctx, g, cv.broadcast(ctx.capacity).storage, what))
    first = group_starts(g)
    if n > 1:
        first[1:] |= tok[1:] != tok[:-1]
    live = ms if ms is not None else g.group_ids < g.num_groups_cap
    first &= live
    p = torch.nonzero(first).squeeze(1)
    gid = torch.clamp(g.group_ids, max=g.num_groups_cap - 1).to(torch.int64)
    lens = g.reduce_sorted([("count", None, ms, False)])[0]
    inend = g.starts + lens
    gp = gid.index_select(0, p)
    nxt = torch.cat([p[1:], torch.full((1,), n, dtype=p.dtype,
                                       device=p.device)])
    cnt = torch.minimum(nxt, inend.index_select(0, gp)) - p
    rid = torch.clamp(scan_ops.segmented_scan("sum", first, None) - 1, min=0)
    lo = (p - g.starts.index_select(0, gp)).to(torch.float64)
    mean = lo + (cnt.to(torch.float64) - 1.0) / 2.0 + 1.0
    if not p.shape[0]:
        return torch.zeros(n, dtype=torch.float64, device=tok.device)
    return mean.index_select(0, torch.clamp(rid, max=p.shape[0] - 1))


class RankCorrAgg(AggregateFunction):
    """rankCorr(x, y): Spearman's correlation of each group's masked-in
    rows, ties at their runs' mean rank.  x's ranks in this aggregate's
    sort grouping (keys, masked-out flag, x), y's in a second one by
    (keys, masked-out flag, y) (K4, K5; run counts by K17); x's ranks go
    back to row order once (one index_copy_) to be read in y's order,
    where K6's sorted entry sums the products.  0 where a rank is
    constant, as the reference."""
    name = "rankCorr"
    holistic = True
    two_step = True

    def __init__(self, arg_types):
        super().__init__(arg_types)
        numeric(self, 0, 1)

    def result_type(self):
        return dt.Float64

    def secondary(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        return notm_key(ctx, mask) + [value_key(args[0], ctx.capacity)]

    def reductions(self, ctx, args, cond):
        return [], list

    def sorted_step(self, ctx, g, args, cond, states):
        mask = self._row_mask(ctx, args, cond)
        cap = ctx.capacity
        n = g.perm.shape[0]
        ctx.hold(n * 48 + cap * 8, f"{self.name}'s ranks")
        rx = _mean_ranks(ctx, g, args[0], mask, f"{self.name}'s x")
        left = None if ctx.max_bytes is None \
            else ctx.max_bytes - ctx.shared["bytes"]
        gy = agg_ops.group_by_sort(
            ctx.keys, ctx.row_valid, g.num_groups_cap,
            secondary=notm_key(ctx, mask) + [value_key(args[1], cap)],
            max_bytes=left)
        ctx.hold(8 * gy.perm.shape[0], f"{self.name}'s second grouping")
        ry = _mean_ranks(ctx, gy, args[1], mask, f"{self.name}'s y")
        raw = torch.zeros(cap, dtype=torch.float64, device=rx.device)
        raw.index_copy_(0, g.perm.to(torch.int64), rx)
        rxy = raw.index_select(0, gy.perm.to(torch.int64))
        ms = _take_mask(ctx, gy, mask)
        return gy.reduce_sorted([
            ("sum", rxy * ry, ms, False), ("sum", rxy, ms, False),
            ("sum", ry, ms, False), ("sum", rxy * rxy, ms, False),
            ("sum", ry * ry, ms, False), ("count", None, ms, False)])

    def finalize(self, states):
        sxy, sx, sy, sxx, syy, n = states
        nf = torch.clamp(n.to(torch.float64), min=1.0)
        cov = sxy - sx * sy / nf
        vx = sxx - sx * sx / nf
        vy = syy - sy * sy / nf
        den = torch.sqrt(torch.clamp(vx * vy, min=0.0))
        return torch.where(den > 0, cov / torch.clamp(den, min=1e-300),
                           torch.zeros_like(cov)), None


class BoundingRatioAgg(AggregateFunction):
    """boundingRatio(x, y): the slope between the rows of least and
    greatest x of each group, (y_hi - y_lo) / (max x - min x), NaN where
    they are equal.  Step 1: min and max of x (K6, K1); step 2: the least
    and greatest order token and y at the first row (lowest row id) that
    holds each, as argMin/argMax take it (K6's sorted entry over the
    query's grouping, K1 under GROUP BY ())."""
    name = "boundingRatio"
    holistic = True
    two_step = True

    def __init__(self, arg_types):
        super().__init__(arg_types)
        numeric(self, 0, 1)

    def result_type(self):
        return dt.Float64

    def secondary(self, ctx, args, cond):
        return None          # the query's own grouping, in any row order

    def reductions(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        v = self._spec_value(ctx, args[0])
        u = dt.remove_nullable(self.arg_types[0]).np_dtype == np.uint64
        return [("min", v, mask, u), ("max", v, mask, u)], list

    def sorted_step(self, ctx, g, args, cond, states):
        mask = self._row_mask(ctx, args, cond)
        r = Rows(ctx, g, mask, self.name)
        ctx.hold(r.n * 20, f"{self.name}'s extreme rows")
        tok = _token(args[0], r.col(args[0]))
        lo, hi = r.reduce([("min", tok, r.mask, True),
                           ("max", tok, r.mask, True)])
        y = self._spec_value(ctx, args[1])
        ys = []
        for best in (lo, hi):
            at = r.mask & (tok == r.group(best))
            if r.sort:
                rows, cnt = g.reduce_sorted([("min", g.perm, at, False),
                                             ("count", None, at, False)])
                val = _rows_of(y, rows.to(torch.int64).clamp_(
                    0, max(ctx.capacity - 1, 0)))
            else:
                val = g.reduce_many([("any", y, at, False)])[0]
            ys.append(f64_of(args[1], val))
        xmin, xmax = (f64_of(args[0], s) for s in states)
        return [xmin, xmax, ys[0], ys[1]]

    def finalize(self, states):
        xmin, xmax, y_lo, y_hi = states
        dx = xmax - xmin
        return torch.where(dx != 0, (y_hi - y_lo) / torch.where(
            dx == 0, torch.ones_like(dx), dx),
            torch.full_like(dx, float("nan"))), None
