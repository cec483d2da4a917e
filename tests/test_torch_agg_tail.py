"""The aggregate tail of the CUDA engine (exprs/agg_ext.py ... agg_ext4.py:
the 39 names whose result is not a Tuple) against the JAX reference, on
the CPU.

The same seeded numpy table goes through ``clickhouse_tpu.connect()`` and
``clickhouse_tpu_torch.connect(device="cpu")``: every name under GROUP BY
() (K1, or a sort of one group), the sort grouping (K4, K5, K6, K17) and
-If (a condition that leaves a group with no row), one query a module and
form (cached in _RUNS), then NULL arguments, UInt64 above 2^63, NaN and
±0.0, ties, a filtered block, and the reference's own cases.  Integers,
strings and arrays of integers must be equal; floats within rtol 1e-9
(the engines add the same float64 terms in other orders), with an
absolute 1e-9 of the largest term where a statistic cancels (the
contingency family's chi^2 is T (S - 1)).  Where the reference is wrong
against ClickHouse (A3: quantilesExactWeighted ignores the weights; the
moving sums drop their window and sum integers in float64) the port's
answer is held to numpy with ClickHouse's rule and the case is pinned in
tests/test_torch_ops.py DIVERGENCES.
"""
import math

import numpy as np
import pytest
import torch

import clickhouse_tpu as jch
import clickhouse_tpu_torch as tch
from clickhouse_tpu_torch.core.errors import (ExecutionError,
                                              NotImplementedError_,
                                              TypeError_, UnknownFunction)
from clickhouse_tpu_torch.exprs import aggregates as tagg
from clickhouse_tpu_torch.interop import table_from_numpy

N = 1200
RTOL = 1e-9
ATOL = 1e-9
TYPES = {"k": "Int32", "x": "Int64", "u": "UInt64", "n": "Nullable(Int64)",
         "f": "Float64", "g": "Float64", "w": "UInt8", "ts": "Int64",
         "e": "UInt8", "a": "Int32", "b": "Int32", "c": "Int64",
         "i0": "Int64", "i1": "Int64"}

# every one of the 39 names: (module, call); a parametric call's levels in
# the call.  Each module's calls go in one query a form.
CALLS = {
    "deltaSum": ("ext", "deltaSum(x)"),
    "quantileExactWeighted": ("ext", "quantileExactWeighted(0.3)(x, w)"),
    "quantileInterpolatedWeighted": (
        "ext", "quantileInterpolatedWeighted(0.6)(x, w)"),
    "quantileTimingWeighted": ("ext", "quantileTimingWeighted(0.9)(x, w)"),
    "quantileTDigestWeighted": ("ext", "quantileTDigestWeighted(0.5)(f, w)"),
    "quantileBFloat16Weighted": (
        "ext", "quantileBFloat16Weighted(0.25)(x, w)"),
    "medianExactWeighted": ("ext", "medianExactWeighted(x, w)"),
    "medianInterpolatedWeighted": ("ext", "medianInterpolatedWeighted(f, w)"),
    "medianTimingWeighted": ("ext", "medianTimingWeighted(x, w)"),
    "medianTDigestWeighted": ("ext", "medianTDigestWeighted(x, w)"),
    "quantilesExactWeighted": (
        "numpy", "quantilesExactWeighted(0.1, 0.5, 0.9)(x, w)"),
    "uniqUpTo": ("ext", "uniqUpTo(4)(a)"),
    "groupArrayMovingSum": ("ext", "groupArrayMovingSum(x)"),
    "groupArrayMovingAvg": ("ext", "groupArrayMovingAvg(x)"),
    "groupArraySorted": ("ext3", "groupArraySorted(5)(x)"),
    "groupArrayLast": ("ext3", "groupArrayLast(5)(x)"),
    "groupArraySample": ("ext3", "groupArraySample(5)(x)"),
    "singleValueOrNull": ("ext3", "singleValueOrNull(c)"),
    "exponentialMovingAverage": (
        "ext3", "exponentialMovingAverage(5)(f, ts)"),
    "exponentialTimeDecayedSum": (
        "ext3", "exponentialTimeDecayedSum(5)(f, ts)"),
    "exponentialTimeDecayedCount": (
        "ext3", "exponentialTimeDecayedCount(5)(ts)"),
    "exponentialTimeDecayedAvg": (
        "ext3", "exponentialTimeDecayedAvg(5)(f, ts)"),
    "exponentialTimeDecayedMax": (
        "ext3", "exponentialTimeDecayedMax(5)(f, ts)"),
    "intervalLengthSum": ("ext3", "intervalLengthSum(i0, i1)"),
    "maxIntersections": ("ext3", "maxIntersections(i0, i1)"),
    "maxIntersectionsPosition": ("ext3", "maxIntersectionsPosition(i0, i1)"),
    "cramersV": ("ext3", "cramersV(a, b)"),
    "cramersVBiasCorrected": ("ext3", "cramersVBiasCorrected(a, b)"),
    "theilsU": ("ext3", "theilsU(a, b)"),
    "contingency": ("ext3", "contingency(a, b)"),
    "windowFunnel": ("ext2", "windowFunnel(40)(ts, e = 0, e = 1, e = 2)"),
    "sequenceMatch": ("ext2", "sequenceMatch('(?1)(?2)')(ts, e = 0, e = 2)"),
    "retention": ("ext2", "retention(e = 0, e = 1, e = 2)"),
    "rankCorr": ("ext2", "rankCorr(x, f)"),
    "boundingRatio": ("ext2", "boundingRatio(ts, f)"),
    "topKWeighted": ("ext4", "topKWeighted(5)(a, w)"),
    "deltaSumTimestamp": ("ext4", "deltaSumTimestamp(x, ts)"),
    "nothing": ("ext4", "nothing(x)"),
    "aggThrow": ("ext4", "aggThrow(0)(x)"),
}
MODULES = ("ext", "ext2", "ext3", "ext4")
FORMS = ("global", "sort", "if")
# -If's condition: group 3 keeps no row
COND = "k != 3 AND x > -20"


def _columns(seed=26):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 12, N).astype(np.int32)
    x = rng.integers(-60, 60, N).astype(np.int64)
    u = rng.integers(0, 1 << 62, N).astype(np.uint64)
    u[rng.random(N) < 0.4] += np.uint64(1 << 63)
    n = rng.integers(-30, 30, N).astype(object)
    n[rng.random(N) < 0.25] = None
    ts = rng.permutation(N).astype(np.int64)
    i0 = rng.integers(0, 3000, N).astype(np.int64)
    return {"k": k, "x": x, "u": u, "n": n,
            "f": np.round(rng.normal(3, 10, N), 3),
            "g": rng.choice([-0.0, 0.0, 1.5, -2.25, np.nan, 7.0], N),
            "w": rng.integers(1, 8, N).astype(np.uint8), "ts": ts,
            "e": rng.integers(0, 4, N).astype(np.uint8),
            "a": rng.integers(0, 6, N).astype(np.int32),
            "b": rng.integers(0, 5, N).astype(np.int32),
            "c": np.where(k % 3 == 0, 7, x).astype(np.int64),
            "i0": i0, "i1": i0 + rng.integers(0, 200, N)}


_SESSIONS = []


def _sessions():
    """The reference's and the port's session over t, made once."""
    if not _SESSIONS:
        cols = _columns()
        js, ts = jch.connect(), tch.connect(device="cpu")
        js.execute("CREATE TABLE t (" + ", ".join(
            f"{c} {t}" for c, t in TYPES.items()) + ")")
        js.insert_pydict("t", cols)
        table_from_numpy(ts, "t", cols, TYPES)
        _SESSIONS.extend([js, ts, cols])
    return _SESSIONS


def _close(got, want):
    if isinstance(want, list) or isinstance(got, list):
        return isinstance(got, list) and isinstance(want, list) \
            and len(got) == len(want) \
            and all(_close(g, w) for g, w in zip(got, want))
    if isinstance(want, float) or isinstance(got, float):
        if want is None or got is None:
            return got is want
        if math.isnan(want) or math.isnan(got):
            return math.isnan(want) and math.isnan(got)
        return math.isclose(got, want, rel_tol=RTOL, abs_tol=ATOL)
    return got == want


def _rows_close(got, want):
    return len(got) == len(want) and all(
        len(g) == len(w) and all(_close(a, b) for a, b in zip(g, w))
        for g, w in zip(got, want))


def _both(sql):
    js, ts = _sessions()[:2]
    want = js.execute(sql).rows()
    got = ts.execute(sql).rows()
    assert _rows_close(got, want), (sql, got[:4], want[:4])
    return got


def _with_if(call: str) -> str:
    """call's -If form with COND."""
    i = call.index("(")
    return f"{call[:i]}If{call[i:-1]}, {COND})"


def _sql(module: str, form: str):
    names = [n for n, (m, _) in CALLS.items() if m == module]
    calls = [CALLS[n][1] if form != "if" else _with_if(CALLS[n][1])
             for n in names]
    settings = " SETTINGS group_array_max_size = 2048"
    if form == "global":
        return names, f"SELECT {', '.join(calls)} FROM t" + settings
    return names, (f"SELECT k, {', '.join(calls)} FROM t GROUP BY k "
                   f"ORDER BY k" + settings)


_RUNS = {}


def _run(module: str, form: str, which: str):
    """The rows of one module's query in one form, on the port ("port")
    or the reference ("ref"), run once."""
    key = (module, form, which)
    if key not in _RUNS:
        names, sql = _sql(module, form)
        s = _sessions()[1 if which == "port" else 0]
        _RUNS[key] = (s.execute(sql).rows(), names, sql)
    return _RUNS[key]


def _column(module, form, which, name):
    rows, names, sql = _run(module, form, which)
    col = names.index(name) + (form != "global")
    return [r[col] for r in rows], sql


# -- numpy's answers, by ClickHouse's rules -----------------------------------

def _np_groups(form: str):
    """Each group's rows (raw order) of a form's query, in key order."""
    c = _sessions()[2]
    if form == "global":
        return [np.arange(N)]
    m = (c["k"] != 3) & (c["x"] > -20) if form == "if" \
        else np.ones(N, bool)
    return [np.flatnonzero((c["k"] == k) & m) for k in np.unique(c["k"])]


def np_weighted_quantile(v, w, q):
    """The first value, in value order, whose running weight reaches
    q * total - 1e-12; 0 (NaN for a float) over no row."""
    if not len(v):
        return float("nan") if v.dtype.kind == "f" else 0
    o = np.argsort(v, kind="stable")
    cum = np.cumsum(w[o].astype(np.float64))
    out = v[o][int(np.argmax(cum >= q * cum[-1] - 1e-12))]
    return float(out) if v.dtype.kind == "f" else int(out)


def np_crosstab(a, b, which: str) -> float:
    """cramersV, cramersVBiasCorrected, theilsU or contingency of (a, b),
    from the contingency table (the reference's formulas)."""
    T = float(len(a))
    if not len(a):
        return 0.0
    ua, ia = np.unique(a, return_inverse=True)
    ub, ib = np.unique(b, return_inverse=True)
    nab = np.zeros((len(ua), len(ub)))
    np.add.at(nab, (ia, ib), 1.0)
    na, nb = nab.sum(1), nab.sum(0)
    cell = nab > 0
    S = float((nab[cell] ** 2 / np.outer(na, nb)[cell]).sum())
    chi2 = T * max(S - 1.0, 0.0)
    R, C = float(len(ua)), float(len(ub))
    if which == "cramersV":
        return math.sqrt(chi2 / max(T * max(min(R, C) - 1.0, 1.0), 1e-300))
    if which == "contingency":
        return math.sqrt(chi2 / max(chi2 + T, 1e-300))
    if which == "theilsU":
        h_a = float((na / T * np.log(T / na)).sum())
        h_ab = float((nab[cell] / T * np.log(
            np.broadcast_to(nb, nab.shape)[cell] / nab[cell])).sum())
        return (h_a - h_ab) / h_a if h_a > 1e-300 else 0.0
    tm1 = max(T - 1.0, 1.0)
    phi2 = max(chi2 / T - (R - 1.0) * (C - 1.0) / tm1, 0.0)
    rc, cc = R - (R - 1.0) ** 2 / tm1, C - (C - 1.0) ** 2 / tm1
    return math.sqrt(phi2 / max(min(rc, cc) - 1.0, 1e-300))


def _mean_ranks(v):
    s = np.sort(v)
    lo = np.searchsorted(s, v, "left")
    hi = np.searchsorted(s, v, "right")
    return (lo + hi - 1) / 2.0 + 1.0


def np_rank_corr(x, y) -> float:
    """Spearman's correlation with mean ranks at ties; 0 where a rank is
    constant (the reference's)."""
    if not len(x):
        return 0.0
    rx, ry = _mean_ranks(x), _mean_ranks(y)
    n = float(len(x))
    cov = (rx * ry).sum() - rx.sum() * ry.sum() / n
    den = math.sqrt(max(((rx * rx).sum() - rx.sum() ** 2 / n)
                        * ((ry * ry).sum() - ry.sum() ** 2 / n), 0.0))
    return cov / den if den > 0 else 0.0


def np_topk_weighted(v, w, k: int):
    """The k values of largest weight sum, heaviest first, equal sums in
    value order."""
    vals, inv = np.unique(v, return_inverse=True)
    sums = np.zeros(len(vals), np.int64)
    np.add.at(sums, inv, w.astype(np.int64))
    o = np.lexsort((vals, -sums))
    return [int(x) for x in vals[o][:k]]


# the calls held to numpy, in the forms where the reference is wrong: the
# weighted quantiles over a group that -If leaves empty (the reference
# reads a neighbouring value: A2's weighted form), and the run counts of
# topKWeighted, rankCorr and the contingency family under a mask (A7's
# run ids); quantilesExactWeighted in every form (A3)
_WEIGHTED = {"quantileExactWeighted": ("x", 0.3),
             "quantileInterpolatedWeighted": ("x", 0.6),
             "quantileTimingWeighted": ("x", 0.9),
             "quantileTDigestWeighted": ("f", 0.5),
             "quantileBFloat16Weighted": ("x", 0.25),
             "medianExactWeighted": ("x", 0.5),
             "medianInterpolatedWeighted": ("f", 0.5),
             "medianTimingWeighted": ("x", 0.5),
             "medianTDigestWeighted": ("x", 0.5)}
_CROSSTAB = ("cramersV", "cramersVBiasCorrected", "theilsU", "contingency")


def _numpy_column(name: str, form: str):
    c = _sessions()[2]
    out = []
    for rows in _np_groups(form):
        if name in _WEIGHTED:
            col, q = _WEIGHTED[name]
            out.append(np_weighted_quantile(c[col][rows], c["w"][rows], q))
        elif name == "quantilesExactWeighted":
            out.append([np_weighted_quantile(c["x"][rows], c["w"][rows], q)
                        for q in (0.1, 0.5, 0.9)])
        elif name in _CROSSTAB:
            out.append(np_crosstab(c["a"][rows], c["b"][rows], name))
        elif name == "rankCorr":
            out.append(np_rank_corr(c["x"][rows], c["f"][rows]))
        else:
            out.append(np_topk_weighted(c["a"][rows], c["w"][rows], 5))
    return out


HELD_TO_NUMPY = {(n, "if") for n in list(_WEIGHTED) + list(_CROSSTAB)
                 + ["rankCorr", "topKWeighted"]} \
    | {("quantilesExactWeighted", f) for f in FORMS}


def _ext_numpy_run(form):
    """quantilesExactWeighted's own query (the port only: A3)."""
    key = ("numpy", form, "port")
    if key not in _RUNS:
        call = CALLS["quantilesExactWeighted"][1]
        call = call if form != "if" else _with_if(call)
        sql = f"SELECT {call} FROM t" if form == "global" else \
            f"SELECT k, {call} FROM t GROUP BY k ORDER BY k"
        _RUNS[key] = (_sessions()[1].execute(sql).rows(),
                      ["quantilesExactWeighted"], sql)
    return _RUNS[key]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("name", sorted(CALLS))
def test_every_tail_name_matches_reference(name, form):
    """Each name under GROUP BY (), the sort grouping and -If gives the
    reference's values (its column of one query over its module's names),
    or numpy's by ClickHouse's rule where the reference is wrong
    (HELD_TO_NUMPY; each pinned in tests/test_torch_ops.py DIVERGENCES)."""
    module = CALLS[name][0]
    if module == "numpy":
        _ext_numpy_run(form)
    got, sql = _column(module, form, "port", name)
    if (name, form) in HELD_TO_NUMPY:
        want = _numpy_column(name, form)
    else:
        want, _ = _column(module, form, "ref", name)
    assert len(got) == len(want) and all(
        _close(a, b) for a, b in zip(got, want)), (sql, got, want)


@pytest.mark.parametrize("name", sorted(
    n for n, f in HELD_TO_NUMPY if f == "if"
    and n not in ("topKWeighted", "quantilesExactWeighted")))
def test_held_names_match_reference_where_it_is_right(name):
    """The names held to numpy under -If agree with the reference on the
    groups its defect leaves alone: the weighted quantiles on every group
    -If leaves a row; the reference's sort grouping form of the rest is
    compared above."""
    module = CALLS[name][0]
    got, sql = _column(module, "if", "port", name)
    want, _ = _column(module, "if", "ref", name)
    if name in _WEIGHTED:
        keep = [i for i, rows in enumerate(_np_groups("if")) if len(rows)]
        assert all(_close(got[i], want[i]) for i in keep), (sql, got, want)
    else:
        np_col = _numpy_column(name, "sort")
        ref_sort, _ = _column(module, "sort", "ref", name)
        assert all(_close(a, b) for a, b in zip(ref_sort, np_col))


@pytest.mark.parametrize("sql", [
    "SELECT k, deltaSum(n), quantileExactWeighted(0.5)(n, w), "
    "groupArraySorted(4)(n), singleValueOrNull(n), uniqUpTo(3)(n), "
    "groupArrayLast(3)(n), groupArraySample(3)(n), deltaSumTimestamp(n, ts), "
    "exponentialTimeDecayedSum(5)(n, ts), boundingRatio(n, x), "
    "windowFunnel(40)(ts, n > 0, n > 10), groupArrayMovingSum(n), "
    "intervalLengthSum(n, i1), maxIntersections(n, i1) FROM t GROUP BY k "
    "ORDER BY k",
    "SELECT k, groupArraySorted(5)(u), quantileExactWeighted(0.5)(u, w), "
    "singleValueOrNull(u), uniqUpTo(3)(u), groupArrayLast(3)(u), "
    "groupArraySample(4)(u), "
    "singleValueOrNull(toUInt64(18446744073709551615)) FROM t GROUP BY k "
    "ORDER BY k",
    "SELECT k, groupArraySorted(5)(g), quantileExactWeighted(0.5)(g, w), "
    "singleValueOrNull(g), uniqUpTo(3)(g), groupArrayLast(4)(g), "
    "topKWeighted(3)(g, w), exponentialTimeDecayedMax(5)(g, ts) FROM t "
    "GROUP BY k ORDER BY k",
    "SELECT groupArraySorted(5)(u), quantileExactWeighted(0.5)(u, w), "
    "singleValueOrNull(u), uniqUpTo(3)(u), groupArraySorted(6)(g), "
    "quantileExactWeighted(0.5)(g, w), singleValueOrNull(g) FROM t",
    "SELECT k, deltaSum(x), quantileExactWeighted(0.4)(x, w), "
    "groupArraySample(3)(x), windowFunnel(30)(ts, e = 1, e = 2), "
    "intervalLengthSum(i0, i1), cramersV(a, b), rankCorr(x, f), "
    "topKWeighted(3)(a, w), retention(e = 1, e = 3) FROM t WHERE x > 0 "
    "GROUP BY k ORDER BY k",
    "SELECT deltaSum(x), groupArraySample(7)(x), groupArrayLast(6)(x), "
    "windowFunnel(30)(ts, e = 1, e = 2), maxIntersectionsPosition(i0, i1), "
    "theilsU(a, b), topKWeighted(4)(a, w) FROM t WHERE ts % 3 = 1",
    "SELECT k, quantileExactWeighted(0.5)(x, w), median(x), "
    "groupArraySorted(3)(x), uniqUpTo(2)(x), intervalLengthSum(x, x + 3) "
    "FROM t GROUP BY k ORDER BY k",
], ids=["nullable", "uint64", "nan-zero", "global-wide", "where-sort",
        "where-global", "shared-secondaries"])
def test_argument_types_and_filters_match_reference(sql):
    """NULL arguments, UInt64 above 2^63 (a constant's too), NaN and ±0.0,
    a filtered block (the row mask in parts) under the sort grouping and
    GROUP BY (), and several holistic aggregates whose secondary keys
    coincide (one sort grouping)."""
    _both(sql)


# -- the reference's own cases -------------------------------------------------

def _pair_with(ddl_and_inserts):
    """A fresh reference and port session with the given statements run on
    both."""
    js, ts = jch.connect(), tch.connect(device="cpu")
    for sql in ddl_and_inserts:
        js.execute(sql)
        ts.execute(sql)
    return js, ts


def _same(pair, sql):
    js, ts = pair
    want = js.execute(sql).rows()
    got = ts.execute(sql).rows()
    assert _rows_close(got, want), (sql, got, want)
    return got


_IV = ["CREATE TABLE iv (g Int64, a Int64, b Int64)",
       "INSERT INTO iv VALUES (0, 1, 5), (0, 2, 6), (0, 4, 8), (1, 0, 3), "
       "(1, 10, 12)"]
_EV = ["CREATE TABLE ev (uid UInt32, t UInt32, e String)",
       "INSERT INTO ev VALUES (1,1,'view'),(1,2,'cart'),(1,3,'buy'),"
       "(2,1,'view'),(2,9,'cart'),(3,5,'cart'),(1,10,'view')",
       "CREATE TABLE xy (g UInt8, x Float64, y Float64)",
       "INSERT INTO xy VALUES (0,1,2),(0,2,4),(0,3,6),(1,1,5),(1,2,3),"
       "(1,3,1)",
       "CREATE TABLE tie (x Float64, y Float64)",
       "INSERT INTO tie VALUES (1,1),(1,2),(2,3),(3,4)"]


@pytest.mark.parametrize("sql,want", [
    ("SELECT g, intervalLengthSum(a, b) FROM iv GROUP BY g ORDER BY g",
     [(0, 7), (1, 5)]),
    ("SELECT g, maxIntersections(a, b), maxIntersectionsPosition(a, b) "
     "FROM iv GROUP BY g ORDER BY g", [(0, 3, 4.0), (1, 1, 0.0)]),
], ids=["interval-length-sum", "max-intersections"])
def test_reference_interval_cases(sql, want):
    """tests/test_agg_batch3.py's interval cases through both engines."""
    assert _same(_pair_with(_IV), sql) == want


def test_reference_decayed_cases():
    """tests/test_agg_batch3.py::test_exponential_moving_average: the
    hand-checked weights, both engines."""
    pair = _pair_with(["CREATE TABLE ema (v Float64, t Int64)",
                       "INSERT INTO ema VALUES (1.0, 0), (2.0, 1), (4.0, 2)"])
    got = _same(pair, "SELECT exponentialMovingAverage(1)(v, t) FROM ema")
    assert abs(got[0][0] - 3.0) < 1e-9
    s, c, a, m = _same(pair, "SELECT exponentialTimeDecayedSum(1)(v, t), "
                       "exponentialTimeDecayedCount(1)(t), "
                       "exponentialTimeDecayedAvg(1)(v, t), "
                       "exponentialTimeDecayedMax(1)(v, t) FROM ema")[0]
    w = [math.exp(-2), math.exp(-1), 1.0]
    assert abs(s - (w[0] + 2 * w[1] + 4 * w[2])) < 1e-9
    assert abs(c - sum(w)) < 1e-9 and abs(a - s / c) < 1e-9
    assert abs(m - 4.0) < 1e-9


def test_reference_crosstab_case():
    """tests/test_agg_batch3.py::test_cramers_v_perfect_and_independent."""
    a = ", ".join(f"({v}, {v}, {i % 2})"
                  for i, v in enumerate([0, 1, 2, 0, 1, 2] * 10))
    pair = _pair_with(["CREATE TABLE cv (a Int64, b Int64, c Int64)",
                       f"INSERT INTO cv VALUES {a}"])
    v, vb, t, cg = _same(pair, "SELECT cramersV(a, b), "
                         "cramersVBiasCorrected(a, b), theilsU(a, b), "
                         "contingency(a, b) FROM cv")[0]
    assert abs(v - 1.0) < 1e-9 and abs(t - 1.0) < 1e-9
    assert 0.8 < cg < 0.85 and abs(vb - 1.0) < 0.05
    v2, t2 = _same(pair, "SELECT cramersV(a, c), theilsU(a, c) FROM cv")[0]
    assert v2 < 1e-6 and t2 < 1e-6


def test_reference_single_value_and_collectors():
    """tests/test_agg_batch3.py's singleValueOrNull, ordered collectors
    and -If cases."""
    pair = _pair_with([
        "CREATE TABLE sv (g Int64, x Int64)",
        "INSERT INTO sv VALUES (0, 5), (0, 5), (1, 1), (1, 2)",
        "CREATE TABLE oc (x Int64)",
        "INSERT INTO oc VALUES (5), (3), (9), (1), (7)",
        "CREATE TABLE dc (g Int64, v Float64, t Int64)",
        "INSERT INTO dc VALUES (0, 1.0, 0), (0, 100.0, 1), (0, 3.0, 2), "
        "(1, 4.0, 0), (1, 5.0, 1)"])
    assert _same(pair, "SELECT g, singleValueOrNull(x) FROM sv GROUP BY g "
                 "ORDER BY g") == [(0, 5), (1, None)]
    srt, last, sample = _same(pair, "SELECT groupArraySorted(3)(x), "
                              "groupArrayLast(2)(x), groupArraySample(2)(x) "
                              "FROM oc")[0]
    assert srt == [1, 3, 5] and last == [1, 7] and len(sample) == 2
    assert len(_same(pair, "SELECT g, singleValueOrNullIf(t, v < 50) FROM "
                     "dc GROUP BY g ORDER BY g")) == 2


@pytest.mark.parametrize("sql,want", [
    ("SELECT uid, windowFunnel(5)(t, e='view', e='cart', e='buy') FROM ev "
     "GROUP BY uid ORDER BY uid", [(1, 3), (2, 1), (3, 0)]),
    ("SELECT uid, windowFunnel(100)(t, e='view', e='cart') FROM ev "
     "GROUP BY uid ORDER BY uid", [(1, 2), (2, 2), (3, 0)]),
    ("SELECT uid, sequenceMatch('(?1)(?2)')(t, e='view', e='cart') FROM ev "
     "GROUP BY uid ORDER BY uid", [(1, 1), (2, 1), (3, 0)]),
    ("SELECT uid, sequenceMatch('(?2)(?1)')(t, e='view', e='cart') FROM ev "
     "GROUP BY uid ORDER BY uid", [(1, 1), (2, 0), (3, 0)]),
    ("SELECT uid, retention(e='view', e='cart', e='buy') FROM ev "
     "GROUP BY uid ORDER BY uid",
     [(1, [1, 1, 1]), (2, [1, 1, 0]), (3, [0, 0, 0])]),
    ("SELECT g, rankCorr(x, y) FROM xy GROUP BY g ORDER BY g",
     [(0, 1.0), (1, -1.0)]),
    ("SELECT rankCorr(x, y) FROM tie", [(0.9486832980505138,)]),
    ("SELECT g, boundingRatio(x, y) FROM xy GROUP BY g ORDER BY g",
     [(0, 2.0), (1, -2.0)]),
], ids=["funnel", "funnel-wide", "sequence", "sequence-reorder",
        "retention", "rank-corr", "rank-corr-ties", "bounding-ratio"])
def test_reference_sequence_cases(sql, want):
    """tests/test_function_batch3.py::TestSequenceAggregates through both
    engines."""
    assert _same(_pair_with(_EV), sql) == want


def test_reference_batch4_and_breadth_cases():
    """tests/test_function_batch5.py's topKWeighted, nothing, aggThrow and
    deltaSumTimestamp, and tests/test_function_breadth.py:158-177's
    deltaSum, quantileExactWeighted, uniqUpTo and groupArrayMovingSum."""
    rng = np.random.default_rng(5)
    n = 400
    cols = {"g": rng.integers(0, 3, n), "x": rng.normal(10, 2, n),
            "w": rng.integers(1, 5, n), "ts": rng.permutation(n)}
    js, ts = jch.connect(), tch.connect(device="cpu")
    types = {"g": "Int64", "x": "Float64", "w": "Int64", "ts": "Int64"}
    js.execute("CREATE TABLE ab4 (g Int64, x Float64, w Int64, ts Int64)")
    js.insert_pydict("ab4", cols)
    table_from_numpy(ts, "ab4", cols, types)
    pair = (js, ts)
    assert _same(pair, "SELECT length(topKWeighted(3)(g, w)) FROM ab4") \
        == [(3,)]
    _same(pair, "SELECT topKWeighted(3)(g, w) FROM ab4")
    assert _same(pair, "SELECT nothing(x) FROM ab4") == [(None,)]
    for s in pair:
        with pytest.raises(Exception, match="aggThrow"):
            s.execute("SELECT aggThrow(1)(x) FROM ab4")
    rows = _same(pair, "SELECT g, deltaSumTimestamp(x, ts) FROM ab4 "
                 "GROUP BY g ORDER BY g")
    assert len(rows) == 3 and all(v > 0 for _, v in rows)
    pair = _pair_with(["CREATE TABLE bt (k Int64, x Float64)",
                       "INSERT INTO bt VALUES (1, 1.5), (2, 2.5), (2, 3.5)"])
    assert _same(pair, "SELECT deltaSum(x) FROM (SELECT arrayJoin([1, 5, 3, "
                 "8]) AS x)") == [(9,)]
    assert _same(pair, "SELECT quantileExactWeighted(0.5)(x, 1) FROM bt") \
        == [(2.5,)]
    assert _same(pair, "SELECT uniqUpTo(1)(k) FROM bt") == [(2,)]
    assert _same(pair, "SELECT groupArrayMovingSum(k) FROM bt") \
        == [([1, 3, 5],)]


# -- refusals ------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(tagg.TUPLE_AGGREGATES))
def test_tuple_aggregates_still_raise_naming_themselves(name):
    """The 16 names whose result is a Tuple wait for the Tuple column
    type: each raises UnknownFunction naming it."""
    with pytest.raises(UnknownFunction, match=name):
        tagg.get_aggregate(name, [tagg.dt.Float64, tagg.dt.Int64])


@pytest.mark.parametrize("sql,err,match", [
    ("SELECT sequenceMatch('(?1)(?t>2)(?2)')(ts, e = 0, e = 1) FROM t",
     NotImplementedError_, "time-bound"),
    ("SELECT sequenceMatch('.*')(ts, e = 0, e = 1) FROM t", TypeError_,
     "no \\(\\?N\\) steps"),
    ("SELECT k, deltaSumState(x) FROM t GROUP BY k", TypeError_,
     "deltaSum"),
    ("SELECT k, groupArraySortedState(3)(x) FROM t GROUP BY k", TypeError_,
     "groupArraySorted"),
    ("SELECT k, quantileExactWeightedState(0.5)(x, w) FROM t GROUP BY k",
     TypeError_, "quantileExactWeighted"),
    ("SELECT windowFunnelState(10)(ts, e = 0, e = 1) FROM t", TypeError_,
     "windowFunnel"),
    ("SELECT aggThrow(0.5)(x) FROM t", ExecutionError, "aggThrow"),
], ids=["sequence-time", "sequence-no-step", "state-deltasum",
        "state-sorted", "state-weighted", "state-funnel", "aggthrow"])
def test_refusals_match_the_reference(sql, err, match):
    """The reference's typed errors: a (?t...) pattern, a pattern of no
    step, -State of a holistic aggregate of the tail, aggThrow."""
    js, ts = _sessions()[:2]
    for s, e in ((ts, err), (js, Exception)):
        with pytest.raises(e, match=match):
            s.execute(sql)


@pytest.mark.parametrize("sql,err,match", [
    ("SELECT windowFunnel(10, 'strict_order')(ts, e = 0, e = 1) FROM t",
     NotImplementedError_, "strict_order"),
    ("SELECT groupArraySorted(3)(s) FROM (SELECT toString(x) AS s FROM t)",
     NotImplementedError_, "groupArraySorted"),
    ("SELECT groupArrayLast(3)(s) FROM (SELECT toString(x) AS s FROM t)",
     NotImplementedError_, "groupArrayLast"),
    ("SELECT topKWeighted(3)(s, w) FROM (SELECT toString(x) AS s, w "
     "FROM t)", NotImplementedError_, "topKWeighted"),
    ("SELECT singleValueOrNullState(x) FROM t", NotImplementedError_,
     "singleValueOrNull"),
    ("SELECT uniqUpTo(3)(x, a) FROM t", NotImplementedError_, "uniqExact"),
], ids=["funnel-mode", "sorted-string", "last-string", "topkw-string",
        "state-single-value", "uniqupto-tuple"])
def test_port_refusals(sql, err, match):
    """What the port refuses with a typed error where the reference
    answers: a windowFunnel mode (the reference ignores it), an Array of
    String (waits for that column type), -State of the mergeable tail
    (no stored layout yet), uniqUpTo of two arguments (A1's tuples)."""
    with pytest.raises(err, match=match):
        _sessions()[1].execute(sql)


def test_delta_sum_of_uint64_compares_unsigned():
    """deltaSum of a UInt64 above 2^63: ClickHouse's unsigned rises,
    wrapping mod 2^64, by numpy (the reference compares signed: A11,
    pinned in tests/test_torch_ops.py DIVERGENCES)."""
    c = _sessions()[2]
    got = _sessions()[1].execute("SELECT k, deltaSum(u) FROM t GROUP BY k "
                                 "ORDER BY k").rows()
    want = []
    for key in np.unique(c["k"]):
        u = [int(v) for v in c["u"][c["k"] == key]]
        want.append((int(key), sum(b - a for a, b in zip(u, u[1:])
                                   if b > a) % (1 << 64)))
    assert got == want


def test_single_value_of_a_string_matches_reference():
    """singleValueOrNull of a String compares dictionary codes."""
    _both("SELECT k % 4 AS m, singleValueOrNull(s), singleValueOrNull(z) "
          "FROM (SELECT k, toString(k % 2) AS s, toString(x) AS z FROM t) "
          "GROUP BY m ORDER BY m")


# -- chip_smoke.py's --aggtail at a small size ---------------------------------

_SMOKE = []


def _smoke():
    """chip_smoke's aggregate-tail tables at a small size in a CPU session
    (hits_t's columns and hits' x of 200,000 rows, events of 300,000 rows
    over 4,096 users) and numpy's answers to its queries."""
    if not _SMOKE:
        import chip_smoke as cs
        n, users = 200_000, 4096
        s = tch.connect(device="cpu")
        cols = cs.hits_t_columns(n)
        s.execute("CREATE TABLE hits_t (t DateTime, d Date, x Int64)")
        s.insert_pydict("hits_t", cols)
        s.execute("CREATE TABLE hits (x Int64)")
        s.insert_pydict("hits", {"x": cols["x"]})
        want = cs.hits_tail_answers(cols)
        ev = cs.events_columns(300_000, users)
        s.execute("CREATE TABLE events (uid UInt32, t DateTime, e UInt8)")
        s.insert_pydict("events", ev)
        want.update(cs.events_answers(ev, users))
        _SMOKE.extend([cs, s, want])
    return _SMOKE


def _smoke_queries():
    import chip_smoke as cs
    return cs.AGGTAIL_QUERIES


@pytest.mark.parametrize("name,sql", _smoke_queries(),
                         ids=[q for q, _ in _smoke_queries()])
def test_chip_smoke_tail_query_matches_numpy(name, sql):
    """Each --aggtail query on the CPU path equals the numpy answer the
    smoke holds the card to (floats within its AGGTAIL_RTOL)."""
    cs, s, want = _smoke()
    rows = s.execute(sql, settings=cs.aggtail_settings(name)).rows()
    assert cs.aggtail_agree(rows, want[name]), (name, rows[:3],
                                                want[name][:3])


def test_chip_smoke_tail1m_calls_cover_every_name():
    """The smoke's card-against-CPU queries name each of the 39 names, and
    run on the CPU at a small size."""
    import chip_smoke as cs
    calls = " ".join(c for cs_ in cs.TAIL_CALLS.values() for c in cs_)
    for name in CALLS:
        assert name + "(" in calls, name
    s = tch.connect(device="cpu")
    table_from_numpy(s, "tail1m", cs.tail1m_columns(20_000, 1000),
                     cs.TAIL1M_TYPES)
    for mod, form, sql, _ in cs.tail1m_sqls():
        assert s.execute(sql).rows(), (mod, form)


# what each AGGTAIL_CAPTURE label must keep of its query's calls (the
# arguments of the launch wrapper, in the plain entries' places; the
# events are hits_t's 200,000 rows twice)
_CAPTURED = {
    "events": lambda a: a[2] is not None and a[0].shape[0] >= 400_000,
    "token": lambda a: a[1] == 62 and a[0].dtype == torch.int64,
    "events_bounds": lambda a: a[0][0].shape[0] >= 400_000,
    "retention": lambda a: a[1] is not None and [sp[0] for sp in a[0]]
    == ["max"] * 3,
    "funnel": lambda a: a[1] is None and a[0][0][0] == "min"
    and a[0][0][2] is not None,
    "sums": lambda a: a[1] is None and sum(
        getattr(sp[1], "dtype", None) == torch.float64 for sp in a[0]) == 5,
    "weights": lambda a: a[0] == "sum" and a[1].dtype == torch.float64
    and a[2] is not None,
    "max": lambda a: a[0] == "max" and a[2] is not None,
    "last": lambda a: a[0] == "last" and a[1] is None and a[3] is not None}


def test_chip_smoke_aggtail_capture_keeps_the_intended_calls():
    """The smoke's AggTailWatch, over the CPU path's entries, keeps of
    each label's query the call its replay is named for: the events'
    sort over twice the rows, the 62-bit token, retention's three maxes,
    windowFunnel's masked min, rankCorr's five float64 sums, the running
    weights, intervalLengthSum's max and deltaSum's masked last."""
    cs, s, _ = _smoke()
    assert set(_CAPTURED) == set(cs.AGGTAIL_CAPTURE)
    watch = cs.AggTailWatch(plain=True)
    try:
        for name in dict.fromkeys(q for _, q in cs.AGGTAIL_CAPTURE.values()):
            watch.query = name
            s.execute(dict(cs.AGGTAIL_QUERIES)[name],
                      settings=cs.aggtail_settings(name))
            watch.query = ""
    finally:
        watch.close()
    for label, ok in _CAPTURED.items():
        assert label in watch.args, label
        assert ok(watch.args[label][1]), (label, watch.args[label][0])


@pytest.mark.parametrize("window", [None, 2, 10])
def test_chip_smoke_moving_sums_follow_row_order(window):
    """The smoke's closed form for Qg2 and Qg2w (a row's place in its
    group of equal x is row // 1,000,003) against running sums taken
    group by group in row order, and the port's answer, over 2,200,000
    rows of hits_t (2 or 3 rows a group, whose t differ): window 2 cuts
    the groups, None and 10 do not."""
    import chip_smoke as cs
    n = 2_200_000
    cols = cs.hits_t_columns(n)
    x, t = cols["x"], cols["t"]
    cnt = np.bincount(x)
    sec = t % 86400
    o = np.argsort(x, kind="stable")
    xs, ss = x[o], sec[o]
    first = np.r_[True, xs[1:] != xs[:-1]]
    gid = np.cumsum(first) - 1
    run = np.cumsum(ss)
    base = np.r_[0, run][np.flatnonzero(first)][gid]
    run = run - base                       # the running sum in its group
    if window is not None:
        pos = np.arange(n) - np.flatnonzero(first)[gid]
        back = np.where(pos >= window, np.r_[0, run][np.arange(n) + 1
                                                     - window], 0)
        run = run - np.where(pos >= window, back, 0)
    want = int(run.sum())
    assert cs.moving_sums_answer(x, t, cnt, window) == want
    s = tch.connect(device="cpu")
    s.execute("CREATE TABLE hits_t (t DateTime, d Date, x Int64)")
    s.insert_pydict("hits_t", cols)
    sql = dict(cs.AGGTAIL_QUERIES)["Qg2" if window is None else "Qg2w"]
    if window is not None:
        sql = sql.replace("(10)", f"({window})")
    got = s.execute(sql, settings={"max_groups": 1 << 20,
                                   "group_array_max_size": 8}).rows()
    assert got == [(want,)], (got, want)
