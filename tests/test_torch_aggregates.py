"""The CUDA engine's aggregate tail against the JAX reference, on the CPU.

Every name of the port's aggregate registry (exprs/aggregates.py _BASE,
the reference's base registry less the sketch and agg_ext classes) runs
through ``clickhouse_tpu.connect()`` and ``clickhouse_tpu_torch.connect(
device="cpu")`` over the same seeded numpy tables, under GROUP BY (), under
the sort grouping and with -If, and the rows must agree: integers (and
strings, and the integers of an Array) exactly; floats within rtol 1e-9
and an absolute 1e-9 of the statistic's largest term (the variance's mean
square, the covariance's mean |x y|, the skewness' mean |x|^3 / var^1.5,
the kurtosis' mean x^4 / var^2): both engines cancel the same float64
sums, which they add in different orders (the reference as differences of
prefix sums over every sorted row, whose error grows with the table, not
the group).  Where the reference is wrong against ClickHouse, the case is
pinned as a test of its own that fails if the reference is repaired.
"""
import math

import numpy as np
import pytest
import torch

import clickhouse_tpu as jch
import clickhouse_tpu_torch as tch
from clickhouse_tpu_torch.core.errors import (AnalysisError,
                                              MemoryLimitExceeded,
                                              NotImplementedError_,
                                              TypeError_, UnknownFunction)
from clickhouse_tpu_torch.exprs import aggregates as tagg
from clickhouse_tpu_torch.interop import table_from_numpy

N_T = 12_000
T_TYPES = {"k": "Int32", "a": "Int32", "b": "UInt8", "u": "UInt64",
           "n": "Nullable(Int64)", "f": "Float64", "g": "Float32",
           "s": "String"}
N_Z = 4_000
Z_TYPES = {"k": "Int32", "f": "Float64", "g": "Float32", "o": "Int32"}
RTOL = 1e-9
ATOL_SCALE = 1e-9

# the argument list of each class's calls (a parametric call's levels are
# added by _call)
ARGS = {
    "CountAgg": "a", "SumAgg": "a", "SumWithOverflowAgg": "b",
    "MinAgg": "a", "MaxAgg": "a", "AvgAgg": "a", "AnyAgg": "a",
    "AnyRespectNullsAgg": "n", "VarPopAgg": "f", "VarSampAgg": "f",
    "StddevPopAgg": "f", "StddevSampAgg": "f", "ArgMinAgg": "a, f",
    "ArgMaxAgg": "u, g", "UniqExactAgg": "n", "QuantileExactAgg": "a",
    "MedianAgg": "g", "CovarPopAgg": "f, a", "CovarSampAgg": "f, a",
    "CorrAgg": "f, a", "SkewPopAgg": "f", "SkewSampAgg": "f",
    "KurtPopAgg": "f", "KurtSampAgg": "f", "AvgWeightedAgg": "a, b",
    "GroupBitAndAgg": "u", "GroupBitOrAgg": "u", "GroupBitXorAgg": "u",
    "QuantileExactHighAgg": "a", "QuantileExactExclusiveAgg": "a",
    "QuantileExactInclusiveAgg": "a", "MedianExactHighAgg": "g"}
# the names of the base registry's classes (the sketches of agg_sketch.py:
# tests/test_torch_sketches.py)
NAMES = sorted(n for n, c in tagg._BASE.items()
               if c.__module__ == tagg.__name__)
# the spellings whose ClickHouse rule the reference does not follow (it
# serves them with its QuantileExactAgg): held to numpy's reading of
# ClickHouse's rule, the reference's answer pinned by
# test_quantile_spellings_take_clickhouse_rules_divergence
CLICKHOUSE_RULES = ("QuantileExactHighAgg", "QuantileExactExclusiveAgg",
                    "QuantileExactInclusiveAgg", "MedianExactHighAgg")
FORMS = ("global", "sort", "if")


def _call(name: str, cond: str = None) -> str:
    cls = tagg._BASE[name].__name__
    args = ARGS[cls] + (f", {cond}" if cond else "")
    fn = name + ("If" if cond else "")
    if name in tagg._MULTI_Q:
        lead = "100, " if name == "quantilesgk" else ""
        return f"{fn}({lead}0.1, 0.5, 0.9)({args})"
    if issubclass(tagg._BASE[name], tagg.QuantileExactAgg) \
            and name not in tagg._MEDIAN_NAMES and name != "median":
        lead = "100, " if name == "quantilegk" else ""
        return f"{fn}({lead}0.3)({args})"
    return f"{fn}({args})"


def _levels(name: str):
    if name in tagg._MULTI_Q:
        return [0.1, 0.5, 0.9]
    return [0.5] if name in tagg._MEDIAN_NAMES or name == "median" else [0.3]


def _clickhouse_quantile(vals: np.ndarray, q: float, rule: str):
    """ClickHouse's QuantileExactHigh / Exclusive / Inclusive at level q
    over a group's values (float64 arithmetic, as the engines do)."""
    a = np.sort(vals)
    n = len(a)
    if rule == "high":
        v = a[n // 2 if q == 0.5 else int(q * n) if q < 1 else n - 1]
        return float(v) if a.dtype.kind == "f" else int(v)
    h = q * (n + 1) if rule == "exclusive" else q * (n - 1) + 1
    k = int(h)
    if k >= n:
        return float(a[n - 1])
    if k < 1:
        return float(a[0])
    lo = float(a[k - 1])
    return lo + (h - k) * (float(a[k]) - lo)


def _clickhouse_column(sessions, name: str, form: str):
    """The column of `name` in _class_run's query, by ClickHouse's rule."""
    c = _reference_columns(sessions[0], "t")
    cls = tagg._BASE[name]
    vals = c[ARGS[cls.__name__]]
    if form == "global":
        rows = [np.ones(len(vals), bool)]
    else:
        rows = [(c["k"] == k) & (c["a"] > 0 if form == "if" else True)
                for k in np.unique(c["k"])]
    out = []
    for r in rows:
        picks = [_clickhouse_quantile(vals[r], q, cls.rule)
                 for q in _levels(name)]
        out.append(picks if name in tagg._MULTI_Q else picks[0])
    return out


def _reference_columns(js, table):
    blk = js.catalog.get_table("default", table).read_block()
    return {name: np.asarray(v) for name, v in blk.to_pydict().items()}


@pytest.fixture(scope="module")
def sessions():
    rng = np.random.default_rng(2024)
    js = jch.connect()
    ts = tch.connect(device="cpu")
    u = rng.integers(0, 1 << 62, N_T).astype(np.uint64)
    u[rng.random(N_T) < 0.4] += np.uint64(1 << 63)
    n = rng.integers(-40, 40, N_T).astype(object)
    n[rng.random(N_T) < 0.25] = None
    js.execute("CREATE TABLE t (k Int32, a Int32, b UInt8, u UInt64, "
               "n Nullable(Int64), f Float64, g Float32, s String)")
    js.insert_pydict("t", {
        "k": rng.integers(0, 8, N_T).astype(np.int32),
        "a": rng.integers(-1000, 1000, N_T).astype(np.int32),
        "b": rng.integers(0, 256, N_T).astype(np.uint8), "u": u, "n": n,
        "f": rng.normal(3, 100, N_T),
        "g": rng.normal(0, 10, N_T).astype(np.float32),
        "s": np.asarray([f"s{v}" for v in rng.integers(0, 300, N_T)],
                        object)})
    # z: floats with NaN, -0.0 and +0.0 among repeated values, and an
    # order column with ties
    f = rng.choice([-0.0, 0.0, 1.5, -2.25, np.nan, 7.0], N_Z)
    g = rng.choice([-0.0, 0.0, 3.5, np.nan, -1.0], N_Z).astype(np.float32)
    js.execute("CREATE TABLE z (k Int32, f Float64, g Float32, o Int32)")
    js.insert_pydict("z", {"k": rng.integers(0, 5, N_Z).astype(np.int32),
                           "f": f, "g": g,
                           "o": rng.integers(0, 3, N_Z).astype(np.int32)})
    for name, types in (("t", T_TYPES), ("z", Z_TYPES)):
        table_from_numpy(ts, name, _reference_columns(js, name), types)
    return js, ts


@pytest.fixture(scope="module")
def scales(sessions):
    """The statistics' largest terms over t (each group's are alike: the
    rows are drawn alike)."""
    c = _reference_columns(sessions[0], "t")
    f, a = c["f"].astype(np.float64), c["a"].astype(np.float64)
    var = f.var()
    return {"VarPopAgg": np.mean(f * f), "VarSampAgg": np.mean(f * f),
            "StddevPopAgg": math.sqrt(np.mean(f * f)),
            "StddevSampAgg": math.sqrt(np.mean(f * f)),
            "CovarPopAgg": np.mean(np.abs(f * a)) + np.mean(np.abs(f))
            * np.mean(np.abs(a)),
            "CovarSampAgg": np.mean(np.abs(f * a)) + np.mean(np.abs(f))
            * np.mean(np.abs(a)),
            "CorrAgg": 1.0,
            "SkewPopAgg": np.mean(np.abs(f) ** 3) / var ** 1.5,
            "SkewSampAgg": np.mean(np.abs(f) ** 3) / var ** 1.5,
            "KurtPopAgg": np.mean(f ** 4) / var ** 2,
            "KurtSampAgg": np.mean(f ** 4) / var ** 2,
            "AvgWeightedAgg": float(np.abs(a).max())}


def _close(got, want, atol):
    if isinstance(want, list) or isinstance(got, list):
        return isinstance(got, list) and isinstance(want, list) \
            and len(got) == len(want) \
            and all(_close(g, w, atol) for g, w in zip(got, want))
    if isinstance(want, float) or isinstance(got, float):
        if want is None or got is None:
            return got is want
        if math.isnan(want) or math.isnan(got):
            return math.isnan(want) and math.isnan(got)
        return math.isclose(got, want, rel_tol=RTOL, abs_tol=atol)
    return got == want


def _rows_close(got, want, atol=0.0):
    return len(got) == len(want) and all(
        len(g) == len(w) and all(_close(a, b, atol) for a, b in zip(g, w))
        for g, w in zip(got, want))


def _both(sessions, sql, atol=0.0):
    js, ts = sessions
    want = js.execute(sql).rows()
    got = ts.execute(sql).rows()
    assert _rows_close(got, want, atol), (sql, got[:4], want[:4])
    return got


_RUNS = {}


def _class_run(sessions, cls: str, form: str):
    """One query over every name of class `cls` in `form`: the rows of
    both engines and the names' column order (run once a class and
    form)."""
    key = (cls, form)
    if key not in _RUNS:
        names = [n for n in NAMES if tagg._BASE[n].__name__ == cls]
        if form == "global":
            sql = f"SELECT {', '.join(_call(n) for n in names)} FROM t"
        else:
            calls = [_call(n, "a > 0" if form == "if" else None)
                     for n in names]
            sql = (f"SELECT k, {', '.join(calls)} FROM t GROUP BY k "
                   f"ORDER BY k SETTINGS group_by_algorithm = 'sort'")
        js, ts = sessions
        _RUNS[key] = (js.execute(sql).rows(), ts.execute(sql).rows(), names,
                      sql)
    return _RUNS[key]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("name", NAMES)
def test_every_aggregate_name_matches_reference(sessions, scales, name,
                                                form):
    """Each registered name under GROUP BY () (K1), the sort grouping (K4,
    K5, K6 and, for the two-step ones, K6's sorted-order entry) and -If
    gives the reference's values (for CLICKHOUSE_RULES, ClickHouse's rule
    by numpy): its column of one query over every name of its class."""
    cls = tagg._BASE[name].__name__
    want, got, names, sql = _class_run(sessions, cls, form)
    col = names.index(name) + (form != "global")
    atol = ATOL_SCALE * scales.get(cls, 0.0)
    w = _clickhouse_column(sessions, name, form) if cls in CLICKHOUSE_RULES \
        else [r[col] for r in want]
    g = [r[col] for r in got]
    assert len(g) == len(w) and all(_close(a, b, atol)
                                    for a, b in zip(g, w)), (sql, g, w)


@pytest.mark.parametrize("sql", [
    "SELECT any(n) RESPECT NULLS, first_value(n) RESPECT NULLS, "
    "last_value(n) RESPECT NULLS, any(n) FROM (SELECT n FROM t "
    "ORDER BY n NULLS FIRST LIMIT 5)",
    "SELECT k, any(n) RESPECT NULLS, anyLast(n) RESPECT NULLS, "
    "count(n), uniqExact(n), argMax(n, a), median(n) FROM t GROUP BY k "
    "ORDER BY k",
    "SELECT k, uniqExactIf(n, a > 100), quantileIf(0.7)(n, b > 7), "
    "varPopIf(n, b < 100), groupBitOrIf(n, a < 0) FROM t GROUP BY k "
    "ORDER BY k",
], ids=["respect-nulls-null-first", "nullable-grouped", "nullable-if"])
def test_nullable_arguments_match_reference(sessions, sql):
    _both(sessions, sql)


@pytest.mark.parametrize("sql", [
    "SELECT k, uniqExact(a), median(f), argMin(b, f), varPop(f) FROM t "
    "WHERE a > 0 AND b < 200 GROUP BY k ORDER BY k",
    "SELECT uniqExact(a), median(f), argMax(b, a), corr(f, a) FROM t "
    "WHERE a > 0",
    "SELECT n, uniqExact(a), quantileExact(0.75)(a), argMin(f, a) FROM t "
    "GROUP BY n ORDER BY n",
    "SELECT s, count(DISTINCT a), median(a) FROM t GROUP BY s ORDER BY s "
    "LIMIT 40",
    "SELECT g, uniqExact(a), argMax(a, b) FROM t WHERE a < -900 GROUP BY g "
    "ORDER BY g",
    "SELECT k, b % 3 AS m, uniqExact(a), median(f), quantiles(0.25, 0.75)(a)"
    ", uniqExactIf(s, a > 0) FROM t GROUP BY k, m ORDER BY k, m",
    "SELECT k, uniqExact(a), uniqExact(f), median(a), median(g), "
    "quantileIf(0.2)(a, b > 50) FROM t GROUP BY k ORDER BY k",
], ids=["where-sort", "where-global", "nullable-key", "string-key",
        "float-key", "two-keys", "several-secondaries"])
def test_holistic_over_filters_and_key_types_match_reference(sessions, sql):
    """The holistic and two-step aggregates over a filtered block (the row
    mask in parts), Nullable, String, Float32 and two keys, and several
    holistic aggregates with secondary keys of their own (one sort each,
    the same groups)."""
    _both(sessions, sql)


def test_holistic_with_totals_matches_reference(sessions, scales):
    """WITH TOTALS over holistic and two-step aggregates: the rows, and the
    totals row over every row (GROUP BY (), a sort of its own)."""
    sql = ("SELECT k, uniqExact(a), median(a), argMax(a, f), varSamp(f) "
           "FROM t GROUP BY k WITH TOTALS ORDER BY k")
    js, ts = sessions
    _both(sessions, sql)
    want, got = js.execute(sql).totals, ts.execute(sql).totals
    assert list(got) == list(want)
    for w, g in zip(want.values(), got.values()):
        w, g = w[0], g[0]
        w, g = (w.item() if hasattr(w, "item") else w,
                g.item() if hasattr(g, "item") else g)
        assert _close(g, w, ATOL_SCALE * scales["VarSampAgg"]), (g, w)


def test_any_respect_nulls_over_null_then_one():
    """any(x) RESPECT NULLS over [NULL, 1] is NULL on both engines (the
    first row); any(x) skips the NULL."""
    js, ts = jch.connect(), tch.connect(device="cpu")
    for s in (js, ts):
        s.execute("CREATE TABLE rn (k Int32, x Nullable(Int64))")
        s.execute("INSERT INTO rn VALUES (1, NULL), (1, 1), (2, 3), "
                  "(2, NULL)")
    for sql, want in (
            ("SELECT any(x) RESPECT NULLS, any(x) FROM rn WHERE k = 1",
             [(None, 1)]),
            ("SELECT k, any(x) RESPECT NULLS, any(x) FROM rn GROUP BY k "
             "ORDER BY k", [(1, None, 1), (2, 3, 3)])):
        assert js.execute(sql).rows() == want
        assert ts.execute(sql).rows() == want


@pytest.mark.parametrize("sql", [
    "SELECT uniqExact(f), uniqExact(g), argMin(o, f), argMax(o, f), "
    "argMin(k, g), argMax(k, g) FROM z",
    "SELECT k, uniqExact(f), uniqExact(g), argMin(o, f), argMax(o, f), "
    "argMin(o, g), argMax(o, g) FROM z GROUP BY k ORDER BY k",
    "SELECT k, uniqExactIf(f, o > 0), argMinIf(o, f, o < 2), "
    "argMax(f, o), argMin(g, o) FROM z GROUP BY k ORDER BY k",
    "SELECT o, median(f), quantiles(0.1, 0.5, 0.9)(g), min(f), max(g) "
    "FROM z WHERE f = f GROUP BY o ORDER BY o",
], ids=["global", "grouped", "if-and-ties", "quantile-signed-zero"])
def test_nan_and_signed_zero_match_reference(sessions, sql):
    """NaN rows count one each in uniqExact, -0.0 and +0.0 once together;
    argMin/argMax order -0.0 below +0.0 and a NaN above every number, and
    of the rows at the best value take the lowest row id."""
    _both(sessions, sql)


def test_nan_and_signed_zero_are_the_documented_counts(sessions):
    """The counts the reference's answer stands for: each NaN row once,
    -0.0 and +0.0 as one value."""
    c = _reference_columns(sessions[0], "z")
    f = c["f"]
    want = int(np.isnan(f).sum()) + len(np.unique(f[~np.isnan(f)]))
    assert sessions[1].execute("SELECT uniqExact(f) FROM z").rows() \
        == [(want,)]


def test_ties_go_to_the_lowest_row_id(sessions):
    """argMin(v, o) / argMax(v, o) over ties of o: the value of the first
    row (lowest row id) at the best o, on both engines and under both
    groupings."""
    c = _reference_columns(sessions[0], "z")
    o, k = c["o"], c["k"]
    rows = np.arange(len(o))
    for sql_form in ("SELECT argMin(k, o), argMax(k, o) FROM z",
                     "SELECT argMin(k, o), argMax(k, o) FROM z "
                     "WHERE k >= 0 GROUP BY k < 100"):
        got = _both(sessions, sql_form)
        want = (int(k[rows[o == o.min()][0]]), int(k[rows[o == o.max()][0]]))
        assert tuple(got[0][-2:]) == want


def test_uint64_above_2_63_for_argmax_and_group_bits(sessions):
    """UInt64 values above 2^63 order and combine as unsigned."""
    c = _reference_columns(sessions[0], "t")
    u = c["u"].astype(np.uint64)
    got = _both(sessions, "SELECT argMax(a, u), argMin(a, u), "
                          "groupBitAnd(u), groupBitOr(u), groupBitXor(u), "
                          "max(u) FROM t")
    assert got[0][2] == int(np.bitwise_and.reduce(u))
    assert got[0][3] == int(np.bitwise_or.reduce(u))
    assert got[0][4] == int(np.bitwise_xor.reduce(u))
    assert got[0][0] == int(c["a"][np.argmax(u)])


def test_quantiles_give_an_array_of_three_levels(sessions):
    rows = _both(sessions, "SELECT k, quantiles(0.2, 0.5, 0.8)(a), "
                           "quantilesExact(0.9, 0.1, 0.5)(f) FROM t "
                           "GROUP BY k ORDER BY k")
    c = _reference_columns(sessions[0], "t")
    a = np.sort(c["a"][c["k"] == 0])
    assert rows[0][1] == [int(a[int(math.floor(q * (len(a) - 1)))])
                          for q in (0.2, 0.5, 0.8)]
    assert all(len(r[2]) == 3 for r in rows)


@pytest.mark.parametrize("sql", [
    "SELECT count(DISTINCT s), uniqExact(s), countDistinct(s) FROM t",
    "SELECT k, count(DISTINCT s) AS c FROM t GROUP BY k ORDER BY c DESC, k",
    "SELECT k, argMin(s, a), argMax(a, s), any(s), uniqExactIf(s, b > 100) "
    "FROM t GROUP BY k ORDER BY k",
], ids=["global", "grouped", "string-args"])
def test_string_arguments_match_reference(sessions, sql):
    _both(sessions, sql)


def test_secondary_key_inside_a_group_keeps_the_groups():
    """The sort grouping with a secondary key that varies inside each
    group: the same groups (ids, count, bounds) as without it, and each
    group's rows in secondary order; the secondary key is packed into a
    word of its own, which the group boundaries never see."""
    from clickhouse_tpu_torch.ops import agg_ops, sort_ops
    rng = np.random.default_rng(5)
    n = 5000
    key = torch.from_numpy(rng.integers(0, 7, n).astype(np.int32))
    sec = torch.from_numpy(rng.integers(-50, 50, n).astype(np.int64))
    rows = torch.from_numpy(rng.random(n) < 0.9)
    keys = [sort_ops.SortKey(key, bounds=(0, 6))]
    plain = agg_ops.group_by_sort(keys, rows, 64)
    g = agg_ops.group_by_sort(keys, rows, 64,
                              secondary=[sort_ops.SortKey(sec)])
    assert int(g.num_groups) == int(plain.num_groups) == 7
    assert torch.equal(g.group_ids, plain.group_ids)
    assert torch.equal(g.starts, plain.starts)
    assert torch.equal(g.ends, plain.ends)
    for gg in range(7):
        seg = g.take(sec)[int(g.starts[gg]):int(g.ends[gg])]
        assert bool((seg[1:] >= seg[:-1]).all())
        assert len(torch.unique(seg)) > 1
    _, words = sort_ops.sort_rows(keys, rows,
                                  secondary=[sort_ops.SortKey(sec)])
    assert len(words) == 1 and int(words[0].max()) < 16  # flag and key


def test_sorted_entry_matches_the_permuted_entry():
    """K6's sorted-order entry (plain version here) over data already in
    sorted order equals the permuted entry over the raw data, for every
    op, storage type and mask, with empty and fully masked groups and one
    group of 40 % of the rows; `any` is the first masked-in row in sorted
    order."""
    from clickhouse_tpu_torch.ops import scan_ops
    rng = np.random.default_rng(11)
    n, cap_g = 3000, 64
    key = rng.integers(0, 40, n)
    key[rng.random(n) < 0.4] = 7
    perm = np.argsort(key, kind="stable")
    ks = key[perm]
    gid = np.cumsum(np.r_[True, ks[1:] != ks[:-1]]) - 1
    gid[gid == gid[-1]] = cap_g      # a group of invalid rows, sorted last
    perm_t = torch.from_numpy(perm.astype(np.int32))
    gid_t = torch.from_numpy(gid.astype(np.int32))
    starts, ends = scan_ops.bounds_of_gid(gid_t, cap_g)
    masks = [None, torch.from_numpy(rng.random(n) < 0.3),
             torch.from_numpy(key != 7), torch.zeros(n, dtype=torch.bool)]
    for dtype in (torch.bool, torch.int32, torch.int64, torch.float32,
                  torch.float64):
        if dtype == torch.bool:
            x = torch.from_numpy(rng.random(n) < 0.5)
        elif dtype.is_floating_point:
            x = torch.from_numpy(rng.normal(0, 1e3, n)).to(dtype)
            x[::37] = float("nan")
            x[::41] = -0.0
        else:
            x = torch.from_numpy(rng.integers(-2**31, 2**31, n)).to(dtype)
        for op in ("sum", "min", "max", "any", "bor", "band", "bxor",
                   "count"):
            if op in ("bor", "band", "bxor") and dtype.is_floating_point:
                continue
            for m in masks:
                d = None if op == "count" else x
                want = scan_ops.segment_reduce_many(
                    [(op, d, m, False)], perm_t, gid_t, cap_g)[0]
                got = scan_ops.segment_reduce_sorted(
                    [(op, None if d is None else d[perm_t],
                      None if m is None else m[perm_t], False)],
                    starts, ends, n)[0]
                if got.is_floating_point():
                    assert torch.equal(torch.isnan(got), torch.isnan(want))
                    ok = ~torch.isnan(want)
                    assert torch.allclose(got[ok], want[ok], rtol=1e-12,
                                          atol=0), (op, dtype)
                else:
                    assert torch.equal(got, want), (op, dtype, m is None)


def test_statistics_reduce_in_one_k6_call_from_stored_columns(sessions,
                                                              monkeypatch):
    """Under the sort grouping the variance family, corr and groupBitXor
    beside argMax reach K6 as ONE segment_reduce_many call: their sums as
    float64 terms of the arguments as stored (fsumx specs, whose terms K6
    forms in registers), the same term asked twice reduced once, and no
    float64 column built; the rows are the reference's."""
    from clickhouse_tpu_torch.ops import scan_ops
    calls = []
    many = scan_ops.segment_reduce_many

    def spy(specs, *args, **kw):
        calls.append(list(specs))
        return many(specs, *args, **kw)
    monkeypatch.setattr(scan_ops, "segment_reduce_many", spy)
    _both(sessions, "SELECT k, argMax(a, b), varSamp(f), stddevPop(f), "
                    "corr(f, a), groupBitXor(a) FROM t GROUP BY k ORDER BY k",
          atol=ATOL_SCALE * 1e4)
    assert len(calls) == 1
    terms = [d for op, d, _, _ in calls[0] if op == "fsumx"]
    assert [(p, y is not None) for _, y, p in terms] == [
        (1, False), (2, False), (1, True), (1, False), (2, False)]
    # the columns as stored: f's float64 and a's narrow integer storage
    cols = {c.dtype for x, y, _ in terms for c in (x, y) if c is not None}
    assert len(cols) == 2 and torch.float64 in cols
    # max(b), five terms, bxor(a) and the groups' count (from the bounds)
    assert len(calls[0]) == 8
    checked = [scan_ops._checked_spec(sp) for sp in calls[0]]
    assert len(scan_ops._plan_launches(checked, True)[0]) == 1


def test_holistic_working_set_is_held_to_the_budget():
    """The holistic path's working set counts against what the governor's
    estimate leaves of the budget: at a budget where the grouping alone
    answers, count(DISTINCT x) beside it raises MemoryLimitExceeded (its
    sort carries x as a secondary word, and its sorted values and flags
    are held), and a larger budget answers as numpy does."""
    ts = tch.connect(device="cpu")
    n = 100_000
    x = (np.arange(n, dtype=np.int64) * 2654435761) % 1_000_003
    table_from_numpy(ts, "hits", {"x": x}, {"x": "Int64"})
    sql = ("SELECT x % 16 AS k, {agg} FROM hits GROUP BY k ORDER BY k "
           "SETTINGS group_by_algorithm = 'sort', "
           "max_device_memory_bytes = {b}")
    small = 6 << 20
    ts.execute(sql.format(agg="count()", b=small))
    with pytest.raises(MemoryLimitExceeded):
        ts.execute(sql.format(agg="count(DISTINCT x)", b=small))
    rows = ts.execute(sql.format(agg="count(DISTINCT x)", b=64 << 20)).rows()
    assert rows == [(k, len(np.unique(x[x % 16 == k]))) for k in range(16)]


def test_float_statistics_are_held_to_the_budget():
    """The float64 columns the statistics sum (corr: x*y, x, y, x^2, y^2)
    are held against the budget before they are built."""
    ts = tch.connect(device="cpu")
    n = 100_000
    table_from_numpy(ts, "w", {"x": np.arange(n, dtype=np.int32),
                               "y": np.arange(n, dtype=np.int32) % 7},
                     {"x": "Int32", "y": "Int32"})
    sql = "SELECT corr(x, y), varPop(x) FROM w SETTINGS " \
          "max_device_memory_bytes = {}"
    with pytest.raises(MemoryLimitExceeded, match="float64"):
        ts.execute(sql.format(3 << 20))
    got = ts.execute(sql.format(64 << 20)).rows()[0]
    x = np.arange(n, dtype=np.float64)
    assert math.isclose(got[1], x.var(), rel_tol=1e-12)
    assert math.isclose(got[0], np.corrcoef(x, x % 7)[0, 1], rel_tol=1e-9)


def test_unported_aggregates_still_raise_typed_errors(sessions):
    """sumCount, studentTTest, welchTTest, simpleLinearRegression (a Tuple
    result: not ported) and -State of uniqExact raise naming themselves; a
    statistic or a quantile of a String, and -Merge of a column that holds
    no state, raise TypeError_ (ClickHouse's ILLEGAL_TYPE_OF_ARGUMENT)."""
    ts = sessions[1]
    for sql, err, match in (
            ("SELECT varPop(s) FROM t", TypeError_, "varPop"),
            ("SELECT k, corr(a, s) FROM t GROUP BY k", TypeError_, "corr"),
            ("SELECT median(s) FROM t", TypeError_, "median"),
            ("SELECT sumCount(a) FROM t", UnknownFunction, "sumCount"),
            ("SELECT k, studentTTest(f, b) FROM t GROUP BY k",
             UnknownFunction, "studentTTest"),
            ("SELECT k, welchTTest(a, b) FROM t GROUP BY k",
             UnknownFunction, "welchTTest"),
            ("SELECT simpleLinearRegression(a, f) FROM t",
             UnknownFunction, "simpleLinearRegression"),
            ("SELECT k, uniqExactState(a) FROM t GROUP BY k",
             NotImplementedError_, "uniqExactState"),
            ("SELECT k, varPopMerge(a) FROM t GROUP BY k",
             TypeError_, "varPopMerge")):
        with pytest.raises(err, match=match):
            ts.execute(sql)


# -- reference defects, pinned: the port gives ClickHouse's answer ----------

def test_uniqexact_of_two_arguments_divergence():
    """ClickHouse's uniqExact(a, b) counts distinct (a, b) pairs; the
    reference reads a alone (exprs/aggregates.py:450).  The port raises a
    typed error rather than count a alone.  Should the reference be
    repaired, this test fails."""
    js, ts = jch.connect(), tch.connect(device="cpu")
    for s in (js, ts):
        s.execute("CREATE TABLE p (a Int32, b Int32)")
        s.execute("INSERT INTO p VALUES (1, 1), (1, 2), (2, 1), (2, 1)")
    pairs, firsts = 3, 2
    ref = js.execute("SELECT uniqExact(a, b) FROM p").rows()[0][0]
    assert ref == firsts and ref != pairs
    with pytest.raises(NotImplementedError_, match="distinct tuples"):
        ts.execute("SELECT uniqExact(a, b) FROM p")
    with pytest.raises(NotImplementedError_, match="distinct tuples"):
        ts.execute("SELECT count(DISTINCT a, b) FROM p")


def test_quantile_spellings_take_clickhouse_rules_divergence():
    """quantileExactHigh and medianExactHigh take ClickHouse's upper rank
    (floor(n / 2) at level 0.5, else floor(q n)); quantileExactExclusive
    and quantileExactInclusive (and quantileInterpolated) interpolate
    linearly at ClickHouse's ranks q (n + 1) and q (n - 1) + 1, giving a
    Float64.  The reference serves every one of them with its lower exact
    quantile floor(q (n - 1)) (exprs/aggregates.py:825-862).  Should the
    reference be repaired, this test fails."""
    js, ts = jch.connect(), tch.connect(device="cpu")
    for s in (js, ts):
        s.execute("CREATE TABLE qr (v Int32)")
        s.execute("INSERT INTO qr VALUES " + ", ".join(
            f"({v})" for v in (7, 1, 10, 4, 2, 9, 3, 6, 5, 8)))
    sql = ("SELECT quantileExactHigh(0.5)(v), medianExactHigh(v), "
           "quantileExactHigh(0.25)(v), quantileExactExclusive(0.25)(v), "
           "quantileExactInclusive(0.25)(v), quantileInterpolated(0.25)(v), "
           "quantilesExactInclusive(0.25, 0.5)(v), "
           "quantileExactExclusive(0.95)(v) FROM qr")
    assert js.execute(sql).rows() == [(5, 5, 3, 3, 3, 3, [3, 5], 9)]
    assert ts.execute(sql).rows() == [(6, 6, 3, 2.75, 3.25, 3.25,
                                       [3.25, 5.5], 10.0)]
    with pytest.raises(AnalysisError, match="levels 0 and 1"):
        ts.execute("SELECT quantileExactExclusive(1)(v) FROM qr")


def test_quantile_if_over_a_group_without_rows_divergence():
    """quantileExactIf over a group with rows but none masked in: ClickHouse
    gives the type's default (0 for an integer, NaN for a float; its
    QuantileExact::get over an empty array); the reference reads a
    neighbouring group's value (exprs/aggregates.py:511-515, through
    gather_compaction_indices).  Should the reference be repaired, this
    test fails."""
    js, ts = jch.connect(), tch.connect(device="cpu")
    for s in (js, ts):
        s.execute("CREATE TABLE qe (k Int32, v Int32, f Float64)")
        s.execute("INSERT INTO qe VALUES (1, 5, 0.5), (1, 6, 1.5), "
                  "(2, 50, 2.5), (2, 70, 3.5)")
    sql = ("SELECT k, quantileExactIf(0.5)(v, v > 10), "
           "medianIf(f, v > 10) FROM qe GROUP BY k ORDER BY k")
    ref = js.execute(sql).rows()
    got = ts.execute(sql).rows()
    assert got[0][:2] == (1, 0) and math.isnan(got[0][2])
    assert got[1] == (2, 50, 2.5)
    assert ref[1] == got[1]
    assert ref[0][1] != 0 and not math.isnan(ref[0][2])


# -- aggregates over intDiv / modulo terms (K6 forms them in registers) ------

N_TM = 6000
TM_DIVISORS = {"x8": (2, 7, 1024, -3, 127), "x16": (2, 7, 1024, -3, 32767),
               "x32": (2, 7, 1024, -3, 2147483647),
               "xn": (2, 7, 1024, -3, 2147483647)}


@pytest.fixture(scope="module")
def term_sessions():
    """Table tm: Int64 columns whose values fit int8 (x8), int16 (x16) and
    int32 (x32, and xn, Nullable), so the port stores them narrow, each
    holding its storage type's MIN and MAX and negative values."""
    rng = np.random.default_rng(2027)
    js = jch.connect()
    ts = tch.connect(device="cpu")
    cols = {"k": rng.integers(0, 6, N_TM).astype(np.int32)}
    for name, st in (("x8", np.int8), ("x16", np.int16), ("x32", np.int32),
                     ("xn", np.int32)):
        info = np.iinfo(st)
        v = rng.integers(info.min, info.max, N_TM, endpoint=True)
        v[:4] = [info.min, info.max, -1, 0]
        cols[name] = v.astype(np.int64)
    xn = cols["xn"].astype(object)
    xn[rng.random(N_TM) < 0.2] = None
    cols["xn"] = xn
    js.execute("CREATE TABLE tm (k Int32, x8 Int64, x16 Int64, x32 Int64, "
               "xn Nullable(Int64))")
    js.insert_pydict("tm", cols)
    table_from_numpy(ts, "tm", _reference_columns(js, "tm"),
                     {"k": "Int32", "x8": "Int64", "x16": "Int64",
                      "x32": "Int64", "xn": "Nullable(Int64)"})
    return js, ts


@pytest.mark.parametrize("col,c", [(col, c) for col, cs in
                                   TM_DIVISORS.items() for c in cs])
def test_aggregates_over_terms_match_reference(term_sessions, col, c):
    """Under the sort grouping, argMax/argMin by, min, max, sum,
    groupBitXor, -If forms, varSamp and corr over `x % c` and
    `intDiv(x, c)` (each term asked more than once in the query; the port
    hands K6 a scan_ops.Term of x's narrow storage where c fits it) give
    the reference's rows: integers exactly; varSamp within rtol 1e-9 and
    ATOL_SCALE of its mean square term, corr within 1e-9."""
    js, ts = term_sessions
    m, d = f"{col} % {c}", f"intDiv({col}, {c})"
    sql = (f"SELECT k, argMax({col}, {m}), argMin({col}, {d}), min({m}), "
           f"max({d}), sum({m}), groupBitXor({d}), maxIf({m}, {col} < 0), "
           f"sumIf({d}, {col} > 0), argMaxIf({col}, {m}, {col} > 0), "
           f"varSamp({m}), corr({col}, {m}) FROM tm GROUP BY k ORDER BY k "
           f"SETTINGS group_by_algorithm = 'sort'")
    want, got = js.execute(sql).rows(), ts.execute(sql).rows()
    x = np.asarray([v for v in _reference_columns(js, "tm")[col]
                    if v is not None], dtype=np.int64)
    r = np.fmod(x, c).astype(np.float64)
    atol = [0.0] * 10 + [ATOL_SCALE * float(np.mean(r * r)), ATOL_SCALE]
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b, tol in zip(g, w, atol):
            assert _close(a, b, tol), (sql, g, w)


def test_q2s2_terms_reach_k6_as_one_source(term_sessions, monkeypatch):
    """Q2s2's shape over x32 (int32 storage): the aggregates hand
    segment_reduce_many `x % 7` as scan_ops.Terms (argMax's and corr's),
    and its plan is ONE launch reading ONE source column (x's storage) in
    four forms; the rows are the reference's."""
    from clickhouse_tpu_torch.ops import scan_ops
    js, ts = term_sessions
    calls = []
    many = scan_ops.segment_reduce_many

    def spy(specs, *args, **kw):
        calls.append(list(specs))
        return many(specs, *args, **kw)
    monkeypatch.setattr(scan_ops, "segment_reduce_many", spy)
    sql = ("SELECT x32 % 1024 AS k, argMax(x32, x32 % 7), varSamp(x32), "
           "stddevPop(x32), corr(x32, x32 % 7), groupBitXor(x32) FROM tm "
           "GROUP BY k ORDER BY k LIMIT 10 "
           "SETTINGS group_by_algorithm = 'sort'")
    x = _reference_columns(js, "tm")["x32"].astype(np.float64)
    assert _rows_close(ts.execute(sql).rows(), js.execute(sql).rows(),
                       ATOL_SCALE * float(np.mean(x * x)))
    assert len(calls) == 1
    terms = [d for op, d, _, _ in calls[0] if isinstance(d, scan_ops.Term)]
    terms += [t for op, d, _, _ in calls[0] if op == "fsumx"
              for t in d[:2] if isinstance(t, scan_ops.Term)]
    assert terms and all(t.op == "mod" and t.c == 7
                         and t.source.dtype == torch.int32 for t in terms)
    checked = [scan_ops._checked_spec(sp) for sp in calls[0]]
    launches, _ = scan_ops._plan_launches(checked, True)
    assert len(launches) == 1 and len(launches[0].data) == 1
    assert launches[0].data[0].dtype == torch.int32
    assert len(launches[0].specs) == 7 and len(launches[0].forms) == 4
