"""The CUDA engine's SQL slice against the JAX reference, on the CPU.

The same SQL runs through ``clickhouse_tpu.connect()`` and
``clickhouse_tpu_torch.connect(device="cpu")`` over the same rows (made
from a seed with numpy, loaded into the reference, read back from its
table and handed to the port with ``interop.table_from_numpy``), and the
rows must agree: integers exactly, floats within rtol=1e-12 (the two
engines add in different orders).  Float sums over the sort grouping are
held to an absolute tolerance of n * eps * sum(|f|) instead (n the table's
rows): the reference takes a group's sum as a difference of two prefix
sums over all sorted rows, whose error scales with the running prefix
(at most sum(|f|)), not with the group.  Rows compare in order where the
reference's order is defined (ORDER BY, and the sort grouping's ascending
keys), as sets otherwise.
"""
import math

import numpy as np
import pytest
import torch

import clickhouse_tpu as jch
import clickhouse_tpu_torch as tch
from clickhouse_tpu_torch.core.errors import (CapacityError,
                                              MemoryLimitExceeded,
                                              NotImplementedError_,
                                              UnknownFunction, UnknownTable)
from clickhouse_tpu_torch.interop import table_from_numpy

FLOAT_RTOL = 1e-12
N_HITS = 100_000
N_T = 20_000
T_TYPES = {"a": "Int32", "b": "UInt8", "u": "UInt64", "n": "Nullable(Int64)",
           "f": "Float64", "g": "Float32"}
N_W = 3000
W_TYPES = {"f1": "Float64", "f2": "Float64", "f3": "Float64", "u1": "UInt64",
           "u2": "UInt64", "i1": "Int64", "v": "Int64"}
U64_EDGE = [9544035305396814861, 1, (1 << 63) + 1025, (1 << 64) - 1]
S_TYPES = {"k": "String", "a": "Int32", "n": "Nullable(String)",
           "f": "Float64", "d": "Date", "i16": "Int16", "u32": "UInt32"}


def _reference_columns(js, table):
    blk = js.catalog.get_table("default", table).read_block()
    return {name: np.asarray(v) for name, v in blk.to_pydict().items()}


@pytest.fixture(scope="module")
def sessions():
    rng = np.random.default_rng(1234)
    js = jch.connect()
    ts = tch.connect(device="cpu")
    # hits: the bench table at a narrow size
    js.execute("CREATE TABLE hits (x Int64)")
    js.insert_pydict("hits", {"x": (np.arange(N_HITS, dtype=np.int64)
                                    * 2654435761) % 1_000_003})
    # t: small bounded keys, UInt64 above 2^63, NULLs, NaN and -0.0
    u = rng.integers(0, 1 << 62, N_T).astype(np.uint64)
    u[rng.random(N_T) < 0.3] += np.uint64(1 << 63)
    n = rng.integers(-50, 50, N_T).astype(object)
    n[rng.random(N_T) < 0.2] = None
    f = rng.normal(0, 100, N_T)
    f[rng.random(N_T) < 0.01] = np.nan
    f[rng.random(N_T) < 0.01] = -0.0
    js.execute("CREATE TABLE t (a Int32, b UInt8, u UInt64, "
               "n Nullable(Int64), f Float64, g Float32)")
    js.insert_pydict("t", {"a": rng.integers(0, 10, N_T).astype(np.int32),
                           "b": rng.integers(0, 4, N_T).astype(np.uint8),
                           "u": u, "n": n, "f": f,
                           "g": rng.normal(0, 10, N_T).astype(np.float32)})
    # s: strings, nullable strings, dates and narrow integers
    ns = 5000
    js.execute("CREATE TABLE s (k String, a Int32, n Nullable(String), "
               "f Float64, d Date, i16 Int16, u32 UInt32)")
    ks = np.asarray([f"k{v}" for v in rng.integers(0, 20, ns)], object)
    nstr = np.asarray([f"n{v}" for v in rng.integers(0, 5, ns)], object)
    nstr[rng.random(ns) < 0.2] = None
    js.insert_pydict("s", {
        "k": ks, "a": rng.integers(-50, 50, ns).astype(np.int32), "n": nstr,
        "f": rng.normal(0, 10, ns),
        "d": rng.integers(18000, 19000, ns).astype(np.int32),
        "i16": rng.integers(-30000, 30000, ns).astype(np.int16),
        "u32": rng.integers(0, 2**32, ns).astype(np.uint32)})
    # w: six keys that each vary over about 64 bits, drawn from 200 rows
    pool = 200
    wide = {"f1": rng.normal(0, 1e10, pool), "f2": rng.normal(0, 1e10, pool),
            "f3": rng.normal(0, 1e10, pool),
            "u1": rng.integers(0, 2**64, pool, dtype=np.uint64),
            "u2": rng.integers(0, 2**64, pool, dtype=np.uint64),
            "i1": rng.integers(-2**63, 2**63 - 1, pool, dtype=np.int64)}
    pick = rng.integers(0, pool, N_W)
    js.execute("CREATE TABLE w (f1 Float64, f2 Float64, f3 Float64, "
               "u1 UInt64, u2 UInt64, i1 Int64, v Int64)")
    js.insert_pydict("w", {**{k: c[pick] for k, c in wide.items()},
                           "v": np.arange(N_W, dtype=np.int64)})
    # u64edge: UInt64 values whose float64 a second rounding would change
    js.execute("CREATE TABLE u64edge (u UInt64)")
    js.insert_pydict("u64edge", {"u": np.array(U64_EDGE, dtype=np.uint64)})
    table_from_numpy(ts, "u64edge", _reference_columns(js, "u64edge"),
                     {"u": "UInt64"})
    table_from_numpy(ts, "hits", _reference_columns(js, "hits"),
                     {"x": "Int64"})
    table_from_numpy(ts, "w", _reference_columns(js, "w"), W_TYPES)
    table_from_numpy(ts, "t", _reference_columns(js, "t"), T_TYPES)
    table_from_numpy(ts, "s", _reference_columns(js, "s"), S_TYPES)
    # arr: an Array column, for the keys the port refuses (GROUP BY,
    # DISTINCT and ORDER BY over an Array)
    for s in (js, ts):
        s.execute("CREATE TABLE arr (k Int64, v Array(Float32))")
        s.execute("INSERT INTO arr VALUES (1, [1, 2]), (2, [3]), (3, [])")
    return js, ts


def _same_value(got, want, atol=0.0):
    if isinstance(want, float) or isinstance(got, float):
        if want is None or got is None:
            return got is want
        if math.isnan(want):
            return math.isnan(got)
        if want == 0.0 and not atol:
            return got == 0.0
        return math.isclose(got, want, rel_tol=FLOAT_RTOL, abs_tol=atol)
    return got == want


def _rows_match(got, want, atol=0.0):
    return len(got) == len(want) and all(
        len(g) == len(w) and all(_same_value(a, b, atol)
                                 for a, b in zip(g, w))
        for g, w in zip(got, want))


def _both(sessions, sql, ordered=True, atol=0.0):
    js, ts = sessions
    want = js.execute(sql).rows()
    got = ts.execute(sql).rows()
    if not ordered:
        key = repr
        want, got = sorted(want, key=key), sorted(got, key=key)
    assert _rows_match(got, want, atol), (sql, got[:5], want[:5])
    return got


def _sum_atol(sessions, table, column):
    """n * eps * sum(|column|) over the table's finite values."""
    js = sessions[0]
    v = np.asarray(_reference_columns(js, table)[column], np.float64)
    v = v[np.isfinite(v)]
    return len(v) * np.finfo(np.float64).eps * float(np.abs(v).sum())


@pytest.mark.parametrize("sql", [
    "SELECT count() FROM hits WHERE x > 500000",
    "SELECT x % 1024 AS k, count() AS c, sum(x) FROM hits GROUP BY k "
    "ORDER BY c DESC LIMIT 10",
    "SELECT x FROM hits ORDER BY x LIMIT 100",
    "SELECT x FROM hits ORDER BY x DESC LIMIT 50",
], ids=["Q1", "Q2", "Q3", "Q3-desc"])
def test_bench_queries_match_reference(sessions, sql):
    rows = _both(sessions, sql)
    assert rows


def test_order_by_int64_limit_takes_32bit_topk_on_both(sessions,
                                                      monkeypatch):
    """ORDER BY an Int64 column with proven bounds, over >= 2^16 rows,
    takes the 32-bit top-k on both packages and gives the same rows."""
    from clickhouse_tpu.ops import sort_ops as jsort
    from clickhouse_tpu_torch.ops import sort_ops as tsort
    calls = []
    for mod, name in ((jsort, "jax"), (tsort, "torch")):
        fn = mod.topk_permutation32

        def spy(*args, _fn=fn, _name=name):
            calls.append(_name)
            return _fn(*args)
        monkeypatch.setattr(mod, "topk_permutation32", spy)
    _both(sessions, "SELECT x, x % 7 AS r FROM hits WHERE x > 1000 "
                    "ORDER BY x DESC LIMIT 37")
    assert sorted(set(calls)) == ["jax", "torch"]


@pytest.mark.parametrize("sql", [
    "SELECT count(), sum(n) FROM t WHERE n > 10",
    "SELECT count() FROM t WHERE n IS NULL",
    "SELECT count(), sum(u) FROM t WHERE u > 9223372036854775808",
    "SELECT count(), sum(a) FROM t WHERE u < 4611686018427387904 AND b != 2",
    "SELECT count(n), countIf(a > 3), sumIf(a, b = 1) FROM t",
    "SELECT avg(a), min(a), max(a), min(u), max(u), avg(u) FROM t",
    "SELECT min(f), max(f), sum(f), avg(f), min(g), max(g), sum(g) FROM t",
    "SELECT min(f), max(f), sum(f), avg(n) FROM t WHERE b = 3 AND f = f",
    "SELECT any(a), min(n), max(n) FROM t WHERE b = 2",
    "SELECT count() FROM t WHERE a + b * 2 > 9 OR f < -150.0",
], ids=["nullable-filter", "is-null", "uint64-filter", "uint64-and",
        "countIf-sumIf", "int-aggs", "float-aggs", "nan-filtered",
        "any-nullable-minmax", "arith-or"])
def test_global_aggregates_match_reference(sessions, sql):
    _both(sessions, sql)


@pytest.mark.parametrize("sql", [
    "SELECT count() FROM hits WHERE x = 500000",
    "SELECT count(), sum(x) FROM hits WHERE x != 1000",
    "SELECT count(), sum(x) FROM hits WHERE x < 1000",
    "SELECT count() FROM hits WHERE x <= 999983",
    "SELECT count(), min(x) FROM hits WHERE x >= 500000",
    "SELECT count() FROM hits WHERE 500000 < x",
    "SELECT count(), sum(x), min(x), avg(x) FROM hits "
    "WHERE x > 1000 AND x < 900000",
    "SELECT count(), sum(n), min(n), avg(n) FROM t WHERE n >= -10",
    "SELECT count(), sum(a) FROM t WHERE u > 9223372036854775808 AND a < 5",
    "SELECT count(), sum(a) FROM t WHERE u > -1",
    "SELECT count(), max(f), min(g) FROM t WHERE f > 0.5 AND g <= 3",
    "SELECT count(), sum(a) FROM t WHERE b = 300 OR b < 1",
    "SELECT count() FROM t WHERE b != 300",
    "SELECT count(), sum(a), max(f) FROM t WHERE a > 2 AND a < 8 AND b != 1 "
    "AND f > -50 AND g < 10",
    "SELECT count(), countIf(a > 3), sum(a) FROM t WHERE n < 20 AND a + 1 > 2",
], ids=["equals", "notEquals", "less", "lessOrEquals", "greaterOrEquals",
        "literal-first", "and-of-two-terms", "nullable", "uint64-and-int32",
        "uint64-vs-signed", "floats", "or-unfused", "beyond-storage-range",
        "five-conjuncts", "term-and-expression"])
def test_filter_terms_match_reference(sessions, sql):
    """WHERE clauses whose `column CMP literal` conjuncts K1 takes as terms
    (and the rest as a mask) give the reference's rows."""
    _both(sessions, sql)


@pytest.mark.parametrize("n_rows", [0, 1500], ids=["empty", "not-1024k"])
def test_filter_terms_over_small_tables(sessions, n_rows):
    """An empty table, and one whose row count is not a multiple of 1024."""
    js, ts = sessions
    x = (np.arange(n_rows, dtype=np.int64) * 7919) % 3001 - 1500
    for s in (js, ts):
        s.execute(f"CREATE TABLE small{n_rows} (x Int64, y Nullable(Int32))")
        if n_rows:
            s.insert_pydict(f"small{n_rows}", {
                "x": x, "y": np.where(x % 5 == 0, None, x // 3)
                .astype(object)})
    for sql in ("SELECT count(), sum(x), min(x), avg(x) FROM {t} "
                "WHERE x > 100",
                "SELECT count(), sum(y) FROM {t} WHERE y <= 0 AND x != 7",
                "SELECT count() FROM {t}"):
        _both(sessions, sql.format(t=f"small{n_rows}"))


def test_q1_is_one_k1_call_with_a_term(sessions, monkeypatch):
    """Q1 reaches K1 once, with `x > 500000` as a term over x's int32
    storage and no mask, and builds no row mask of the table."""
    from clickhouse_tpu_torch.ops import agg_ops
    calls, built = [], []
    plain = agg_ops._masked_reduce_plain
    tensor = agg_ops.RowMask.tensor

    def spy(op, data, mask, unsigned=False, n_rows=None, terms=()):
        calls.append((op, data, mask, n_rows, terms))
        return plain(op, data, mask, unsigned, n_rows, terms)

    def spy_tensor(self):
        built.append(self.capacity)
        return tensor(self)
    monkeypatch.setattr(agg_ops, "_masked_reduce_plain", spy)
    monkeypatch.setattr(agg_ops.RowMask, "tensor", spy_tensor)
    _both(sessions, "SELECT count() FROM hits WHERE x > 500000")
    assert len(calls) == 1
    op, data, mask, n_rows, terms = calls[0]
    assert op == "sum" and data is None and mask is None
    assert n_rows == N_HITS and len(terms) == 1
    assert terms[0].storage.dtype == torch.int32 and terms[0].cmp == "greater"
    assert terms[0].storage.shape[0] not in built


@pytest.mark.parametrize("sql", [
    "SELECT a, b, count(), sum(n), sum(u) FROM t GROUP BY a, b",
    "SELECT b, count(), countIf(a > 4), avg(a) FROM t GROUP BY b",
    "SELECT a % 3 AS m, count() AS c, sum(a) FROM t WHERE n IS NOT NULL "
    "GROUP BY m",
], ids=["two-keys", "countIf-avg", "expr-key"])
def test_dense_group_by_matches_reference(sessions, sql):
    _both(sessions, sql, ordered=False)


@pytest.mark.parametrize("sql", [
    "SELECT f FROM t ORDER BY f LIMIT 20",
    "SELECT f FROM t ORDER BY f DESC LIMIT 20",
    "SELECT n FROM t ORDER BY n LIMIT 30",
    "SELECT n FROM t ORDER BY n DESC LIMIT 30",
    "SELECT u, a FROM t ORDER BY u DESC LIMIT 25",
    "SELECT g FROM t ORDER BY g LIMIT 15",
], ids=["float-nan", "float-desc", "nullable", "nullable-desc",
        "uint64-desc", "float32"])
def test_order_by_limit_matches_reference(sessions, sql):
    _both(sessions, sql)


@pytest.mark.parametrize("sql,ordered", [
    ("SELECT count() FROM s WHERE k = 'k3'", True),
    ("SELECT count() FROM s WHERE k IN ('k1', 'k2', 'zz')", True),
    ("SELECT count() FROM s WHERE a IN (1, 2, 3) OR a NOT IN (4)", True),
    ("SELECT count() FROM s WHERE k > 'k15'", True),
    ("SELECT k, count(), sum(a) FROM s GROUP BY k", False),
    ("SELECT n, count() FROM s GROUP BY n", False),
    ("SELECT min(k), max(k), any(k) FROM s", True),
    ("SELECT k FROM s ORDER BY k DESC LIMIT 7", True),
    ("SELECT n FROM s ORDER BY n LIMIT 7", True),
    ("SELECT toString(a) AS t, count() FROM s WHERE a < -45 GROUP BY t",
     False),
    ("SELECT sum(if(a > 5, 1, 0)), sum(multiIf(a < -10, 1, a < 10, 2, 3)) "
     "FROM s", True),
    ("SELECT count() FROM s WHERE if(a > 0, 'pos', 'neg') = 'pos'", True),
    ("SELECT sum(intDiv(a, 7)), sum(a % 7), sum(-a), sum(abs(a)), "
     "sum(least(a, 3)), max(greatest(a, 3)) FROM s", True),
    ("SELECT sum(toInt64(f)), sum(toInt32(f * 100)), sum(CAST(a AS Float64)),"
     " sum(toUInt8(a)) FROM s", True),
    ("SELECT count() FROM s WHERE isNull(n) AND a > 0", True),
    ("SELECT sum(coalesce(toInt64(a), 0)), count(nullIf(a, 3)) FROM s", True),
    ("SELECT min(d), max(d), count() FROM s WHERE d > toDate('2020-01-01')",
     True),
    ("SELECT sum(i16), min(i16), max(i16), avg(i16), sum(u32), max(u32) "
     "FROM s", True),
    ("SELECT sum(u32 % 1000), sum(intDiv(u32, 3)) FROM s", True),
    ("SELECT sum(a * 2 + 1), sum(a - 100), sum(f / 3) FROM s", True),
    ("SELECT a % 5 AS m, count(), countIf(n IS NULL) FROM s GROUP BY m",
     False),
    ("SELECT i16 FROM s ORDER BY i16 LIMIT 5", True),
    ("SELECT u32 FROM s ORDER BY u32 DESC LIMIT 5", True),
], ids=["str-eq", "str-in", "int-in", "str-order", "str-key", "nullable-str-key",
        "str-minmax", "str-order-desc", "nullable-str-order", "toString-key",
        "if-multiIf", "str-if", "intDiv-mod-neg-abs-least", "casts",
        "isNull", "coalesce-nullIf", "dates", "narrow-ints", "uint32-div",
        "arith", "mod-key", "int16-order", "uint32-order"])
def test_strings_casts_and_functions_match_reference(sessions, sql, ordered):
    _both(sessions, sql, ordered=ordered)


def test_ddl_insert_values_and_drop(sessions):
    js, ts = sessions
    for s in (js, ts):
        s.execute("CREATE TABLE v (k Int32, w Nullable(UInt16), z Float64)")
        s.execute("INSERT INTO v VALUES (1, 5, 0.5), (2, NULL, -1.5), "
                  "(3, 65535, 2.0), (2, 7, 1.0)")
    _both(sessions, "SELECT count(), sum(k), sum(w), max(w), avg(z) FROM v")
    _both(sessions, "SELECT k, count(), sum(w) FROM v GROUP BY k",
          ordered=False)
    for s in (js, ts):
        s.execute("DROP TABLE v")
    with pytest.raises(UnknownTable):
        ts.execute("SELECT count() FROM v")


@pytest.mark.parametrize("sql,err,match", [
    ("SELECT sumCount(a) FROM t", UnknownFunction, "sumCount"),
    ("SELECT xxHash64(a) FROM t", UnknownFunction, "xxHash64"),
    ("SELECT x FROM hits ORDER BY x", None, None),
    ("SELECT x, count() FROM hits GROUP BY x", None, None),
    ("SELECT a, min(f) FROM t GROUP BY a", None, None),
    ("SELECT a, count() FROM t GROUP BY a SETTINGS group_by_algorithm='sort'",
     None, None),
    ("SELECT x FROM hits ORDER BY x LIMIT 5000", None, None),
    ("SELECT a FROM t UNION ALL SELECT a FROM t", None, None),
    ("ALTER TABLE t DELETE WHERE a = 1", NotImplementedError_,
     "AlterTable"),
    ("SELECT a, count() FROM t GROUP BY a WITH TOTALS", None, None),
    ("SELECT a FROM t ORDER BY a WITH FILL", None, None),
    ("SELECT a, sumState(n) FROM t GROUP BY a", None, None),
    ("SELECT a, uniqExact(b) FROM t GROUP BY a", None, None),
    ("SELECT a, argMax(b, f) FROM t GROUP BY a", None, None),
    ("SELECT a, groupBitOr(b) FROM t GROUP BY a", None, None),
    ("SELECT a, uniq(b) FROM t GROUP BY a", None, None),
    ("SELECT a, quantile(0.5)(f) FROM t GROUP BY a", None, None),
    ("SELECT a, uniqExactState(b) FROM t GROUP BY a", NotImplementedError_,
     "uniqExactState"),
    ("SELECT isFinite(f), isNaN(g) FROM t", None, None),
    ("SELECT v, count() FROM arr GROUP BY v", NotImplementedError_,
     "GROUP BY over the Array"),
    ("SELECT DISTINCT v FROM arr", NotImplementedError_,
     "DISTINCT over the Array"),
    ("SELECT v FROM arr ORDER BY v", NotImplementedError_,
     "ORDER BY over the Array"),
    ("SELECT k, v FROM arr ORDER BY v LIMIT 2", NotImplementedError_,
     "ORDER BY over the Array"),
], ids=["unknown-aggregate", "unknown-scalar", "full-sort", "unbounded-keys",
        "minmax-group-by", "sort-setting", "large-k", "union", "alter",
        "with-totals", "with-fill", "state-combinator",
        "grouped-uniqExact", "grouped-argMax", "grouped-groupBitOr",
        "grouped-uniq", "grouped-quantile", "grouped-unported-combinator",
        "ported-scalar-isFinite", "array-group-by", "array-distinct",
        "array-order-by", "array-order-by-limit"])
def test_unported_paths_raise_typed_errors(sessions, sql, err, match):
    """Unported paths raise typed errors naming them (an unported
    aggregate under GROUP BY names the aggregate, not its argument); the
    paths ported since (err None: the full sort, the sort grouping,
    k > 4,096, WITH TOTALS, WITH FILL, -State, uniqExact, argMax,
    groupBitOr, uniq and quantile under GROUP BY, UNION ALL, and isFinite,
    the case that named
    an unported scalar before cityHash64 did) answer as the reference does;
    uniqUpTo and xxHash64 took the places of uniq and cityHash64, ported
    since."""
    if err is None:
        _both(sessions, sql)
        return
    with pytest.raises(err, match=match):
        sessions[1].execute(sql)


def test_aggregate_names_are_the_references():
    """The port's copy of the reference's aggregate names is its registry,
    and every name (and a combinator of it) is an aggregate call."""
    from clickhouse_tpu.exprs import aggregates as jagg
    from clickhouse_tpu_torch.exprs import aggregates as tagg
    assert tagg.REFERENCE_AGGREGATES == set(jagg.AGGREGATES)
    for name in sorted(jagg.AGGREGATES):
        for form in (name, name + "If", name + "State", name + "Merge"):
            assert tagg.is_aggregate_name(form) \
                == jagg.is_aggregate_name(form), form
    for name in ("plus", "concat", "cosineDistance", "ifNull"):
        assert not tagg.is_aggregate_name(name)


Q2B = ("SELECT x AS k, count() AS c FROM hits GROUP BY k ORDER BY c DESC "
       "LIMIT 10 SETTINGS max_groups = 2097152")
Q2M = ("SELECT intDiv(x, 4) AS k, count() AS c, sum(x) AS s, min(x) AS lo, "
       "max(x) AS hi, any(x) AS a FROM hits GROUP BY k ORDER BY s DESC "
       "LIMIT 10")


@pytest.mark.parametrize("sql", [Q2B, Q2M,
                                 Q2M.replace("ORDER BY s DESC LIMIT 10",
                                             "ORDER BY k")],
                         ids=["Q2b", "Q2m", "Q2m-all-groups"])
def test_sort_grouping_bench_queries_match_reference(sessions, sql,
                                                     monkeypatch):
    """Q2b and Q2m take the sort grouping on both packages (K4, K5; K6 for
    Q2m's sum, min, max and any) and give the same rows."""
    from clickhouse_tpu_torch.ops import scan_ops, sort_ops
    seen = []
    for mod, name in ((sort_ops, "radix_sort_pairs"),
                      (scan_ops, "segment_bounds"),
                      (scan_ops, "segment_reduce_many")):
        fn = getattr(mod, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            seen.append(_name)
            return _fn(*args, **kw)
        monkeypatch.setattr(mod, name, spy)
    assert _both(sessions, sql)
    assert {"radix_sort_pairs", "segment_bounds"} <= set(seen)
    assert ("segment_reduce_many" in seen) == ("min(x)" in sql)


def test_q2m_reduces_every_aggregate_in_one_k6_call(sessions, monkeypatch):
    """Q2m's sum, min, max and any reach K6 as ONE segment_reduce_many
    call of four specs over x's storage and every row of a group (no
    mask, so no count: the group counts come from the grouping's bounds),
    and its count() reaches no kernel; the rows are the reference's."""
    from clickhouse_tpu_torch.ops import scan_ops
    calls = []
    many = scan_ops.segment_reduce_many

    def spy(specs, *args, **kw):
        calls.append(([(op, d, m) for op, d, m, _ in specs], kw))
        return many(specs, *args, **kw)
    monkeypatch.setattr(scan_ops, "segment_reduce_many", spy)
    _both(sessions, Q2M)
    assert len(calls) == 1
    specs, kw = calls[0]
    assert [op for op, _, _ in specs] == ["sum", "min", "max", "any"]
    assert all(m is None for _, _, m in specs)
    assert len({d.data_ptr() for _, d, _ in specs}) == 1
    assert kw["group_rows"] is not None


@pytest.mark.parametrize("sql,ordered", [
    ("SELECT n, count(), sum(a), min(a), max(a) FROM t GROUP BY n "
     "SETTINGS group_by_algorithm='sort'", True),
    ("SELECT k, count(), min(a), max(i16), any(d), avg(a) FROM s GROUP BY k",
     False),
    ("SELECT n, count(), min(k), max(k), any(a) FROM s GROUP BY n", False),
    ("SELECT f, count(), sum(a) FROM t GROUP BY f", True),
    ("SELECT g, count(), max(b) FROM t GROUP BY g", True),
    ("SELECT u, count(), min(a), any(b) FROM t GROUP BY u", True),
    ("SELECT u, b, n, count(), max(f) FROM t GROUP BY u, b, n", True),
    ("SELECT a, g, count() FROM t GROUP BY a, g", True),
    ("SELECT a, b, minIf(f, b > 1), maxIf(n, a < 5), anyIf(u, b = 2), "
     "avgIf(a, f > 0), countIf(f > 0) FROM t GROUP BY a, b", True),
    ("SELECT b, min(f), max(f), any(f), min(g), max(g) FROM t GROUP BY b "
     "SETTINGS group_by_algorithm='sort'", True),
    ("SELECT a % 3 AS m, min(u), max(u), sum(u), avg(u) FROM t GROUP BY m",
     True),
    ("SELECT i16, u32, count() FROM s GROUP BY i16, u32", True),
    ("SELECT d, count(), min(f) FROM s WHERE a > 0 GROUP BY d", True),
], ids=["nullable-key", "string-key", "nullable-string-key", "float64-key",
        "float32-key", "uint64-key", "three-keys", "int-float-keys",
        "if-combinators", "float-minmax-nan", "uint64-minmax",
        "narrow-keys", "date-key"])
def test_sort_grouping_matches_reference(sessions, sql, ordered):
    """GROUP BY over keys the dense grouping cannot take (unbounded,
    floats, min/max/any) through the sort grouping: groups in ascending
    key order (the NULL group first; String keys in dictionary code order,
    compared as sets)."""
    _both(sessions, sql, ordered=ordered)


@pytest.mark.parametrize("where", ["", "WHERE v % 3 != 0"],
                         ids=["scan-rows", "filtered"])
def test_group_by_six_wide_keys_matches_reference(sessions, where,
                                                  monkeypatch):
    """Six keys of about 64 bits each pack into more key arrays than K5
    compares a row (four); the groups and their values are the
    reference's."""
    from clickhouse_tpu_torch.ops import scan_ops
    arrays = []
    bounds = scan_ops.segment_bounds

    def spy(keys, *args):
        arrays.append(len(keys))
        return bounds(keys, *args)
    monkeypatch.setattr(scan_ops, "segment_bounds", spy)
    _both(sessions, f"SELECT f1, u1, i1, f2, u2, f3, count(), min(v), sum(v) "
                    f"FROM w {where} GROUP BY f1, u1, i1, f2, u2, f3")
    assert arrays[0] > 4


def test_sort_working_set_is_held_to_the_budget(sessions):
    """The governor's estimate is the reference's (scan bytes and the
    largest intermediate); the sort grouping's working set is held against
    what it leaves of the budget where the sort runs: Q2b at 3 MiB raises
    MemoryLimitExceeded naming the sort, and the dense GROUP BY of Q2 at
    the same budget raises it naming the dense grouping (its 3,653,632
    bytes of slots, ids and K2's inputs and outputs, held to the budget
    since the dense grouping has its own check), while Q2 and Q2b at 7
    MiB answer as the reference does.  The working set of Q2b's 100,000
    rows is 4,420,712 bytes beside the estimate's 2,000,000: the packed
    key, K4's buffers and scratch, the key array, and K5's group ids (4
    bytes a row) and 100,352 slots (16 bytes each), so Q2b needs 7 MiB
    where the count without the key array and K5 let it answer at 4
    MiB."""
    js, ts = sessions
    q2b = Q2B + ", max_device_memory_bytes = {}"
    q2 = ("SELECT x % 1024 AS k, count() AS c, sum(x) FROM hits GROUP BY k "
          "ORDER BY c DESC LIMIT 10 SETTINGS max_device_memory_bytes = {}")
    with pytest.raises(MemoryLimitExceeded, match="sorting 100000 rows"):
        ts.execute(q2b.format(3 << 20))
    with pytest.raises(MemoryLimitExceeded, match="densely"):
        ts.execute(q2.format(3 << 20))
    _both(sessions, q2.format(7 << 20))
    with pytest.raises(MemoryLimitExceeded, match="sorting 100000 rows"):
        ts.execute(q2b.format(6 << 20))
    _both(sessions, q2b.format(7 << 20))


@pytest.mark.parametrize("sql", [
    "SELECT b, sum(f), avg(f), sum(g), avg(g) FROM t WHERE f = f GROUP BY b "
    "SETTINGS group_by_algorithm='sort'",
    "SELECT a, sum(f), avg(f), count() FROM t WHERE f = f GROUP BY a",
    "SELECT k, sum(f), avg(f) FROM s GROUP BY k",
], ids=["float-sums", "float-sums-keys", "float-sums-string-key"])
def test_sort_grouping_float_sums_match_reference(sessions, sql):
    """Float sums over the sort grouping, within n * eps * sum(|f|)
    (module docstring).  NaN rows are filtered out: the reference's prefix
    difference would turn every later group's sum into NaN (ROADMAP queue
    3)."""
    table = "s" if "FROM s" in sql else "t"
    _both(sessions, sql, ordered=table == "t",
          atol=_sum_atol(sessions, table, "f"))


@pytest.mark.parametrize("sql", [
    "SELECT a, f FROM t ORDER BY a DESC, f",
    "SELECT n, u FROM t ORDER BY n, u DESC",
    "SELECT k, a FROM s ORDER BY k, a DESC",
    "SELECT g, b FROM t ORDER BY g DESC, b",
    "SELECT f FROM t ORDER BY f",
    "SELECT u FROM t ORDER BY u LIMIT 5000",
    "SELECT x FROM hits WHERE x > 1000 ORDER BY x DESC LIMIT 6000",
    "SELECT x % 100 AS m, x FROM hits ORDER BY m, x LIMIT 300",
], ids=["two-keys", "nullable-first-key", "string-key", "float32-desc",
        "float-nan", "uint64-large-k", "filtered-large-k",
        "multi-key-limit"])
def test_full_sort_matches_reference(sessions, sql):
    """ORDER BY without a top-k: the full stable sort (K4), ties in row
    order, NULLs and NaNs where the reference puts them."""
    _both(sessions, sql)


@pytest.mark.parametrize("autotune", [1, 0], ids=["autotune-on",
                                                 "autotune-off"])
def test_max_groups_overflow(sessions, autotune):
    """More groups than max_groups slots: with capacity_autotune the
    session retries with more slots and answers as the reference; without
    it, a CapacityError naming max_groups and the groups needed."""
    sql = (f"SELECT x % 5000 AS k, count(), min(x) FROM hits GROUP BY k "
           f"SETTINGS max_groups = 1024, capacity_autotune = {autotune}")
    if autotune:
        _both(sessions, sql)
        return
    with pytest.raises(CapacityError, match="max_groups") as e:
        sessions[1].execute(sql)
    assert e.value.setting == "max_groups" and e.value.needed == 5000


def test_streamed_size_raises_typed_error(sessions):
    """Above max_device_block_bytes an aggregation streams (as the
    reference's), and so does ORDER BY ... LIMIT (TopKProgram, which once
    raised naming itself): the reference's rows."""
    js, ts = sessions
    sql = "SELECT count() FROM hits SETTINGS max_device_block_bytes = 1000"
    before = ts.profile_events.get("StreamedQueries", 0)
    assert ts.execute(sql).rows() == js.execute(sql).rows() == [(N_HITS,)]
    assert ts.profile_events.get("StreamedQueries", 0) == before + 1
    sql = "SELECT x FROM hits ORDER BY x LIMIT 5"
    got = ts.execute(sql + " SETTINGS max_device_block_bytes = 1000").rows()
    assert ts.profile_events.get("StreamedQueries", 0) == before + 2
    assert got == js.execute(sql + " SETTINGS max_device_block_bytes = "
                             "1000").rows() == js.execute(sql).rows()


def test_connect_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: connect() succeeds")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tch.connect()


@pytest.mark.parametrize("sql", [
    "SELECT toFloat64(u) FROM u64edge",
    "SELECT count() FROM u64edge WHERE u >= 9544035305396816000.0",
    "SELECT count() FROM u64edge WHERE u + 0.0 >= 9544035305396816000.0",
    "SELECT count() FROM u64edge WHERE u < 9544035305396816000.0",
    "SELECT toFloat32(u) FROM u64edge",
], ids=["toFloat64", "filter-ge", "sum-with-float", "filter-lt",
        "toFloat32"])
def test_uint64_to_float_rounds_once(sessions, sql):
    """UInt64 values at and above 2^63 convert to float64 as numpy does,
    rounded once (9544035305396814861 and 2^63 + 1025 are one ulp off when
    converted as signed and then moved by 2^64), so filters against a
    float constant count the reference's rows; the doubles are the same
    bits."""
    js, ts = sessions
    want, got = js.execute(sql).rows(), ts.execute(sql).rows()
    assert got == want, (sql, got, want)
    assert all(type(g) is type(w) for gr, wr in zip(got, want)
               for g, w in zip(gr, wr))


@pytest.mark.parametrize("sql,topk", [
    ("SELECT x FROM hits ORDER BY x LIMIT 0", []),
    ("SELECT x FROM hits ORDER BY x DESC LIMIT 0 OFFSET 3",
     ["topk_smallest32"]),
], ids=["limit-0", "desc-limit-0-offset"])
def test_order_by_limit_0_returns_no_row(sessions, sql, topk, monkeypatch):
    """ORDER BY one key LIMIT 0 gives no row, as the reference does, and
    reaches no top-k or sort; with OFFSET 3 the sort keeps its top 3 (the
    limit hint is offset + limit) and the LIMIT drops them."""
    from clickhouse_tpu_torch.ops import sort_ops
    calls = []
    for name in ("topk_smallest", "topk_smallest32", "radix_sort_pairs"):
        fn = getattr(sort_ops, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*args, **kw)
        monkeypatch.setattr(sort_ops, name, spy)
    assert _both(sessions, sql) == []
    assert calls == topk


def test_insert_values_with_expressions(sessions):
    """INSERT ... VALUES whose values are expressions runs each one as a
    SELECT without FROM and inserts the row the reference inserts."""
    js, ts = sessions
    for s in (js, ts):
        s.execute("CREATE TABLE ins (d Date, a Int64, b Int32, c String)")
        s.execute("INSERT INTO ins VALUES (toDate('2020-01-03'), 1+2, 4, 'c')")
        s.execute("INSERT INTO ins VALUES (toDate('2021-05-06'), -7, 2*3, "
                  "'dd')")
    rows = _both(sessions, "SELECT d, a, b, c FROM ins ORDER BY a")
    assert len(rows) == 2 and rows[1][1] == 3
    for s in (js, ts):
        s.execute("DROP TABLE ins")


@pytest.mark.parametrize("sql", [
    "SELECT 1",
    "SELECT 1 + 2 AS a, 'x'",
    "SELECT count() FROM numbers(10)",
    "SELECT number % 7 AS k, count(), sum(number) FROM numbers(1000) "
    "GROUP BY k ORDER BY k",
    "SELECT number FROM numbers(5, 3)",
], ids=["select-1", "select-expr-and-string", "numbers-count",
        "numbers-group-by", "numbers-start-count"])
def test_select_without_from_and_numbers(sessions, sql, monkeypatch):
    """SELECT without FROM (one row) and numbers() give the reference's
    rows; numbers()' bounds are proven, so a GROUP BY of `number % 7`
    takes the dense grouping as in the reference."""
    from clickhouse_tpu_torch.ops import agg_ops
    dense = []
    fn = agg_ops.group_by_dense

    def spy(*args, **kw):
        dense.append(args[1])
        return fn(*args, **kw)
    monkeypatch.setattr(agg_ops, "group_by_dense", spy)
    assert _both(sessions, sql)
    assert bool(dense) == ("GROUP BY" in sql)


# -- intDiv / modulo by a constant in the column's narrow storage -----------
# d.x is an Int64 column stored as int32 (its values include ±(2^31 - 1) and
# -2^31), d.i an Int32 column stored as int16, d.n a Nullable(Int64) stored
# as int32, d.j an Int32 column at INT32_MIN and INT32_MAX (stored as it is)

DIV_TYPES = {"r": "Int64", "x": "Int64", "i": "Int32",
             "n": "Nullable(Int64)", "j": "Int32"}
DIV_CONSTANTS = ["4", "1024", "7", "-3", "-1", "1", "3000000000",
                 "2147483647", "-2147483648", "40000"]


@pytest.fixture(scope="module")
def div_sessions():
    rng = np.random.default_rng(99)
    edge = [2**31 - 1, -2**31, -(2**31 - 1), 0, 1, -1, 1023, -1025, 4, -4]
    x = np.concatenate([edge, rng.integers(-2**31, 2**31, 500)]).astype(
        np.int64)
    n = x.astype(object)
    n[rng.random(len(x)) < 0.25] = None
    j = np.where(np.arange(len(x)) % 2 == 0, -2**31, 2**31 - 1).astype(
        np.int32)
    cols = {"r": np.arange(len(x), dtype=np.int64), "x": x,
            "i": ((x % 65536) - 32768).astype(np.int32), "n": n, "j": j}
    js = jch.connect()
    ts = tch.connect(device="cpu")
    js.execute("CREATE TABLE d (" + ", ".join(
        f"{c} {t}" for c, t in DIV_TYPES.items()) + ")")
    js.insert_pydict("d", cols)
    table_from_numpy(ts, "d", _reference_columns(js, "d"), DIV_TYPES)
    stored = ts.catalog.get_table("default", "d").read_block().columns
    assert {c: stored[c].data.dtype for c in "xinj"} == {
        "x": torch.int32, "i": torch.int16, "n": torch.int32,
        "j": torch.int32}
    return js, ts


@pytest.mark.parametrize("col", ["x", "i", "n", "j"])
@pytest.mark.parametrize("fn", ["intDiv", "modulo", "intDivOrZero",
                                "moduloOrZero"])
def test_div_by_constants_match_reference(div_sessions, fn, col):
    """intDiv, modulo and their OrZero forms by constants (positive,
    negative, -1, 1, beyond int32, INT32_MIN and INT32_MAX, 0 for the OrZero
    forms) and by a column, bit for bit with the reference."""
    consts = DIV_CONSTANTS + (["0"] if fn.endswith("OrZero") else [])
    sql = ("SELECT r, " + ", ".join(f"{fn}({col}, {c})" for c in consts)
           + f", {fn}({col}, r - 3) FROM d ORDER BY r")
    assert _both(div_sessions, sql)


@pytest.mark.parametrize("fn,c", [("intDiv", 4), ("modulo", 1024),
                                  ("intDiv", -7), ("modulo", -2**31)])
def test_div_by_a_constant_reads_the_narrow_storage(fn, c):
    """On the narrow path the scanned column's widened copy is never made
    (its cache on the StoredColVal stays unset), and the result is the
    int64 one; divisor -1 and a divisor beyond the storage type take the
    wide path."""
    from clickhouse_tpu_torch.core import dtypes as dt
    from clickhouse_tpu_torch.exprs import functions
    from clickhouse_tpu_torch.exprs.expr import ColVal, StoredColVal
    s = torch.tensor([2**31 - 1, -2**31, -(2**31 - 1), 0, 5, -5, 1023],
                     dtype=torch.int32)
    want = s.to(torch.int64)
    want = torch.div(want, c, rounding_mode="trunc") if fn == "intDiv" \
        else torch.fmod(want, c)
    f = functions.get(fn)

    def run(d):
        a = StoredColVal(dt.Int64, s)
        b = ColVal(dt.Int64, torch.tensor(d, dtype=torch.int64))
        out = f.execute([a, b], f.resolve([dt.Int64, dt.Int64]))
        return a, out
    a, out = run(c)
    assert a._wide is None
    assert out.data.dtype == torch.int64 and torch.equal(out.data, want)
    for d in (-1, 2**31):
        a, _ = run(d)
        assert a._wide is not None


# -- DISTINCT, LIMIT BY and WITH TOTALS --------------------------------------
# DISTINCT emits its rows in the sort grouping's ascending key order and
# LIMIT BY keeps the rows in stream order in both engines, so rows compare
# in order.

@pytest.mark.parametrize("sql", [
    "SELECT DISTINCT a FROM t",
    "SELECT DISTINCT b, a FROM t WHERE a > 3",
    "SELECT DISTINCT n FROM t",
    "SELECT DISTINCT u FROM t WHERE a = 2",
    "SELECT DISTINCT f FROM t WHERE b = 1",
    "SELECT DISTINCT g FROM t WHERE a < 2",
    "SELECT DISTINCT k FROM s",
    "SELECT DISTINCT n, k FROM s WHERE a > 0",
    "SELECT DISTINCT a % 3 AS m, n FROM t WHERE b > 0 ORDER BY m DESC, n "
    "LIMIT 7",
    "SELECT DISTINCT k, a FROM s ORDER BY a, k LIMIT 10",
    "SELECT count() FROM (SELECT DISTINCT intDiv(x, 4) FROM hits)",
    "SELECT DISTINCT x % 7 AS r FROM hits",
], ids=["int", "two-keys-filter", "nullable-int", "uint64", "float64",
        "float32", "string", "nullable-string-and-string", "order-limit",
        "string-order-limit", "Q2d", "expression"])
def test_distinct_matches_reference(sessions, sql):
    _both(sessions, sql)


@pytest.mark.parametrize("sql", [
    "SELECT a, f FROM t LIMIT 2 BY a",
    "SELECT n, a FROM t WHERE b < 2 LIMIT 1 BY n",
    "SELECT k, a FROM s LIMIT 3 BY k",
    "SELECT n, a FROM s LIMIT 2 BY n",
    "SELECT f, a FROM t WHERE b = 0 LIMIT 1 BY f",
    "SELECT a, u % 7 AS r FROM t LIMIT 1 BY r",
    "SELECT k, n, a FROM s ORDER BY a DESC LIMIT 2 BY k, n LIMIT 20",
    "SELECT count() FROM (SELECT x, intDiv(x, 4) AS q FROM hits "
    "LIMIT 2 BY q)",
    "SELECT a, b FROM t WHERE a > 7 LIMIT 0 BY a",
], ids=["int", "nullable-int-filter", "string", "nullable-string", "float",
        "expression", "order-limit", "Q2l", "limit-0"])
def test_limit_by_matches_reference(sessions, sql):
    _both(sessions, sql)


def test_limit_by_an_unselected_expression_matches_numpy(sessions):
    """Q2l: LIMIT BY over an expression that is not a selected column (the
    port projects it as a hidden column; the reference's eager executor
    cannot find its column: S5, pinned in test_torch_ops.DIVERGENCES)."""
    js, ts = sessions
    x = _reference_columns(js, "hits")["x"]
    want = int(np.minimum(np.bincount(x // 4), 2).sum())
    got = ts.execute("SELECT count() FROM (SELECT x FROM hits "
                     "LIMIT 2 BY intDiv(x, 4))").rows()
    assert got == [(want,)]
    a, u = (_reference_columns(js, "t")[c] for c in ("a", "u"))
    first = np.unique(u % np.uint64(7), return_index=True)[1]
    got = ts.execute("SELECT a, u FROM t LIMIT 1 BY u % 7").rows()
    assert got == [(int(a[i]), int(u[i])) for i in sorted(first)]


def _set_limit_by_offset(plan, offset):
    if type(plan).__name__ == "LimitByNode":
        plan.offset = offset
        return 1
    return sum(_set_limit_by_offset(c, offset) for c in plan.children())


@pytest.mark.parametrize("offset", [1, 2, 5])
def test_limit_by_offset_matches_reference(sessions, offset):
    """LIMIT n OFFSET m BY: the SQL of both engines leaves the offset at 0,
    so it is set on the LimitBy node of both plans."""
    from clickhouse_tpu.sql import parse as jparse
    from clickhouse_tpu_torch.sql import parse as tparse
    sql = "SELECT a, n, f FROM t WHERE b < 3 LIMIT 2 BY a, n"
    out = []
    for s, parse in zip(sessions, (jparse, tparse)):
        plan = s._plan(parse(sql), s.settings)
        assert _set_limit_by_offset(plan, offset) == 1
        cols = s._execute(plan, s.settings)[0]
        out.append(list(zip(*[list(v) for v in cols.values()])))
    want, got = ([tuple(_cell(x) for x in r) for r in rows] for rows in out)
    assert len(want) > 0 and _rows_match(got, want)


TOTALS = [
    "SELECT a, count(), sum(f) FROM t GROUP BY a WITH TOTALS ORDER BY a",
    "SELECT a, min(f), max(n), any(b) FROM t GROUP BY a WITH TOTALS "
    "ORDER BY a",
    "SELECT a, count() AS c FROM t GROUP BY a WITH TOTALS HAVING c > 2000 "
    "ORDER BY a SETTINGS group_by_algorithm = 'sort'",
    "SELECT n, count(), sum(a) FROM t WHERE b > 0 GROUP BY n WITH TOTALS "
    "ORDER BY n LIMIT 5",
    "SELECT a * 2 AS d, count() AS c, c * 10 AS e FROM t GROUP BY d "
    "WITH TOTALS ORDER BY d",
    "SELECT f, count() AS c FROM t GROUP BY f WITH TOTALS ORDER BY c DESC, "
    "f LIMIT 3",
    "SELECT u % 5 AS r, sum(u) FROM t GROUP BY r WITH TOTALS ORDER BY r",
    "SELECT x % 1024 AS k, count() AS c, sum(x) FROM hits GROUP BY k "
    "WITH TOTALS ORDER BY c DESC LIMIT 10",
    "SELECT k, count() AS c, sum(a) FROM s GROUP BY k WITH TOTALS "
    "HAVING c > 250 ORDER BY k",
    "SELECT n, k, count() FROM s GROUP BY n, k WITH TOTALS ORDER BY n, k "
    "LIMIT 6",
]
TOTALS_IDS = ["dense", "sort-minmax", "having-sort", "nullable-key-filter",
              "projection", "float-key", "uint64", "Q2t", "string-key",
              "nullable-string-and-string-keys"]


@pytest.mark.parametrize("sql", TOTALS, ids=TOTALS_IDS)
def test_with_totals_matches_reference(sessions, sql):
    """The rows, and Result.totals: the aggregates over every row before
    HAVING, the keys at their type's default.  A String key's default is
    '' in the port and the dictionary's first value in the reference (S4,
    pinned in test_torch_ops.DIVERGENCES): it is checked for ''."""
    js, ts = sessions
    _both(sessions, sql)
    want, got = js.execute(sql), ts.execute(sql)
    assert got.totals is not None and list(got.totals) == list(want.totals)
    for (name, typ), w, g in zip(got.types, want.totals.values(),
                                 got.totals.values()):
        assert len(g) == len(w) == 1
        if typ.replace("Nullable(", "").startswith("String"):
            assert g[0] == "", name
        else:
            assert _same_value(_cell(g[0]), _cell(w[0])), name


def _cell(v):
    """A result cell as a Python value."""
    return v.item() if hasattr(v, "item") else v


def test_with_totals_of_a_global_aggregate_is_none(sessions):
    js, ts = sessions
    sql = "SELECT count(), sum(a) FROM t WITH TOTALS"
    assert ts.execute(sql).totals is None
    assert js.execute(sql).totals is None
    assert ts.execute("SELECT a FROM t LIMIT 1").totals is None


@pytest.mark.parametrize("sql,needed", [
    ("SELECT DISTINCT x % 5000 AS r FROM hits", 5000),
    ("SELECT x % 3000 AS r FROM hits LIMIT 1 BY r", 3000),
], ids=["distinct", "limit-by"])
def test_distinct_and_limit_by_max_groups(sessions, sql, needed):
    """More groups than max_groups slots: CapacityError naming max_groups
    and the groups needed without capacity_autotune; with it, the session
    retries with more slots and answers as numpy (the reference's DISTINCT
    too; its LIMIT BY has no such check and keeps wrong rows: S6, pinned
    in test_torch_ops.DIVERGENCES)."""
    js, ts = sessions
    with pytest.raises(CapacityError, match="max_groups") as e:
        ts.execute(sql + " SETTINGS max_groups = 1024, "
                         "capacity_autotune = 0")
    assert e.value.setting == "max_groups" and e.value.needed == needed
    r = _reference_columns(js, "hits")["x"] % needed
    if "DISTINCT" in sql:
        want = [(int(v),) for v in np.unique(r)]
    else:
        want = [(int(r[i]),) for i in sorted(np.unique(
            r, return_index=True)[1])]
    assert ts.execute(sql + " SETTINGS max_groups = 1024").rows() == want


# -- the governor: the dense grouping's working set and cached chars --------

def _estimate(ts, sql):
    from clickhouse_tpu_torch.exec.streaming import \
        estimate_plan_device_bytes
    from clickhouse_tpu_torch.sql import parse
    return estimate_plan_device_bytes(ts._plan(parse(sql), ts.settings),
                                      ts.catalog, ts.settings)


@pytest.mark.parametrize("sql", [
    "SELECT x % 1024 AS k, count() AS c, sum(x) FROM hits GROUP BY k "
    "ORDER BY c DESC LIMIT 10",
    "SELECT b, a, count(), avg(a), sum(b) FROM t GROUP BY b, a "
    "ORDER BY b, a",
], ids=["Q2", "two-keys"])
def test_dense_grouping_is_held_to_the_budget(sessions, sql, monkeypatch):
    """A dense GROUP BY holds its working set (the slots, the ids, the
    dense stage's passes, K2's inputs and outputs) against what the
    governor's estimate leaves of the budget: one byte less raises the
    sort path's MemoryLimitExceeded, the exact budget and the default one
    answer as the reference does."""
    from clickhouse_tpu_torch.core.errors import MemoryLimitExceeded
    from clickhouse_tpu_torch.ops import agg_ops
    js, ts = sessions
    needs = []
    fn = agg_ops.dense_group_bytes

    def spy(*args, **kw):
        needs.append(fn(*args, **kw))
        return needs[-1]
    monkeypatch.setattr(agg_ops, "dense_group_bytes", spy)
    assert _both(sessions, sql)
    assert len(needs) == 1
    budget = _estimate(ts, sql) + needs[0]
    with pytest.raises(MemoryLimitExceeded, match="densely"):
        ts.execute(sql + f" SETTINGS max_device_memory_bytes = {budget - 1}")
    got = ts.execute(sql + f" SETTINGS max_device_memory_bytes = {budget}")
    assert got.rows() == js.execute(sql).rows()


def test_cached_dictionary_chars_count_for_every_reader(sessions):
    """A String column's dictionary chars, once cached on the device by
    one query, count against the budget of every later query that reads
    the column (one byte short raises MemoryLimitExceeded naming them),
    and not against a query of another table."""
    from clickhouse_tpu_torch.core.errors import MemoryLimitExceeded
    js, ts = sessions
    d = ts.catalog.get_table("default", "s").read_block()["k"].dictionary
    d._chars = {}
    build = "SELECT count() FROM s WHERE startsWith(k, 'k1')"
    assert ts.execute(build).rows() == js.execute(build).rows()
    chars = d.cached_chars_bytes(ts.device)
    assert chars == sum(len(v.encode()) for v in d.values_str()) \
        + 4 * (len(d) + 1)
    reader = "SELECT count() FROM s WHERE k = 'k1' OR a > 3"
    budget = _estimate(ts, reader) + chars
    with pytest.raises(MemoryLimitExceeded, match="cached string"):
        ts.execute(reader + f" SETTINGS max_device_memory_bytes = "
                   f"{budget - 1}")
    got = ts.execute(reader + f" SETTINGS max_device_memory_bytes = "
                     f"{budget}")
    assert got.rows() == js.execute(reader).rows()
    other = "SELECT count() FROM hits WHERE x > 3"
    got = ts.execute(other + f" SETTINGS max_device_memory_bytes = "
                     f"{_estimate(ts, other)}")
    assert got.rows() == js.execute(other).rows()
