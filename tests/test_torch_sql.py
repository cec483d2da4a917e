"""The CUDA engine's SQL slice against the JAX reference, on the CPU.

The same SQL runs through ``clickhouse_tpu.connect()`` and
``clickhouse_tpu_torch.connect(device="cpu")`` over the same rows (made
from a seed with numpy, loaded into the reference, read back from its
table and handed to the port with ``interop.table_from_numpy``), and the
rows must agree: integers exactly, floats within rtol=1e-12 (the two
engines add in different orders).
"""
import math

import numpy as np
import pytest
import torch

import clickhouse_tpu as jch
import clickhouse_tpu_torch as tch
from clickhouse_tpu_torch.core.errors import (NotImplementedError_,
                                              UnknownFunction, UnknownTable)
from clickhouse_tpu_torch.interop import table_from_numpy

FLOAT_RTOL = 1e-12
N_HITS = 100_000
N_T = 20_000
T_TYPES = {"a": "Int32", "b": "UInt8", "u": "UInt64", "n": "Nullable(Int64)",
           "f": "Float64", "g": "Float32"}
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
    table_from_numpy(ts, "hits", _reference_columns(js, "hits"),
                     {"x": "Int64"})
    table_from_numpy(ts, "t", _reference_columns(js, "t"), T_TYPES)
    table_from_numpy(ts, "s", _reference_columns(js, "s"), S_TYPES)
    return js, ts


def _same_value(got, want):
    if isinstance(want, float) or isinstance(got, float):
        if want is None or got is None:
            return got is want
        if math.isnan(want):
            return math.isnan(got)
        if want == 0.0:
            return got == 0.0
        return math.isclose(got, want, rel_tol=FLOAT_RTOL, abs_tol=0.0)
    return got == want


def _rows_match(got, want):
    return len(got) == len(want) and all(
        len(g) == len(w) and all(_same_value(a, b) for a, b in zip(g, w))
        for g, w in zip(got, want))


def _both(sessions, sql, ordered=True):
    js, ts = sessions
    want = js.execute(sql).rows()
    got = ts.execute(sql).rows()
    if not ordered:
        key = repr
        want, got = sorted(want, key=key), sorted(got, key=key)
    assert _rows_match(got, want), (sql, got[:5], want[:5])
    return got


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
    ("SELECT uniqExact(a) FROM t", UnknownFunction, "uniqExact"),
    ("SELECT lower('A') FROM t", UnknownFunction, "lower"),
    ("SELECT x FROM hits ORDER BY x", NotImplementedError_,
     "sort_permutation"),
    ("SELECT x, count() FROM hits GROUP BY x", NotImplementedError_,
     "group_by_sort"),
    ("SELECT a, min(f) FROM t GROUP BY a", NotImplementedError_,
     "group_by_sort"),
    ("SELECT a, count() FROM t GROUP BY a SETTINGS group_by_algorithm='sort'",
     NotImplementedError_, "group_by_sort"),
    ("SELECT x FROM hits ORDER BY x LIMIT 5000", NotImplementedError_,
     "large-k"),
    ("SELECT a FROM t UNION ALL SELECT a FROM t", NotImplementedError_,
     "UnionNode"),
    ("ALTER TABLE t DELETE WHERE a = 1", NotImplementedError_,
     "AlterTable"),
], ids=["unknown-aggregate", "unknown-scalar", "full-sort", "unbounded-keys",
        "minmax-group-by", "sort-setting", "large-k", "union", "alter"])
def test_unported_paths_raise_typed_errors(sessions, sql, err, match):
    with pytest.raises(err, match=match):
        sessions[1].execute(sql)


def test_streamed_size_raises_typed_error(sessions):
    ts = sessions[1]
    with pytest.raises(NotImplementedError_, match="out-of-core streaming"):
        ts.execute("SELECT count() FROM hits SETTINGS "
                   "max_device_block_bytes = 1000")


def test_connect_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: connect() succeeds")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tch.connect()
