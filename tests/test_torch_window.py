"""Window functions of the CUDA engine against the JAX reference, on the CPU.

The cases of ``tests/test_window.py`` (every function, the ROWS and RANGE
frames of its parametrisations, peers under the default frame, ``count()
OVER ()``, a window over an aggregate) and more: NULL arguments, DESC and
String ORDER BY keys, NULLS FIRST/LAST, UInt64 and Float64 arguments,
several calls over one window.  The same rows, made from a seed with numpy,
go through ``clickhouse_tpu.connect()`` and
``clickhouse_tpu_torch.connect(device="cpu")``; rows compare in order
(every query orders its output).  Integers and strings must be equal;
floats must agree within n * eps * sum(|v|) (n the table's rows, v the
summed column, ``_sum_atol`` of ``test_torch_sql.py``): both engines take a
frame's sum as a difference of running sums over the partition, added in
another order (the port's K17 plain version in doubling passes).

The port's kernels take their plain versions here (K17 segmented_scan, K18
segmented_search, K4, K5); ``tests/test_torch_kernels.py`` holds the
kernels to them on the card.
"""
import numpy as np
import pytest

import clickhouse_tpu as jch
import clickhouse_tpu_torch as tch
from clickhouse_tpu_torch.core.errors import MemoryLimitExceeded
from clickhouse_tpu_torch.interop import table_from_numpy

N = 2000
TYPES = {"g": "Int64", "x": "Int64", "v": "Float64", "id": "Int64",
         "n": "Nullable(Int64)", "s": "String", "u": "UInt64"}


@pytest.fixture(scope="module")
def sessions():
    rng = np.random.default_rng(11)
    n = rng.integers(-50, 50, N).astype(object)
    n[rng.random(N) < 0.2] = None
    u = rng.integers(0, 1 << 62, N).astype(np.uint64)
    u[rng.random(N) < 0.3] += np.uint64(1 << 63)
    data = {"g": rng.integers(0, 20, N).astype(np.int64),
            "x": rng.integers(0, 1000, N).astype(np.int64),
            "v": rng.normal(size=N),
            "id": np.arange(N, dtype=np.int64), "n": n,
            "s": np.asarray([f"s{k:02d}" for k in rng.integers(0, 40, N)],
                            dtype=object),
            "u": u}
    js, ts = jch.connect(), tch.connect(device="cpu")
    js.execute("CREATE TABLE w (" + ", ".join(
        f"{c} {t}" for c, t in TYPES.items()) + ")")
    js.insert_pydict("w", data)
    table_from_numpy(ts, "w", data, TYPES)
    for name, rows in (("peers", ([1, 1, 2, 2, 3], [10, 20, 30, 40, 50])),
                       ("peers2", ([1, 1, 2], [10, 20, 30]))):
        cols = {"k": np.array(rows[0], np.int64),
                "v": np.array(rows[1], np.int64)}
        js.execute(f"CREATE TABLE {name} (k Int64, v Int64)")
        js.insert_pydict(name, cols)
        table_from_numpy(ts, name, cols, {"k": "Int64", "v": "Int64"})
    cols = {"v": np.array([1, 2, 3], np.int64)}
    js.execute("CREATE TABLE ef (v Int64)")
    js.insert_pydict("ef", cols)
    table_from_numpy(ts, "ef", cols, {"v": "Int64"})
    return js, ts, data


def _atol(data, col):
    v = np.asarray(data[col], np.float64)
    v = v[np.isfinite(v)]
    return len(v) * np.finfo(np.float64).eps * float(np.abs(v).sum())


def _same(got, want, atol):
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if len(g) != len(w):
            return False
        for a, b in zip(g, w):
            if isinstance(b, float) and isinstance(a, float):
                if np.isnan(b) or np.isnan(a):
                    if not (np.isnan(a) and np.isnan(b)):
                        return False
                elif abs(a - b) > atol:
                    return False
            elif a != b:
                return False
    return True


def _both(sessions, sql, atol_col="v"):
    js, ts, data = sessions
    want = js.execute(sql).rows()
    got = ts.execute(sql).rows()
    assert _same(got, want, _atol(data, atol_col)), (sql, got[:5], want[:5])
    return got


# -- the cases of tests/test_window.py::TestWindow ---------------------------

@pytest.mark.parametrize("sql", [
    "SELECT id, row_number() OVER (PARTITION BY g ORDER BY id) AS rn "
    "FROM w ORDER BY id LIMIT 100",
    "SELECT g, x, rank() OVER (PARTITION BY g ORDER BY x) AS rk, "
    "dense_rank() OVER (PARTITION BY g ORDER BY x) AS dr "
    "FROM w ORDER BY g, x, id LIMIT 200",
    "SELECT g, sum(x) OVER (PARTITION BY g) AS s FROM w "
    "ORDER BY id LIMIT 50",
    "SELECT id, sum(x) OVER (PARTITION BY g ORDER BY id) AS rs "
    "FROM w ORDER BY id LIMIT 100",
    "SELECT id, avg(v) OVER (PARTITION BY g ORDER BY id) AS ra "
    "FROM w ORDER BY id LIMIT 50",
    "SELECT id, lag(x) OVER (PARTITION BY g ORDER BY id) AS lg, "
    "lead(x, 2) OVER (PARTITION BY g ORDER BY id) AS ld "
    "FROM w ORDER BY id LIMIT 200",
    "SELECT count() OVER () AS c FROM w LIMIT 1",
    "SELECT g, first_value(x) OVER (PARTITION BY g ORDER BY id) AS f "
    "FROM w ORDER BY id LIMIT 50",
    "SELECT g, c, sum(c) OVER (ORDER BY g) AS running "
    "FROM (SELECT g, count() AS c FROM w GROUP BY g) ORDER BY g",
    "SELECT g, min(x) OVER (PARTITION BY g) AS mn, "
    "max(x) OVER (PARTITION BY g) AS mx FROM w ORDER BY id LIMIT 30",
], ids=["row_number", "rank_dense_rank", "partition_sum_full",
        "running_sum", "running_avg_float", "lag_lead", "global_window",
        "first_value", "window_over_aggregate", "min_max_window"])
def test_window_functions_match_reference(sessions, sql):
    _both(sessions, sql)


# -- the frames of tests/test_window.py::TestWindowFrames ---------------------

ROWS_FRAMES = [
    "ROWS BETWEEN 3 PRECEDING AND CURRENT ROW",
    "ROWS BETWEEN 2 PRECEDING AND 2 FOLLOWING",
    "ROWS BETWEEN CURRENT ROW AND 4 FOLLOWING",
    "ROWS BETWEEN UNBOUNDED PRECEDING AND 1 FOLLOWING",
    "ROWS BETWEEN 1 PRECEDING AND UNBOUNDED FOLLOWING",
    "ROWS BETWEEN 2 FOLLOWING AND 5 FOLLOWING",
    "ROWS BETWEEN 5 PRECEDING AND 2 PRECEDING",
    "ROWS 4 PRECEDING",
]


@pytest.mark.parametrize("spec", ROWS_FRAMES)
@pytest.mark.parametrize("fn", ["sum", "count", "min", "max"])
def test_rows_frames_match_reference(sessions, spec, fn):
    call = f"{fn}(x)" if fn != "count" else "count()"
    _both(sessions, f"SELECT id, {call} OVER (PARTITION BY g ORDER BY id "
                    f"{spec}) FROM w ORDER BY g, id")


@pytest.mark.parametrize("spec", [
    "RANGE BETWEEN 30 PRECEDING AND CURRENT ROW",
    "RANGE BETWEEN 10 PRECEDING AND 10 FOLLOWING",
    "RANGE BETWEEN CURRENT ROW AND 50 FOLLOWING",
    "RANGE BETWEEN UNBOUNDED PRECEDING AND 5 FOLLOWING",
])
def test_range_offset_frames_match_reference(sessions, spec):
    _both(sessions, f"SELECT id, sum(x) OVER (PARTITION BY g ORDER BY id "
                    f"{spec}) FROM w ORDER BY g, id")


@pytest.mark.parametrize("sql", [
    "SELECT sum(v) OVER (ORDER BY k) FROM peers ORDER BY k, v",
    "SELECT sum(v) OVER (ORDER BY k ROWS BETWEEN UNBOUNDED PRECEDING AND "
    "CURRENT ROW) FROM peers2 ORDER BY k, v",
    "SELECT avg(v) OVER (ORDER BY v ROWS BETWEEN 2 FOLLOWING AND 3 "
    "FOLLOWING) FROM ef ORDER BY v",
    "SELECT first_value(x) OVER (PARTITION BY g ORDER BY id ROWS BETWEEN 2 "
    "PRECEDING AND 1 FOLLOWING) AS f, last_value(x) OVER (PARTITION BY g "
    "ORDER BY id ROWS BETWEEN 2 PRECEDING AND 1 FOLLOWING) AS l FROM w "
    "ORDER BY g, id",
], ids=["default_frame_includes_peers", "rows_current_row_excludes_peers",
        "avg_over_empty_frame_is_nan", "first_last_value_frames"])
def test_frame_cases_match_reference(sessions, sql):
    _both(sessions, sql)


def test_default_frame_peers_values(sessions):
    """Tied ORDER BY rows share one frame (the reference's golden rows)."""
    rows = _both(sessions, "SELECT sum(v) OVER (ORDER BY k) FROM peers "
                           "ORDER BY k, v")
    assert [r[0] for r in rows] == [30, 30, 100, 100, 150]


# -- beyond test_window.py: NULLs, DESC, strings, other types -----------------

@pytest.mark.parametrize("sql", [
    # a NULL argument: skipped by the aggregates, kept by lag/lead
    "SELECT id, sum(n) OVER (PARTITION BY g ORDER BY id) AS s, "
    "count(n) OVER (PARTITION BY g ORDER BY id ROWS BETWEEN 3 PRECEDING "
    "AND CURRENT ROW) AS c FROM w ORDER BY id",
    "SELECT id, min(n) OVER (PARTITION BY g ORDER BY id ROWS BETWEEN 2 "
    "PRECEDING AND 2 FOLLOWING) AS a, max(n) OVER (PARTITION BY g ORDER BY "
    "id) AS b FROM w ORDER BY id",
    "SELECT id, any(n) OVER (PARTITION BY g ORDER BY id ROWS BETWEEN 1 "
    "PRECEDING AND 3 FOLLOWING) AS a, first_value(n) OVER (PARTITION BY g "
    "ORDER BY id ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) AS f, "
    "last_value(n) OVER (PARTITION BY g ORDER BY id ROWS BETWEEN 1 "
    "PRECEDING AND 1 FOLLOWING) AS l FROM w ORDER BY id",
    "SELECT id, avg(n) OVER (PARTITION BY g) AS a, lag(n) OVER (PARTITION "
    "BY g ORDER BY id) AS lg FROM w ORDER BY id",
    # DESC ORDER BY, its peers and its RANGE frame
    "SELECT id, x, rank() OVER (PARTITION BY g ORDER BY x DESC) AS r, "
    "sum(x) OVER (PARTITION BY g ORDER BY x DESC) AS s FROM w "
    "ORDER BY g, x DESC, id",
    "SELECT id, sum(x) OVER (PARTITION BY g ORDER BY id DESC RANGE BETWEEN "
    "5 PRECEDING AND 5 FOLLOWING) AS s FROM w ORDER BY id",
    # a String ORDER BY key (its dictionary's rank) and PARTITION BY key
    "SELECT id, s, row_number() OVER (PARTITION BY g ORDER BY s, id) AS r, "
    "dense_rank() OVER (PARTITION BY g ORDER BY s) AS d FROM w ORDER BY id",
    "SELECT id, count() OVER (PARTITION BY s ORDER BY x) AS c, "
    "min(s) OVER (PARTITION BY g) AS m FROM w ORDER BY id",
    # a Nullable ORDER BY key, NULLS FIRST and LAST
    "SELECT id, row_number() OVER (PARTITION BY g ORDER BY n NULLS FIRST, "
    "id) AS a, row_number() OVER (PARTITION BY g ORDER BY n DESC NULLS "
    "LAST, id) AS b FROM w ORDER BY id",
    # UInt64 above 2^63 and Float64 arguments and keys
    "SELECT id, max(u) OVER (PARTITION BY g ORDER BY id) AS a, min(u) OVER "
    "(PARTITION BY g ORDER BY id ROWS BETWEEN 2 PRECEDING AND 2 FOLLOWING) "
    "AS b, sum(u) OVER (PARTITION BY g) AS c FROM w ORDER BY id",
    "SELECT id, max(v) OVER (PARTITION BY g ORDER BY v) AS a, "
    "sum(v) OVER (PARTITION BY g ORDER BY v ROWS BETWEEN 3 PRECEDING AND "
    "CURRENT ROW) AS b FROM w ORDER BY id",
    # several calls over one window, and calls over several windows
    "SELECT id, row_number() OVER (ORDER BY x, id) AS a, "
    "sum(x) OVER (PARTITION BY g ORDER BY id) AS b, "
    "count() OVER (PARTITION BY g % 3) AS c, "
    "lead(id) OVER (PARTITION BY g ORDER BY id) AS d FROM w ORDER BY id",
    # a window over a filtered block
    "SELECT id, row_number() OVER (PARTITION BY g ORDER BY id) AS r, "
    "sum(x) OVER (PARTITION BY g ORDER BY x RANGE BETWEEN 100 PRECEDING AND "
    "CURRENT ROW) AS s FROM w WHERE x > 300 ORDER BY id",
], ids=["null_sum_count", "null_min_max", "null_any_first_last",
        "null_avg_lag", "desc_rank_sum", "desc_range", "string_order",
        "string_partition", "nulls_first_last", "uint64", "float64",
        "several_windows", "filtered"])
def test_window_edges_match_reference(sessions, sql):
    _both(sessions, sql)


def test_calls_differing_in_frame_are_two_columns(sessions):
    """W1: the port computes each call over its own frame (the reference
    gives both columns the first call's frame; test_torch_ops.py
    DIVERGENCES pins it): the pair equals each call queried alone."""
    js, ts, _ = sessions
    win = "PARTITION BY g ORDER BY id"
    both = ts.execute(
        f"SELECT id, sum(x) OVER ({win}) AS a, sum(x) OVER ({win} ROWS "
        f"BETWEEN 1 PRECEDING AND CURRENT ROW) AS b, max(x) OVER ({win} ROWS "
        f"BETWEEN 2 PRECEDING AND CURRENT ROW) AS c, max(x) OVER ({win} ROWS "
        f"BETWEEN CURRENT ROW AND 2 FOLLOWING) AS d FROM w ORDER BY id"
    ).rows()
    for col, frame, fn in ((1, "", "sum"),
                           (2, " ROWS BETWEEN 1 PRECEDING AND CURRENT ROW",
                            "sum"),
                           (3, " ROWS BETWEEN 2 PRECEDING AND CURRENT ROW",
                            "max"),
                           (4, " ROWS BETWEEN CURRENT ROW AND 2 FOLLOWING",
                            "max")):
        sql = f"SELECT id, {fn}(x) OVER ({win}{frame}) FROM w ORDER BY id"
        alone = js.execute(sql).rows()
        assert [r[col] for r in both] == [r[1] for r in alone], frame
    assert [r[1] for r in both] != [r[2] for r in both]


def test_window_past_the_budget_raises_naming_the_window(sessions):
    """The window holds its working set against the governor's budget:
    a small max_memory_usage raises MemoryLimitExceeded naming the call
    before it allocates."""
    ts = sessions[1]
    sql = ("SELECT sum(x) OVER (PARTITION BY g ORDER BY id ROWS BETWEEN 2 "
           "PRECEDING AND 2 FOLLOWING) AS s FROM w")
    with pytest.raises(MemoryLimitExceeded, match="window function"):
        ts.execute(sql, settings={"max_memory_usage": 200_000})
    assert len(ts.execute(sql).rows()) == N
