"""UNION ALL, ROLLUP/CUBE/GROUPING SETS, FULL JOIN and INTERSECT/EXCEPT of
the CUDA engine against the JAX reference, on the CPU.

The same rows, made from a seed with numpy, go through
``clickhouse_tpu.connect()`` and ``clickhouse_tpu_torch.connect(
device="cpu")``.  Rows compare in order where the query orders them, as
multisets otherwise (a set operation's output keeps the left side's row
order, a UNION ALL its branches' in turn, a GROUP BY's groups follow the
grouping); integers and strings must be equal, floats within rtol 1e-12
(the engines sum in other orders).  The port's kernels take their plain
versions here (K17's running count for INTERSECT/EXCEPT, K4 and K5 for
the grouping, K2 for the dense GROUP BY of each ROLLUP branch).
"""
import numpy as np
import pytest

import clickhouse_tpu as jch
import clickhouse_tpu_torch as tch
from clickhouse_tpu_torch.core.errors import MemoryLimitExceeded
from clickhouse_tpu_torch.interop import table_from_numpy

FLOAT_RTOL = 1e-12
N = 3000
TABLES = {
    "a": ({"k": "Int64", "s": "String", "n": "Nullable(Int32)",
           "f": "Float64", "u": "UInt64"}, N, 0),
    "b": ({"k": "Int64", "s": "String", "n": "Nullable(Int32)",
           "f": "Float64", "u": "UInt64"}, N // 2, 1),
}


def _columns(rng, n, shift):
    s = np.asarray([f"v{k}" for k in rng.integers(shift * 10, 30 + shift * 10,
                                                  n)], dtype=object)
    nn = rng.integers(-5, 5, n).astype(object)
    nn[rng.random(n) < 0.2] = None
    u = rng.integers(0, 4, n).astype(np.uint64)
    u[rng.random(n) < 0.3] += np.uint64(1 << 63)
    return {"k": rng.integers(0, 50, n).astype(np.int64), "s": s, "n": nn,
            "f": np.round(rng.normal(0, 10, n), 1), "u": u}


@pytest.fixture(scope="module")
def sessions():
    rng = np.random.default_rng(21)
    js, ts = jch.connect(), tch.connect(device="cpu")
    for name, (types, n, shift) in TABLES.items():
        cols = _columns(rng, n, shift)
        js.execute(f"CREATE TABLE {name} (" + ", ".join(
            f"{c} {t}" for c, t in types.items()) + ")")
        js.insert_pydict(name, cols)
        table_from_numpy(ts, name, cols, types)
    arr = {"id": np.arange(4, dtype=np.int64),
           "v": np.array([[1, 2, 0], [3, 0, 0], [4, 5, 6], [7, 8, 9]],
                         np.int64)}
    for name, width in (("arr1", 3), ("arr2", 2)):
        cols = {"id": arr["id"], "v": arr["v"][:, :width]}
        js.execute(f"CREATE TABLE {name} (id Int64, v Array(Int64))")
        js.insert_pydict(name, {"id": cols["id"],
                                "v": [list(r) for r in cols["v"]]})
        table_from_numpy(ts, name, {"id": cols["id"],
                                    "v": [list(r) for r in cols["v"]]},
                         {"id": "Int64", "v": "Array(Int64)"})
    return js, ts


def _close(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        if np.isnan(a) or np.isnan(b):
            return np.isnan(a) and np.isnan(b)
        return abs(a - b) <= FLOAT_RTOL * max(abs(a), abs(b))
    return a == b


def _both(sessions, sql, ordered=False):
    js, ts = sessions
    want = js.execute(sql).rows()
    got = ts.execute(sql).rows()
    if not ordered:
        want, got = sorted(want, key=repr), sorted(got, key=repr)
    assert len(got) == len(want), (sql, len(got), len(want))
    assert all(len(g) == len(w) and all(_close(x, y) for x, y in zip(g, w))
               for g, w in zip(got, want)), (sql, got[:5], want[:5])
    return got


@pytest.mark.parametrize("sql", [
    "SELECT k FROM a UNION ALL SELECT k FROM b",
    # dictionaries that differ between the branches
    "SELECT s, k FROM a WHERE k < 10 UNION ALL SELECT s, k FROM b",
    "SELECT s FROM a UNION ALL SELECT 'x' AS s FROM b WHERE k = 3",
    # Nullable beside non-NULL, and a NULL literal branch
    "SELECT n FROM a UNION ALL SELECT n FROM b",
    "SELECT k, n FROM a WHERE k < 5 UNION ALL SELECT k, NULL FROM b "
    "WHERE k < 5",
    # types widened to the branches' supertype, UInt64 above 2^63, floats
    "SELECT u, f FROM a UNION ALL SELECT u, f FROM b",
    "SELECT toInt32(k) AS x FROM a UNION ALL SELECT k AS x FROM b",
    # three branches, and the union below an aggregate and an ORDER BY
    "SELECT k FROM a WHERE k < 3 UNION ALL SELECT k FROM b WHERE k < 3 "
    "UNION ALL SELECT k + 100 FROM a WHERE k = 7",
    "SELECT count(), sum(y), max(y) FROM (SELECT k AS y FROM a WHERE "
    "k < 20 UNION ALL SELECT k + 1 AS y FROM b WHERE k > 30)",
    "SELECT s, count() FROM (SELECT s FROM a UNION ALL SELECT s FROM b) "
    "GROUP BY s",
    # Array columns of different widths and lengths
    "SELECT id, v FROM arr1 UNION ALL SELECT id, v FROM arr2",
], ids=["one-column", "dictionaries", "string-literal", "nullable",
        "null-literal", "uint64-float", "supertype", "three-branches",
        "aggregate-above", "group-by-string", "array"])
def test_union_all_matches_reference(sessions, sql):
    _both(sessions, sql)


def test_union_all_keeps_branch_order(sessions):
    _both(sessions, "SELECT k, s FROM a WHERE k < 4 UNION ALL "
                    "SELECT k, s FROM b WHERE k < 4", ordered=True)


@pytest.mark.parametrize("sql", [
    "SELECT k % 3 AS x, k % 2 AS y, count(), sum(k) FROM a "
    "GROUP BY ROLLUP(x, y)",
    "SELECT k % 3 AS x, k % 2 AS y, count(), sum(f) FROM a "
    "GROUP BY CUBE(x, y)",
    "SELECT s, k % 4 AS x, count() FROM a GROUP BY ROLLUP(s, x)",
    "SELECT k % 3 AS x, k % 2 AS y, count() FROM a "
    "GROUP BY GROUPING SETS ((x, y), (x), ())",
    "SELECT k, s, count(), grouping(k, s) FROM a WHERE k < 5 "
    "GROUP BY ROLLUP(k, s)",
    "SELECT k % 3 AS x, count(), min(n), max(u) FROM a "
    "GROUP BY x WITH ROLLUP",
    "SELECT k % 3 AS x, k % 5 AS y, sum(k) FROM a GROUP BY x, y WITH CUBE "
    "ORDER BY x, y",
], ids=["rollup", "cube", "rollup-string", "grouping-sets", "grouping",
        "with-rollup", "with-cube-ordered"])
def test_rollup_cube_grouping_sets_match_reference(sessions, sql):
    _both(sessions, sql)


@pytest.mark.parametrize("sql", [
    "SELECT a.k, b.k FROM a FULL JOIN b ON a.k = b.k",
    "SELECT a.s, b.s, a.n FROM (SELECT * FROM a WHERE k < 10) AS a "
    "FULL OUTER JOIN (SELECT * FROM b WHERE k > 5) AS b ON a.s = b.s",
    "SELECT a.k, b.k, a.f, b.f FROM (SELECT * FROM a WHERE k < 30) AS a "
    "FULL JOIN (SELECT * FROM b WHERE k > 20) AS b ON a.k = b.k",
    "SELECT count(), sum(a.k), sum(b.k) FROM a FULL JOIN b ON a.k = b.k",
], ids=["on", "strings-nullable", "floats", "aggregate-above"])
def test_full_join_matches_reference(sessions, sql):
    """FULL JOIN ... ON (USING is left out: the reference puts the right
    key into the padded left key there, a known defect, analyzer.py:1068)."""
    _both(sessions, sql)


@pytest.mark.parametrize("op", ["INTERSECT", "EXCEPT"])
@pytest.mark.parametrize("mode", ["", " DISTINCT", " ALL"])
@pytest.mark.parametrize("cols", ["k", "k % 7, s", "n", "f, u"])
def test_intersect_except_match_reference(sessions, op, mode, cols):
    _both(sessions, f"SELECT {cols} FROM a WHERE k < 40 {op}{mode} "
                    f"SELECT {cols} FROM b WHERE k > 10")


def test_intersect_except_keep_left_order(sessions):
    for op in ("INTERSECT", "EXCEPT"):
        _both(sessions, f"SELECT k, s FROM a {op} SELECT k, s FROM b",
              ordered=True)


def test_intersect_past_the_budget_raises_naming_it(sessions):
    """INTERSECT holds its working set against the governor's budget."""
    ts = sessions[1]
    sql = "SELECT k FROM a INTERSECT SELECT k FROM b"
    with pytest.raises(MemoryLimitExceeded, match="INTERSECT"):
        ts.execute(sql, settings={"max_memory_usage": 80_000})
    assert ts.execute(sql).rows()
