"""ORDER BY ... WITH FILL of the CUDA engine against the JAX reference, on
the CPU.

The same numpy-seeded rows go through ``clickhouse_tpu.connect()`` and
``clickhouse_tpu_torch.connect(device="cpu")``; every answer must be
equal, rows in order.  The block and its grid of pad_to(fill_max_rows)
points are sorted together with K4's plain version.  Cases: the
reference's TestWithFill (tests/test_sql_e2e.py:589), ASC and DESC, FROM,
TO and STEP, a Float key, a Nullable key, an unsigned key, empty input, a
grid cut at fill_max_rows, a filter and a GROUP BY below the sort, and
the other columns at their defaults (a String at '', where the reference
shows its dictionary's first value: R2, pinned in tests/test_torch_ops.py
DIVERGENCES).
"""
import numpy as np
import pytest

import clickhouse_tpu as jch
import clickhouse_tpu_torch as tch

N = 400


@pytest.fixture(scope="module")
def sessions():
    rng = np.random.default_rng(41)
    js, ts = jch.connect(), tch.connect(device="cpu")
    n = rng.integers(-30, 30, N).astype(object)
    n[rng.random(N) < 0.2] = None
    cols = {"a": rng.integers(-100, 400, N) * 3,
            "f": np.round(rng.uniform(0, 20, N) * 4) / 4,
            "n": n,
            "u": rng.integers(0, 900, N).astype(np.uint32),
            "v": rng.integers(0, 10, N)}
    for s in (js, ts):
        s.execute("CREATE TABLE w (a Int64, f Float64, n Nullable(Int32), "
                  "u UInt32, v Int64)")
        s.insert_pydict("w", cols)
        s.execute("CREATE TABLE wf (x Int64, v Int64)")
        s.execute("INSERT INTO wf VALUES (1, 10), (4, 40), (7, 70)")
        s.execute("CREATE TABLE e (x Int64)")
    return js, ts


def _both(sessions, sql):
    js, ts = sessions
    want = js.execute(sql).rows()
    got = ts.execute(sql).rows()
    assert got == want, (sql, len(got), len(want),
                         [(g, w) for g, w in zip(got, want) if g != w][:3])
    return got


@pytest.mark.parametrize("sql,want", [
    ("SELECT x, v FROM wf ORDER BY x WITH FILL",
     [(1, 10), (2, 0), (3, 0), (4, 40), (5, 0), (6, 0), (7, 70)]),
    ("SELECT x FROM wf ORDER BY x WITH FILL FROM 0 TO 10",
     [(i,) for i in range(10)]),
    ("SELECT x FROM wf ORDER BY x WITH FILL STEP 2",
     [(1,), (3,), (4,), (5,), (7,)]),
    ("SELECT x FROM wf ORDER BY x DESC WITH FILL",
     [(i,) for i in range(7, 0, -1)]),
    ("SELECT x FROM e ORDER BY x WITH FILL", []),
], ids=["basic", "from-to", "step", "desc", "empty-no-bounds"])
def test_reference_with_fill_cases(sessions, sql, want):
    assert _both(sessions, sql) == want


@pytest.mark.parametrize("sql", [
    "SELECT a, v FROM w ORDER BY a WITH FILL",
    "SELECT a, v FROM w ORDER BY a DESC WITH FILL",
    "SELECT a FROM w ORDER BY a WITH FILL FROM -500 TO 1500 STEP 7",
    "SELECT a FROM w ORDER BY a DESC WITH FILL FROM 1300 TO -400 STEP -11",
    "SELECT a FROM w ORDER BY a WITH FILL STEP 5",
    "SELECT f, v FROM w ORDER BY f WITH FILL STEP 0.25",
    "SELECT f FROM w ORDER BY f DESC WITH FILL FROM 25.0 TO 0.5 STEP -0.5",
    "SELECT n, v FROM w ORDER BY n WITH FILL",
    "SELECT n FROM w ORDER BY n DESC WITH FILL STEP -2",
    "SELECT u, a FROM w ORDER BY u WITH FILL STEP 3",
    "SELECT a FROM w WHERE a > 100000 ORDER BY a WITH FILL",
    "SELECT a FROM w WHERE a > 100000 ORDER BY a WITH FILL FROM 0 TO 5",
    "SELECT a FROM w ORDER BY a WITH FILL FROM 0 TO 100000 "
    "SETTINGS fill_max_rows = 600",
    "SELECT a FROM w WHERE v = 3 ORDER BY a WITH FILL STEP 9",
    "SELECT intDiv(a, 100) AS b, count() FROM w WHERE a % 200 < 100 "
    "GROUP BY b ORDER BY b WITH FILL STEP 1",
], ids=["asc", "desc", "from-to-step", "desc-from-to-step", "step",
        "float-step", "float-desc", "nullable", "nullable-desc",
        "unsigned", "empty", "empty-from-to", "grid-cut", "filtered",
        "qfill-shape"])
def test_with_fill_matches_reference(sessions, sql):
    _both(sessions, sql)


def test_with_fill_string_column_default():
    """The grid's rows hold '' in a String column (ClickHouse's default;
    R2: the reference shows the dictionary's first value)."""
    ts = tch.connect(device="cpu")
    ts.execute("CREATE TABLE s (a Int64, s String)")
    ts.execute("INSERT INTO s VALUES (1, 'x'), (4, 'w')")
    assert ts.execute("SELECT a, s FROM s ORDER BY a WITH FILL").rows() == [
        (1, "x"), (2, ""), (3, ""), (4, "w")]
