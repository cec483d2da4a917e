"""SELECT ... FINAL over the MergeTree family of the CUDA engine against
the JAX reference, on the CPU.

The same statements and numpy-seeded rows go through
``clickhouse_tpu.connect()`` and ``clickhouse_tpu_torch.connect(
device="cpu")``; integers and strings must be equal, float sums within
rtol 1e-9.  The fold takes the plain versions of K4 and K5 (the sort
grouping by the ORDER BY key), K6's permuted entry (SummingMergeTree's
sums), its sorted-order entry (CollapsingMergeTree's counts and
positions) and K17 (VersionedCollapsingMergeTree's surplus).  Where the
reference is wrong against ClickHouse (R1: ReplacingMergeTree(ver) keeps
the newest row whatever its version; R3: more keys than max_groups drop
the keys past the slots) the port is held to numpy's reading of
ClickHouse's rule and the divergence is pinned in
tests/test_torch_ops.py DIVERGENCES.
"""
import numpy as np
import pytest

import clickhouse_tpu as jch
import clickhouse_tpu_torch as tch
from clickhouse_tpu_torch.core.errors import (CapacityError,
                                              NotImplementedError_)

FLOAT_RTOL = 1e-9


def _pair():
    return jch.connect(), tch.connect(device="cpu")


def _run(sessions, *stmts):
    for st in stmts:
        for s in sessions:
            s.execute(st)


def _close(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return abs(a - b) <= FLOAT_RTOL * max(abs(a), abs(b), 1e-300)
    return a == b


def _both(sessions, sql, settings=None):
    js, ts = sessions
    want = js.execute(sql, settings=settings).rows()
    got = ts.execute(sql, settings=settings).rows()
    assert len(got) == len(want), (sql, got[:5], want[:5])
    for g, w in zip(got, want):
        assert all(_close(x, y) for x, y in zip(g, w)), (sql, g, w)
    return got


# -- the reference's own cases (tests/test_mergetree.py, test_merges.py) --

REPLACING = ("CREATE TABLE r (k Int64, v Int64) "
             "ENGINE = ReplacingMergeTree ORDER BY k",
             "INSERT INTO r VALUES (1, 10), (2, 20)",
             "INSERT INTO r VALUES (1, 11), (3, 30)")
SUMMING = ("CREATE TABLE sm (k Int64, total Int64, label String) "
           "ENGINE = SummingMergeTree ORDER BY k",
           "INSERT INTO sm VALUES (1, 5, 'a'), (2, 7, 'b')",
           "INSERT INTO sm VALUES (1, 3, 'a2'), (2, 1, 'b2')")
COLLAPSING = ("CREATE TABLE t (k Int64, v Int64, sign Int8) "
              "ENGINE = CollapsingMergeTree(sign) ORDER BY k",)
VERSIONED = ("CREATE TABLE t (k Int64, v Int64, sign Int8, ver UInt64) "
             "ENGINE = VersionedCollapsingMergeTree(sign, ver) ORDER BY k",)


@pytest.mark.parametrize("stmts,sql,want", [
    (REPLACING, "SELECT count() FROM r", [(4,)]),
    (REPLACING, "SELECT k, v FROM r FINAL ORDER BY k",
     [(1, 11), (2, 20), (3, 30)]),
    (REPLACING, "SELECT sum(v) FROM r FINAL", [(61,)]),
    (SUMMING, "SELECT k, total FROM sm FINAL ORDER BY k", [(1, 8), (2, 8)]),
    (SUMMING, "SELECT k, total, label FROM sm FINAL ORDER BY k",
     [(1, 8, "a2"), (2, 8, "b2")]),
    (COLLAPSING + ("INSERT INTO t VALUES (1, 10, 1)",
                   "INSERT INTO t VALUES (1, 10, -1)"),
     "SELECT count() FROM t FINAL", [(0,)]),
    (COLLAPSING + ("INSERT INTO t VALUES (1, 10, 1), (1, 10, -1), "
                   "(1, 20, 1)",), "SELECT k, v FROM t FINAL", [(1, 20)]),
    (COLLAPSING + ("INSERT INTO t VALUES (2, 5, -1), (2, 7, -1), (2, 6, 1)",),
     "SELECT k, v, sign FROM t FINAL", [(2, 5, -1)]),
    (COLLAPSING + ("INSERT INTO t VALUES (3, 1, -1), (3, 2, 1)",),
     "SELECT v, sign FROM t FINAL ORDER BY v", [(1, -1), (2, 1)]),
    (COLLAPSING + ("INSERT INTO t VALUES (1, 1, 1), (2, 2, 1)",
                   "INSERT INTO t VALUES (1, 1, -1), (2, 3, 1)"),
     "SELECT k, v FROM t FINAL ORDER BY k, v", [(2, 3)]),
    (COLLAPSING + ("INSERT INTO t VALUES (1, 10, 1), (2, 5, 1)",
                   "INSERT INTO t VALUES (1, 10, -1), (3, 7, -1)"),
     "SELECT k, v FROM t FINAL ORDER BY k", [(2, 5), (3, 7)]),
    (VERSIONED + ("INSERT INTO t VALUES (1, 10, 1, 1)",
                  "INSERT INTO t VALUES (1, 10, -1, 1), (1, 20, 1, 2)"),
     "SELECT k, v, ver FROM t FINAL", [(1, 20, 2)]),
    (VERSIONED + ("INSERT INTO t VALUES (1, 10, 1, 1), (1, 10, -1, 2)",),
     "SELECT count() FROM t FINAL", [(2,)]),
    (VERSIONED + ("INSERT INTO t VALUES (1, 10, 1, 1), (2, 9, 1, 1)",
                  "INSERT INTO t VALUES (1, 10, -1, 1)"),
     "SELECT k, v FROM t FINAL ORDER BY k", [(2, 9)]),
], ids=["replacing-without-final", "replacing-keeps-last",
        "replacing-aggregate", "summing", "summing-newest-string",
        "collapsing-pair-cancels", "collapsing-extra-positive",
        "collapsing-extra-negative", "collapsing-equal-trailing-positive",
        "collapsing-multiple-keys", "collapsing-final-read",
        "versioned-same-version-cancels", "versioned-versions-survive",
        "versioned-final-read"])
def test_reference_final_cases(stmts, sql, want):
    """The FINAL reads of the reference's TestReplacing, TestSumming,
    TestCollapsing and TestVersionedCollapsing (their OPTIMIZE cases as
    FINAL reads of the same rows: OPTIMIZE is not ported)."""
    sessions = _pair()
    _run(sessions, *stmts)
    assert _both(sessions, sql) == want


def test_replacing_with_version_takes_the_highest():
    """ReplacingMergeTree(ver) FINAL keeps each key's highest version, the
    newest row among equal versions: the answer of the reference's own
    merge (test_merges.py::TestReplacingWithVersion after OPTIMIZE)."""
    ts = tch.connect(device="cpu")
    ts.execute("CREATE TABLE t (k Int64, v Int64, ver UInt64) "
               "ENGINE = ReplacingMergeTree(ver) ORDER BY k")
    ts.execute("INSERT INTO t VALUES (1, 100, 5)")
    ts.execute("INSERT INTO t VALUES (1, 200, 3), (2, 9, 1)")
    ts.execute("INSERT INTO t VALUES (2, 10, 1), (2, 8, 0)")
    assert ts.execute("SELECT k, v FROM t FINAL ORDER BY k").rows() \
        == [(1, 100), (2, 10)]


# -- seeded tables of many parts --------------------------------------------

PARTS = 8
ROWS = 1500


def _parts(seed, keys, signs=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(PARTS):
        part = {"k": rng.integers(0, keys, ROWS).astype(np.uint32),
                "v": rng.integers(0, 1 << 32, ROWS).astype(np.uint32),
                "p": rng.integers(-10**12, 10**12, ROWS),
                "f": np.round(rng.normal(0, 100, ROWS), 2),
                "s": np.asarray([f"s{i}" for i in rng.integers(0, 40, ROWS)],
                                object)}
        if signs:
            part["sign"] = np.where(rng.random(ROWS) < 0.6, 1,
                                    -1).astype(np.int8)
            part["ver"] = rng.integers(0, 3, ROWS).astype(np.uint32)
        out.append(part)
    return out


def _load(sessions, name, engine, parts, signs=False):
    extra = ", sign Int8, ver UInt32" if signs else ""
    for s in sessions:
        s.execute(f"CREATE TABLE {name} (k UInt32, v UInt32, p Int64, "
                  f"f Float64, s String{extra}) ENGINE = {engine} "
                  f"ORDER BY k")
        for part in parts:
            s.insert_pydict(name, part)


@pytest.mark.parametrize("engine,signs", [
    ("ReplacingMergeTree", False), ("SummingMergeTree", False),
    ("CollapsingMergeTree(sign)", True),
    ("VersionedCollapsingMergeTree(sign, ver)", True),
], ids=["replacing", "summing", "collapsing", "versioned"])
@pytest.mark.parametrize("keys", [50, 5000], ids=["dense", "sparse"])
def test_final_over_many_parts_matches_reference(engine, signs, keys):
    sessions = _pair()
    _load(sessions, "m", engine, _parts(keys, keys, signs), signs)
    cols = "k, v, p, f, s" + (", sign, ver" if signs else "")
    _both(sessions, f"SELECT {cols} FROM m FINAL ORDER BY {cols}")
    _both(sessions, "SELECT count(), sum(p), sum(v) FROM m FINAL")
    _both(sessions, "SELECT count(), sum(p) FROM m FINAL WHERE v > 2000000000")


def test_replacing_version_over_many_parts_is_numpys():
    """ReplacingMergeTree(v) over eight parts: each key's row of the
    highest v, the newest among equal v (numpy's lexsort), R1 aside."""
    parts = _parts(7, 300)
    rng = np.random.default_rng(8)
    for part in parts:                  # few versions: ties within a key
        part["v"] = rng.integers(0, 4, ROWS).astype(np.uint32)
    ts = tch.connect(device="cpu")
    _load([ts], "m", "ReplacingMergeTree(v)", parts)
    k = np.concatenate([p["k"] for p in parts])
    v = np.concatenate([p["v"] for p in parts])
    p = np.concatenate([x["p"] for x in parts])
    o = np.lexsort((np.arange(len(k)), v, k))
    last = np.r_[k[o][1:] != k[o][:-1], True]
    want = sorted(zip(k[o][last].tolist(), v[o][last].tolist(),
                      p[o][last].tolist()))
    assert ts.execute("SELECT k, v, p FROM m FINAL ORDER BY k").rows() \
        == want


def test_final_with_more_keys_than_max_groups():
    """More keys than max_groups: the fold's slots are the reference's
    pad_to(min(rows, max_groups)), and the key count past them raises
    CapacityError naming max_groups, which the session re-plans (the
    reference drops the keys past its slots, R3)."""
    keys = np.arange(3000, dtype=np.int64)
    ts = tch.connect(device="cpu")
    ts.execute("CREATE TABLE r (k Int64, v Int64) "
               "ENGINE = ReplacingMergeTree ORDER BY k")
    ts.insert_pydict("r", {"k": keys, "v": keys})
    ts.insert_pydict("r", {"k": keys[::3], "v": -keys[::3]})
    sql = "SELECT count(), sum(v) FROM r FINAL"
    want = [(3000, int(keys.sum() - 2 * keys[::3].sum()))]
    with pytest.raises(CapacityError, match="max_groups") as e:
        ts.execute(sql, settings={"max_groups": 1024,
                                  "capacity_autotune": 0})
    assert e.value.setting == "max_groups" and e.value.needed == 3000
    before = ts.profile_events.get("CapacityRetunes", 0)
    assert ts.execute(sql, settings={"max_groups": 1024}).rows() == want
    assert ts.profile_events.get("CapacityRetunes", 0) > before


def test_aggregating_merge_tree_final_raises_naming_it():
    """AggregatingMergeTree FINAL, which raised naming the engine until its
    AggregateFunction columns and -State/-Merge were ported, now folds as
    the reference does: a key's states merged into one (count, sum, max
    and uniq columns over two parts with duplicate keys), and a table of
    that engine without a state column keeps a row a key.  An
    AggregateFunction whose state is not ported still raises naming it."""
    sessions = _pair()
    _run(sessions,
         "CREATE TABLE src (k Int64, v Int64, u UInt32)",
         "INSERT INTO src VALUES (1, 1, 5), (1, 2, 5), (2, -2, 7), "
         "(3, 9, 3), (3, 9, 4), (2, 8, 1)",
         "CREATE TABLE a (k Int64, c AggregateFunction(count, Int64), "
         "s AggregateFunction(sum, Int64), m AggregateFunction(max, Int64), "
         "u AggregateFunction(uniq, UInt32)) "
         "ENGINE = AggregatingMergeTree ORDER BY k",
         "INSERT INTO a SELECT k, countState(v), sumState(v), maxState(v), "
         "uniqState(u) FROM src GROUP BY k",
         "INSERT INTO a SELECT k, countState(v), sumState(v), maxState(v), "
         "uniqState(u) FROM src WHERE k < 3 GROUP BY k",
         "CREATE TABLE b (k Int64, c Int64) "
         "ENGINE = AggregatingMergeTree ORDER BY k",
         "INSERT INTO b VALUES (1, 2), (1, 3), (2, 4)")
    got = _both(sessions, "SELECT k, finalizeAggregation(c), "
                "finalizeAggregation(s), finalizeAggregation(m), "
                "finalizeAggregation(u) FROM a FINAL ORDER BY k")
    assert got == [(1, 4, 6, 2, 1), (2, 4, 12, 8, 2), (3, 2, 18, 9, 2)]
    _both(sessions, "SELECT count() FROM a FINAL")
    _both(sessions, "SELECT k FROM b FINAL ORDER BY k")
    with pytest.raises(NotImplementedError_, match="uniqExact"):
        sessions[1].execute("CREATE TABLE e (k Int64, c AggregateFunction("
                            "uniqExact, Int64)) ENGINE = "
                            "AggregatingMergeTree ORDER BY k")
