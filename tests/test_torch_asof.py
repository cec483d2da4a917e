"""ASOF JOIN of the CUDA engine against the JAX reference, on the CPU.

The same numpy-seeded rows go through ``clickhouse_tpu.connect()`` and
``clickhouse_tpu_torch.connect(device="cpu")``; every answer must be equal,
rows in order.  The join takes the plain versions of K4 and K5 (the build
side grouped by its keys, its asof tokens ordering each key's rows), K8
(each probe row's key group) and K18 (the probe's token searched within
its group).  Cases: the four operators, INNER and LEFT, one and two
equality keys, NULL keys and NULL asof values on both sides, key groups
with no build row, equal build tokens (the newest row wins), Float and
UInt64 asof values, join_use_nulls, and the reference's own
test_join_propagate.py::test_asof_join.
"""
import numpy as np
import pytest

import clickhouse_tpu as jch
import clickhouse_tpu_torch as tch
from clickhouse_tpu_torch.core.errors import NotImplementedError_

N_PROBE = 2000
N_BUILD = 400


def _nulls(rng, a, share):
    out = a.astype(object)
    out[rng.random(len(a)) < share] = None
    return out


@pytest.fixture(scope="module")
def sessions():
    rng = np.random.default_rng(37)
    js, ts = jch.connect(), tch.connect(device="cpu")
    ev = {"uid": rng.integers(0, 25, N_PROBE),   # 20-24: no build row
          "g": rng.integers(0, 3, N_PROBE),
          "t": rng.integers(0, 500, N_PROBE),
          "f": np.round(rng.normal(0, 10, N_PROBE), 1),
          "u": rng.integers(0, 50, N_PROBE).astype(np.uint64)
          + np.uint64(1 << 63)}
    # few build tokens: many equal (uid, g, t) build rows
    px = {"uid": rng.integers(0, 20, N_BUILD),
          "g": rng.integers(0, 3, N_BUILD),
          "t": rng.integers(0, 500, N_BUILD) // 25 * 25,
          "f": np.round(rng.normal(0, 10, N_BUILD), 1),
          "u": rng.integers(0, 50, N_BUILD).astype(np.uint64)
          + np.uint64(1 << 63),
          "price": rng.integers(1, 100, N_BUILD)}
    evn = {"uid": _nulls(rng, ev["uid"], 0.1), "g": ev["g"],
           "t": _nulls(rng, ev["t"], 0.1)}
    pxn = {"uid": _nulls(rng, px["uid"], 0.1), "g": px["g"],
           "t": _nulls(rng, px["t"], 0.1), "price": _nulls(rng, px["price"],
                                                           0.2)}
    for s in (js, ts):
        s.execute("CREATE TABLE ev (uid Int64, g Int64, t Int64, "
                  "f Float64, u UInt64)")
        s.insert_pydict("ev", ev)
        s.execute("CREATE TABLE px (uid Int64, g Int64, t Int64, f Float64, "
                  "u UInt64, price Int64)")
        s.insert_pydict("px", px)
        s.execute("CREATE TABLE evn (uid Nullable(Int64), g Int64, "
                  "t Nullable(Int64))")
        s.insert_pydict("evn", evn)
        s.execute("CREATE TABLE pxn (uid Nullable(Int64), g Int64, "
                  "t Nullable(Int64), price Nullable(Int64))")
        s.insert_pydict("pxn", pxn)
    return js, ts


def _both(sessions, sql, settings=None):
    js, ts = sessions
    want = js.execute(sql, settings=settings).rows()
    got = ts.execute(sql, settings=settings).rows()
    assert got == want, (sql, len(got), len(want),
                         [(g, w) for g, w in zip(got, want) if g != w][:3])
    return got


OPS = ("<=", "<", ">=", ">")


@pytest.mark.parametrize("kind", ["INNER", "LEFT"])
@pytest.mark.parametrize("op", OPS)
def test_asof_one_key(sessions, op, kind):
    _both(sessions, f"SELECT ev.uid, ev.t, price, px.t FROM ev ASOF {kind} "
                    f"JOIN px ON ev.uid = px.uid AND ev.t {op} px.t")


@pytest.mark.parametrize("kind", ["INNER", "LEFT"])
@pytest.mark.parametrize("op", OPS)
def test_asof_two_keys(sessions, op, kind):
    _both(sessions, f"SELECT ev.uid, ev.g, ev.t, price FROM ev ASOF {kind} "
                    f"JOIN px ON ev.uid = px.uid AND ev.g = px.g "
                    f"AND px.t {op} ev.t")


@pytest.mark.parametrize("op", OPS)
def test_asof_nulls(sessions, op):
    """NULL equality keys and NULL asof values never match, on either
    side; a LEFT join keeps the probe row with the default."""
    _both(sessions, f"SELECT evn.uid, evn.t, price FROM evn ASOF LEFT JOIN "
                    f"pxn ON evn.uid = pxn.uid AND evn.t {op} pxn.t")
    _both(sessions, f"SELECT count(), sum(price) FROM evn ASOF JOIN pxn "
                    f"ON evn.uid = pxn.uid AND evn.t {op} pxn.t")


@pytest.mark.parametrize("sql", [
    "SELECT ev.uid, ev.f, price FROM ev ASOF JOIN px ON ev.uid = px.uid "
    "AND ev.f >= px.f",
    "SELECT ev.uid, ev.u, price FROM ev ASOF LEFT JOIN px "
    "ON ev.uid = px.uid AND ev.u < px.u",
    "SELECT ev.uid, ev.t, price FROM ev ASOF LEFT JOIN pxn "
    "ON ev.uid = pxn.uid AND ev.t >= pxn.t SETTINGS join_use_nulls = 1",
    "SELECT count(), sum(price), sum(ev.t) FROM ev ASOF LEFT JOIN px "
    "ON ev.uid = px.uid AND ev.t > px.t WHERE ev.g = 1",
], ids=["float", "uint64", "join-use-nulls", "aggregate-where"])
def test_asof_forms(sessions, sql):
    _both(sessions, sql)


def test_asof_second_inequality_refused_by_both(sessions):
    sql = ("SELECT ev.uid FROM ev ASOF JOIN px ON ev.uid = px.uid "
           "AND ev.t >= px.t AND price > 50")
    for s in sessions:
        with pytest.raises(Exception, match="exactly one inequality"):
            s.execute(sql)


def test_asof_reference_case():
    """tests/test_join_propagate.py::test_asof_join through both engines."""
    rng = np.random.default_rng(3)
    n, m = 2000, 300
    uid, t = rng.integers(0, 20, n), rng.integers(0, 1000, n)
    quid, qt = rng.integers(0, 20, m), rng.integers(0, 1000, m)
    price = rng.integers(1, 100, m)
    pair = (jch.connect(), tch.connect(device="cpu"))
    for s in pair:
        s.execute("CREATE TABLE ev (uid Int64, t Int64)")
        s.insert_pydict("ev", {"uid": uid, "t": t})
        s.execute("CREATE TABLE px (uid Int64, t Int64, price Int64)")
        s.insert_pydict("px", {"uid": quid, "t": qt, "price": price})
    for op in OPS:
        _both(pair, f"SELECT ev.uid, ev.t, price FROM ev ASOF INNER JOIN px "
                    f"ON ev.uid = px.uid AND px.t {op} ev.t "
                    f"ORDER BY ev.uid, ev.t, price")


def test_asof_equal_tokens_take_the_newest_row():
    """Among build rows of equal asof value, the last inserted wins."""
    ts = tch.connect(device="cpu")
    ts.execute("CREATE TABLE q (s Int64, ts Int64, px Int64)")
    ts.execute("INSERT INTO q VALUES (1, 10, 100), (1, 10, 101), "
               "(1, 20, 200)")
    ts.execute("INSERT INTO q VALUES (1, 10, 102), (2, 5, 7)")
    ts.execute("CREATE TABLE t (s Int64, ts Int64)")
    ts.execute("INSERT INTO t VALUES (1, 15), (1, 10), (1, 9), (2, 5), "
               "(3, 1)")
    assert ts.execute("SELECT t.s, t.ts, px FROM t ASOF LEFT JOIN q "
                      "ON t.s = q.s AND t.ts >= q.ts").rows() == [
        (1, 15, 102), (1, 10, 102), (1, 9, 0), (2, 5, 7), (3, 1, 0)]


def test_asof_array_right_column_raises(sessions):
    js, ts = sessions
    ts.execute("CREATE TABLE pa (uid Int64, t Int64, a Array(Int64))")
    ts.execute("INSERT INTO pa VALUES (1, 1, [1, 2])")
    with pytest.raises(NotImplementedError_, match="Array"):
        ts.execute("SELECT a FROM ev ASOF JOIN pa ON ev.uid = pa.uid "
                   "AND ev.t >= pa.t")
