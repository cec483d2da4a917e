"""The CUDA engine's sketch and array aggregates against the JAX reference,
on the CPU.

uniq (uniqCombined, uniqCombined64, uniqHLL12, uniqTheta), groupArray,
groupUniqArray (groupArrayDistinct), topK and entropy run through
``clickhouse_tpu.connect()`` and ``clickhouse_tpu_torch.connect(
device="cpu")`` over the same seeded numpy tables.

* The HLL state: the port's (groups, m) uint8 registers are held to the
  reference's (groups, m / 8) u64 limbs byte for byte (each engine's
  finalize is watched for its state: the reference's through a host
  callback of its jitted plan) for every argument type, NULLs, -If under
  GROUP BY (), one to three arguments, a String's codes, and at caps that
  give m = 4,096 (GROUP BY ()), 1,024, 256 and 64 (the sort grouping over
  5,000, 20,000 and 140,000 rows).  Under the sort grouping with a mask
  (-If, NULLs) the reference's registers are wrong past the first group
  (its (group, limb) ids do not ascend there), so the port's are held to
  numpy's registers of the same (group, hash) pairs and the reference's
  defect is pinned (``test_uniq_if_under_grouping_divergence``).
* K16's row-order entry (keys with small proven ranges: the row's slot
  from its keys, a slot -> group table): its registers are the
  reference's limbs and the perm entry's for a key from -5, two keys,
  m = 64 and 4,096, two arguments and rows outside the grouping; numpy's
  for uniqIf and a Nullable key; the route each key shape takes (Qu2's
  key, two keys within and past HLL_ROWS_MAX_CELLS, a wide and a float
  key); a key outside its bounds falls back to the perm entry; streamed
  chunks take it; chip_smoke's row-order cases against the perm entry's
  plain version; its cells' copy (``hll_cells``) against numpy, and its
  two steps together against the update.
* Estimates equal the reference's, or differ by 1 where the float32 sum of
  2^-register adds in another order; such cases are counted and must be
  few.
* groupArray, groupUniqArray and topK are exact (integers; a float's bits);
  entropy within a relative 1e-9 (the port sums c log2(T / c) / T a run,
  the reference log2(T / c) / T a row).
* The reference's own TestSketches and TestArrayAggs queries
  (tests/test_agg_functions.py:85-170), the re-plan past
  group_array_max_size among them, through both engines.
* Streamed (``max_device_block_bytes = 1``, chunks of 1,024 rows): uniq
  global and grouped through the carry (K16's merge), topK and groupArray
  through the collect, held to the reference's streamed rows.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import clickhouse_tpu as jch
import clickhouse_tpu_torch as tch
from clickhouse_tpu.exprs import agg_sketch as jsk
from clickhouse_tpu.ops import scan_ops as jscan
from chip_smoke import K16_CELLS_CASES, K16_UPDATE_CASES, k16_cells_case, \
    k16_perm_of, k16_update, k16_update_case
from clickhouse_tpu_torch.core.column import Dictionary
from clickhouse_tpu_torch.core.errors import (CapacityError,
                                              NotImplementedError_)
from clickhouse_tpu_torch.exprs import agg_sketch as tsk
from clickhouse_tpu_torch.interop import table_from_numpy
from clickhouse_tpu_torch.ops import sketch_ops

ENTROPY_RTOL = 1e-9
STREAM = {"max_device_block_bytes": 1, "stream_chunk_rows": 1024}
TYPES = {"k": "Int32", "i8": "Int8", "i16": "Int16", "i32": "Int32",
         "i64": "Int64", "u8": "UInt8", "u16": "UInt16", "u32": "UInt32",
         "u64": "UInt64", "f32": "Float32", "f64": "Float64", "b": "Bool",
         "d": "Date", "t": "DateTime", "dec": "Decimal(18, 2)",
         "s": "String", "nv": "Nullable(Int64)"}
ARG_COLS = [c for c in TYPES if c != "k"]


def _columns(n, seed):
    rng = np.random.default_rng(seed)
    u64 = rng.integers(0, 1 << 62, n, dtype=np.uint64)
    u64[rng.random(n) < 0.4] += np.uint64(1 << 63)
    return {
        "k": rng.integers(0, 8, n).astype(np.int32),
        "i8": rng.integers(-128, 128, n).astype(np.int8),
        "i16": rng.integers(-2000, 2000, n).astype(np.int16),
        "i32": rng.integers(-10**6, 10**6, n).astype(np.int32),
        "i64": rng.integers(-10**12, 10**12, n),
        "u8": rng.integers(0, 256, n).astype(np.uint8),
        "u16": rng.integers(0, 65536, n).astype(np.uint16),
        "u32": rng.integers(2**31 - 500, 2**31 + 3000, n).astype(np.uint32),
        "u64": u64,
        "f32": rng.normal(0, 10, n).astype(np.float32),
        "f64": np.where(rng.random(n) < 0.5, rng.normal(0, 1, n),
                        rng.integers(-300, 300, n).astype(np.float64)),
        "b": rng.random(n) < 0.5,
        "d": rng.integers(0, 30_000, n).astype(np.int32),
        "t": rng.integers(0, 2**31, n).astype(np.int64),
        "dec": rng.integers(-10**6, 10**6, n),
        "s": np.asarray([f"s{v}" for v in rng.integers(0, 900, n)], object),
        "nv": np.asarray([None if v % 5 == 0 else int(v) for v in
                          rng.integers(0, 2500, n)], object)}


_SESSIONS = {}


def _sessions():
    """Tables t (5,000 rows: m = 1,024 under the sort grouping), t20
    (20,000: m = 256) and t140 (140,000: m = 64), loaded alike into both
    engines."""
    if not _SESSIONS:
        js, ts = jch.connect(), tch.connect(device="cpu")
        for name, n, types in (("t", 5_000, TYPES),
                               ("t20", 20_000, {"k": "Int32", "i64": "Int64",
                                                "f32": "Float32"}),
                               ("t140", 140_000, {"k": "Int32",
                                                  "i32": "Int32",
                                                  "u64": "UInt64"})):
            cols = {c: v for c, v in _columns(n, n).items() if c in types}
            js.execute(f"CREATE TABLE {name} (" + ", ".join(
                f"{c} {t}" for c, t in types.items()) + ")")
            js.insert_pydict(name, cols)
            blk = js.catalog.get_table("default", name).read_block()
            table_from_numpy(ts, name, {c: np.asarray(v) for c, v in
                                        blk.to_pydict().items()}, types)
        _SESSIONS.update(js=js, ts=ts)
    return _SESSIONS["js"], _SESSIONS["ts"]


@pytest.fixture
def states(monkeypatch):
    """The states each engine's HLL finalize is given, in call order:
    the reference's limbs viewed as (groups, m) bytes, the port's
    registers."""
    seen = {"ref": [], "port": []}

    def spy(cls, key, as_bytes):
        orig = cls.finalize

        def finalize(self, st):
            seen[key].append(as_bytes(st[0]))
            return orig(self, st)
        monkeypatch.setattr(cls, "finalize", finalize)
    def ref(cls):
        orig = cls.finalize

        def finalize(self, st):
            # the reference's plan is one jitted program: its state comes
            # out through a host callback
            jax.debug.callback(lambda s: seen["ref"].append(
                np.asarray(s).view(np.uint8).reshape(s.shape[0], -1)),
                st[0], ordered=True)
            return orig(self, st)
        monkeypatch.setattr(cls, "finalize", finalize)
    ref(jsk.HLLUniqAgg)
    spy(tsk.HLLUniqAgg, "port", lambda s: s.numpy())
    return seen


def _captured(sql, states):
    js, ts = _sessions()
    del states["ref"][:], states["port"][:]
    want = js.execute(sql).rows()
    got = ts.execute(sql).rows()
    return got, want, list(states["port"]), list(states["ref"])


# -- the numpy model of the registers ----------------------------------------

def _mix(z):
    with np.errstate(over="ignore"):
        z = z.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def _np_registers(gid, values, cap_g, m):
    """numpy's (cap_g, m) registers of the rows (group gid, an integer
    value hashed as splitmix64 of its u64 bits)."""
    log2m = m.bit_length() - 1
    h = _mix(values.astype(np.int64).view(np.uint64))
    reg = (h & np.uint64(m - 1)).astype(np.int64)
    w = (h >> np.uint64(log2m)) | (np.uint64(1) << np.uint64(64 - log2m))
    low = w & (~w + np.uint64(1))
    rho = np.log2(low.astype(np.float64)).astype(np.int64) + 1
    out = np.zeros((cap_g, m), np.uint8)
    np.maximum.at(out, (gid.astype(np.int64), reg), rho.astype(np.uint8))
    return out


def _reference_columns(name):
    js = _sessions()[0]
    blk = js.catalog.get_table("default", name).read_block()
    return {c: np.asarray(v) for c, v in blk.to_pydict().items()}


# -- the registers -----------------------------------------------------------

GLOBAL_SQL = [
    "SELECT " + ", ".join(f"uniq({c})" for c in ARG_COLS) + " FROM t",
    "SELECT uniqIf(i64, i32 > 0), uniqIf(s, b), uniq(i32, f64), "
    "uniq(i8, s, u64), uniq(nv, f32) FROM t",
]
GROUPED_SQL = [
    ("SELECT k, uniq(i8), uniq(u32), uniq(u64), uniq(f64), uniq(s), "
     "uniq(b) FROM t GROUP BY k ORDER BY k", 1024),
    ("SELECT k, uniq(i64, f32), uniqCombined(s, i8, d) FROM t GROUP BY k "
     "ORDER BY k", 1024),
    ("SELECT k, uniq(i64), uniqHLL12(f32) FROM t20 GROUP BY k ORDER BY k",
     256),
    ("SELECT k, uniq(i32), uniqTheta(u64, i32) FROM t140 GROUP BY k "
     "ORDER BY k", 64),
]


@pytest.mark.parametrize("sql", GLOBAL_SQL, ids=["every-type", "if-args"])
def test_global_registers_are_the_references_limbs(states, sql):
    """GROUP BY (): 1,024 slots, m = 4,096; every argument type (UInt32
    above 2^31, UInt64 above 2^63, a Float64 stored as float32, a String's
    codes, NULLs), -If, one to three arguments: bit for bit."""
    got, want, port, ref = _captured(sql, states)
    assert len(port) == len(ref) == len(want[0])
    for p, r in zip(port, ref):
        assert p.shape == r.shape == (1024, 4096)
        assert np.array_equal(p, r)
    assert _estimates_close(got, want)


@pytest.mark.parametrize("sql,m", GROUPED_SQL,
                         ids=["types", "args", "m256", "m64"])
def test_grouped_registers_are_the_references_limbs(states, sql, m):
    """The sort grouping (K16's permuted update): m from the grouping's
    slots as the reference's _m_for_cap, bit for bit."""
    got, want, port, ref = _captured(sql, states)
    assert port and len(port) == len(ref)
    for p, r in zip(port, ref):
        assert p.shape[1] == m and p.shape == r.shape
        assert np.array_equal(p, r)
    assert _estimates_close(got, want)


# -- K16's row-order route under the sort grouping ----------------------------

@pytest.fixture
def routes(monkeypatch):
    """The K16 update entries the port's HLL steps take, in call order:
    "rows" (the row-order entry), "perm" (the perm entry) or "trivial"
    (GROUP BY ())."""
    seen = []

    def spy(name):
        orig = getattr(sketch_ops, name)

        def call(*a, **kw):
            seen.append("rows" if name == "hll_update_rows" else
                        "perm" if kw.get("perm") is not None else "trivial")
            return orig(*a, **kw)
        monkeypatch.setattr(sketch_ops, name, call)
    spy("hll_update")
    spy("hll_update_rows")
    return seen


def _perm_route_states(sql, states, monkeypatch):
    """The port's HLL states of sql with the row-order route turned off
    (every key refused): the perm entry's."""
    with monkeypatch.context() as mp:
        mp.setattr(tsk.HLLUniqAgg, "_slot_keys",
                   staticmethod(lambda ctx, m: None))
        return _captured(sql, states)[2]


ROUTE_SQL = [
    ("SELECT k - 5 AS kk, uniq(i64), uniq(i64, f32) FROM t GROUP BY kk "
     "ORDER BY kk", 1024),
    ("SELECT k, i8 % 3 AS j, uniq(i32) FROM t GROUP BY k, j ORDER BY k, j",
     1024),
    ("SELECT k, uniq(u64) FROM t140 GROUP BY k ORDER BY k", 64),
    ("SELECT k, uniq(i64), uniq(s) FROM t GROUP BY k ORDER BY k "
     "SETTINGS max_groups = 1024", 4096),
    ("SELECT k, uniq(i64) FROM t WHERE i32 > 0 GROUP BY k ORDER BY k",
     1024),
]


@pytest.mark.parametrize("sql,m", ROUTE_SQL,
                         ids=["negative-lo-two-args", "two-keys", "m64",
                              "m4096", "rows-outside-the-grouping"])
def test_row_order_route_registers_are_the_references_limbs(
        states, routes, monkeypatch, sql, m):
    """Keys with small proven ranges take K16's row-order entry (a key
    from -5, two keys, m = 64 and m = 4,096, two hash arguments, rows a
    WHERE leaves outside the grouping): its registers are the
    reference's limbs and the perm entry's, bit for bit."""
    got, want, port, ref = _captured(sql, states)
    assert routes and set(routes) == {"rows"}
    assert port and len(port) == len(ref)
    for p, r in zip(port, ref):
        assert p.shape[1] == m and np.array_equal(p, r)
    assert _estimates_close(got, want)
    perm = _perm_route_states(sql, states, monkeypatch)
    assert routes[len(port):] == ["perm"] * len(port)
    assert all(np.array_equal(a, b) for a, b in zip(port, perm))


def _np_nullable_key_registers(c, cap_g, m):
    """numpy's registers of uniq(i64) by nv % 7 (the NULL group first,
    then the values ascending)."""
    nv = np.array([-1 if v is None else v % 7 for v in c["nv"]], np.int64)
    gid = np.searchsorted(np.unique(nv), nv)
    return _np_registers(gid, c["i64"], cap_g, m)


def test_row_order_route_masks_and_nullable_keys_are_numpys(
        states, routes, monkeypatch):
    """An aggregate mask (uniqIf) and a Nullable key (its validity, then
    its data zeroed where NULL) in row order: numpy's registers and the
    perm entry's, bit for bit."""
    c = _reference_columns("t")
    # (a mask of its own: the reference caches each statement's plan, and
    # its state reaches the fixture only from a plan traced under it)
    sql = "SELECT k, uniqIf(i64, i32 < 0) FROM t GROUP BY k ORDER BY k"
    _, _, port, _ = _captured(sql, states)
    assert routes == ["rows"]
    keep = c["i32"] < 0
    gid = np.searchsorted(np.unique(c["k"]), c["k"])
    assert np.array_equal(port[0], _np_registers(
        gid[keep], c["i64"][keep], port[0].shape[0], 1024))
    assert np.array_equal(port[0], _perm_route_states(sql, states,
                                                      monkeypatch)[0])
    del routes[:]
    sql = "SELECT nv % 7 AS kk, uniq(i64) FROM t GROUP BY kk ORDER BY kk"
    got, want, port, _ = _captured(sql, states)
    assert routes == ["rows"]
    assert np.array_equal(port[0], _np_nullable_key_registers(
        c, port[0].shape[0], 1024))
    assert np.array_equal(port[0], _perm_route_states(sql, states,
                                                      monkeypatch)[0])
    assert _estimates_close(got, want)


ROWS_CASES = [c for c in K16_UPDATE_CASES if c[2] == "rows"]


@pytest.mark.parametrize("case", ROWS_CASES, ids=[c[0] for c in ROWS_CASES])
def test_row_order_plain_matches_the_perm_plain(case):
    """chip_smoke's row-order K16 cases on the CPU (the entry takes its
    plain version there): the perm entry's plain version over the same
    grouping's perm and group ids gives the same registers, bit for bit
    (Qu2's key at m = 64 and 4,096, two keys, a Nullable key, int64,
    int8 and constant keys, slots of no group and groups past cap_g, a
    mask, a row bound, two columns)."""
    args, m, cap_g, kw = k16_update_case(case, torch.device("cpu"))
    got = k16_update(args, m, cap_g, kw)
    n = sketch_ops._rows_of_keys(args, kw["keys"], kw["mask"], kw["n_rows"])
    perm, gid = k16_perm_of(kw["keys"], kw["table"], n, cap_g, kw["mask"])
    want = sketch_ops.hll_update(args, m, cap_g, perm=perm, gid=gid,
                                 mask=kw["mask"])
    assert got.any() and torch.equal(got, want)


@pytest.mark.parametrize("case", K16_CELLS_CASES,
                         ids=[c[0] for c in K16_CELLS_CASES])
def test_cells_copy_plain_matches_numpy(case):
    """K16's cells' copy (its plain version, what the CPU runs): each slot's
    registers as bytes in its group's row, numpy's, bit for bit; slots of
    no group and groups past cap_g write nothing."""
    cells, table, cap_g = k16_cells_case(case, torch.device("cpu"))
    want = np.zeros((cap_g, cells.shape[1]), np.uint8)
    for slot, g in enumerate(table.numpy()):
        if 0 <= g < cap_g:
            want[g] = cells[slot].numpy()
    assert np.array_equal(sketch_ops.hll_cells(cells, table, cap_g).numpy(),
                          want)


@pytest.mark.parametrize("case", ROWS_CASES[:4],
                         ids=[c[0] for c in ROWS_CASES[:4]])
def test_row_order_cells_then_copy_is_the_update(case):
    """The keyed row-order update's two steps on the CPU: its registers
    a slot (the plain update with each slot its own group) copied by
    hll_cells into the slots' groups give the update's registers, bit for
    bit."""
    args, m, cap_g, kw = k16_update_case(case, torch.device("cpu"))
    keys, table = kw["keys"], kw["table"]
    n = sketch_ops._rows_of_keys(args, keys, kw["mask"], kw["n_rows"])
    slots = table.shape[0]
    cells = sketch_ops._hll_update_rows_plain(
        args, m.bit_length() - 1, slots, n, keys,
        torch.arange(slots, dtype=torch.int32), kw["mask"])
    got = sketch_ops.hll_cells(cells.to(torch.int32), table, cap_g)
    assert got.any() and torch.equal(got, k16_update(args, m, cap_g, kw))


HITS_ROWS = 20_000


@pytest.fixture(scope="module")
def hits_session():
    """A small hits (x Int64 of bench.py's formula) in the port."""
    ts = tch.connect(device="cpu")
    ts.execute("CREATE TABLE hits (x Int64)")
    ts.insert_pydict("hits", {"x": (np.arange(HITS_ROWS, dtype=np.int64)
                                    * 2654435761) % 1_000_003})
    return ts


@pytest.mark.parametrize("keys,route", [
    ("x % 1024", "rows"), ("x % 100, x % 160", "rows"), ("x", "perm"),
    ("toFloat64(x % 10)", "perm"), ("x % 100, x % 170", "perm")],
    ids=["qu2-key", "two-keys-16000-slots", "wide", "float",
         "two-keys-17000-slots"])
def test_route_choice(hits_session, routes, states, monkeypatch, keys,
                      route):
    """Qu2's SQL over a small hits (m = 256 at its 20,480 group slots)
    takes the row-order entry, as do two keys of 16,000 slots (4,096,000
    registers); a key of a million values, a float key and two keys of
    17,000 slots (past HLL_ROWS_MAX_CELLS registers) take the perm
    entry.  Both routes give the same registers."""
    assert sketch_ops.HLL_ROWS_MAX_CELLS == 1 << 22
    sql = (f"SELECT {keys}, uniq(x), uniqCombined(x, x % 7) FROM hits "
           f"GROUP BY {keys} ORDER BY {keys} LIMIT 10")
    del states["port"][:]
    rows = hits_session.execute(sql).rows()
    assert routes == [route, route]
    port = list(states["port"])
    with monkeypatch.context() as mp:
        mp.setattr(tsk.HLLUniqAgg, "_slot_keys",
                   staticmethod(lambda ctx, m: None))
        del states["port"][:]
        assert hits_session.execute(sql).rows() == rows
    assert all(np.array_equal(a, b) for a, b in zip(port, states["port"]))


def test_key_outside_its_bounds_takes_the_perm_route(routes):
    """A key whose values leave its proven bounds (keys 6-9 against
    (0, 5)) changes no answer: the slot table's check finds a group's key
    outside and the step takes the perm entry; with true bounds the
    row-order entry gives the same registers, numpy's."""
    from clickhouse_tpu_torch.core import dtypes as dt
    from clickhouse_tpu_torch.exprs.aggregates import GroupContext
    from clickhouse_tpu_torch.exprs.expr import ColVal
    from clickhouse_tpu_torch.ops import agg_ops
    from clickhouse_tpu_torch.ops.sort_ops import SortKey
    rng = np.random.default_rng(11)
    k = rng.integers(0, 10, 3000).astype(np.int32)
    x = rng.integers(0, 1 << 40, 3000)
    rows = agg_ops.RowMask.of(torch.ones(3000, dtype=torch.bool))
    want = _np_registers(k, x, 1024, 4096)
    for bounds, route in (((0, 5), "perm"), ((0, 9), "rows")):
        g = agg_ops.group_by_sort([SortKey(torch.from_numpy(k))], rows, 1024)
        ctx = GroupContext(row_valid=rows, grouping=g, keys=[
            SortKey(torch.from_numpy(k), bounds=bounds)])
        agg = tsk.HLLUniqAgg([dt.Int64])
        del routes[:]
        st = agg.sorted_step(ctx, g, [ColVal(dt.Int64, torch.from_numpy(x))],
                             None, [])[0]
        assert routes == [route]
        assert np.array_equal(st.numpy(), want)
    keys = [sketch_ops.SlotKey(torch.from_numpy(k), 0, 10)]
    assert sketch_ops.hll_slot_table(g.unique_keys, g.num_groups,
                                     keys) is not None
    assert sketch_ops.hll_slot_table(
        g.unique_keys, torch.tensor(11), keys) is None


def test_streamed_chunks_take_the_row_order_route(routes):
    """Q5ub's shape streamed (chunks of 1,024 rows): each chunk's step sees
    the GROUP BY keys and takes the row-order entry over its own
    grouping's slot table; the answers are the reference's streamed."""
    js, ts = _sessions()
    sql = "SELECT k, uniq(i64) FROM t GROUP BY k ORDER BY k"
    got = ts.execute(sql, settings=STREAM).rows()
    assert len(routes) >= 5 and set(routes) == {"rows"}
    assert _estimates_close(got, js.execute(sql, settings=STREAM).rows())


def _estimates_close(got, want, limit=2) -> bool:
    """Equal rows, but an estimate may differ by 1 (the float32 sum's
    order); at most `limit` such values."""
    if len(got) != len(want):
        return False
    off = 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if a != b:
                if not (isinstance(a, int) and abs(a - b) == 1):
                    return False
                off += 1
    return off <= limit


def test_masked_grouped_registers_are_numpys(states):
    """-If and NULLs under the sort grouping: the port's registers are
    numpy's over the (group, value) pairs of the rows that pass."""
    c = _reference_columns("t")
    got, _, port, _ = _captured(
        "SELECT k, uniqIf(i64, i32 > 0), uniq(nv) FROM t GROUP BY k "
        "ORDER BY k", states)
    keys = np.unique(c["k"])
    gid = np.searchsorted(keys, c["k"])
    cap_g = port[0].shape[0]
    keep = c["i32"] > 0
    assert np.array_equal(port[0], _np_registers(gid[keep], c["i64"][keep],
                                                 cap_g, 1024))
    nv = c["nv"]
    ok = np.array([v is not None for v in nv])
    assert np.array_equal(port[1], _np_registers(
        gid[ok], np.array([v for v in nv if v is not None], np.int64),
        cap_g, 1024))
    for row, g in zip(got, keys):
        sel = (c["k"] == g) & keep
        exact = len(np.unique(c["i64"][sel]))
        assert abs(row[1] - exact) <= max(4, 0.1 * exact)


def test_uniq_if_under_grouping_divergence(states):
    """The reference's grouped uniqIf keeps a group's masked-out rows as
    (group, limb) ids past every group's (agg_sketch.py:337-341), so its
    segment bounds break after the first group: its registers there are
    not numpy's.  The port's are; should the reference be repaired, this
    test fails and the case joins the bit-for-bit ones."""
    c = _reference_columns("t")
    _, want, port, ref = _captured(
        "SELECT k, uniqIf(i64, i32 > 0) FROM t GROUP BY k ORDER BY k",
        states)
    keys = np.unique(c["k"])
    keep = c["i32"] > 0
    model = _np_registers(np.searchsorted(keys, c["k"])[keep],
                          c["i64"][keep], port[0].shape[0], 1024)
    assert np.array_equal(port[0], model)
    assert np.array_equal(ref[0][0], model[0])
    assert not np.array_equal(ref[0][1:len(keys)], model[1:len(keys)])


def test_every_spelling_and_form_estimates_match_reference():
    """uniq's five spellings, GROUP BY () and the sort grouping, with -If
    under GROUP BY (): the reference's estimates (or 1 off, counted)."""
    js, ts = _sessions()
    names = ("uniq", "uniqCombined", "uniqCombined64", "uniqHLL12",
             "uniqTheta")
    for sql in ("SELECT " + ", ".join(f"{n}(i32)" for n in names)
                + ", " + ", ".join(f"{n}If(u16, b)" for n in names)
                + " FROM t",
                "SELECT k, " + ", ".join(f"{n}(f64, s)" for n in names)
                + " FROM t GROUP BY k ORDER BY k"):
        assert _estimates_close(ts.execute(sql).rows(),
                                js.execute(sql).rows())


def test_merge_and_finalize_plain_match_reference():
    """K16's merge (plain) is the reference's seg_reduce_2d("bytemax")
    over the limbs of the same partial states; its finalize the
    reference's finalize (or 1 off, counted), over registers as data
    makes them, empty groups among them."""
    rng = np.random.default_rng(3)
    merge = jax.jit(jscan.seg_reduce_2d, static_argnums=0)
    finalize = jax.jit(lambda s: jsk.HLLUniqAgg([]).finalize([s])[0])
    for m, cap_g, n_in in ((64, 512, 1200), (1024, 40, 120),
                           (4096, 3, 9)):
        # rho is geometric (1 + trailing zeros of a hash): registers as
        # data makes them, 60 % empty
        regs = np.minimum(rng.geometric(0.5, (n_in, m)),
                          65 - m.bit_length())
        regs[rng.random((n_in, m)) < 0.6] = 0
        st = regs.astype(np.uint8)
        gid = np.sort(rng.integers(0, cap_g // 2, n_in))
        perm = rng.permutation(n_in)
        keep = rng.random(n_in) < 0.8
        starts = np.searchsorted(gid, np.arange(cap_g))
        ends = np.searchsorted(gid, np.arange(cap_g), side="right")
        got = sketch_ops.hll_merge(
            torch.from_numpy(st), cap_g, starts=torch.from_numpy(starts),
            ends=torch.from_numpy(ends),
            perm=torch.from_numpy(perm.astype(np.int32)),
            mask=torch.from_numpy(keep))
        limbs = st.view(np.uint64)[perm]
        limbs = np.where(keep[perm][:, None], limbs, 0)
        boundary = np.r_[True, gid[1:] != gid[:-1]]
        want = np.asarray(merge("bytemax", jnp.asarray(limbs),
                                jnp.asarray(boundary), jnp.asarray(starts),
                                jnp.asarray(ends)))
        assert np.array_equal(got.numpy(), want.view(np.uint8).reshape(
            cap_g, m))
        est = sketch_ops.hll_finalize(got).numpy()
        ref = np.asarray(finalize(jnp.asarray(want)))
        d = np.abs(est.astype(np.int64) - ref.astype(np.int64))
        assert d.max() <= 1 and (d > 0).sum() <= max(2, cap_g // 100)
        assert (est[ends == starts] == 0).all()
    trivial = sketch_ops.hll_merge(torch.from_numpy(st), 3,
                                   mask=torch.from_numpy(keep))
    assert np.array_equal(trivial[0].numpy(), st[keep].max(axis=0))
    assert not trivial[1:].any()


def test_states_of_two_dictionaries_are_not_merged():
    """S3: a String hashes its dictionary code, which counts distinct
    strings within one dictionary only; the updates of one aggregate
    (a streamed query's chunks) over two dictionaries raise."""
    from clickhouse_tpu_torch.core import dtypes as dt
    from clickhouse_tpu_torch.exprs.expr import ColVal
    agg = tsk.HLLUniqAgg([dt.String])
    a = Dictionary(np.asarray(["a", "b"], object))
    b = Dictionary(np.asarray(["a", "c"], object))
    codes = torch.zeros(3, dtype=torch.int32)
    agg._same_dictionaries([ColVal(dt.String, codes, dictionary=a)])
    agg._same_dictionaries([ColVal(dt.String, codes, dictionary=Dictionary(
        np.asarray(["a", "b"], object)))])
    with pytest.raises(NotImplementedError_, match="S3"):
        agg._same_dictionaries([ColVal(dt.String, codes, dictionary=b)])


# -- the array aggregates, topK and entropy ----------------------------------

def _rows_close(got, want):
    """Rows equal, a float within ENTROPY_RTOL."""
    def close(a, b):
        if isinstance(a, float) or isinstance(b, float):
            return math.isclose(a, b, rel_tol=ENTROPY_RTOL, abs_tol=1e-12)
        if isinstance(a, list) or isinstance(b, list):
            return list(a) == list(b)
        return a == b
    return len(got) == len(want) and all(
        len(g) == len(w) and all(close(a, b) for a, b in zip(g, w))
        for g, w in zip(got, want))


HOLISTIC_SQL = [
    "SELECT k, groupArray(7)(i32), groupUniqArray(6)(i8 % 5), "
    "groupArrayDistinct(3)(u8 % 4) FROM t GROUP BY k ORDER BY k",
    "SELECT groupArray(5)(f64), groupUniqArray(d % 3), topK(4)(u16 % 9), "
    "entropy(i16 % 11) FROM t",
    "SELECT k, topK(3)(i64 % 7), topK(2)(f32 > 0), entropy(i8), "
    "entropy(s) FROM t GROUP BY k ORDER BY k",
    "SELECT k, groupArrayIf(4)(i64, b), groupUniqArrayIf(5)(i8 % 4, b), "
    "groupArray(4)(nv) FROM t GROUP BY k ORDER BY k",
    "SELECT groupArrayIf(3)(u64, b), topK(3)(u64 % 5), entropy(f64), "
    "topKIf(2)(i8 % 3, b), entropyIf(u8, b), topK(3)(nv % 4) FROM t",
    "SELECT k, length(groupArray(i32)) AS l, count() AS c FROM t "
    "GROUP BY k HAVING l != c",
]


@pytest.mark.parametrize("sql", HOLISTIC_SQL,
                         ids=["arrays", "global", "topk-entropy",
                              "array-if-nullable", "global-if", "length"])
def test_holistic_sketches_match_reference(sql):
    """The array aggregates, topK and entropy with and without -If and
    NULLs (topK and entropy with a mask under GROUP BY () only: see the
    divergence below): the reference's rows."""
    js, ts = _sessions()
    got, want = ts.execute(sql).rows(), js.execute(sql).rows()
    assert _rows_close(got, want), (sql, got[:3], want[:3])


MASKED_RUNS_SQL = ("SELECT k, topKIf(3)(u8 % 6, i32 > 0), "
                   "entropyIf(u8 % 6, i32 > 0), topK(2)(nv % 3), "
                   "entropy(nv % 5) FROM t GROUP BY k ORDER BY k")


def _np_runs(c):
    """numpy's topKIf(3)(u8 % 6, i32 > 0), entropyIf(...), topK(2)(nv %
    3) and entropy(nv % 5) a group: the most frequent first, ties in
    value order; -sum p log2 p."""
    out = []
    nv = np.array([-1 if v is None else v for v in c["nv"]], np.int64)
    for g in np.unique(c["k"]):
        row = [int(g)]
        for v, sel, k in ((c["u8"] % 6, c["i32"] > 0, 3),
                          (nv % 3, nv >= 0, 2)):
            sel = sel & (c["k"] == g)
            vals, cnt = np.unique(v[sel].astype(np.int64),
                                  return_counts=True)
            row.append([int(x) for x in vals[np.lexsort((vals, -cnt))][:k]])
            if k == 3:
                p = cnt / cnt.sum()
                row.append(float(-(p * np.log2(p)).sum()))
        sel = (nv >= 0) & (c["k"] == g)
        _, cnt = np.unique(nv[sel] % 5, return_counts=True)
        p = cnt / cnt.sum()
        row.append(float(-(p * np.log2(p)).sum()))
        out.append(tuple(row))
    return out


def test_masked_topk_and_entropy_are_numpys():
    """topK and entropy with -If and NULLs under the sort grouping:
    numpy's answers (entropy within ENTROPY_RTOL)."""
    ts = _sessions()[1]
    want = _np_runs(_reference_columns("t"))
    assert _rows_close(ts.execute(MASKED_RUNS_SQL).rows(), want)


def test_topk_and_entropy_under_a_masked_grouping_divergence():
    """The reference's topK and entropy give a group's masked-out rows
    the run id past every run (agg_sketch.py:183-186, :225-228), so its
    runs' bounds break after the first group with such rows: its answers
    there are not numpy's (entropy 0.0 for a group of five values).  The
    port's are; should the reference be repaired, this test fails."""
    js, ts = _sessions()
    want = _np_runs(_reference_columns("t"))
    ref = js.execute(MASKED_RUNS_SQL).rows()
    assert _rows_close(ref[:1], want[:1])
    assert not any(_rows_close([r], [w]) for r, w in zip(ref[1:], want[1:]))
    assert _rows_close(ts.execute(MASKED_RUNS_SQL).rows(), want)


def test_group_array_replans_past_the_setting():
    """A groupArray of no width wider than group_array_max_size raises
    CapacityError naming the setting; the session re-plans with it raised
    and answers every row, as the reference does."""
    js, ts = _sessions()
    sql = "SELECT k, groupArray(i32) FROM t GROUP BY k ORDER BY k"
    with pytest.raises(CapacityError, match="group_array_max_size"):
        ts.execute(sql, settings={"capacity_autotune": 0})
    got, want = ts.execute(sql).rows(), js.execute(sql).rows()
    assert got == want and max(len(r[1]) for r in got) > 256


# -- the reference's own TestSketches and TestArrayAggs ----------------------

@pytest.fixture(scope="module")
def m_sessions():
    """tests/test_agg_functions.py's table m (4,000 rows, seed 77) and
    TestSketches' table u (60,000 UInt64)."""
    rng = np.random.default_rng(77)
    n = 4000
    data = {"k": rng.integers(0, 8, n).astype(np.uint32),
            "x": rng.normal(3, 2, n), "y": rng.normal(-1, 4, n),
            "v": rng.integers(0, 50, n).astype(np.uint32),
            "b": rng.integers(0, 1 << 40, n).astype(np.uint64)}
    u = np.random.default_rng(3).integers(0, 1 << 62, 60000,
                                          dtype=np.uint64)
    js, ts = jch.connect(), tch.connect(device="cpu")
    js.execute("CREATE TABLE m (k UInt32, x Float64, y Float64, v UInt32, "
               "b UInt64)")
    js.insert_pydict("m", data)
    js.execute("CREATE TABLE u (x UInt64)")
    js.insert_pydict("u", {"x": u})
    table_from_numpy(ts, "m", data, {"k": "UInt32", "x": "Float64",
                                     "y": "Float64", "v": "UInt32",
                                     "b": "UInt64"})
    table_from_numpy(ts, "u", {"x": u}, {"x": "UInt64"})
    return js, ts


REFERENCE_SQL = {
    "uniq_hll_within_tolerance": "SELECT k, uniq(b), uniqExact(b) FROM m "
                                 "GROUP BY k ORDER BY k",
    "uniq_large_relative_error": "SELECT uniq(x) FROM u",
    "entropy": "SELECT k, entropy(v) FROM m GROUP BY k ORDER BY k",
    "group_array_order_and_values": "SELECT k, groupArray(v) FROM m "
                                    "GROUP BY k ORDER BY k",
    "group_array_bounded": "SELECT k, groupArray(5)(v) FROM m GROUP BY k "
                           "ORDER BY k",
    "group_uniq_array": "SELECT k, groupUniqArray(v) FROM m GROUP BY k "
                        "ORDER BY k",
    "top_k": "SELECT k, topK(3)(v) FROM m GROUP BY k ORDER BY k",
    "group_array_in_expression": "SELECT k, length(groupArray(v)) AS l, "
                                 "count() AS c FROM m GROUP BY k "
                                 "HAVING l != c",
}


@pytest.mark.parametrize("case", sorted(REFERENCE_SQL))
def test_reference_sketch_and_array_queries(m_sessions, case):
    """TestSketches and TestArrayAggs (tests/test_agg_functions.py:85-170)
    through both engines: the reference's rows (the HLL estimates equal or
    1 off; entropy within ENTROPY_RTOL), the groupArray past width 256
    re-planned."""
    js, ts = m_sessions
    sql = REFERENCE_SQL[case]
    got, want = ts.execute(sql).rows(), js.execute(sql).rows()
    if "uniq" in case:
        assert _estimates_close(got, want), (got, want)
    else:
        assert _rows_close(got, want), (got[:3], want[:3])
    if case == "group_array_order_and_values":
        assert max(len(r[1]) for r in got) > 256


# -- streamed ------------------------------------------------------------------

STREAM_SQL = {
    "global": "SELECT uniq(i64), uniqIf(i32, b), uniq(s) FROM t",
    "grouped": "SELECT k, uniq(i64), uniqCombined(f32, u8) FROM t "
               "GROUP BY k ORDER BY k",
    "collect": "SELECT k, topK(3)(u8 % 7), groupArray(4)(i32), "
               "entropy(i8 % 9) FROM t GROUP BY k ORDER BY k",
}


@pytest.mark.parametrize("case", sorted(STREAM_SQL))
def test_streamed_sketches_match_reference_streamed(case):
    """t (5,000 rows) streamed in chunks of 1,024 rows: uniq through the
    carry (GROUP BY (): the trivial merge; keyed: the sort regrouping and
    K16's merge, m of each chunk's slots as the reference's), topK,
    groupArray and entropy through the collect; the reference's streamed
    rows."""
    js, ts = _sessions()
    sql = STREAM_SQL[case]
    before = ts.profile_events.get("StreamedQueries", 0)
    got = ts.execute(sql, settings=STREAM).rows()
    assert ts.profile_events.get("StreamedQueries", 0) == before + 1
    want = js.execute(sql, settings=STREAM).rows()
    if case == "collect":
        assert _rows_close(got, want), (got[:3], want[:3])
    else:
        assert _estimates_close(got, want), (got, want)
