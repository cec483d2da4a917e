"""The streamed programs beyond the aggregation, CUDA engine against the
JAX reference, on the CPU: TopKProgram (ORDER BY ... LIMIT), CollectProgram
(any other shape, a holistic aggregate among them), the grace join (both
join sides above the threshold) and blow-up streaming (a cross join's
intermediate over the budget).

The reference's cases of tests/test_streaming.py run through
``clickhouse_tpu.connect()`` and ``clickhouse_tpu_torch.connect(
device="cpu")`` over the same rows, inserted in the same parts, with the
thresholds that make every table "big" (STREAM: chunks of 1,024 rows).
The port's streamed rows must be the reference's streamed rows, in their
order, and the port's whole-block rows: integers and strings exactly,
floats within a relative FLOAT_RTOL (the reference adds the chunks' float
partial sums in another order).  Each case asserts the counter of its
program (StreamedQueries, GraceJoinBuckets, BlowupStreamedQueries).

K14's plain version (ops/filter_ops.compact_rows) is held against the
reference's gather_compaction_indices, run through JAX on the CPU, on the
first `count` output slots (the rest are unspecified in both).
"""
import math

import numpy as np
import pytest
import torch

import clickhouse_tpu as jch
import clickhouse_tpu_torch as tch
from clickhouse_tpu_torch.core.errors import (MemoryLimitExceeded,
                                              NotImplementedError_)

STREAM = {"max_device_block_bytes": 1, "stream_chunk_rows": 1024}
GRACE = {**STREAM, "grace_join_buckets": 4}
FLOAT_RTOL = 1e-9
N = 10_000


def _load(s):
    """tests/test_streaming.py's `big` (several parts) and `dim`."""
    s.execute("CREATE TABLE big (id Int64, k Int64, kw Int64, v Float64, "
              "cat String, nv Nullable(Int64))")
    rng = np.random.default_rng(7)
    ids = np.arange(N, dtype=np.int64)
    k = (ids % 97).astype(np.int64)
    kw = rng.integers(0, 3000, N).astype(np.int64) * 1_000_003
    v = rng.normal(100.0, 10.0, N).round(3)
    cat = np.asarray([f"c{i % 13}" for i in range(N)], object)
    nv = np.asarray([None if i % 11 == 0 else int(i % 7) for i in range(N)],
                    object)
    for lo in range(0, N, 3_000):
        hi = min(lo + 3_000, N)
        s.insert_pydict("big", {"id": ids[lo:hi], "k": k[lo:hi],
                                "kw": kw[lo:hi], "v": v[lo:hi],
                                "cat": cat[lo:hi], "nv": nv[lo:hi]})
    s.execute("CREATE TABLE dim (k Int64, name String)")
    s.insert_pydict("dim", {
        "k": np.arange(97, dtype=np.int64),
        "name": np.asarray([f"name{i}" for i in range(97)], object)})


def _load_grace(s):
    """TestGraceJoin's tables: fact (some keys unmatched), bigdim, and
    the string-keyed sfact and sdim."""
    rng = np.random.default_rng(3)
    nf, nd = 20_000, 4_000
    s.execute("CREATE TABLE fact (fk Int64, w Int64)")
    s.insert_pydict("fact", {"fk": rng.integers(0, nd + 500, nf),
                             "w": rng.integers(0, 100, nf)})
    s.execute("CREATE TABLE bigdim (k Int64, label Int64, tag String)")
    s.insert_pydict("bigdim", {
        "k": np.arange(nd, dtype=np.int64),
        "label": (np.arange(nd, dtype=np.int64) * 7) % 97,
        "tag": np.asarray([f"t{i % 11}" for i in range(nd)], object)})
    s.execute("CREATE TABLE sfact (sk String, w Int64)")
    s.insert_pydict("sfact", {
        "sk": np.asarray([f"key{i % 700}" for i in range(10_000)], object),
        "w": np.arange(10_000, dtype=np.int64) % 50})
    s.execute("CREATE TABLE sdim (sk String, lab Int64)")
    s.insert_pydict("sdim", {
        "sk": np.asarray([f"key{i}" for i in range(600)], object),
        "lab": np.arange(600, dtype=np.int64)})


@pytest.fixture(scope="module")
def sessions():
    js, ts = jch.connect(), tch.connect(device="cpu")
    _load(js)
    _load(ts)
    return js, ts


@pytest.fixture(scope="module")
def grace_sessions():
    js, ts = jch.connect(), tch.connect(device="cpu")
    _load_grace(js)
    _load_grace(ts)
    return js, ts


def _same(got, want) -> bool:
    if isinstance(want, float) or isinstance(got, float):
        if want is None or got is None:
            return got is want
        if math.isnan(want):
            return math.isnan(got)
        return math.isclose(got, want, rel_tol=FLOAT_RTOL, abs_tol=1e-12)
    return got == want


def _rows_match(got, want) -> bool:
    return len(got) == len(want) and all(
        len(g) == len(w) and all(_same(a, b) for a, b in zip(g, w))
        for g, w in zip(got, want))


def _counted(s, sql, settings, event):
    before = s.profile_events.get(event, 0)
    r = s.execute(sql, settings=settings)
    assert s.profile_events.get(event, 0) > before, \
        f"{event} did not move: {sql}"
    return r


def _both(sessions, sql, settings=STREAM, event="StreamedQueries"):
    """The port's streamed rows against the reference's streamed rows and
    the port's whole-block rows, in order; rows_read against the
    reference's."""
    js, ts = sessions
    want = _counted(js, sql, settings, event)
    got = _counted(ts, sql, settings, event)
    whole = ts.execute(sql).rows()
    assert _rows_match(got.rows(), want.rows()), (got.rows()[:5],
                                                  want.rows()[:5])
    assert _rows_match(got.rows(), whole), (got.rows()[:5], whole[:5])
    assert got.rows_read == want.rows_read
    return got.rows()


# -- TopKProgram (tests/test_streaming.py TestStreamingTopK) -----------------

TOPK = {
    "asc": "SELECT id, v FROM big ORDER BY v LIMIT 7",
    "desc-with-offset": "SELECT id, v FROM big ORDER BY v DESC LIMIT 5 "
                        "OFFSET 3",
    "multi-key": "SELECT k, id FROM big ORDER BY k DESC, id LIMIT 9",
    "string-key": "SELECT cat, id FROM big ORDER BY cat, id LIMIT 6",
    "nullable-key": "SELECT nv, id FROM big ORDER BY nv, id LIMIT 8",
    "expression-key": "SELECT id FROM big ORDER BY v * -1 LIMIT 4",
    "after-filter": "SELECT id, v FROM big WHERE k < 10 ORDER BY v LIMIT 5",
    "over-probe-join": "SELECT id, name FROM big INNER JOIN dim "
                       "ON big.k = dim.k ORDER BY v, id LIMIT 5",
    # tests/test_streaming.py TestHostPrewhere
    "prewhere-order-by-limit": "SELECT id, v FROM big WHERE k = 13 AND "
                               "id > 100 ORDER BY id LIMIT 7",
}


@pytest.mark.parametrize("name", list(TOPK))
def test_topk_matches_reference(sessions, name):
    rows = _both(sessions, TOPK[name])
    assert rows


def test_topk_ties_keep_the_carry_first():
    """Equal sort keys in every chunk: the first rows in row order win, as
    one block's stable sort keeps them (the carry comes before the chunk
    in every merge)."""
    js, ts = jch.connect(), tch.connect(device="cpu")
    for s in (js, ts):
        s.execute("CREATE TABLE t (id Int64, g Int64)")
        for lo in range(0, 6000, 2000):
            s.insert_pydict("t", {"id": np.arange(lo, lo + 2000,
                                                  dtype=np.int64),
                                  "g": np.arange(lo, lo + 2000) % 3})
    rows = _both((js, ts), "SELECT id, g FROM t ORDER BY g LIMIT 1500")
    assert [r[0] for r in rows] == [i for i in range(6000) if i % 3 == 0
                                    ][:1500]


@pytest.mark.parametrize("order", ["g DESC, id", "g, id DESC",
                                   "h, g DESC, id"])
def test_topk_of_packed_keys_at_a_k3_chunk(order):
    """Chunks of 2^16 rows and more: a top-k over several bounded integer
    keys takes K3 over one key packed from their bounds (ties by row
    id), as a top-k over one key does; the reference's rows."""
    js, ts = jch.connect(), tch.connect(device="cpu")
    rng = np.random.default_rng(17)
    n = 150_000
    data = {"id": np.arange(n, dtype=np.int64),
            "g": rng.integers(-40, 40, n), "h": rng.integers(0, 3, n)}
    for s in (js, ts):
        s.execute("CREATE TABLE p (id Int64, g Int64, h Int64)")
        for lo in range(0, n, 70_000):
            s.insert_pydict("p", {c: v[lo:lo + 70_000]
                                  for c, v in data.items()})
    sql = f"SELECT id, g, h FROM p WHERE id > 10 ORDER BY {order} LIMIT 20"
    _both((js, ts), sql, {"max_device_block_bytes": 1,
                          "stream_chunk_rows": 1 << 16})


@pytest.mark.parametrize("name", ["multi-key", "string-key", "nullable-key",
                                  "expression-key", "over-probe-join",
                                  "ties-by-one-key", "ties-by-two-keys"])
def test_topk_sorts_a_chunk_in_slices(sessions, name, monkeypatch):
    """A chunk above TOPK_SORT_ROWS that K3 cannot take is lowered and
    sorted by K4 a slice at a time, each slice's first rows merged into
    the carry (ties keep the earlier slice's row, as one stable sort of
    the chunk does): the reference's rows, at chunks of 4,096 rows and
    slices of 1,024 (the k rows' pad unit)."""
    from clickhouse_tpu_torch.exec import streaming
    sliced = []
    slice_rows = streaming._slice_rows

    def watch(blk, lo, hi):
        sliced.append((lo, hi))
        return slice_rows(blk, lo, hi)
    monkeypatch.setattr(streaming, "TOPK_SORT_ROWS", 1024)
    monkeypatch.setattr(streaming, "_slice_rows", watch)
    sql = {"ties-by-one-key": "SELECT id, k FROM big ORDER BY k LIMIT 40",
           "ties-by-two-keys": "SELECT id, k, cat FROM big ORDER BY k DESC, "
                               "cat LIMIT 30"}.get(name) or TOPK[name]
    _both(sessions, sql, {**STREAM, "stream_chunk_rows": 4096})
    # the join streams as a grace join (dim is above the threshold too),
    # whose buckets hold under 1,024 probe rows: one slice a chunk
    assert (1024, 2048) in sliced if name != "over-probe-join" \
        else (0, 1024) in sliced


# -- CollectProgram (TestStreamingCollect) -----------------------------------

COLLECT = {
    "filtered-select": "SELECT id, v FROM big WHERE k = 13",
    "limit-early-stop": "SELECT id FROM big WHERE k >= 0 LIMIT 10",
    "full-table-scan": "SELECT id, k, v, cat FROM big",
    "full-order-by-device": "SELECT id FROM big WHERE k < 3 "
                            "ORDER BY v DESC",
    "distinct-upper": "SELECT DISTINCT cat FROM big ORDER BY cat",
    "nullable-strings-limit-offset": "SELECT nv, cat FROM big WHERE k > 90 "
                                     "LIMIT 20 OFFSET 5",
    "no-row-collected": "SELECT id, cat, nv FROM big WHERE v > 1e9",
}


@pytest.mark.parametrize("name", list(COLLECT))
def test_collect_matches_reference(sessions, name):
    rows = _both(sessions, COLLECT[name])
    if name == "limit-early-stop":
        assert len(rows) == 10


@pytest.mark.parametrize("sql,settings", [
    ("SELECT id, v FROM big ORDER BY v, id",
     {**STREAM, "max_device_memory_bytes": 1}),
    ("SELECT nv, id FROM big ORDER BY nv DESC, id LIMIT 20",
     {**STREAM, "max_device_memory_bytes": 1, "stream_topk_max": 1}),
], ids=["full-order-by-host-external-sort", "host-sort-desc-nullable"])
def test_collect_host_external_sort(sessions, sql, settings):
    """Collected rows over the budget: the Sort [-> Limit] runs on the
    host (_np_order), with NULL and DESC as the device sort orders them."""
    js, ts = sessions
    got = _counted(ts, sql, settings, "StreamedQueries").rows()
    assert got == js.execute(sql, settings=settings).rows()
    assert got == js.execute(sql).rows() == ts.execute(sql).rows()


def test_collect_counts_the_bytes_copied_back(sessions):
    """io_stats' back_bytes: the collected rows as stored, id in 2 bytes
    (its values are below 10,000) and v in 8, and nothing else."""
    sql = COLLECT["filtered-select"]
    ts = sessions[1]
    rows = ts.execute(sql, settings=STREAM).rows()
    prog = next(p for (q, _), (p, _) in ts._stream_cache.items() if q == sql)
    assert type(prog).__name__ == "CollectProgram"
    assert prog.io_stats["back_bytes"] == 10 * len(rows) > 0


def test_holistic_aggregate_streams_via_collect(sessions):
    rows = _both(sessions, "SELECT quantileExact(0.5)(v) FROM big")
    assert 95 < rows[0][0] < 105


def test_window_upper_raises_naming_the_window(sessions):
    """A window function above a collect's rows is not ported: the port
    raises naming it before it reads a chunk (the reference answers)."""
    js, ts = sessions
    sql = ("SELECT id, row_number() OVER (ORDER BY v) AS rn FROM big "
           "WHERE k = 5 ORDER BY rn LIMIT 6")
    assert js.execute(sql, settings=STREAM).rows() == js.execute(sql).rows()
    before = ts.profile_events.get("StreamedQueries", 0)
    with pytest.raises(NotImplementedError_, match="window"):
        ts.execute(sql, settings=STREAM)
    assert ts.profile_events.get("StreamedQueries", 0) == before


# -- the grace join (TestGraceJoin) ------------------------------------------

GRACE_SQL = {
    "inner-agg": "SELECT count(), sum(label), sum(w) FROM fact "
                 "INNER JOIN bigdim ON fact.fk = bigdim.k",
    "left-join-group": "SELECT count(), countIf(label >= 0) FROM fact "
                       "LEFT JOIN bigdim ON fact.fk = bigdim.k",
    "grouped-by-build-column": "SELECT tag, count() AS c FROM fact "
                               "INNER JOIN bigdim ON fact.fk = bigdim.k "
                               "GROUP BY tag ORDER BY tag",
    "topk-over-grace": "SELECT fk, label FROM fact INNER JOIN bigdim "
                       "ON fact.fk = bigdim.k ORDER BY label DESC, fk "
                       "LIMIT 7",
    "string-keys": "SELECT count(), sum(lab) FROM sfact "
                   "INNER JOIN sdim ON sfact.sk = sdim.sk",
    "semi-join": "SELECT count() FROM fact LEFT SEMI JOIN bigdim "
                 "ON fact.fk = bigdim.k",
    # a collect over the buckets: its rows come bucket by bucket, in the
    # reference's buckets (splitmix64 of the key, mod 4)
    "collect-bucket-order": "SELECT fk, w, label FROM fact INNER JOIN "
                            "bigdim ON fact.fk = bigdim.k WHERE w < 3",
}


@pytest.mark.parametrize("name", list(GRACE_SQL))
def test_grace_join_matches_reference(grace_sessions, name):
    js, ts = grace_sessions
    sql = GRACE_SQL[name]
    want = _counted(js, sql, GRACE, "GraceJoinBuckets").rows()
    before = ts.profile_events.get("GraceJoinBuckets", 0)
    got = _counted(ts, sql, GRACE, "StreamedQueries").rows()
    assert ts.profile_events.get("GraceJoinBuckets", 0) == before + 4
    assert _rows_match(got, want), (got[:5], want[:5])
    if name == "collect-bucket-order":
        assert sorted(got) == sorted(ts.execute(sql).rows())
    else:
        assert _rows_match(got, ts.execute(sql).rows())


def test_grace_buckets_are_the_reference_s():
    """The host partition: each row's bucket is the reference's
    (splitmix64 over int64, float64 bits and crc32/adler32 of strings; NULL
    in bucket 0), and a part's rows keep their order in a bucket."""
    from clickhouse_tpu.exec import streaming as ref
    from clickhouse_tpu_torch.exec import streaming as port
    rng = np.random.default_rng(5)
    ints = rng.integers(-2 ** 40, 2 ** 40, 5000)
    floats = rng.normal(0, 1e6, 5000)
    strs = np.asarray([None if i % 9 == 0 else f"s{i % 77}é"
                       for i in range(5000)], object)
    nints = np.asarray([None if i % 7 == 0 else int(i) for i in range(5000)],
                       object)
    for cols, kinds in (([ints], ["int"]), ([floats], ["float"]),
                        ([strs], ["str"]), ([nints], ["int"]),
                        ([ints, strs], ["int", "str"])):
        for P in (2, 4, 8, 256):
            want = ref._bucket_of(cols, kinds, P)
            got = port._bucket_of(cols, kinds, P)
            assert np.array_equal(got.astype(np.int32), want)
    part = type("P", (), {"num_rows": 5000, "columns": {"a": ints}})()
    want = ref._partition_rows([part], ["a"], ["int"], 8)
    got = port._partition_rows([part], ["a"], ["int"], 8)
    assert all(np.array_equal(g[0], w[0]) for g, w in zip(got, want))
    # a part hashed in slices on worker threads, as one
    big = rng.integers(0, 2 ** 62, (1 << 23) + 5000)
    assert np.array_equal(port._part_buckets([big], ["int"], 8, None),
                          port._bucket_of([big], ["int"], 8))


@pytest.mark.parametrize("build_bytes,want", [(1, 2), (3_000_000_000, 8),
                                              (1 << 40, 256)])
def test_grace_bucket_count(build_bytes, want):
    from clickhouse_tpu.exec.streaming import _grace_bucket_count as ref
    from clickhouse_tpu_torch.core.settings import Settings
    from clickhouse_tpu_torch.exec.streaming import _grace_bucket_count
    got = _grace_bucket_count(build_bytes, 2 << 30, Settings())
    assert got == ref(build_bytes, 2 << 30, Settings()) == want


# -- blow-up streaming (TestBlowupStreaming) ---------------------------------

def _blown(s, sql, settings):
    return _counted(s, sql, settings, "BlowupStreamedQueries").rows()


@pytest.mark.parametrize("sql,settings", [
    ("SELECT count(*) FROM numbers(10000) n1 CROSS JOIN numbers(1000) n2",
     {"max_memory_usage": 16000000, "max_joined_block_size_rows": 1000}),
    ("SELECT sum(n1.number + n2.number) FROM numbers(20000) n1 "
     "CROSS JOIN numbers(500) n2", {"max_memory_usage": 20000000}),
], ids=["cross-join-streams-under-budget", "cross-join-sum-parity"])
def test_blowup_streaming_matches_reference(sql, settings):
    want = _blown(jch.connect(), sql, settings)
    ts = tch.connect(device="cpu")
    got = _blown(ts, sql, settings)
    assert got == want == ts.execute(sql).rows()


def test_huge_joined_block_refused():
    sql = "SELECT count(*) FROM numbers(10000) n1 CROSS JOIN numbers(1000) n2"
    st = {"max_memory_usage": 16000000, "max_joined_block_size_rows": 10000000}
    ref_err = __import__("clickhouse_tpu.core.errors",
                         fromlist=["x"]).MemoryLimitExceeded
    with pytest.raises(ref_err, match="expanding join"):
        jch.connect().execute(sql, settings=st)
    with pytest.raises(MemoryLimitExceeded, match="expanding join"):
        tch.connect(device="cpu").execute(sql, settings=st)


def test_stored_probe_side():
    sql = "SELECT count(*), sum(bp.x) FROM bp CROSS JOIN numbers(400)"
    st = {"max_memory_usage": 30000000}
    out = []
    for s in (jch.connect(), tch.connect(device="cpu")):
        s.execute("CREATE TABLE bp (x Int64) ENGINE = MergeTree ORDER BY x")
        s.insert_pydict("bp", {"x": np.arange(30000, dtype=np.int64)})
        out.append(_blown(s, sql, st))
    assert out[0] == out[1] == [(30000 * 400, 400 * 30000 * 29999 // 2)]


# -- ORDER BY DESC LIMIT at the u64 extremes (TestTopKDescExtremes) -----------

@pytest.mark.parametrize("ddl,insert,queries", [
    ("CREATE TABLE dx (x UInt64) ENGINE = MergeTree ORDER BY x",
     "INSERT INTO dx VALUES (0),(1),(2)",
     ["SELECT x FROM dx ORDER BY x DESC LIMIT 10",
      "SELECT x FROM dx ORDER BY x LIMIT 2"]),
    ("CREATE TABLE dsm (x Int64) ENGINE = MergeTree ORDER BY x",
     "INSERT INTO dsm VALUES (-9223372036854775808),"
     "(-9223372036854775807),(5)",
     ["SELECT x FROM dsm ORDER BY x LIMIT 2",
      "SELECT x FROM dsm ORDER BY x DESC LIMIT 3"]),
    ("CREATE TABLE dnl (x Nullable(UInt64), f UInt8) ENGINE = MergeTree "
     "ORDER BY f", "INSERT INTO dnl VALUES (0, 1), (NULL, 1), (1, 0), (2, 1)",
     ["SELECT x FROM dnl WHERE f = 1 ORDER BY x DESC LIMIT 10"]),
], ids=["desc-limit-small-uints", "desc-limit-signed-min",
        "nulls-last-with-filter-padding"])
def test_topk_desc_extremes(ddl, insert, queries):
    """The reference's cases, whole-block and streamed (TopKProgram) in
    both engines."""
    js, ts = jch.connect(), tch.connect(device="cpu")
    for s in (js, ts):
        s.execute(ddl)
        s.execute(insert)
    for sql in queries:
        want = js.execute(sql).rows()
        assert ts.execute(sql).rows() == want
        assert _counted(ts, sql, STREAM, "StreamedQueries").rows() == want
        assert _counted(js, sql, STREAM, "StreamedQueries").rows() == want


# -- K14's plain version against the reference's compaction ------------------

# rows of K14's tile: must equal kTile of csrc/compact_rows.cu (no kernel
# runs on the CPU to report it)
K14_TILE = 65_536
K14_STEP = 4096         # a tile's step: a run of 16 rows a thread


def _masks():
    rng = np.random.default_rng(14)
    n = 3 * 4096 + 17
    edges = np.zeros(n, bool)
    edges[[0, 15, 16, 4095, 4096, 8191, 8192, n - 1]] = True
    one = np.zeros(n, bool)
    one[5000] = True
    big = 3 * K14_TILE + 17
    r = np.arange(big)
    runs = (r % 16 == 0) | (r % 16 == 15) | (r == big - 1)
    tile_edges = np.zeros(big, bool)
    tile_edges[[0, K14_STEP - 1, K14_STEP, K14_TILE - 1, K14_TILE,
                2 * K14_TILE - 1, 2 * K14_TILE, 3 * K14_TILE - 1,
                3 * K14_TILE, big - 1]] = True
    last = np.zeros(5 * K14_TILE + 33, bool)
    last[5 * K14_TILE:] = rng.random(33) < 0.5
    bound = np.zeros(2 * K14_TILE + 100, bool)
    cut = K14_TILE + 5 * K14_STEP + 3 * 16 + 7    # inside a thread's runs
    bound[:cut] = rng.random(cut) < 0.5
    return {"empty": np.zeros(n, bool), "full": np.ones(n, bool),
            "one-bit": one, "tile-edges": edges,
            "random-1pct": rng.random(n) < 0.01,
            "random-50pct": rng.random(n) < 0.5,
            "k14-tile-and-a-row": rng.random(K14_TILE + 1) < 0.5,
            "k14-tile-edges": tile_edges, "k14-run-edges": runs,
            "k14-last-tile-only": last, "k14-cut-inside-runs": bound,
            "k14-tiles-1pct": rng.random(big) < 0.01}


@pytest.mark.parametrize("name", list(_masks()))
def test_compact_rows_plain_matches_reference(name):
    import jax.numpy as jnp
    from clickhouse_tpu.ops.filter_ops import gather_compaction_indices
    from clickhouse_tpu_torch.ops.filter_ops import compact_rows
    mask = _masks()[name]
    want_idx, want_count = gather_compaction_indices(jnp.asarray(mask))
    idx, count = compact_rows(torch.from_numpy(mask))
    c = int(count)
    assert c == int(want_count) == int(mask.sum())
    assert idx.dtype == torch.int32 and idx.shape == (len(mask),)
    assert np.array_equal(idx.numpy()[:c], np.asarray(want_idx)[:c])


def test_compact_rows_plain_reads_row_mask_parts():
    """A RowMask's row bound, mask and K1 terms select the rows, as the
    bool mask they give does."""
    import jax.numpy as jnp
    from clickhouse_tpu.ops.filter_ops import gather_compaction_indices
    from clickhouse_tpu_torch.ops.agg_ops import RowMask, Term
    from clickhouse_tpu_torch.ops.filter_ops import compact_rows
    rng = np.random.default_rng(15)
    n = 2 * 4096 + 100
    x = torch.from_numpy(rng.integers(-100, 100, n).astype(np.int32))
    v = torch.from_numpy((rng.random(n) < 0.9).astype(np.uint8))
    m = torch.from_numpy(rng.random(n) < 0.7)
    t1 = Term(x, v, np.dtype(np.int64), "greater", np.dtype(np.int64), -20)
    t2 = Term(x, None, np.dtype(np.int64), "notEquals", np.dtype(np.int64), 7)
    rows = RowMask(n, torch.device("cpu"), n - 50, (t1, t2), m)
    want = rows.tensor().numpy()
    assert want.sum() > 1000
    want_idx, want_count = gather_compaction_indices(jnp.asarray(want))
    idx, count = compact_rows(rows)
    c = int(count)
    assert c == int(want_count)
    assert np.array_equal(idx.numpy()[:c], np.asarray(want_idx)[:c])
    full = RowMask(n, torch.device("cpu"), n)
    idx, count = compact_rows(full)
    assert int(count) == n and np.array_equal(idx.numpy(), np.arange(n))


def test_blowup_refused_where_the_plan_scans_a_big_table():
    """Two tables above the threshold joined on an expression key: no
    streaming rewrite applies (the grace join takes column keys), so both
    engines refuse the plan over the budget; the blow-up chance is not
    taken, as it would read the other big table whole."""
    sql = ("SELECT count(), sum(label) FROM fact INNER JOIN bigdim "
           "ON fact.fk + 0 = bigdim.k")
    st = {**STREAM, "max_memory_usage": 400_000}
    ref_err = __import__("clickhouse_tpu.core.errors",
                         fromlist=["x"]).MemoryLimitExceeded
    for mod, err in ((jch, ref_err), (tch, MemoryLimitExceeded)):
        s = mod.connect() if mod is jch else mod.connect(device="cpu")
        _load_grace(s)
        with pytest.raises(err, match="no streaming rewrite"):
            s.execute(sql, settings=st)
        assert s.profile_events.get("BlowupStreamedQueries", 0) == 0


def test_blowup_streams_beside_a_table_above_the_threshold():
    """A cross join over small tables streams its probe side although
    another table of the catalog is above the streaming threshold.  The
    reference refuses it there (its governor raises inside try_streaming,
    before its blow-up chance; ROADMAP queue 3, ST4); the port answers as
    the reference does without the other table."""
    sql = "SELECT count(*), sum(t.x) FROM t CROSS JOIN numbers(1000)"
    st = {"max_device_block_bytes": 100_000, "max_memory_usage": 16_000_000}
    rows = [(3000 * 1000, 1000 * 3000 * 2999 // 2)]
    ref_err = __import__("clickhouse_tpu.core.errors",
                         fromlist=["x"]).MemoryLimitExceeded
    for mod in (jch, tch):
        s = mod.connect() if mod is jch else mod.connect(device="cpu")
        s.execute("CREATE TABLE t (x Int64)")
        s.insert_pydict("t", {"x": np.arange(3000, dtype=np.int64)})
        assert _blown(s, sql, st) == rows
        s.execute("CREATE TABLE huge (y Int64)")
        s.insert_pydict("huge", {"y": np.arange(50_000, dtype=np.int64)
                                 * 1_000_003})
        if mod is jch:
            with pytest.raises(ref_err, match="no streaming rewrite"):
                s.execute(sql, settings=st)
        else:
            assert _blown(s, sql, st) == rows
