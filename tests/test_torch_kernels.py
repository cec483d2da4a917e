"""Hand-written CUDA kernels of clickhouse_tpu_torch against their plain
PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a GPU.  The file
imports no JAX, so on a machine with a card it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Integer results must be bit-exact.  Float sums: rtol=1e-12, because the
kernel adds per-block partials in another order than torch's sum.
"""
import numpy as np
import pytest
import torch

from clickhouse_tpu_torch.ops import _native
from clickhouse_tpu_torch.ops.agg_ops import (_masked_reduce_plain,
                                              masked_reduce)
from clickhouse_tpu_torch.ops.mxu_segsum import (_dense_group_reduce_plain,
                                                 dense_group_reduce)
from clickhouse_tpu_torch.ops.sort_ops import (_topk_smallest32_plain,
                                               _topk_smallest_plain,
                                               topk_smallest, topk_smallest32)

pytestmark = pytest.mark.cuda

DTYPES = [torch.bool, torch.int8, torch.uint8, torch.int16, torch.int32,
          torch.int64, torch.float32, torch.float64]
OPS = ["sum", "min", "max", "any", "bor", "band", "bxor"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _values(rng, dtype, n):
    if dtype == torch.bool:
        a = rng.integers(0, 2, n).astype(bool)
    elif dtype.is_floating_point:
        a = rng.normal(0, 1e6, n)
        a[rng.random(n) < 0.01] = -0.0
        a[rng.random(n) < 0.01] = 0.0
        a = a.astype(np.float32 if dtype == torch.float32 else np.float64)
    else:
        info = torch.iinfo(dtype)
        a = rng.integers(info.min, info.max, n, endpoint=True,
                         dtype=np.int64)
        a = a.astype(str(dtype).replace("torch.", ""))
    return torch.from_numpy(a)


def _same(got, want):
    got, want = got.cpu(), want.cpu()
    assert got.dtype == want.dtype
    if got.is_floating_point():
        g, w = got.double().item(), want.double().item()
        if np.isnan(w):
            assert np.isnan(g)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-12)
            assert np.signbit(g) == np.signbit(w) or g != 0.0
    else:
        assert got.item() == want.item()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("n", [1, 1000, 1_000_003])
def test_masked_reduce_matches_plain(dev, dtype, n):
    rng = np.random.default_rng(n)
    data = _values(rng, dtype, n)
    masks = [None, torch.from_numpy(rng.random(n) < 0.3),
             torch.zeros(n, dtype=torch.bool), torch.ones(n, dtype=torch.bool)]
    for op in OPS:
        if op in ("bor", "band", "bxor") and dtype.is_floating_point:
            continue
        for m in masks:
            want = _masked_reduce_plain(op, data, m)
            got = masked_reduce(op, data.to(dev),
                                None if m is None else m.to(dev))
            _same(got, want)


def test_masked_reduce_nan_unsigned_and_overflow(dev):
    x = torch.tensor([1.0, float("nan"), -0.0, 0.0], dtype=torch.float64)
    for op in ("min", "max", "sum"):
        _same(masked_reduce(op, x.to(dev)), _masked_reduce_plain(op, x, None))
    u = torch.tensor([1, -1, 5, -(1 << 63)], dtype=torch.int64)  # u64 bits
    for op in ("min", "max"):
        got = masked_reduce(op, u.to(dev), unsigned=True)
        _same(got, _masked_reduce_plain(op, u, None, unsigned=True))
    big = torch.full((1000,), (1 << 62), dtype=torch.int64)
    _same(masked_reduce("sum", big.to(dev)),
          _masked_reduce_plain("sum", big, None))


@pytest.mark.parametrize("S", [1, 1024, 2047, 16384])
def test_dense_group_reduce_matches_plain(dev, S):
    rng = np.random.default_rng(S)
    n = 3_000_000
    ids = torch.from_numpy(rng.integers(-2, S + 2, n).astype(np.int32))
    base = torch.from_numpy(rng.random(n) < 0.9)
    cms = [None, torch.from_numpy(rng.random(n) < 0.5)]
    svs = [_values(rng, t, n) for t in (torch.int64, torch.int32,
                                        torch.uint8, torch.bool)]
    sms = [None, torch.from_numpy(rng.random(n) < 0.5), None, None]
    want = _dense_group_reduce_plain(ids, base, cms, svs, sms, S)

    def cu(ts):
        return [None if t is None else t.to(dev) for t in ts]
    got = dense_group_reduce(ids.to(dev), base.to(dev), cu(cms), cu(svs),
                             cu(sms), S)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("case", ["one_slot", "zipf"])
def test_dense_group_reduce_skewed_slots_match_plain(dev, case):
    """Lanes of a warp share slots: S = 1, and Zipf(1.1) slots over 1,024;
    both count masks None (counted once, then copied)."""
    rng = np.random.default_rng(7)
    n = 3_000_000
    if case == "one_slot":
        S, ids = 1, np.zeros(n, np.int32)
    else:
        S, ids = 1024, ((rng.zipf(1.1, n) - 1) % 1024).astype(np.int32)
    ids = torch.from_numpy(ids)
    base = torch.from_numpy(rng.random(n) < 0.9)
    x = _values(rng, torch.int64, n)
    want = _dense_group_reduce_plain(ids, base, [None, None], [x], [None], S)
    got = dense_group_reduce(ids.to(dev), base.to(dev), [None, None],
                             [x.to(dev)], [None], S)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("case", ["counts_none", "same_mask_tensor", "S4096",
                                  "S8192", "S16384"])
def test_dense_group_reduce_count_masks_and_tiles_match_plain(dev, case):
    """Count arrays with the same mask (None twice, or one tensor twice) are
    counted once; one count and one sum over S = 4,096 fill one 48 KB
    histogram, S = 8,192 one 96 KB histogram, S = 16,384 two 96 KB tiles."""
    rng = np.random.default_rng(11)
    n = 3_000_000
    S = int(case[1:]) if case.startswith("S") else 1024
    ids = torch.from_numpy(rng.integers(-3, S + 3, n).astype(np.int32))
    base = torch.from_numpy(rng.random(n) < 0.9)
    x = _values(rng, torch.int64, n)
    m = torch.from_numpy(rng.random(n) < 0.5)
    cms = {"counts_none": [None, None], "same_mask_tensor": [m, None, m]}.get(
        case, [None])
    want = _dense_group_reduce_plain(ids, base, cms, [x], [m], S)
    mc = m.to(dev)
    got = dense_group_reduce(ids.to(dev), base.to(dev),
                             [mc if t is m else None for t in cms],
                             [x.to(dev)], [mc], S)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("n,k", [(10, 3), (10, 40), (5000, 100),
                                 (3_000_000, 100), (3_000_000, 4096),
                                 (100_000, 1)])
@pytest.mark.parametrize("order", ["random", "descending", "ascending",
                                   "constant"])
def test_topk_smallest32_matches_plain(dev, n, k, order):
    """The 32-bit entry: ties, keys 2^32 - 2 and 2^32 - 1, invalid rows,
    monotone keys (every row admitted), and one key everywhere (ties across
    every block boundary)."""
    rng = np.random.default_rng(n + k + len(order))
    key = rng.integers(-50, 50, n).astype(np.int32)
    key[:4] = np.array([-1, -2, -1, 0], np.int32)[:min(4, n)]
    if order == "descending":
        key = np.arange(n, 0, -1, dtype=np.int32)
    elif order == "ascending":
        key = np.arange(n, dtype=np.int32)
    elif order == "constant":
        key = np.full(n, 5, np.int32)
    key = torch.from_numpy(key)
    valid = torch.from_numpy(rng.random(n) < 0.8)
    for v in (valid, None):
        want = _topk_smallest32_plain(key, v, k)
        got = topk_smallest32(key.to(dev), None if v is None else v.to(dev),
                              k)
        m = min(n if v is None else int(v.sum()), k)
        assert torch.equal(got.cpu()[:m], want[:m])


@pytest.mark.parametrize("n,k", [(10, 3), (10, 40), (5000, 100),
                                 (3_000_000, 100), (3_000_000, 4096),
                                 (100_000, 1)])
@pytest.mark.parametrize("order", ["random", "descending", "ascending"])
def test_topk_smallest_matches_plain(dev, n, k, order):
    rng = np.random.default_rng(n + k)
    tok = torch.from_numpy(rng.integers(-50, 50, n).astype(np.int64)
                           * (1 << 57))           # ties and both signs
    if order != "random":   # every row beats the last k (or none does)
        tok = torch.arange(n, dtype=torch.int64) * (-1 if order ==
                                                    "descending" else 1)
    valid = torch.from_numpy(rng.random(n) < 0.8)
    for v in (valid, None):
        want = _topk_smallest_plain(tok, v, k)
        got = topk_smallest(tok.to(dev), None if v is None else v.to(dev), k)
        n_valid = n if v is None else int(v.sum())
        m = min(n_valid, k)
        assert torch.equal(got.cpu()[:m], want[:m])


def test_launch_counters_count_kernel_launches(dev):
    _native.reset_launches()
    x = torch.arange(10, device=dev)
    masked_reduce("sum", x)
    dense_group_reduce(x.to(torch.int32), None, [None], [x], [None], 10)
    topk_smallest(x, None, 3)
    assert _native.LAUNCHES == {"masked_reduce": 1, "dense_group_reduce": 1,
                                "topk_smallest": 1}


SQL_ON_CARD = [
    "SELECT count() FROM hits WHERE x > 500000",
    "SELECT x % 1024 AS k, count() AS c, sum(x) FROM hits GROUP BY k "
    "ORDER BY c DESC LIMIT 10",
    "SELECT x FROM hits ORDER BY x LIMIT 100",
    "SELECT x FROM hits ORDER BY x DESC LIMIT 4096",
    "SELECT count(), sum(n), min(n), max(n), avg(n) FROM t WHERE n > 10",
    "SELECT count(), sum(u), min(u), max(u) FROM t "
    "WHERE u > 9223372036854775808",
    "SELECT min(f), max(f), sum(f), avg(f), any(f) FROM t WHERE f = f",
    "SELECT a, b, count(), sum(n), sum(u), countIf(f > 0) FROM t "
    "GROUP BY a, b",
    "SELECT k, count(), sum(a), avg(n) FROM t WHERE a > 2 GROUP BY k",
    "SELECT f FROM t ORDER BY f DESC LIMIT 30",
    "SELECT n FROM t ORDER BY n LIMIT 30",
    "SELECT k, u FROM t ORDER BY u DESC LIMIT 25",
]


@pytest.fixture(scope="module")
def sessions_cpu_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import clickhouse_tpu_torch as ch
    from clickhouse_tpu_torch.interop import table_from_numpy
    rng = np.random.default_rng(99)
    n_hits, n = 300_000, 200_000
    u = rng.integers(0, 1 << 62, n).astype(np.uint64)
    u[rng.random(n) < 0.3] += np.uint64(1 << 63)
    nn = rng.integers(-50, 50, n).astype(object)
    nn[rng.random(n) < 0.2] = None
    f = rng.normal(0, 100, n)
    f[rng.random(n) < 0.01] = np.nan
    tables = {
        "hits": ({"x": (np.arange(n_hits, dtype=np.int64) * 2654435761)
                  % 1_000_003}, {"x": "Int64"}),
        "t": ({"a": rng.integers(0, 10, n).astype(np.int32),
               "b": rng.integers(0, 4, n).astype(np.uint8), "u": u,
               "n": nn, "f": f,
               "k": np.asarray([f"k{v}" for v in rng.integers(0, 30, n)],
                               object)},
              {"a": "Int32", "b": "UInt8", "u": "UInt64",
               "n": "Nullable(Int64)", "f": "Float64", "k": "String"}),
    }
    out = []
    for device in ("cpu", "cuda"):
        s = ch.connect(device=device)
        for name, (cols, types) in tables.items():
            table_from_numpy(s, name, cols, types)
        out.append(s)
    return out


@pytest.mark.parametrize("sql", SQL_ON_CARD)
def test_sql_on_card_matches_cpu(sessions_cpu_cuda, sql):
    cpu, cuda = sessions_cpu_cuda
    want, got = cpu.execute(sql).rows(), cuda.execute(sql).rows()
    if "ORDER BY" not in sql:
        want, got = sorted(want, key=repr), sorted(got, key=repr)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float) and b == b:
                np.testing.assert_allclose(a, b, rtol=1e-12)
            elif isinstance(b, float):
                assert a != a
            else:
                assert a == b
