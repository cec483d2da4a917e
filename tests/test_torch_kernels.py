"""Hand-written CUDA kernels of clickhouse_tpu_torch against their plain
PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a GPU.  The file
imports no JAX, so on a machine with a card it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Integer results must be bit-exact.  Float sums: rtol=1e-12, because the
kernel adds per-block partials in another order than torch's sum; K6's
float sums within n_g * eps * sum(|x|) of each group of n_g rows, because
its atomics add a group's parts in an order that varies from run to run.
"""
import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import (CMPS, SORT_KEY_CHAINS, grouped_rows, make_term,
                        sort_key_columns, term_cases)
from clickhouse_tpu_torch.ops import _native
from clickhouse_tpu_torch.ops.agg_ops import (_masked_reduce_plain,
                                              masked_reduce)
from clickhouse_tpu_torch.ops.mxu_segsum import (_dense_group_reduce_plain,
                                                 dense_group_reduce)
from clickhouse_tpu_torch.ops.scan_ops import (_segment_bounds_plain,
                                               _segment_reduce_plain,
                                               segment_bounds, segment_reduce)
from clickhouse_tpu_torch.ops.sort_ops import (_radix_sort_pairs_plain,
                                               _topk_smallest32_plain,
                                               _topk_smallest_plain,
                                               radix_sort_pairs, sort_rows,
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


@pytest.mark.parametrize("case", range(13))
def test_masked_reduce_terms_match_plain(dev, case):
    """The term entry, exact against its plain version: every CMP and
    literal, a row bound that is not a multiple of 16, reductions of a
    second column, and a misaligned view of every column."""
    rng = np.random.default_rng(case)
    n = 10_007
    type_name, values, lits = term_cases(rng, n)[case]
    y = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, n)).to(dev)
    yf = torch.from_numpy(rng.normal(0, 1, n)).to(dev)
    for cmp in CMPS:
        for lit in lits:
            t = make_term(values, type_name, cmp, lit, dev)
            cap = t.storage.shape[0]
            yc = torch.zeros(cap, dtype=torch.int64, device=dev)
            yc[:n] = y
            for n_rows in (n, n - 5, 0):
                for op, data in (("sum", None), ("sum", yc), ("min", yc),
                                 ("any", yc)):
                    got = masked_reduce(op, data, None, n_rows=n_rows,
                                        terms=[t])
                    want = _masked_reduce_plain(op, data, None, False,
                                                n_rows, [t])
                    _same(got, want)
            # views starting 1..3 rows in: misaligned for every type
            for off in (1, 3):
                tv = dataclasses.replace(
                    t, storage=t.storage[off:],
                    validity=None if t.validity is None
                    else t.validity[off:])
                got = masked_reduce("sum", None, None, n_rows=n - 9,
                                    terms=[tv])
                _same(got, _masked_reduce_plain("sum", None, None, False,
                                                n - 9, [tv]))
                fv = torch.zeros(cap, dtype=torch.float64, device=dev)
                fv[:n] = yf
                got = masked_reduce("sum", fv[off:], None, terms=[tv])
                _same(got, _masked_reduce_plain("sum", fv[off:], None,
                                                False, None, [tv]))


def test_masked_reduce_two_terms_mask_and_nan_ops(dev):
    """Two terms ANDed with a bool mask, on float and int data, every op."""
    rng = np.random.default_rng(5)
    n = 100_003
    x = (np.arange(n) * 2654435761) % 1_000_003
    f = rng.normal(0, 1e3, n)
    f[rng.random(n) < 0.02] = np.nan
    t1 = make_term(x, "Int64", "greater", 5, dev)
    t2 = make_term(f, "Float64", "lessOrEquals", 300.5, dev)
    cap = t1.storage.shape[0]
    mask = torch.from_numpy(rng.random(cap) < 0.7).to(dev)
    fd = torch.zeros(cap, dtype=torch.float64, device=dev)
    fd[:n] = torch.from_numpy(f)
    for data in (None, fd, t1.storage, fd.to(torch.float32)):
        for op in OPS:
            if data is None and op != "sum":
                continue
            if op in ("bor", "band", "bxor") and data.is_floating_point():
                continue
            got = masked_reduce(op, data, mask, n_rows=n, terms=[t1, t2])
            _same(got, _masked_reduce_plain(op, data, mask, False, n,
                                            [t1, t2]))


def test_masked_reduce_never_copies_a_column(dev):
    """The wrapper reads columns where they lie: an aligned column, a
    misaligned view and a count over a mask allocate no copy."""
    n = 10_000_000
    x = torch.arange(n, dtype=torch.int32, device=dev)
    t = make_term(np.arange(1000), "Int64", "greater", 5, dev)
    term = dataclasses.replace(t, storage=x, validity=None)
    view = dataclasses.replace(t, storage=x[1:], validity=None)
    mask = x % 3 == 0
    masked_reduce("sum", None, None, terms=[term])
    torch.cuda.synchronize()
    for args in ((None, None, [term]), (None, None, [view]),
                 (None, mask, []), (x[1:], None, [view])):
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        masked_reduce("sum", args[0], args[1], terms=args[2])
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated() - before < 1 << 20


def test_launch_counters_count_kernel_launches(dev):
    _native.reset_launches()
    x = torch.arange(10, device=dev)
    masked_reduce("sum", x)
    dense_group_reduce(x.to(torch.int32), None, [None], [x], [None], 10)
    topk_smallest(x, None, 3)
    key, perm = radix_sort_pairs(x.to(torch.int32), 4)
    gid, _, _, _ = segment_bounds([key], torch.tensor(10, device=dev), 16)
    segment_reduce("sum", x, None, perm, gid, 16)
    assert _native.LAUNCHES == {"masked_reduce": 1, "dense_group_reduce": 1,
                                "topk_smallest": 1, "radix_sort_pairs": 1,
                                "segment_bounds": 1, "segment_reduce": 1}


# -- K4 radix_sort_pairs, K5 segment_bounds, K6 segment_reduce ----------------

def _sort_keys(case, rng, n):
    """(key tensor of u32 / u64 bits, significant bits) for K4."""
    if case == "u32_21_bits":                 # Q2b's packed key
        return torch.from_numpy(rng.integers(0, 1 << 21, n)
                                .astype(np.int32)), 21
    if case == "u32_full":
        return torch.from_numpy(rng.integers(0, 1 << 32, n, dtype=np.uint64)
                                .astype(np.uint32).view(np.int32)), 32
    if case == "u64_full":                    # values above 2^63 included
        return torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, n,
                                             dtype=np.int64)), 64
    if case == "u64_ties":
        return torch.from_numpy(rng.integers(0, 5, n).astype(np.int64)
                                << 60), 64
    if case == "all_equal":
        return torch.full((n,), 3, dtype=torch.int32), 2
    if case == "zero_bits":
        return torch.zeros(n, dtype=torch.int32), 0
    raise ValueError(case)


@pytest.mark.parametrize("case", ["u32_21_bits", "u32_full", "u64_full",
                                  "u64_ties", "all_equal", "zero_bits"])
@pytest.mark.parametrize("n", [1, 4095, 4097, 1_000_003])
def test_radix_sort_pairs_matches_plain(dev, case, n):
    rng = np.random.default_rng(n + len(case))
    key, bits = _sort_keys(case, rng, n)
    values = torch.from_numpy(rng.permutation(n).astype(np.int32))
    for v in (None, values):
        vd = None if v is None else v.to(dev)
        got = radix_sort_pairs(key.to(dev), bits, vd)
        want = _radix_sort_pairs_plain(key.to(dev), bits, vd)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("names", [["int32_bounded"], ["int64"], ["uint64"],
                                   ["float64"], ["float32"], ["uint8"]]
                         + SORT_KEY_CHAINS, ids="-".join)
@pytest.mark.parametrize("invalid", [False, True])
def test_sort_rows_chain_matches_plain(dev, names, invalid):
    """The whole pass plan on the card (packing, chained K4 calls) gives
    the permutation of the plain path, invalid rows last."""
    n = 100_003
    rng = np.random.default_rng(len(names))
    cols = sort_key_columns(rng, n)
    valid = torch.from_numpy(rng.random(n) < 0.8) if invalid else None
    keys = [cols[k] for k in names]
    want, wkeys = sort_rows(keys, valid)
    got, gkeys = sort_rows(
        [dataclasses.replace(k, data=k.data.to(dev)) for k in keys],
        None if valid is None else valid.to(dev))
    m = n if valid is None else int(valid.sum())
    assert torch.equal(got.cpu()[:m], want[:m])
    for g, w in zip(gkeys, wkeys):
        assert torch.equal(g.cpu()[:m], w[:m])


@pytest.mark.parametrize("case", ["one_group", "every_row", "over_cap",
                                  "invalid_rows", "two_keys", "no_valid",
                                  "six_keys"])
def test_segment_bounds_matches_plain(dev, case):
    rng = np.random.default_rng(len(case))
    n = 1_000_003
    cap_g = 1 << 20
    nv = n
    keys = [np.sort(rng.integers(0, 50_000, n)).astype(np.int32)]
    if case == "one_group":
        keys = [np.zeros(n, np.int32)]
    elif case == "every_row":
        keys = [np.arange(n, dtype=np.int64)]
    elif case == "over_cap":
        keys, cap_g = [np.arange(n, dtype=np.int32) // 3], 1024
    elif case == "invalid_rows":
        nv = n - 12_345
    elif case == "two_keys":
        keys.append(rng.integers(0, 2, n).astype(np.int64))
        keys = [keys[0], np.where(keys[0] % 7 == 0, keys[1], 0)]
    elif case == "no_valid":
        nv = 0
    elif case == "six_keys":                  # more arrays than K5 compares
        keys += [np.where(keys[0] % p == 0, rng.integers(0, 3, n), 0)
                 .astype(np.int64 if p % 2 else np.int32)
                 for p in (2, 3, 5, 7, 11)]
    kd = [torch.from_numpy(k).to(dev) for k in keys]
    nvt = torch.tensor(nv, dtype=torch.int64, device=dev)
    got = segment_bounds(kd, nvt, cap_g)
    want = _segment_bounds_plain(kd, nvt, cap_g)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _check_group_values(got, want, op, data, mask, perm, gid, cap_g):
    if got.is_floating_point() and op == "sum":
        absd = data.abs().to(torch.float64)
        scale = _segment_reduce_plain("sum", absd, mask, perm, gid, cap_g,
                                      False)
        cnt = _segment_reduce_plain("count", None, mask, perm, gid, cap_g,
                                    False)
        tol = cnt.to(torch.float64) * 2.3e-16 * scale
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        assert bool(((got - want).abs() <= tol)[~nan].all())
    elif got.is_floating_point():
        assert torch.equal(got.view(torch.int64) if got.dtype ==
                           torch.float64 else got.view(torch.int32),
                           want.view(torch.int64) if want.dtype ==
                           torch.float64 else want.view(torch.int32))
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype,op", [
    (d, op) for op in OPS + ["count"] for d in DTYPES
    if not (d.is_floating_point and op in ("bor", "band", "bxor"))], ids=str)
def test_segment_reduce_matches_plain(dev, dtype, op):
    rng = np.random.default_rng(7)
    n, groups, cap_g = 1_000_003, 70_000, 1 << 17
    x = _values(rng, dtype, n)
    if dtype.is_floating_point:
        x[::101] = float("nan")
    perm, gid = grouped_rows(n, groups, dev)
    for m in (None, torch.from_numpy(rng.random(n) < 0.3),
              torch.zeros(n, dtype=torch.bool)):
        md = None if m is None else m.to(dev)
        d = None if op == "count" else x.to(dev)
        got = segment_reduce(op, d, md, perm, gid, cap_g)
        want = _segment_reduce_plain(op, d, md, perm, gid, cap_g, False)
        _check_group_values(got, want, op, d, md, perm, gid, cap_g)


@pytest.mark.parametrize("op", ["sum", "min", "max", "any", "count"])
def test_segment_reduce_skewed_group_matches_plain(dev, op):
    """One group holds 40 % of the rows: it spans many tiles, combined by
    atomics; small groups around it stay whole in a tile."""
    rng = np.random.default_rng(11)
    n = 3_000_000
    perm, gid = grouped_rows(n, 200_000, dev, skew=0.4)
    x = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, n)).to(dev)
    d = None if op == "count" else x
    for m in (None, torch.from_numpy(rng.random(n) < 0.5).to(dev)):
        got = segment_reduce(op, d, m, perm, gid, 1 << 18)
        want = _segment_reduce_plain(op, d, m, perm, gid, 1 << 18, False)
        assert torch.equal(got, want)


def test_segment_reduce_unsigned_and_narrow_storage(dev):
    """UInt64 bits compare unsigned; a column's narrow storage reduces as
    its values."""
    rng = np.random.default_rng(12)
    n = 200_000
    perm, gid = grouped_rows(n, 5000, dev)
    u = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, n,
                                      dtype=np.int64)).to(dev)
    for op in ("min", "max", "sum", "any"):
        got = segment_reduce(op, u, None, perm, gid, 8192, unsigned=True)
        want = _segment_reduce_plain(op, u, None, perm, gid, 8192, True)
        assert torch.equal(got, want)
    narrow = torch.from_numpy(rng.integers(-1000, 1000, n)
                              .astype(np.int16)).to(dev)
    for op in ("min", "max", "sum"):
        a = segment_reduce(op, narrow, None, perm, gid, 8192)
        b = segment_reduce(op, narrow.to(torch.int64), None, perm, gid, 8192)
        assert torch.equal(a.to(torch.int64), b)


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
    "SELECT x AS k, count() AS c FROM hits GROUP BY k ORDER BY c DESC, k "
    "LIMIT 10",
    "SELECT intDiv(x, 4) AS k, count() AS c, sum(x) AS s, min(x) AS lo, "
    "max(x) AS hi, any(x) AS a FROM hits GROUP BY k ORDER BY s DESC LIMIT 10",
    "SELECT n, k, count(), min(f), max(f), any(a), avg(a) FROM t "
    "GROUP BY n, k",
    "SELECT u, count(), sum(a), minIf(a, b > 1) FROM t GROUP BY u",
    "SELECT f, count() FROM t GROUP BY f",
    "SELECT x FROM hits ORDER BY x DESC",
    "SELECT a, f FROM t ORDER BY a DESC, f",
    "SELECT x FROM hits ORDER BY x LIMIT 5000",
    # more groups than slots: K5 and K6 skip the groups past max_groups,
    # then the session retries with more slots
    "SELECT x % 5000 AS k, count(), min(x), any(x) FROM hits GROUP BY k "
    "SETTINGS max_groups = 1024",
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
