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

from chip_smoke import (CMPS, K4_ROWS, K5_CASES, K6_SORTED_LAYOUTS,
                        K13_CASES, k13_case, K14_CASES, k14_rows,
                        K15_CASES, k15_case, K16_MERGE_CASES,
                        K16_UPDATE_CASES, K16_CELLS_CASES, k16_cells_case,
                        k16_merge_case, k16_update, k16_update_case,
                        K6_TERM_DIVISORS, K7_CASES, K8_CASES,
                        K9_CASES, K10_CASES, K11_CASES, K12_DTYPES,
                        SORT_KEY_CHAINS, U64_EDGE, grouped_rows, k5_args,
                        k6_many_specs, k12_cases, sorted_gid,
                        k7_args, k7_outputs, k8_args, k8_results, k9_args,
                        k10_args, k11_case, k11_error, make_term,
                        sort_key_columns, term_cases)
from clickhouse_tpu_torch.ops import _native
from clickhouse_tpu_torch.ops.calendar_ops import (_calendar_part_plain,
                                                   calendar_part)
from clickhouse_tpu_torch.ops.agg_ops import (_masked_reduce_plain,
                                              masked_reduce)
from clickhouse_tpu_torch.ops.join_ops import (ProbeResult,
                                               _dense_gather_join_plain,
                                               _expand_matches_cuda,
                                               _expand_matches_plain,
                                               dense_gather_join,
                                               expand_matches,
                                               propagate_join)
from clickhouse_tpu_torch.ops.mxu_segsum import (_dense_group_reduce_plain,
                                                 dense_group_reduce)
from clickhouse_tpu_torch.ops import scan_ops
from clickhouse_tpu_torch.ops.scan_ops import (K5_TILE_ROWS, Term,
                                               _built,
                                               _segment_bounds_plain,
                                               _segment_reduce_plain,
                                               bounds_of_gid,
                                               segment_bounds, segment_reduce,
                                               fsumx_column,
                                               segment_reduce_many,
                                               segment_reduce_sorted)
from clickhouse_tpu_torch.ops.string_ops import (_prefix_match_plain,
                                                 prefix_match)
from clickhouse_tpu_torch.ops.vector_ops import (DISTANCE_OPS,
                                                 _vector_distance_plain,
                                                 vector_distance)
from clickhouse_tpu_torch.ops.sort_ops import (K4_TILE_ROWS,
                                               _radix_sort_pairs_plain,
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


@pytest.mark.parametrize("case", range(14))
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


def test_masked_reduce_uint64_term_at_the_f1_edge(dev):
    """A UInt64 column at and above 2^63 against float constants one ulp
    from its values' float64: the term converts each value as unsigned,
    rounded once, as the plain version (numpy's astype) does."""
    n = 4003
    values = np.resize(np.array(U64_EDGE, dtype=np.uint64), n)
    for cmp in CMPS:
        for lit in (9544035305396816000.0, 9544035305396814000.0,
                    9223372036854777856.0, float(1 << 63), 2.0 ** 64, 1.0):
            t = make_term(values, "UInt64", cmp, lit, dev)
            for n_rows in (n, n - 3):
                got = masked_reduce("sum", None, None, n_rows=n_rows,
                                    terms=[t])
                _same(got, _masked_reduce_plain("sum", None, None, False,
                                                n_rows, [t]))
    t = make_term(values, "UInt64", "greaterOrEquals",
                  9544035305396816000.0, dev)
    # two of each four rows: 9544035305396814861 and 2^64 - 1
    assert int(masked_reduce("sum", None, None, n_rows=n,
                             terms=[t])) == n // 4 * 2 + (n % 4 > 0)


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
    gid, _, starts, ends = segment_bounds([key], torch.tensor(10, device=dev),
                                          16)
    segment_reduce("sum", x, None, perm, gid, 16)
    segment_reduce_sorted([("sum", x, None, False)], starts, ends, 10)
    word = x.to(torch.int32)
    dense_gather_join(x, None, x, None, [("word", word, -1)], 0, 9)
    propagate_join([x], None, [x], None, [word])
    ones = torch.ones(10, dtype=torch.bool, device=dev)
    expand_matches(ProbeResult(ones, word, torch.ones_like(word)), ones, 1024)
    prefix_match(torch.full((10,), 97, dtype=torch.uint8, device=dev),
                 word[:6], b"a")
    vector_distance(torch.ones((10, 8), device=dev),
                    torch.full((10,), 8, dtype=torch.int32, device=dev),
                    torch.ones(8, device=dev), "cosine")
    calendar_part(x, "year", False, np.uint16)
    from clickhouse_tpu_torch.ops.chunk_ops import unpack_pairs
    unpack_pairs(torch.zeros(10, dtype=torch.uint8, device=dev), 20, 0, 5,
                 4, torch.int32)
    from clickhouse_tpu_torch.ops.filter_ops import compact_rows
    compact_rows(ones)
    from clickhouse_tpu_torch.ops import hash_ops, sketch_ops
    arg = hash_ops.HashArg(x)
    hash_ops.row_hash([arg])
    st = sketch_ops.hll_update([arg], 64, 4)
    sketch_ops.hll_update_rows([arg], 64, 4, [sketch_ops.SlotKey(x, 0, 10)],
                               torch.arange(10, dtype=torch.int32,
                                            device=dev))
    sketch_ops.hll_merge(st, 2)
    sketch_ops.hll_finalize(st)
    from clickhouse_tpu_torch.ops import search
    scan_ops.segmented_scan("sum", x, None)
    search.segmented_search(x, x, "left")
    assert _native.LAUNCHES == {"masked_reduce": 1, "dense_group_reduce": 1,
                                "topk_smallest": 1, "radix_sort_pairs": 1,
                                "segment_bounds": 1, "segment_reduce": 1,
                                "segment_reduce_sorted": 1, "dense_join": 1, "hash_join": 1,
                                "expand_matches": 1, "prefix_match": 1,
                                "vector_distance": 1, "calendar_part": 1,
                                "unpack_pairs": 1, "compact_rows": 1,
                                "row_hash": 1, "hll_update": 1,
                                "hll_update_rows": 1, "hll_cells": 1,
                                "hll_merge": 1, "hll_finalize": 1,
                                "segmented_scan": 1, "segmented_search": 1}


# -- K11 vector_distance -------------------------------------------------------

@pytest.mark.parametrize("op", sorted(DISTANCE_OPS))
@pytest.mark.parametrize("case", K11_CASES)
def test_vector_distance_matches_plain(dev, case, op):
    """K11 against its plain version on chip_smoke's K11_CASES (widths 8,
    24, 128 and 136, ragged lengths, a zero row and a zero query, a row
    count off the block, rows past n), within chip_smoke.k11_error's
    tolerance; rows past n hold the zero row's value."""
    a, lens, q, n = k11_case(case, np.random.default_rng(31))
    A, L, Q = (torch.from_numpy(x).to(dev) for x in (a, lens, q))
    got = vector_distance(A, L, Q, op, n)
    want = _vector_distance_plain(A, L, Q, op, n)
    torch.cuda.synchronize()
    k11_error(got, want, A, L, Q, op, n)


def test_vector_distance_refuses_what_it_does_not_take(dev):
    """A misaligned matrix, a width past K11's shared memory and a width
    off the 8-element grid raise before a launch."""
    lens = torch.full((16,), 8, dtype=torch.int32, device=dev)
    buf = torch.zeros(16 * 8 + 1, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        vector_distance(buf[1:].view(16, 8), lens, torch.ones(8, device=dev),
                        "dot")
    wide = _native.K11_MAX_WIDTH + 8
    with pytest.raises(ValueError, match="wider"):
        vector_distance(torch.zeros((16, wide), device=dev), lens,
                        torch.ones(wide, device=dev), "dot")
    with pytest.raises(ValueError, match="multiple of 8"):
        vector_distance(torch.zeros((16, 12), device=dev), lens,
                        torch.ones(12, device=dev), "dot")


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
    if case == "all_equal":                   # one digit takes every row
        return torch.full((n,), 3, dtype=torch.int32), 2
    if case == "top_digit_constant":          # bits 14-20 constant
        return torch.from_numpy((rng.integers(0, 1 << 14, n) | (77 << 14))
                                .astype(np.int32)), 21
    if case == "zero_bits":
        return torch.zeros(n, dtype=torch.int32), 0
    raise ValueError(case)


@pytest.mark.parametrize("case", ["u32_21_bits", "u32_full", "u64_full",
                                  "u64_ties", "all_equal",
                                  "top_digit_constant", "zero_bits"])
@pytest.mark.parametrize("n", (4097,) + K4_ROWS)
def test_radix_sort_pairs_matches_plain(dev, case, n):
    """Row counts of one tile and one more row, and more tiles than the
    card holds at once (the look-back waits on running tiles)."""
    rng = np.random.default_rng(n + len(case))
    key, bits = _sort_keys(case, rng, n)
    values = torch.from_numpy(rng.permutation(n).astype(np.int32))
    for v in (None, values):
        vd = None if v is None else v.to(dev)
        got = radix_sort_pairs(key.to(dev), bits, vd)
        want = _radix_sort_pairs_plain(key.to(dev), bits, vd)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])


def test_radix_sort_tiles_match_the_library(dev):
    lib = _native.library()
    for key_bytes, rows in K4_TILE_ROWS.items():
        assert lib.chtt_radix_tile_rows(key_bytes) == rows


def test_radix_sort_u64_chain_matches_plain(dev):
    """Two chained u64 calls (the low key, then the high one in the order
    so far, with the first call's permutation as values)."""
    rng = np.random.default_rng(21)
    n = 3_000_017
    lo, hi = (torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, n,
                                            dtype=np.int64)).to(dev)
              for _ in range(2))
    p_got = radix_sort_pairs(lo, 64)[1]
    p_want = _radix_sort_pairs_plain(lo, 64, None)[1]
    assert torch.equal(p_got, p_want)
    got = radix_sort_pairs(hi[p_got.long()], 64, p_got)
    want = _radix_sort_pairs_plain(hi[p_want.long()], 64, p_want)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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


@pytest.mark.parametrize("case", K5_CASES)
def test_segment_bounds_look_back_cases_match_plain(dev, case):
    """K5's one pass against its plain version where the look-back and the
    tiles' edges matter (chip_smoke.k5_case): one row, part of a tile, a
    tile multiple and one row, a group over 100 tiles, a boundary at every
    tile's first row, u64 keys, two to five key arrays, no valid row, and
    key arrays that do not start on a 16-byte boundary."""
    kd, nvt, cap_g = k5_args(case, np.random.default_rng(len(case)), dev)
    got = segment_bounds(kd, nvt, cap_g)
    want = _segment_bounds_plain(kd, nvt, cap_g)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_segment_bounds_is_one_launch(dev):
    """One K5 call counts one launch; the wrapper's tile rows are the
    kernel's."""
    assert _native.library().chtt_segment_tile_rows() == K5_TILE_ROWS
    kd, nvt, cap_g = k5_args("invalid_rows", np.random.default_rng(3), dev)
    _native.reset_launches()
    segment_bounds(kd, nvt, cap_g)
    torch.cuda.synchronize()
    assert _native.LAUNCHES["segment_bounds"] == 1


def _check_group_values(got, want, op, data, mask, perm, gid, cap_g,
                        unsigned=False):
    if op == "fsumx":
        op, data = "sum", fsumx_column(data, unsigned)
    data = _built(data)
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


@pytest.mark.parametrize("case", ["q2m", "two_columns_two_masks", "split",
                                  "f64_terms", "f64_term_types",
                                  "q2s2_terms", "term_ops"])
@pytest.mark.parametrize("skew", [None, 0.4], ids=["uniform", "skew40"])
def test_segment_reduce_many_matches_plain(dev, case, skew):
    """Several specs in one segment_reduce_many call (one launch, or more
    for more specs, columns or masks than one takes) against the plain
    version spec by spec, with and without the grouping's row counts, and
    with one group holding 40 % of the rows."""
    rng = np.random.default_rng(13)
    n, cap_g = 1_000_003, 1 << 17
    perm, gid = grouped_rows(n, 70_000, dev, skew=skew)
    specs = k6_many_specs(rng, n, dev)[case]
    rows = _segment_reduce_plain("count", None, None, perm, gid, cap_g,
                                 False)
    for group_rows in (None, rows):
        got = segment_reduce_many(specs, perm, gid, cap_g,
                                  group_rows=group_rows)
        for (op, d, m, u), g in zip(specs, got):
            want = _segment_reduce_plain(op, d, m, perm, gid, cap_g, u)
            _check_group_values(g, want, op, d, m, perm, gid, cap_g, u)


def test_segment_reduce_many_launches_once(dev):
    """Q2m's four ops over one column, no mask and the grouping's row
    counts: one K6 launch."""
    rng = np.random.default_rng(14)
    n = 200_003
    perm, gid = grouped_rows(n, 5000, dev)
    rows = _segment_reduce_plain("count", None, None, perm, gid, 8192, False)
    _native.reset_launches()
    segment_reduce_many(k6_many_specs(rng, n, dev)["q2m"], perm, gid, 8192,
                        group_rows=rows)
    assert _native.LAUNCHES["segment_reduce"] == 1


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


@pytest.mark.parametrize("dtype,op", [
    (d, op) for op in OPS + ["count"] for d in DTYPES
    if not (d.is_floating_point and op in ("bor", "band", "bxor"))], ids=str)
@pytest.mark.parametrize("skew", [None, 0.4], ids=["uniform", "skew40"])
def test_segment_reduce_sorted_matches_plain(dev, dtype, op, skew):
    """K6's sorted-order entry (data and masks in sorted order, no
    permutation) against its plain version: every op and storage type,
    with no mask, a partial mask, a mask of no row and a mask of no row in
    every other group (fully masked groups), empty slots past the last
    group, invalid rows past the last valid one, and one group holding
    40 % of the rows."""
    rng = np.random.default_rng(17)
    n, cap_g = 1_000_003, 1 << 17
    x = _values(rng, dtype, n)
    if dtype.is_floating_point:
        x[::101] = float("nan")
    _, gid = grouped_rows(n, 70_000, dev, skew=skew)
    gid[-3000:] = cap_g
    starts, ends = bounds_of_gid(gid, cap_g)
    d = None if op == "count" else x.to(dev)
    for m in (None, torch.from_numpy(rng.random(n) < 0.3).to(dev),
              torch.zeros(n, dtype=torch.bool, device=dev),
              (gid % 2 == 1)):
        got = segment_reduce_sorted([(op, d, m, False)], starts, ends,
                                    n)[0]
        want = _segment_reduce_plain(op, d, m, None, gid, cap_g, False)
        _check_group_values(got, want, op, d, m, None, gid, cap_g)


def test_segment_reduce_sorted_launches_once_and_reads_no_perm(dev):
    """Several specs over sorted data: one launch of the sorted-order
    entry, none of the permuted one."""
    rng = np.random.default_rng(18)
    n = 200_003
    _, gid = grouped_rows(n, 5000, dev)
    starts, ends = bounds_of_gid(gid, 8192)
    specs = k6_many_specs(rng, n, dev)["q2m"]
    _native.reset_launches()
    got = segment_reduce_sorted(specs, starts, ends, n)
    assert _native.LAUNCHES["segment_reduce_sorted"] == 1
    assert _native.LAUNCHES["segment_reduce"] == 0
    for (op, d, m, u), g in zip(specs, got):
        assert torch.equal(g, _segment_reduce_plain(op, d, m, None, gid,
                                                    8192, u))


@pytest.mark.parametrize("case", ["f64_terms", "f64_term_types",
                                  "q2s2_terms", "term_ops"])
def test_segment_reduce_sorted_f64_terms_match_plain(dev, case):
    """The statistics' terms (powers and products formed in registers)
    and the intDiv/modulo Terms through the sorted-order entry."""
    rng = np.random.default_rng(20)
    n, cap_g = 1_000_003, 1 << 17
    _, gid = grouped_rows(n, 70_000, dev, skew=0.4)
    starts, ends = bounds_of_gid(gid, cap_g)
    specs = k6_many_specs(rng, n, dev)[case]
    got = segment_reduce_sorted(specs, starts, ends, n)
    for (op, d, m, u), g in zip(specs, got):
        want = _segment_reduce_plain(op, d, m, None, gid, cap_g, u)
        _check_group_values(g, want, op, d, m, None, gid, cap_g, u)


@pytest.mark.parametrize("sorted_entry", [False, True],
                         ids=["permuted", "sorted"])
@pytest.mark.parametrize("storage", [torch.int8, torch.int16, torch.int32],
                         ids=str)
def test_segment_reduce_terms_match_plain(dev, storage, sorted_entry):
    """Every op over intDiv and modulo Terms of a narrow signed storage
    (its MIN and MAX among the values) by each of K6_TERM_DIVISORS, formed
    in registers from the one gathered column, against the plain version
    over the built column: through both entries; the same Term in two
    forms of one launch."""
    rng = np.random.default_rng(21)
    n, cap_g = 400_003, 1 << 16
    info = torch.iinfo(storage)
    src = torch.from_numpy(rng.integers(info.min, info.max, n,
                                        endpoint=True)).to(storage)
    src[:4] = torch.tensor([info.min, info.max, -1, 0], dtype=storage)
    src = src.to(dev)
    perm, gid = grouped_rows(n, 30_000, dev, skew=0.4)
    m = torch.from_numpy(rng.random(n) < 0.5).to(dev)
    cs = K6_TERM_DIVISORS[(torch.int8, torch.int16,
                           torch.int32).index(storage)]
    for c in cs:
        for kind in ("div", "mod"):
            t = Term(src, kind, c, torch.int64)
            specs = [("sum", t, None, False), ("min", t, m, False),
                     ("max", t, None, False), ("any", t, m, False),
                     ("bxor", t, None, False), ("bor", t, m, False),
                     ("fsumx", (t, None, 2), None, (False, False)),
                     ("fsumx", (src, t, 1), m, (False, False))]
            if sorted_entry:
                starts, ends = bounds_of_gid(gid, cap_g)
                got = segment_reduce_sorted(specs, starts, ends, n)
                p = None
            else:
                got = segment_reduce_many(specs, perm, gid, cap_g)
                p = perm
            for (op, d, mm, u), g in zip(specs, got):
                built = (tuple(_built(x) if x is not None and not
                               isinstance(x, int) else x for x in d)
                         if op == "fsumx" else _built(d))
                want = _segment_reduce_plain(op, built, mm, p, gid, cap_g,
                                             u)
                _check_group_values(g, want, op, d, mm, p, gid, cap_g, u)


@pytest.mark.parametrize("groups", ["two_rows", "one_row"])
def test_segment_reduce_many_groups_a_warp(dev, groups):
    """A warp's 256 rows holding a hundred groups and more (each run its
    own atomic into device memory, the row-slot path of the segmented
    reduction): two rows a group and a group a row, every op, through
    both entries (the sorted one with a group boundary in every step)."""
    rng = np.random.default_rng(22)
    n = 600_001
    if groups == "two_rows":
        perm, gid = grouped_rows(n, n // 2, dev, seed=22)
    else:
        perm = torch.randperm(n, device=dev).to(torch.int32)
        gid = torch.arange(n, dtype=torch.int32, device=dev)
    cap_g = n
    x = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, n)).to(dev)
    f = torch.from_numpy(rng.normal(0, 1e6, n)).to(dev)
    m = torch.from_numpy(rng.random(n) < 0.7).to(dev)
    specs = [("sum", x, None, False), ("min", x, m, False),
             ("max", f, None, False), ("any", x, m, False),
             ("band", x, None, False), ("sum", f, m, False),
             ("count", None, m, False)]
    starts, ends = bounds_of_gid(gid, cap_g)
    for p, got in ((perm, segment_reduce_many(specs, perm, gid, cap_g)),
                   (None, segment_reduce_sorted(specs, starts, ends, n))):
        for (op, d, mm, u), g in zip(specs, got):
            want = _segment_reduce_plain(op, d, mm, p, gid, cap_g, u)
            _check_group_values(g, want, op, d, mm, p, gid, cap_g, u)


@pytest.mark.parametrize("layout", range(len(K6_SORTED_LAYOUTS)))
def test_segment_reduce_sorted_bounds_layouts(dev, layout):
    """The sorted entry from K5's bounds over chip_smoke.K6_SORTED_LAYOUTS:
    one-row groups, more groups than slots, a group of 40 % of 3M rows,
    groups of 2,049 rows, empty slots past the last group; against the
    plain version over the group ids."""
    rows, groups, cg, skew, invalid = K6_SORTED_LAYOUTS[layout]
    rng = np.random.default_rng(23)
    if groups == rows:
        gid = torch.arange(rows, dtype=torch.int32, device=dev)
    elif skew is None and rows == groups * 2049:
        gid = torch.arange(rows, dtype=torch.int32, device=dev) // 2049
    else:
        gid = sorted_gid(rows, groups, dev, skew=skew, seed=14,
                         invalid=invalid)
    gid = torch.where(gid >= cg, cg, gid).to(torch.int32)
    d = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, rows)).to(dev)
    m = torch.from_numpy(rng.random(rows) < 0.5).to(dev)
    specs = [("sum", d, None, False), ("min", d, m, False),
             ("any", d, m, False), ("count", None, m, False)]
    starts, ends = bounds_of_gid(gid, cg)
    got = segment_reduce_sorted(specs, starts, ends, rows)
    for (op, dd, mm, u), g in zip(specs, got):
        want = _segment_reduce_plain(op, dd, mm, None, gid, cg, u)
        _check_group_values(g, want, op, dd, mm, None, gid, cg, u)


@pytest.mark.parametrize("groups", [1, 1000])
def test_uniq_exact_and_quantile_on_card_match_numpy(groups):
    """count(DISTINCT x), median and quantiles over 1M rows through
    connect(device="cuda") (K4 with x as a secondary word, K5, K6's
    sorted-order entry) against numpy."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import clickhouse_tpu_torch as ch
    from clickhouse_tpu_torch.interop import table_from_numpy
    rng = np.random.default_rng(19)
    n = 1_000_000
    x = rng.integers(0, 300_000, n)
    k = rng.integers(0, groups, n)
    s = ch.connect(device="cuda")
    table_from_numpy(s, "u", {"k": k, "x": x}, {"k": "Int64", "x": "Int64"})
    _native.reset_launches()
    got = s.execute("SELECT k, count(DISTINCT x), median(x), "
                    "quantiles(0.1, 0.9)(x) FROM u GROUP BY k "
                    "ORDER BY k").rows()
    assert _native.LAUNCHES["segment_reduce_sorted"] >= 1
    want = []
    for g in range(groups):
        v = np.sort(x[k == g])
        pick = [int(v[int(np.floor(q * (len(v) - 1)))])
                for q in (0.5, 0.1, 0.9)]
        want.append((g, len(np.unique(v)), pick[0], pick[1:]))
    assert got == want
    assert s.execute("SELECT count(DISTINCT x) FROM u").rows() \
        == [(len(np.unique(x)),)]


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
    # DISTINCT, LIMIT BY and WITH TOTALS (K4, K5; K1)
    "SELECT DISTINCT a, n FROM t",
    "SELECT DISTINCT k FROM t WHERE b > 1",
    "SELECT k, a FROM t LIMIT 2 BY k",
    "SELECT count() FROM (SELECT x FROM hits LIMIT 2 BY intDiv(x, 4))",
    "SELECT k, count(), sum(a) FROM t GROUP BY k WITH TOTALS ORDER BY k",
    # the dictionary strings (K10 for the prefixes and suffixes)
    "SELECT count() FROM t WHERE startsWith(k, 'k1')",
    "SELECT k LIKE '%3', endsWith(k, '2'), k NOT LIKE 'k2%', length(k), "
    "upper(k), position(k, '1') FROM t",
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


def test_with_totals_on_card_matches_cpu(sessions_cpu_cuda):
    cpu, cuda = sessions_cpu_cuda
    sql = ("SELECT k, count() AS c, sum(a), min(f) FROM t GROUP BY k "
           "WITH TOTALS HAVING c > 6000 ORDER BY k")
    want, got = cpu.execute(sql), cuda.execute(sql)
    assert got.rows() == want.rows()
    assert list(got.totals) == list(want.totals)
    assert list(got.totals["k"]) == list(want.totals["k"]) == [""]
    for name in list(want.totals)[1:]:
        np.testing.assert_allclose(np.asarray(got.totals[name], float),
                                   np.asarray(want.totals[name], float),
                                   rtol=1e-12)


def test_startswith_launches_k10_once(sessions_cpu_cuda):
    """Q7b's form on the card: one K10 launch over the dictionary and one
    K1 count of the rows' mask."""
    cuda = sessions_cpu_cuda[1]
    cuda.execute("SELECT count() FROM t WHERE startsWith(k, 'k2')")
    _native.reset_launches()
    got = cuda.execute("SELECT count() FROM t WHERE startsWith(k, 'k2')")
    assert _native.LAUNCHES["prefix_match"] == 1
    assert _native.LAUNCHES["masked_reduce"] == 1
    assert sum(_native.LAUNCHES.values()) == 2
    assert got.rows() == sessions_cpu_cuda[0].execute(
        "SELECT count() FROM t WHERE startsWith(k, 'k2')").rows()


@pytest.mark.parametrize("case", K10_CASES)
def test_prefix_match_cases(dev, case):
    """K10 on the cases of chip_smoke.k10_args, prefix and suffix, each
    with and without negate, three runs each: 0, 1 and 3 values, a value
    count off the block, values of 0-3 bytes, of 64-66 and 4,000 bytes,
    chars at an odd address, needles past 48 bytes and past the kernel's
    shared-memory stage, int64 offsets, chars past 2^31 bytes."""
    chars, offsets, needles = k10_args(case, np.random.default_rng(
        len(case)), dev)
    for nd in needles:
        for suffix in (False, True):
            for negate in (False, True):
                want = _prefix_match_plain(chars, offsets, nd, suffix, negate)
                for _ in range(3):
                    _exact(prefix_match(chars, offsets, nd, suffix, negate),
                           want)


def _exact(got: torch.Tensor, want: torch.Tensor):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", K7_CASES)
def test_dense_join_cases(dev, case):
    """K7 on the cases of chip_smoke.k7_case: unique keys, holes, probe
    keys outside the range, invalid rows, a Nullable payload, sentinels
    below and above, key words, presence, narrow and UInt64 keys, views
    1-3 rows in, a table of each width with the sentinel at its edges,
    2-8 words packed in a slot, 1, 3 and 4k + 1 probe rows, a toInt8
    payload, and stated ranges that do not hold (out_of_range set)."""
    bk, bv, pk, pv, words, lo, hi = k7_args(case, np.random.default_rng(
        len(case)), dev)
    got = k7_outputs(dense_gather_join(bk, bv, pk, pv, words, lo, hi))
    want = k7_outputs(_dense_gather_join_plain(bk, bv, pk, pv, words, lo,
                                               hi - lo + 1))
    assert len(got) == len(want)
    assert (len(want) == 1) == (case in ("wrapped_payload",
                                         "build_key_outside"))
    for a, b in zip(got, want):
        _exact(a, b)


@pytest.mark.parametrize("case", K8_CASES)
def test_hash_join_cases(dev, case):
    """K8 on the cases of chip_smoke.k8_case, three runs each: the smallest
    build row id must win where keys repeat; forced-equal hashes, a run
    past the last bucket, payload chunks and Q4x's group-index table."""
    args, kw = k8_args(case, np.random.default_rng(len(case)), dev)
    for _ in range(3):
        got, want = k8_results(case, args, kw)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _exact(a, b)


@pytest.mark.parametrize("case", K9_CASES)
def test_expand_matches_cases(dev, case):
    """K9 on the cases of chip_smoke.k9_case, three runs each: no match,
    INNER, LEFT, ANY, one probe row holding 90 % of the output, a count
    beyond the capacity, no probe row, many look-back tiles, a tile's
    output at the spill threshold less one, at it and above it, heavy rows
    in adjacent tiles, an empty tile, the capacity mid-tile and mid-heavy
    row, a row count mid-tile (with and without a mask) and at 0, a row
    count off the 16-row grid, and views 1-3 rows in."""
    args = k9_args(case, np.random.default_rng(len(case)), dev)
    want = _expand_matches_plain(*args)
    for _ in range(3):
        got = expand_matches(*args)
        for a, b in zip(got, want):
            _exact(a, b)
    if case == "beyond_capacity":
        assert int(got[3]) > args[2]


def test_expand_matches_tile_constants(dev):
    """The Python side's tile rows and spill slots are the kernel's."""
    from chip_smoke import K9_TILE
    from clickhouse_tpu_torch.ops import join_ops
    lib = _native.library()
    assert lib.chtt_expand_tile_rows() == join_ops._EXPAND_TILE == K9_TILE
    assert lib.chtt_expand_spill_slots() == join_ops._EXPAND_SLOTS
    assert join_ops.EXPAND_HEAVY_SLOTS >= join_ops._EXPAND_SLOTS


@pytest.mark.parametrize("heavy", [4096, 1 << 30])
@pytest.mark.parametrize("case", ["heavy_adjacent", "cap_mid_heavy",
                                  "count_mid_tile", "view_3",
                                  "one_row_90_percent"])
def test_expand_matches_at_other_spill_thresholds(dev, case, heavy):
    """Every tile with output spilled to the second grid (4,096), or none
    (2^30): the same slots as the plain version."""
    args = k9_args(case, np.random.default_rng(len(case)), dev)
    n_rows = args[5] if args[5] is not None else args[0].matched.shape[0]
    got = _expand_matches_cuda(*args[:5], n_rows, heavy=heavy)
    for a, b in zip(got, _expand_matches_plain(*args)):
        _exact(a, b)


def test_intdiv_by_a_constant_stays_in_the_narrow_storage(dev):
    """intDiv and modulo of an Int64 column stored as int32 by a constant
    allocate at most 12 bytes a row (the int32 result and its int64
    widening) and leave the widened column unmade."""
    from clickhouse_tpu_torch.core import dtypes as dt
    from clickhouse_tpu_torch.exprs import functions
    from clickhouse_tpu_torch.exprs.expr import ColVal, StoredColVal
    n = 10_000_000
    s = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=dev)
    for fn, c in (("intDiv", 4), ("modulo", 1024)):
        a = StoredColVal(dt.Int64, s)
        b = ColVal(dt.Int64, torch.tensor(c, dtype=torch.int64, device=dev))
        f = functions.get(fn)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = f.execute([a, b], f.resolve([dt.Int64, dt.Int64]))
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated() - before <= 12 * n + (1 << 20)
        assert a._wide is None
        want = s.to(torch.int64)
        want = torch.div(want, c, rounding_mode="trunc") if fn == "intDiv" \
            else torch.fmod(want, c)
        _exact(out.data, want)


def test_vector_top_k_on_card_matches_cpu():
    """ORDER BY cosineDistance / L2Distance ... LIMIT k over 100,000
    vectors of 32 Float32 (with and without a WHERE) gives the CPU's ids
    on the card, each query through K11 once over every row and K3 once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import clickhouse_tpu_torch as ch
    from clickhouse_tpu_torch.interop import table_from_numpy
    rng = np.random.default_rng(8)
    v = rng.normal(size=(100_000, 32)).astype(np.float32)
    q = ",".join(f"{x:.5f}" for x in rng.normal(size=32))
    sessions = []
    for device in ("cpu", "cuda"):
        s = ch.connect(device=device)
        table_from_numpy(s, "vecs", {"id": np.arange(100_000), "v": v},
                         {"id": "Int64", "v": "Array(Float32)"})
        sessions.append(s)
    for sql in [f"SELECT id FROM vecs ORDER BY cosineDistance(v, CAST([{q}] "
                f"AS Array(Float32))) LIMIT 10",
                f"SELECT id FROM vecs ORDER BY L2Distance(v, [{q}]) LIMIT 10",
                f"SELECT id FROM vecs WHERE id < 50000 ORDER BY "
                f"cosineDistance(v, CAST([{q}] AS Array(Float32))) LIMIT 3"]:
        want = sessions[0].execute(sql).rows()
        _native.reset_launches()
        got = sessions[1].execute(sql).rows()
        assert got == want, sql
        assert _native.LAUNCHES["vector_distance"] == 1
        assert _native.LAUNCH_ROWS["vector_distance"][0] >= 100_000
        assert _native.LAUNCHES["topk_smallest"] == 1


@pytest.mark.parametrize("dtype", K12_DTYPES, ids=str)
def test_calendar_part_cases(dev, dtype):
    """K12 on chip_smoke.k12_cases for one storage type: every op use of
    K12_SPECS, days and seconds, the edge days, 1 row, part of a group of
    8 rows, 4,099 and 1,000,003 rows, and views 1-3 rows in: exact."""
    calls = 0
    for x, op, seconds, out_np, c0, c1 in k12_cases(dev, (dtype,)):
        _exact(calendar_part(x, op, seconds, out_np, c0, c1),
               _calendar_part_plain(x, op, seconds, out_np, c0, c1))
        calls += 1
    assert calls


def test_calendar_functions_launch_k12_once(sessions_cpu_cuda):
    """Each calendar function of a query is one K12 launch over the rows
    on the card, and the answers are the CPU's."""
    cpu, cuda = sessions_cpu_cuda
    for s in (cpu, cuda):
        s.execute("CREATE TABLE ct (t DateTime, d Date)")
        s.insert_pydict("ct", {"t": 1372636800 + np.arange(70_000) * 37,
                               "d": np.arange(70_000, dtype=np.int32)
                               - 30_000})
    for sql, n in (("SELECT toHour(t), toYear(d), toStartOfMonth(t) "
                    "FROM ct", 3),
                   ("SELECT count() FROM ct WHERE t + INTERVAL 1 MONTH > "
                    "toDateTime('2013-08-01 00:00:00')", 1),
                   ("SELECT dateDiff('month', d, t), toDate(t) FROM ct", 3)):
        _native.reset_launches()
        got = cuda.execute(sql).rows()
        assert _native.LAUNCHES["calendar_part"] == n, sql
        assert min(_native.LAUNCH_ROWS["calendar_part"]) >= 70_000
        assert got == cpu.execute(sql).rows(), sql


@pytest.mark.parametrize("case", K13_CASES,
                         ids=[f"w{c[0]}-lo{c[1]}-{c[4]}" for c in K13_CASES])
def test_unpack_pairs_matches_plain(dev, case):
    """K13 against its plain version and the values packed: offsets below
    zero, odd row counts, a part's short last chunk, every output type."""
    from clickhouse_tpu_torch.ops.chunk_ops import (_unpack_pairs_plain,
                                                    unpack_pairs)
    w4, lo, half, rows, out_dtype = case
    data, want, bpp = k13_case(*case)
    d = torch.from_numpy(data).to(dev)
    before = _native.LAUNCHES["unpack_pairs"]
    got = unpack_pairs(d, w4, lo, bpp, 2 * half, out_dtype)
    assert _native.LAUNCHES["unpack_pairs"] == before + 1
    assert torch.equal(got, _unpack_pairs_plain(d, w4, lo, bpp, 2 * half,
                                                out_dtype))
    assert torch.equal(got.cpu(), torch.from_numpy(want).to(out_dtype))


@pytest.mark.parametrize("case", K14_CASES, ids=[c[0] for c in K14_CASES])
def test_compact_rows_matches_plain(dev, case):
    """K14 against its plain version: the count and the first `count`
    indices (the slots past it are unspecified), one launch a call, over
    bool masks, row bounds, K1 terms with and without a mask and views
    1 and 3 rows in."""
    from clickhouse_tpu_torch.ops.filter_ops import (_compact_rows_plain,
                                                     compact_rows)
    rows = k14_rows(case, dev)
    before = _native.LAUNCHES["compact_rows"]
    idx, count = compact_rows(rows)
    assert _native.LAUNCHES["compact_rows"] == before + 1
    pidx, pcount = _compact_rows_plain(rows)
    c = int(count)
    assert c == int(pcount) == int(rows.tensor().sum())
    assert idx.dtype == torch.int32 and idx.shape == (rows.capacity,)
    assert torch.equal(idx[:c], pidx[:c])


# -- K15 row_hash and K16 hll --------------------------------------------------

@pytest.mark.parametrize("name", K15_CASES)
def test_row_hash_matches_plain(dev, name):
    """K15 against its plain version, bit for bit: every storage type,
    UInt64 above 2^63, floats with NaN/-0.0/inf, a Float64 stored as
    float32, codes, terms, a constant, 1-6 columns (past four a second
    launch from the carried hash), views, one row."""
    from clickhouse_tpu_torch.ops import hash_ops
    args, n = k15_case(name, dev)
    before = _native.LAUNCHES["row_hash"]
    got = hash_ops.row_hash(args, n)
    assert _native.LAUNCHES["row_hash"] == before + (2 if len(args) > 4
                                                    else 1)
    want = hash_ops._fold(hash_ops.plain_values(args, n), args[0].kind)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", K16_UPDATE_CASES,
                         ids=[c[0] for c in K16_UPDATE_CASES])
def test_hll_update_matches_plain(dev, case):
    """K16's update against its plain version, bit for bit (a register's
    max does not depend on the order the rows come in): GROUP BY () at m
    64-4,096 with masks, a row bound and 3 and 6 columns; the sort
    grouping's perm and group ids, rows past cap_g, a 40 % group, a
    mask; the row-order entry (its own counter, and its cells' copy's)
    over its keys: Qu2's 256 KB and 16 MB of u32 cells, two keys, a
    Nullable key, an int64 and an int8 key, a constant key, slots of no
    group, a mask, a row bound."""
    args, m, cap_g, kw = k16_update_case(case, dev)
    counters = {"hll_update_rows": 1, "hll_cells": 1} if "keys" in kw \
        else {"hll_update": 1}
    before = dict(_native.LAUNCHES)
    got = k16_update(args, m, cap_g, kw)
    assert {k: v - before[k] for k, v in _native.LAUNCHES.items()
            if v != before[k]} == {**counters, **(
                {"row_hash": 1} if len(args) > 4 else {})}
    want = k16_update(args, m, cap_g, kw, plain=True)
    assert got.shape == (cap_g, m) and torch.equal(got, want)


@pytest.mark.parametrize("case", K16_CELLS_CASES,
                         ids=[c[0] for c in K16_CELLS_CASES])
def test_hll_cells_matches_plain(dev, case):
    """K16's cells' copy against its plain version bit for bit (m 64 to
    4,096, slots of no group and groups past cap_g), one launch."""
    from clickhouse_tpu_torch.ops import sketch_ops
    cells, table, cap_g = k16_cells_case(case, dev)
    before = _native.LAUNCHES["hll_cells"]
    got = sketch_ops.hll_cells(cells, table, cap_g)
    assert _native.LAUNCHES["hll_cells"] == before + 1
    assert torch.equal(got, sketch_ops._hll_cells_plain(cells, table, cap_g))


@pytest.mark.parametrize("case", K16_MERGE_CASES,
                         ids=[c[0] for c in K16_MERGE_CASES])
def test_hll_merge_and_finalize_match_plain(dev, case):
    """K16's merge against its plain version bit for bit (K5's bounds
    through perm, empty groups, a mask, GROUP BY ()'s one group), and its
    finalize within 1 of the plain version's float32 estimate (the sum of
    2^-register in another order), 1 off for at most 1 % of the groups;
    an empty group's estimate 0."""
    from clickhouse_tpu_torch.ops import sketch_ops
    st, groups, kw = k16_merge_case(case, dev)
    got = sketch_ops.hll_merge(st, groups, **kw)
    want = sketch_ops._hll_merge_plain(st, groups, kw.get("starts"),
                                       kw.get("ends"), kw.get("perm"),
                                       kw.get("mask"))
    assert torch.equal(got, want)
    est = sketch_ops.hll_finalize(got)
    plain = sketch_ops._hll_finalize_plain(want)
    d = (est - plain).abs()
    assert int(d.max()) <= 1 and int((d > 0).sum()) <= max(2, groups // 100)
    assert not bool(est[~got.bool().any(dim=1)].any())


def test_sketch_queries_on_the_card_match_the_cpu(dev):
    """uniq (GROUP BY () and the sort grouping), cityHash64, topK, entropy
    and groupArray through a CUDA session against a CPU session over the
    same 70,000 rows: the rows equal, an HLL estimate within 1."""
    import clickhouse_tpu_torch as tch
    from clickhouse_tpu_torch.interop import table_from_numpy
    rng = np.random.default_rng(5)
    cols = {"k": rng.integers(0, 50, 70_000).astype(np.int32),
            "x": rng.integers(0, 1 << 40, 70_000),
            "f": rng.normal(0, 1, 70_000)}
    types = {"k": "Int32", "x": "Int64", "f": "Float64"}
    cuda, cpu = tch.connect(device="cuda"), tch.connect(device="cpu")
    for s in (cuda, cpu):
        table_from_numpy(s, "sk", cols, types)
    for sql in ("SELECT uniq(x), uniqIf(f, k > 3) FROM sk",
                "SELECT k, uniq(x, f), uniqHLL12(k) FROM sk GROUP BY k "
                "ORDER BY k",
                "SELECT count() FROM sk WHERE cityHash64(x, k) % 4 = 1",
                "SELECT k, topK(3)(x % 5), entropy(x % 9), groupArray(4)(x) "
                "FROM sk GROUP BY k ORDER BY k"):
        _native.reset_launches()
        got, want = cuda.execute(sql).rows(), cpu.execute(sql).rows()
        assert len(got) == len(want), sql
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                if isinstance(b, float):
                    assert abs(a - b) <= 1e-9 * max(1.0, abs(b)), sql
                elif isinstance(b, list):
                    assert list(a) == list(b), sql
                else:
                    assert abs(a - b) <= (1 if "uniq" in sql else 0), sql
        if "uniq" in sql:
            assert _native.LAUNCHES["hll_update"] \
                + _native.LAUNCHES["hll_update_rows"] >= 1
        if "cityHash64" in sql:
            assert _native.LAUNCHES["row_hash"] == 1


# -- K17 segmented_scan, K18 segmented_search ---------------------------------

@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("layout", ["one_segment", "random_segments",
                                    "tile_edges"])
@pytest.mark.parametrize("name", ["bool", "int8", "int32", "int64",
                                  "uint64", "float32", "float64",
                                  "row_index"])
def test_segmented_scan_matches_plain(dev, name, layout, reverse):
    """K17 against its plain version: every op, masks of none, some and
    every row, 100,003 rows (integers, first and last exact; float sums
    within n * eps of the scan of |x|: chip_smoke.k17_agree)."""
    from chip_smoke import k17_agree, k17_boundary, k17_mask, k17_values
    from clickhouse_tpu_torch.ops.scan_ops import (SCAN_OPS,
                                                   _segmented_scan_plain,
                                                   segmented_scan)
    rng = np.random.default_rng(len(name) * 7 + len(layout) + reverse)
    n = 100_003
    data, uns = k17_values(rng, name, n, dev)
    boundary = k17_boundary(rng, layout, n, dev)
    for mkind in ("none", "random", "all_masked"):
        mask = k17_mask(rng, mkind, n, dev)
        for op in SCAN_OPS:
            if data is None and op not in ("first", "min", "sum"):
                continue
            if data is None and boundary is None and mask is None:
                continue
            got = segmented_scan(op, data, boundary, mask, reverse=reverse,
                                 unsigned=uns)
            want = _segmented_scan_plain(op, data, boundary, mask, reverse,
                                         uns, n)
            k17_agree(op, got, want, data, boundary, mask, reverse)


@pytest.mark.parametrize("n", [513, 3 * 512 + 17])
@pytest.mark.parametrize("name", ["bool", "int8", "uint8", "int16", "int32",
                                  "int64", "uint64", "float32", "float64",
                                  "row_index"])
def test_segmented_scan_instances(dev, name, n):
    """Every K17 kernel instance (chip_smoke.K17_DTYPES, every op) with
    and without boundaries (at every 512-row warp-tile's first and last
    row) and a mask, both directions, at a warp-tile and a row and at
    three warp-tiles and 17 rows, against the plain version
    (chip_smoke.k17_agree)."""
    from chip_smoke import (K17_TILE, k17_agree, k17_boundary, k17_calls,
                            k17_mask, k17_values)
    from clickhouse_tpu_torch.ops.scan_ops import (_segmented_scan_plain,
                                                   segmented_scan)
    assert _native.library().chtt_scan_tile_rows() == K17_TILE
    rng = np.random.default_rng(n + len(name))
    data, uns = k17_values(rng, name, n, dev)
    for layout in ("one_segment", "tile_edges"):
        boundary = k17_boundary(rng, layout, n, dev)
        for mkind in ("none", "random"):
            mask = k17_mask(rng, mkind, n, dev)
            for op, reverse in k17_calls(data, boundary, mask):
                got = segmented_scan(op, data, boundary, mask,
                                     reverse=reverse, unsigned=uns)
                want = _segmented_scan_plain(op, data, boundary, mask,
                                             reverse, uns, n)
                k17_agree(op, got, want, data, boundary, mask, reverse)


@pytest.mark.parametrize("name", ["int32", "uint64", "float64", "row_index"])
def test_segmented_scan_chunk_edges(dev, name):
    """K17 over chip_smoke.K17_CHUNK_ROWS rows, chunks of several
    warp-tiles each, with boundaries at every chunk's first and last row,
    masks of none and some rows, against the plain version."""
    from chip_smoke import (K17_CHUNK_ROWS, k17_agree, k17_boundary,
                            k17_calls, k17_chunk_rows, k17_mask, k17_values)
    from clickhouse_tpu_torch.ops.scan_ops import (_segmented_scan_plain,
                                                   segmented_scan)
    n = K17_CHUNK_ROWS
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(len(name))
    data, uns = k17_values(rng, name, n, dev)
    boundary = k17_boundary(rng, "chunk_edges", n, dev,
                            k17_chunk_rows(n, sms))
    for mkind in ("none", "random"):
        mask = k17_mask(rng, mkind, n, dev)
        for op, reverse in k17_calls(data, boundary, mask):
            got = segmented_scan(op, data, boundary, mask, reverse=reverse,
                                 unsigned=uns)
            want = _segmented_scan_plain(op, data, boundary, mask, reverse,
                                         uns, n)
            k17_agree(op, got, want, data, boundary, mask, reverse)


def test_segmented_scan_float_sum_repeats(dev):
    """A float64 sum with boundaries repeats bit for bit (K17 adds in a
    fixed order), over one chunk and over many."""
    from chip_smoke import K17_CHUNK_ROWS, k17_float_repeats
    k17_float_repeats(dev, 100_003)
    k17_float_repeats(dev, K17_CHUNK_ROWS)


@pytest.mark.parametrize("name", ["one_segment_sorted",
                                  "many_segments_sorted", "straddle",
                                  "sparse_wide", "one_out_of_order",
                                  "empty_segments", "extremes",
                                  "extremes_unsigned"])
def test_segmented_search_cases(dev, name):
    """K18 over chip_smoke.K18_CASES, both sides, against the plain
    version, each case's tiles in the branch it is built for (the
    shared-memory window, queries out of order, a stretch wider than the
    window: chip_smoke.check_k18_case)."""
    from chip_smoke import check_k18_case
    check_k18_case(name, dev)


def test_segmented_scan_launches_once_a_call(dev):
    from clickhouse_tpu_torch.ops.scan_ops import segmented_scan
    _native.reset_launches()
    segmented_scan("sum", torch.ones(10, dtype=torch.int32, device=dev),
                   None)
    assert _native.LAUNCHES["segmented_scan"] == 1


@pytest.mark.parametrize("unsigned", [False, True])
@pytest.mark.parametrize("side", ["left", "right"])
def test_segmented_search_matches_plain(dev, side, unsigned):
    """K18 against its plain version over 300,000 rows in 1,000 segments
    (some empty), queries equal to, between, below and above the keys,
    segment ids outside the segments, and the one-segment form."""
    from clickhouse_tpu_torch.ops.search import (_segmented_search_plain,
                                                 segmented_search)
    rng = np.random.default_rng(int(unsigned) * 2 + (side == "right"))
    n, n_seg = 300_000, 1000
    seg = np.sort(rng.integers(0, n_seg, n))
    vals = rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)
    if unsigned:
        vals[rng.random(n) < 0.5] |= np.int64(-(1 << 63))
    key = vals ^ np.int64(-(1 << 63)) if unsigned else vals
    o = np.lexsort((key, seg))
    seg, vals = seg[o], vals[o]
    starts = np.searchsorted(seg, np.arange(n_seg), "left")
    ends = np.searchsorted(seg, np.arange(n_seg), "right")
    q = np.concatenate([vals, vals + 1, vals - 1,
                        np.array([-(1 << 63), (1 << 63) - 1, 0])])
    gid = np.concatenate([seg, seg, seg, [-1, n_seg + 3, 5]]).astype(
        np.int32)
    t = torch.from_numpy(vals).to(dev)
    args = dict(gid=torch.from_numpy(gid).to(dev),
                starts=torch.from_numpy(starts).to(dev),
                ends=torch.from_numpy(ends).to(dev))
    qt = torch.from_numpy(q).to(dev)
    got = segmented_search(t, qt, side, unsigned=unsigned, **args)
    want = _segmented_search_plain(t, qt, side, args["gid"], args["starts"],
                                   args["ends"], unsigned)
    assert torch.equal(got, want)
    flip = -(1 << 63) if unsigned else 0
    one = torch.sort(t ^ flip).values ^ flip
    got = segmented_search(one, qt, side, unsigned=unsigned)
    want = _segmented_search_plain(one, qt, side, None, None, None, unsigned)
    assert torch.equal(got, want)


def test_window_queries_match_the_cpu(dev):
    """Window, union and set-operation queries on the card against a CPU
    session, each launching K17 (and K18 for a RANGE offset frame)."""
    import clickhouse_tpu_torch as tch
    from clickhouse_tpu_torch.interop import table_from_numpy
    rng = np.random.default_rng(21)
    cols = {"g": rng.integers(0, 30, 80_000), "x": rng.integers(0, 5000,
                                                                80_000),
            "v": rng.normal(0, 1, 80_000)}
    types = {"g": "Int64", "x": "Int64", "v": "Float64"}
    cuda, cpu = tch.connect(device="cuda"), tch.connect(device="cpu")
    for s in (cuda, cpu):
        table_from_numpy(s, "wk", cols, types)
    w = "PARTITION BY g ORDER BY x"
    for sql, kernels in (
            (f"SELECT g, x, rank() OVER ({w}), dense_rank() OVER ({w}), "
             f"sum(x) OVER ({w}) FROM wk ORDER BY g, x, 3, 4", ("scan",)),
            (f"SELECT sum(s), sum(c) FROM (SELECT sum(x) OVER ({w} RANGE "
             f"BETWEEN 50 PRECEDING AND 20 FOLLOWING) AS s, count() OVER "
             f"({w} RANGE BETWEEN 50 PRECEDING AND 20 FOLLOWING) AS c "
             f"FROM wk)", ("scan", "search")),
            (f"SELECT sum(a), sum(b), sum(c) FROM (SELECT min(x) OVER ({w} "
             f"ROWS BETWEEN CURRENT ROW AND UNBOUNDED FOLLOWING) AS a, "
             f"max(v) OVER ({w} ROWS BETWEEN 3 PRECEDING AND 3 FOLLOWING) "
             f"AS b, lag(x, 2) OVER ({w}) AS c FROM wk)", ("scan",)),
            ("SELECT x FROM wk WHERE g < 10 INTERSECT SELECT x FROM wk "
             "WHERE g > 20 ORDER BY x", ("scan",))):
        _native.reset_launches()
        got, want = cuda.execute(sql).rows(), cpu.execute(sql).rows()
        assert len(got) == len(want), sql
        for g, w_ in zip(got, want):
            for a, b in zip(g, w_):
                if isinstance(b, float):
                    assert abs(a - b) <= 1e-9 * max(1.0, abs(b)), sql
                else:
                    assert a == b, sql
        assert _native.LAUNCHES["segmented_scan"] >= 1, sql
        if "search" in kernels:
            assert _native.LAUNCHES["segmented_search"] >= 1, sql
