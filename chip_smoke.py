"""Quickest proof that the CUDA engine (clickhouse_tpu_torch) runs on a GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --k2-wide   # only K2 at S = 16,384 (see k2_wide)
    python3 chip_smoke.py --queries   # only the query times (time_queries)
    python3 chip_smoke.py --gathers   # only random gathers by table size
    python3 chip_smoke.py --k9        # only K9 alone (k9_turn)
    python3 chip_smoke.py --vectors   # only K11's cases, Q8, Q8l, Q8w and
                                      # K11 at Q8's inputs
    python3 chip_smoke.py --aggregates  # only K6's cases (both entries),
                                      # Q2u, Q2ug, Q2q, Q2s2 and Q2g, K6
                                      # at Q2ug's and Q2s2's inputs
    python3 chip_smoke.py --k6        # only K6 at Q2m's, Q2ug's and Q2s2's
                                      # inputs and their device-busy time
                                      # (an older checkout's alike)
    python3 chip_smoke.py --calendar  # only K12's cases, Qt1-Qt5 over
                                      # hits_t and K12 at their inputs
    python3 chip_smoke.py --streaming  # only K13's and K14's cases, Q5,
                                      # Q5b, Q6 and Q5np streamed over 1B
                                      # rows, the other programs' Q5t, Q5c,
                                      # Q5h, Q5t2, Q5t3, Q6g and Q6x,
                                      # K13 at their chunks and K14 at
                                      # Q5c's and Q5h's and a dense mask
    python3 chip_smoke.py --k14       # only K14's cases and K14 at Q5c's
                                      # and Q5h's first chunk masks (made
                                      # on the card) and a dense 2^27-row
                                      # mask (an older checkout's alike)
    python3 chip_smoke.py --sketch    # only K15's and K16's cases, Qu1-Qu3,
                                      # Qs1 and Qs2 over hits, Q5u and Q5ub
                                      # streamed over big, and K15 and K16
                                      # at their inputs
    python3 chip_smoke.py --window    # only K17's and K18's cases, the
                                      # window, union and set-operation
                                      # queries Qw1-Qw5, Qr1-Qr3, Qi1-Qi2
                                      # over hits, their times, and K17
                                      # and K18 at Qw5's and Qw3's inputs
    python3 chip_smoke.py --scan-search  # only K17's and K18's cases and
                                      # the two kernels at Qw5's and Qw3's
                                      # inputs (an older checkout's alike)
    python3 chip_smoke.py --sass calendar_part  # one source's nvcc time,
                                      # registers, spills, shared bytes and
                                      # SASS CALLs a kernel (or
                                      # --sass segment_reduce)

Needs one NVIDIA Hopper card, nvcc and PyTorch built for CUDA; exits
non-zero without them.  Phases, each of which fails the run:

  1. build the eighteen hand-written kernels (csrc/*.cu) with nvcc for sm_90a,
     one nvcc a source, all started together;
  2. hold each kernel against its plain PyTorch version on the card: edge
     cases (K1 with and without filter terms over every storage type and
     comparison, constants outside the storage range, NaN, NULLs, UInt64
     at and above 2^63 against float constants one ulp from its values,
     row bounds off the 16-row grid and misaligned views; K2 with skewed
     slots; both K3 entries with ties, extreme keys, invalid rows,
     monotone keys and ties across blocks; K4 over every key type's token,
     UInt64 above 2^63, NaN and -0.0, all-equal keys, a constant top digit,
     one row, one tile and one tile plus a row, more tiles than the card
     holds at once (the look-back waits), invalid rows, no valid row and
     multi-key chains; K5 over K5_CASES: one row, part of a tile, a tile
     multiple and one row, a group over 100 tiles, a boundary at every
     tile's first row, more groups than slots, no valid row, u64 keys, two
     to five key arrays and misaligned views; K6 for every op, with masks,
     empty and fully masked groups, one group holding 40 % of the rows,
     and several ops over two columns and two masks in one launch, and
     its sorted-order entry (data already in sorted order, no
     permutation) over every op and storage type, partial masks, masks of
     no row and of no row in every other group, invalid rows and a 40 %
     group (check_k6_sorted); K7
     over K7_CASES: unique keys, holes, probe keys outside the range,
     invalid rows, a Nullable payload, sentinels at both int32 edges, key
     words, a presence table, int8/int16/int64 and UInt64 keys, views 1-3
     rows in, a narrow table of each width (1, 2, 4 bytes) with the
     sentinel at the width's edges, 2-8 words packed in one slot, 1, 3
     and 4k + 1 probe rows, a toInt8 payload, and stated ranges that do
     not hold (a word, a build key), which must set out_of_range; K8 over
     K8_CASES, three runs each: duplicates
     (the smallest row id wins), one key of 4 and of 8 bytes, two to eight
     key words, hashes forced equal (the word-by-word check), a run past
     the last bucket, float keys with -0.0/+0.0/NaN, a table of one key,
     nothing matching, 300,000 rows of one key, one, five and ten words,
     views one row in, Q4x's group-index table, words kept in the payload
     array rather than the bucket; K9
     over K9_CASES, three runs each: no match, LEFT, ANY,
     one probe row holding 90 % of the output, a count beyond the
     capacity, no probe row, 20M probe rows, a tile's output at the spill
     threshold less one, at it and above it, heavy rows in adjacent tiles,
     an empty tile, the capacity mid-tile and mid-heavy-row, a row count
     mid-tile (with and without a mask) and at 0, a row count off the
     16-row grid, views 1-3 rows in); K10 over K10_CASES, prefix and
     suffix each with and without negate, three runs each (0, 1 and 3
     values, a value count off the block, values of 0-3, 64-66 and 4,000
     bytes, chars at an odd address, needles past 48 bytes and past the
     kernel's shared-memory stage, int64 offsets, chars past 2^31 bytes);
     K11 over K11_CASES for each of its four ops (widths 8, 24, 128 and
     136, ragged lengths 0, 1, W - 1 and W, a zero row, a zero query, a
     row count off the block, rows past n, which must hold the zero row's
     value unread), within 1e-5 relative plus 1e-6 of the row's scale
     (k11_error); K12 over every op use of K12_SPECS, days and seconds,
     int8/int16/int32/int64 storage, the edge days of K12_EDGE_DATES
     (1900, 2000 and 2100's Februaries, month and year ends, days before
     1970), K12_ROWS rows and views 1-3 rows in, and k12_edge_cases
     (every int8 and int16 day, every day's first and last second over
     int32 with INT32_MIN and INT32_MAX, the run-time divisors of
     K12_DIVISORS with their anchors, the constants of
     K12_CONSTANT_EDGES); K13 over K13_CASES; K14 over K14_CASES (the
     count and the first `count` indices: one row to a 2^27-row chunk,
     empty, full, one bit, the first version's tile edges, a row bound,
     K1 terms with and without a mask, views 1 and 3 rows in, and, at
     K14's tile as the library reports it, a tile and a row, three tiles
     and 17 rows with bits at every tile's and run's edges, row bounds
     inside a thread's runs, every tile empty but the last, a mask view 1
     row in over several tiles and a dense 2^27-row mask); K17 over every
     op, both directions, K17_DTYPES, K17_LAYOUTS and K17_MASKS at
     K17_ROWS rows (the edges of its 512-row warp-tile), K17_CHUNK_ROWS
     rows with boundaries at every chunk's edges, a float64 sum twice bit
     for bit and a sum that wraps (check_k17); K18 over K18_ROWS rows in
     1, 7 and n/50 segments, queries on, between and beyond the keys,
     both sides, signed and unsigned, clamped segment ids, and K18_CASES
     (sorted queries, tiles straddling segments, empty segments, +-(2^63
     - 1), a query out of order in each tile, a stretch wider than the
     shared-memory window), each in the branch it is built for
     (check_k18); integer
     results must agree
     exactly, K1's and K2's float sums within rtol 1e-12, K6's within
     n_g * eps * sum(|x|) a group of n_g rows (its atomics add a group's
     parts in a varying order); then SELECT without FROM, numbers() and
     INSERT ... VALUES with expressions through connect(device="cuda"),
     against numpy, and 20 small join queries (every ported form, and
     three-table chains whose middle key is not built) on the card
     against the CPU, and a 1:N join past max_joined_rows raising
     CapacityError;
  3. drive the main path through the public API: connect(device="cuda"),
     CREATE TABLE hits (x Int64), insert_pydict 100M rows of
     (arange * 2654435761) % 1_000_003, then Q1, Q2, Q2b, Q2m and Q3
     (Q1-Q3 and Q2b the SQL of bench.py), each checked against a numpy
     answer, with the kernels' launch counters reset before and read after
     to show the queries went through K1-K6: Q1 must reach K1 once at 100M
     rows with its filter as a term (read in x's int32 storage) and
     allocate no row mask; Q2b and Q2m must reach K4 once and K5 over
     every row, Q2m K6 exactly once (all four aggregates in one launch)
     and Q2b never; each query's peak device memory is printed, for Q2b
     and Q2m beside the governor's count for the sort grouping and the
     grouping's own peak; then, over tables of 1M build and 100M probe
     rows, Q4 (bench.py:505-507 over bench.py:492-504's data), Q4h (keys
     far apart) and Q4x (each build key twice), checked against numpy,
     each launching exactly the kernels of its path (JOIN_PATHS: Q4 K7,
     Q4h K8, Q4x K4, K5, K8 and K9; K1 for the aggregate), its peak
     memory beside the governor's estimate; then Q2t (Q2 WITH TOTALS: its
     rows and Result.totals), Q2l (LIMIT 2 BY intDiv(x, 4)) and Q2d
     (DISTINCT intDiv(x, 4)) over hits, and over hits_s (url String,
     bench.py:455-465: 50M urls, 25M distinct; the host time of its
     device block printed) Q7 (bench.py: 466-468), Q7b (bench.py:473-475:
     K10's prefix and K1; its first run builds the dictionary's chars,
     once and under the governor's check, their time and bytes printed),
     Q7d (DISTINCT url) and Q7s (LIKE '%99': K10's suffix), each against
     numpy and launching exactly the kernels of its path (SLICE10_PATHS),
     its peak beside the governor's estimate; then over vecs (id Int64, v
     Array(Float32): bench.py:538-543's 10,000,000 x 128 normals, the
     host time of the data and of its device block printed) Q8
     (bench.py:545-550: ORDER BY cosineDistance LIMIT 10, K11 and K3's
     32-bit entry), Q8l (L2Distance to a Float64 literal: K3's 64-bit
     entry) and Q8w (WHERE id < 1000000 ... LIMIT 3: K1's count too),
     their ids against numpy's float64 top-k, whose k-th and (k+1)-th
     distances must lie further apart than the engine's float32 error,
     each launching exactly SLICE11_PATHS; then the aggregate tail over
     hits (SLICE12_QUERIES: Q2u count(DISTINCT x), Q2ug the same by x %
     1024, Q2q median and quantiles, Q2s2 argMax, varSamp, stddevPop,
     corr and groupBitXor, Q2g varPop, argMin and median under GROUP BY
     ()), each against numpy (integers exact, floats within STAT_TOL of
     the statistic's largest term) and launching exactly SLICE12_PATHS,
     its peak beside the governor's estimate; then over hits_t (t
     DateTime, d Date, x Int64: every second of July 2013 in a scattered
     order, its day, hits' x; 100M rows) Qt1-Qt5 (SLICE13_QUERIES:
     ClickBench Q43's date_trunc('minute') bucket, toHour/toDayOfWeek
     groups, a toYYYYMMDD day series, a month step and dateDiff, and
     round/sqrt/log/bitAnd aggregates) against numpy's datetime64
     conversions, launching exactly SLICE13_PATHS, each K12 launch (one a
     calendar function) over every row; Q2's and Q2t's peaks are split
     by allocation (watch_dense: the dense grouping's slots and ids, K2's
     inputs and outputs); then the window, union and set-operation
     queries over hits (WINDOW_QUERIES: Qw1-Qw5 window functions under
     PARTITION BY x % 1024 ORDER BY x and one partition, each column
     checked by its sum and the sum of cityHash64(x, w); Qr1, Qr2 ROLLUP
     and CUBE; Qr3 UNION ALL of two 100M-row blocks; Qi1, Qi2 INTERSECT
     and EXCEPT over 200M rows) against numpy (window_answers), each
     launching WINDOW_PATHS (K17 for every window query and set
     operation, K18 for the RANGE offset frames), its peak beside the
     governor's estimate and the window's held working set;
  4. replay each kernel on the exact inputs the main path gave it (its
     largest launch on the main path), held against its plain version, and
     time it, its plain version and, where one exists, the single PyTorch
     call computing the same function (CUDA events, L2 flushed, device
     time); print bytes and bound_ms (bytes / 3.35 TB/s) for each, K1 in
     both its forms (Q1's filter term, and the largest bool-mask count the
     main path made: the aggregated block's row count in _sort_block) and
     the kernels of one call from a torch.profiler trace, K2 on skewed
     slots at 100M rows and at S = 16,384, K3's level 1 and merge apart
     (torch.profiler), K4 at Q2b's and Q2m's inputs with its histogram and
     scatter kernels apart (torch.profiler: one histogram and one scatter
     a pass), K5 at Q2b's and Q2m's inputs (torch.profiler: one kernel a
     call) beside a copy of its key array, K6's one launch of Q2m's four
     aggregates, each of them alone and over 100M rows where one group
     holds 40 % of them, K7 at Q4's inputs beside index_select, K8 at
     Q4h's (and its probe at Q4x's) beside searchsorted for information,
     both also with the unread build key's words beside label (the
     inputs before the join built only what is read), K9 at Q4x's (the
     probe rows as their row count) beside repeat_interleave, also with
     the rows as a bool mask, its scan pass alone, on the heavy-row and
     many-tile cases and at each spill threshold of K9_HEAVY_SWEEP, each
     with its kernels a call; K10 at Q7b's inputs (its bytes: the chars'
     32-byte sectors holding a compared byte, the offsets and the output)
     and at Q7s's; K11 at Q8's inputs beside torch.mv(A, q) (the dot
     alone, for information); K6's sorted-order entry at Q2ug's inputs
     (its first-occurrence flags) beside torch.segment_reduce(sum,
     lengths=group rows); K12 at Qt2's toHour and toDayOfWeek, Qt1's
     minute bucket, Qt3's toYYYYMMDD, Qt4's month step and toStartOfDay
     over t's int32 storage, and toYYYYMMDD over t widened to int64 (the
     64-bit path; library none); K17 at Qw5's one-segment running sum
     beside torch.cumsum (and its max beside torch.cummax, Qw1's bool sum,
     the peer bounds' forward and reverse "first", its three passes
     apart), K18 at Qw5's RANGE edge beside torch.searchsorted and at
     Qw3's partitions with their tiles by branch (window_shapes); the
     window queries' walls and device-busy times
     (window_times); fails unless Q4's K7 call
     carries label alone and
     Q4h's K8 call one word; time each query (median wall time of 20
     runs, synchronised) with its peak memory beside the governor's
     estimate, the device-busy time of Q1, Q2b, Q2m, Q4, Q4h, Q4x and the
     slice-10 queries (torch.profiler) and Q4's wall over the probe
     roofline of bench.py:509-525;
  5. with the earlier tables freed, stream bench.py's BASELINE-scale
     queries (streaming_phase): big (1B rows of x) and fact (1B rows of
     fk) inserted in 250M pieces, dim (10M rows); Q5 (its host PREWHERE
     sends the ~500M rows above 500000), Q5b and Q6 with stream_readers =
     2, and Q5np (Q5 with the PREWHERE off) packed and, through
     ChunkSource(pack=False), unpacked: each must stream, read its chunks
     (aligned: 2 a 250M part), equal numpy, launch exactly
     stream_paths (K13 a chunk), and hold less device memory above what
     was allocated before it than its column's bytes; prints the H2D
     copy rate pinned and pageable, each query's cold and warm walls,
     wire rate, io_stats, device-busy time and peak; then K13 at Q5np's
     and Q6's chunks (K13's cases of K13_CASES run in phase 2); then, in
     the same session with dim_g (600M rows, above the threshold) added,
     the other streamed programs (PROGRAM_SQL): Q5t, Q5t2 and Q5t3
     (TopKProgram; Q5t3's keys do not pack, so K4 sorts its chunks a
     slice at a time), Q5c and Q5h (CollectProgram, K14 a chunk), Q6g (the
     grace join, 8 buckets) and Q6x (blow-up streaming of a cross join),
     each checked for its counter, program, chunks, numpy's answer,
     exactly its stream_paths and a peak below the 12 GiB budget; then K14
     at Q5c's and Q5h's chunks and at a dense 2^27-row mask, each beside
     its plain version, torch.nonzero, K1's count of the same mask and a
     fill of the kept slots (the phase split; k14_time) (K14's cases of
     K14_CASES run in phase 2).

The second-to-last line is a JSON object of per-kernel results (name,
route, source, replaces, launches, ms, plain_ms, bound_ms, bound_by,
library_ms, ...); the last line is {"ok": true, "device": {...}}.
"""
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_ROWS = 100_000_000
Q1 = "SELECT count() FROM hits WHERE x > 500000"
Q2 = ("SELECT x % 1024 AS k, count() AS c, sum(x) FROM hits GROUP BY k "
      "ORDER BY c DESC LIMIT 10")
Q3 = "SELECT x FROM hits ORDER BY x LIMIT 100"
Q2B = ("SELECT x AS k, count() AS c FROM hits GROUP BY k ORDER BY c DESC "
       "LIMIT 10 SETTINGS max_groups = 2097152")
Q2M = ("SELECT intDiv(x, 4) AS k, count() AS c, sum(x) AS s, min(x) AS lo, "
       "max(x) AS hi, any(x) AS a FROM hits GROUP BY k ORDER BY s DESC "
       "LIMIT 10")
QUERIES = (("Q1", Q1), ("Q2", Q2), ("Q2b", Q2B), ("Q2m", Q2M), ("Q3", Q3))
# the join queries: Q4 is bench.py:505-507 over its data (bench.py:492-504);
# Q4h the same SQL over keys far apart (the hash table), Q4x over a build
# side whose keys repeat (the 1:N expansion)
Q4 = "SELECT count(), sum(label) FROM fact INNER JOIN dim ON fact.fk = dim.k"
Q4H = ("SELECT count(), sum(label) FROM fact_h INNER JOIN dim_h "
       "ON fact_h.fk = dim_h.k")
Q4X = ("SELECT count(), sum(label) FROM fact INNER JOIN dim2 "
       "ON fact.fk = dim2.k")
JOIN_QUERIES = (("Q4", Q4), ("Q4h", Q4H), ("Q4x", Q4X))
N_DIM = 1_000_000
# each join query's launches, exactly (every other kernel: none): K1 twice
# for count() and sum(label), and once more in Q4x for the build side's
# valid rows
JOIN_PATHS = {"Q4": {"dense_join": 1, "masked_reduce": 2},
              "Q4h": {"hash_join": 1, "masked_reduce": 2},
              "Q4x": {"radix_sort_pairs": 1, "segment_bounds": 1,
                      "hash_join": 2, "expand_matches": 1,
                      "masked_reduce": 3}}
# the kernel of each join query that must cover every probe row
JOIN_PROBE = {"Q4": "dense_join", "Q4h": "hash_join",
              "Q4x": "expand_matches"}
# slice 10: DISTINCT, LIMIT BY and WITH TOTALS over hits, and the string
# configuration hits_s (url String), bench.py:455-465: N_S_ROWS rows of
# 'http://example.com/p' + str(i % N_S_DISTINCT), with Q7 (bench.py:466-468),
# Q7b (bench.py:473-475), Q7d (DISTINCT) and Q7s (K10's suffix form)
N_S_ROWS = 50_000_000
N_S_DISTINCT = N_S_ROWS // 2
URL_PREFIX = "http://example.com/p"
Q2T = ("SELECT x % 1024 AS k, count() AS c, sum(x) FROM hits GROUP BY k "
       "WITH TOTALS ORDER BY c DESC LIMIT 10")
Q2L = "SELECT count() FROM (SELECT x FROM hits LIMIT 2 BY intDiv(x, 4))"
Q2D = "SELECT count() FROM (SELECT DISTINCT intDiv(x, 4) FROM hits)"
Q7 = ("SELECT count() FROM (SELECT url, count() AS c FROM hits_s "
      "GROUP BY url) SETTINGS max_groups = 67108864")
Q7B = ("SELECT count() FROM hits_s "
       "WHERE startsWith(url, 'http://example.com/p1')")
Q7D = ("SELECT count() FROM (SELECT DISTINCT url FROM hits_s) "
       "SETTINGS max_groups = 67108864")
Q7S = "SELECT count() FROM hits_s WHERE url LIKE '%99'"
SLICE10_QUERIES = (("Q2t", Q2T), ("Q2l", Q2L), ("Q2d", Q2D), ("Q7", Q7),
                   ("Q7b", Q7B), ("Q7d", Q7D), ("Q7s", Q7S))
# each query's launches, exactly (every other kernel: none): K4 and K5 for
# the sort grouping and K1 for the outer count(); Q2t's dense grouping
# (K2), its top-k (K3) and its totals' count() and sum(x) (K1 twice);
# Q7b's and Q7s's K10 over the dictionary and K1's count of the mask
_SORTED = {"radix_sort_pairs": 1, "segment_bounds": 1, "masked_reduce": 1}
_AFFIX = {"prefix_match": 1, "masked_reduce": 1}
SLICE10_PATHS = {"Q2t": {"dense_group_reduce": 1, "topk_smallest": 1,
                         "masked_reduce": 2},
                 "Q2l": _SORTED, "Q2d": _SORTED, "Q7": _SORTED,
                 "Q7d": _SORTED, "Q7b": _AFFIX, "Q7s": _AFFIX}
# slice 12: the aggregate tail over hits.  Q2u and Q2g take GROUP BY ()
# (K1 for the sums, K4 over x and K5 for the holistic ones); Q2ug is the
# shape of ClickBench's `RegionID, COUNT(DISTINCT UserID)`
Q2U = "SELECT count(DISTINCT x) FROM hits"
Q2UG = ("SELECT x % 1024 AS k, count(DISTINCT x) AS u FROM hits GROUP BY k "
        "ORDER BY u DESC, k LIMIT 10")
Q2Q = ("SELECT x % 1024 AS k, median(x), quantiles(0.1, 0.9)(x) FROM hits "
       "GROUP BY k ORDER BY k LIMIT 10")
Q2S2 = ("SELECT x % 1024 AS k, argMax(x, x % 7), varSamp(x), stddevPop(x), "
        "corr(x, x % 7), groupBitXor(x) FROM hits GROUP BY k ORDER BY k "
        "LIMIT 10")
Q2G = "SELECT varPop(x), argMin(x, x % 7), median(x) FROM hits"
SLICE12_QUERIES = (("Q2u", Q2U), ("Q2ug", Q2UG), ("Q2q", Q2Q),
                   ("Q2s2", Q2S2), ("Q2g", Q2G))
# each query's launches, exactly: K4 once for a word of x (the secondary
# key of count(DISTINCT x) and of median/quantiles, sorted in its own
# word) and once for the group key's word, K5 over the group key's words
# alone, K6's sorted-order entry for uniqExact's first-occurrence flags
# and argMax's rows at the best value (quantiles read their values at
# starts + offset: no K6), K6 once for Q2s2's seven reductions (x and
# x % 7 as stored; the statistics' squares and products formed in
# registers), K1 for GROUP BY ()'s sums and argMin
# (its min, then `any` of the rows at it) and for the ORDER BY's row mask,
# K3 for ORDER BY k LIMIT 10 and K4 once more for ORDER BY u DESC, k
SLICE12_PATHS = {
    "Q2u": {"radix_sort_pairs": 1, "segment_bounds": 1,
            "segment_reduce_sorted": 1},
    "Q2ug": {"radix_sort_pairs": 3, "segment_bounds": 1,
             "segment_reduce_sorted": 1, "masked_reduce": 1},
    "Q2q": {"radix_sort_pairs": 2, "segment_bounds": 1, "masked_reduce": 1,
            "topk_smallest": 1},
    "Q2s2": {"radix_sort_pairs": 1, "segment_bounds": 1,
             "segment_reduce": 1, "segment_reduce_sorted": 1,
             "masked_reduce": 1, "topk_smallest": 1},
    "Q2g": {"masked_reduce": 4, "radix_sort_pairs": 1, "segment_bounds": 1}}
# float results of the slice-12 queries: within 1e-9 of the statistic's
# largest term (the variance's mean square s2/c, the standard deviation's
# root mean square; a correlation's 1): the engine cancels float64 sums
# (s2/c - mean^2) that K6 and K1 add in another order than numpy's
# two-pass variance
STAT_TOL = 1e-9
# the queries whose device-busy time a trace takes
BUSY_QUERIES = ("Q1", "Q2b", "Q2m", "Q4", "Q4h", "Q4x", "Q8", "Q8l",
                "Q8w") + tuple(
    q for q, _ in SLICE10_QUERIES) + tuple(q for q, _ in SLICE12_QUERIES) \
    + ("Qt1", "Qt2", "Qt3", "Qt4", "Qt5")
QUERY_REPS = 20
KERNEL_REPS = 20
FLOAT_RTOL = 1e-12      # the kernel adds float partials in another order
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
L2_FLUSH_BYTES = 128 << 20  # > the H100's 50 MB L2
SLEEP_CYCLES = 1_000_000    # ~0.5 ms of device time to cover host enqueue
# per-kernel keys of the kernels line beyond the contract's
EXTRA_KEYS = ("k1_count_ms", "fill_ms", "q5h_ms", "q5h_plain_ms",
              "q5h_library_ms", "q5h_k1_count_ms", "q5h_fill_ms",
              "q5h_bytes", "q5h_bound_ms", "q5h_shape", "dense_ms",
              "dense_plain_ms", "dense_library_ms", "dense_k1_count_ms",
              "dense_fill_ms", "dense_bytes", "dense_bound_ms",
              "dense_shape", "level1_ms", "merge_ms", "entry64_ms",
              "entry64_bound_ms",
              "one_slot_ms", "zipf_ms", "wide_s_ms", "counts_only_ms",
              "sums_only_ms", "mask_form_ms", "mask_form_plain_ms",
              "mask_form_library_ms", "mask_form_bytes",
              "mask_form_bound_ms", "mask_form_shape", "launches_fused",
              "launches_mask_form", "kernels_per_call", "passes",
              "digit_bits", "per_op_ms", "skew_ms", "skew_bound_ms",
              "information", "hist_ms", "scatter_ms", "q2m_ms", "q2m_bound_ms", "q2m_library_ms",
              "specs", "launches_per_query", "copy_ms", "q2m_plain_ms",
              "q2m_bytes", "q4x_probe_ms", "q4x_probe_bound_ms",
              "l2_resident", "with_key_ms", "with_key_bound_ms",
              "with_key_plain_ms", "with_key_bytes",
              "with_key_4_byte_slots_ms", "words_in_bucket_ms",
              "words_in_payload_ms", "q4x_probe_words_in_bucket_ms",
              "q4x_probe_words_in_payload_ms", "with_mask_ms",
              "with_mask_bytes", "with_mask_bound_ms", "heavy_ms",
              "heavy_bytes", "heavy_bound_ms", "many_tiles_ms",
              "many_tiles_bytes", "many_tiles_bound_ms", "threshold_ms",
              "scan_only_ms", "scan_only_bound_ms", "suffix_ms",
              "suffix_plain_ms", "suffix_bytes", "suffix_bound_ms",
              "sorted_entry", "sorted_ms", "sorted_plain_ms",
              "sorted_library_ms", "sorted_library", "sorted_bytes",
              "sorted_bound_ms", "sorted_shape",
              "launches_sorted", "launches_permuted", "q2s2_ms",
              "q2s2_plain_ms", "q2s2_bytes", "q2s2_bound_ms", "q2s2_shape",
              "q2s2_sector_bytes", "q2s2_sector_floor_ms", "q2s2_sources",
              "q2s2_forms", "q2s2_sorted_entry",
              "q2s2_sorted_ms", "q2s2_sorted_plain_ms",
              "q2s2_sorted_library_ms", "q2s2_sorted_library",
              "q2s2_sorted_bytes", "q2s2_sorted_bound_ms",
              "q2s2_sorted_shape",
              "bucket_ms", "bucket_plain_ms", "bucket_bytes",
              "bucket_bound_ms", "bucket_kernels_per_call", "k12_calls",
              "yyyymmdd_ms", "yyyymmdd_plain_ms", "yyyymmdd_bytes",
              "yyyymmdd_bound_ms", "yyyymmdd_kernels_per_call",
              "add_months_ms", "add_months_plain_ms", "add_months_bytes",
              "add_months_bound_ms", "add_months_kernels_per_call",
              "dow_ms", "dow_plain_ms", "dow_bytes", "dow_bound_ms",
              "dow_kernels_per_call", "start_of_day_ms",
              "start_of_day_plain_ms", "start_of_day_bytes",
              "start_of_day_bound_ms", "start_of_day_kernels_per_call",
              "yyyymmdd64_ms", "yyyymmdd64_plain_ms", "yyyymmdd64_bytes",
              "yyyymmdd64_bound_ms", "yyyymmdd64_kernels_per_call",
              "q5_ms", "q5_plain_ms", "q5_bytes", "q5_bound_ms", "q5_shape",
              "shape", "scatter_amax_ms", "sorted_sector_bytes",
              "sorted_gather_ms",
              "sorted_sector_floor_ms", "finalize_ms", "finalize_plain_ms",
              "finalize_bytes", "finalize_bound_ms", "finalize_off_by_one",
              "finalize_shape", "merge_plain_ms", "merge_bytes",
              "merge_bound_ms", "merge_shape", "launches_update",
              "launches_merge", "launches_finalize", "launches_update_rows",
              "launches_cells", "split", "rows_ms", "rows_plain_ms",
              "rows_bytes", "rows_bound_ms", "rows_shape", "cells_ms",
              "cells_plain_ms", "cells_bytes", "cells_bound_ms",
              "cells_shape", "layouts", "max_ms", "cummax_ms",
              "bool_sum_ms", "bool_sum_bound_ms", "first_index_ms",
              "reverse_first_index_ms", "first_index_bound_ms", "qw3_ms",
              "qw3_bytes", "qw3_bound_ms", "qw5_tiles", "qw3_tiles")
F64_EPS = 2.0 ** -52
CMPS = ["equals", "notEquals", "less", "lessOrEquals", "greater",
        "greaterOrEquals"]
# UInt64 values whose float64, converted as signed and moved by 2^64,
# would be one ulp off numpy's
U64_EDGE = [9544035305396814861, 1, (1 << 63) + 1025, (1 << 64) - 1]


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=KERNEL_REPS) -> float:
    """Mean device milliseconds of one fn() (after one warm run), timed with
    CUDA events around each call.  Before each call the L2 is flushed (a
    write of L2_FLUSH_BYTES) and the device is held busy by a sleep kernel
    while the host enqueues fn(), so the events see device time from a cold
    cache and no host launch gaps."""
    fn()
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    events = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        events.append((start, stop))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / reps


def bound_ms(nbytes: int) -> float:
    """Least time to move nbytes at the card's memory rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"shape/dtype {tuple(got.shape)}/{got.dtype} != "
             f"{tuple(want.shape)}/{want.dtype}")
    if got.is_floating_point():
        g, w = got.double(), want.double()
        nan_g, nan_w = torch.isnan(g), torch.isnan(w)
        if not torch.equal(nan_g, nan_w):
            fail("NaN positions differ")
        g, w = g[~nan_g], w[~nan_w]
        if g.numel() and not torch.allclose(g, w, rtol=FLOAT_RTOL, atol=0):
            fail(f"float results differ beyond rtol {FLOAT_RTOL}")
        return float((g - w).abs().max()) if g.numel() else 0.0
    if not torch.equal(got, want):
        fail("integer results differ")
    return 0.0


def _lit_type(v) -> str:
    """The type the analyzer gives a numeric literal: the narrowest
    unsigned type for v >= 0, signed for v < 0, Float64 for a float."""
    if isinstance(v, float):
        return "Float64"
    for bits in (8, 16, 32, 64):
        if 0 <= v < 1 << bits:
            return f"UInt{bits}"
        if -(1 << (bits - 1)) <= v < 0:
            return f"Int{bits}"
    raise ValueError(v)


def term_cases(rng, n):
    """(column type, values, literals) for K1's filter terms: every storage
    type a term reads (Int64 narrowed to int8 / int16 / int32, full int64,
    uint8, UInt16 in int32, UInt32 in int64, UInt64 bits, Float64 stored as
    float32, float32, float64), NULLs, NaN, -0.0 and infinities, constants
    outside the storage range, and UInt64 values at and above 2^63 against
    float constants one ulp from their float64 (U64_EDGE)."""
    big = rng.integers(-(1 << 62), 1 << 62, n)
    u64 = rng.integers(0, 1 << 62, n).astype(np.uint64)
    u64[rng.random(n) < 0.3] += np.uint64(1 << 63)
    f = rng.normal(0, 100, n)
    f[rng.random(n) < 0.05] = np.nan
    f[rng.random(n) < 0.05] = -0.0
    f[:3] = [np.inf, -np.inf, 0.0]
    nul = rng.integers(-50, 50, n).astype(object)
    nul[rng.random(n) < 0.2] = None
    u64_edge = np.resize(np.array(U64_EDGE, dtype=np.uint64), n)
    u64_edge[::3] = rng.integers(1 << 63, (1 << 64) - 1, len(u64_edge[::3]),
                                 dtype=np.uint64, endpoint=True)
    lits = [0, 7, -1, -129, 127, 300, 40000, -(1 << 40), 1 << 40,
            (1 << 63) + 5, 1.5, -0.0, float("nan"), float("inf")]
    return [
        ("Int64", rng.integers(-100, 100, n), lits),               # int8
        ("Int64", rng.integers(-30000, 30000, n), lits),           # int16
        ("Int64", (np.arange(n) * 2654435761) % 1_000_003, lits),  # int32
        ("Int64", big, lits + [int(big[5]), -(1 << 63) + 1]),
        ("UInt8", rng.integers(0, 256, n).astype(np.uint8), lits),
        ("UInt16", rng.integers(0, 65536, n).astype(np.uint16), lits),
        ("UInt32", rng.integers(0, 1 << 32, n).astype(np.uint32), lits),
        ("UInt64", u64, lits + [int(u64[3]), (1 << 64) - 1]),
        ("UInt64", rng.integers(0, 200, n).astype(np.uint64), lits),
        ("Float32", f.astype(np.float32), lits + [float(np.float32(f[7]))]),
        ("Float64", f.astype(np.float32).astype(np.float64), lits),
        ("Float64", f, lits + [float(f[9])]),
        ("Nullable(Int32)", nul, lits),
        # UInt64 values whose float64 a second rounding would change
        ("UInt64", u64_edge, lits + [9544035305396816000.0,
                                     9223372036854777856.0,
                                     float(1 << 63), 2.0 ** 64]),
    ]


def make_term(values, type_name, cmp, lit, dev):
    """The executor's K1 term for `c CMP lit` over a column of `values`."""
    from clickhouse_tpu_torch.core import dtypes as dt
    from clickhouse_tpu_torch.core.column import column_from_numpy
    from clickhouse_tpu_torch.exec.executor import _filter_term
    from clickhouse_tpu_torch.exprs.expr import (BoundCall, BoundColumn,
                                                 BoundLiteral,
                                                 colval_from_column)
    col = column_from_numpy(np.asarray(values), dt.parse_type_name(type_name),
                            device=dev)
    cv = colval_from_column(col)
    expr = BoundCall(cmp, [BoundColumn("c", cv.dtype), BoundLiteral(
        lit, dt.parse_type_name(_lit_type(lit)))], dt.UInt8)
    term = _filter_term(expr, {"c": cv}, col.capacity)
    if term is None:
        fail(f"`{type_name} {cmp} {lit!r}` did not become a K1 term")
    return term


def check_k1_terms(dev) -> int:
    """K1 with filter terms against its plain version: every case of
    term_cases, every comparison, row bounds off the 16-row grid (and 0),
    a count, a sum and a min of a second column, and views starting 1 and
    3 rows in (misaligned for every type).  -> calls compared."""
    import dataclasses
    from clickhouse_tpu_torch.ops.agg_ops import (_masked_reduce_plain,
                                                  masked_reduce)
    rng = np.random.default_rng(4)
    n = 10_007
    calls = 0
    for type_name, values, lits in term_cases(rng, n):
        y = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, n)).to(dev)
        for cmp in CMPS:
            for lit in lits:
                t = make_term(values, type_name, cmp, lit, dev)
                data = torch.zeros(t.storage.shape[0], dtype=torch.int64,
                                   device=dev)
                data[:n] = y
                for rows in (n, n - 5, 0):
                    for op, d in (("sum", None), ("sum", data),
                                  ("min", data)):
                        max_abs_err(
                            masked_reduce(op, d, None, n_rows=rows,
                                          terms=[t]),
                            _masked_reduce_plain(op, d, None, False, rows,
                                                 [t]))
                        calls += 1
                for off in (1, 3):
                    tv = dataclasses.replace(
                        t, storage=t.storage[off:],
                        validity=None if t.validity is None
                        else t.validity[off:])
                    for d in (None, data[off:]):
                        max_abs_err(
                            masked_reduce("sum", d, None, n_rows=n - 9,
                                          terms=[tv]),
                            _masked_reduce_plain("sum", d, None, False,
                                                 n - 9, [tv]))
                        calls += 1
    return calls


def check_k1(dev):
    from clickhouse_tpu_torch.ops.agg_ops import (_masked_reduce_plain,
                                                  masked_reduce)
    g = torch.Generator(device="cpu").manual_seed(1)
    n = 1_000_003
    mask = torch.rand(n, generator=g) < 0.3
    cases = []
    for dtype in (torch.bool, torch.int8, torch.uint8, torch.int16,
                  torch.int32, torch.int64, torch.float32, torch.float64):
        if dtype.is_floating_point:
            x = torch.randn(n, generator=g, dtype=torch.float64) * 1e6
            x[::97] = -0.0
            x[::89] = float("nan")
            x = x.to(dtype)
        elif dtype == torch.bool:
            x = torch.rand(n, generator=g) < 0.5
        else:
            info = torch.iinfo(dtype)
            x = torch.randint(info.min, info.max, (n,), generator=g,
                              dtype=torch.int64).to(dtype)
        for op in ("sum", "min", "max", "any", "bor", "band", "bxor"):
            if op in ("bor", "band", "bxor") and dtype.is_floating_point:
                continue
            for m in (None, mask, torch.zeros(n, dtype=torch.bool)):
                cases.append((op, x, m, False))
    u64 = torch.tensor([1, -1, 5, -(1 << 63)], dtype=torch.int64)
    cases += [("min", u64, None, True), ("max", u64, None, True),
              ("sum", torch.full((10_000,), 1 << 62, dtype=torch.int64),
               None, False)]
    for op, x, m, uns in cases:
        want = _masked_reduce_plain(op, x.to(dev),
                                    None if m is None else m.to(dev), uns)
        got = masked_reduce(op, x.to(dev), None if m is None else m.to(dev),
                            unsigned=uns)
        max_abs_err(got, want)
    n_terms = check_k1_terms(dev)
    print(f"K1 masked_reduce edge cases: {len(cases)} without terms and "
          f"{n_terms} with filter terms agree", flush=True)


def check_k2(dev):
    from clickhouse_tpu_torch.ops.mxu_segsum import (
        _dense_group_reduce_plain, dense_group_reduce)
    g = torch.Generator(device="cpu").manual_seed(2)
    n = 3_000_000
    for S in (1, 1000, 16384):
        ids = torch.randint(-3, S + 3, (n,), generator=g, dtype=torch.int32)
        base = torch.rand(n, generator=g) < 0.9
        cm = [None, torch.rand(n, generator=g) < 0.5]
        sv = [torch.randint(-(1 << 62), 1 << 62, (n,), generator=g),
              torch.randint(-(1 << 31), (1 << 31) - 1, (n,), generator=g,
                            dtype=torch.int64).to(torch.int32),
              torch.rand(n, generator=g) < 0.5]
        sm = [None, torch.rand(n, generator=g) < 0.5, None]

        def on(ts):
            return [None if t is None else t.to(dev) for t in ts]
        args = (ids.to(dev), base.to(dev), on(cm), on(sv), on(sm), S)
        want = _dense_group_reduce_plain(*args)
        got = dense_group_reduce(*args)
        for a, b in zip(got, want):
            max_abs_err(a, b)
    # skewed keys, where lanes of a warp share a slot: one slot, Zipf(1.1)
    # over 1,024 slots; both count masks None (counted once, then copied)
    zipf = np.random.default_rng(2).zipf(1.1, n)
    x = torch.randint(-(1 << 62), 1 << 62, (n,), generator=g)
    for S, ids in ((1, torch.zeros(n, dtype=torch.int32)),
                   (1024, torch.from_numpy(((zipf - 1) % 1024)
                                           .astype(np.int32)))):
        args = (ids.to(dev), None, [None, None], [x.to(dev)], [None], S)
        want = _dense_group_reduce_plain(*args)
        got = dense_group_reduce(*args)
        for a, b in zip(got, want):
            max_abs_err(a, b)
    # one mask tensor counted twice (counted once), and one count and one
    # sum over S = 4,096 (one 48 KB histogram), 8,192 (one of 96 KB) and
    # 16,384 (two 96 KB tiles)
    m = torch.rand(n, generator=g) < 0.5
    for S, cms in ((1024, [m, None, m]), (4096, [None]), (8192, [None]),
                   (16384, [None])):
        ids = torch.randint(-3, S + 3, (n,), generator=g, dtype=torch.int32)
        md = m.to(dev)
        args = (ids.to(dev), None, [md if c is m else None for c in cms],
                [x.to(dev)], [md], S)
        want = _dense_group_reduce_plain(*args)
        for a, b in zip(dense_group_reduce(*args), want):
            max_abs_err(a, b)
    print("K2 dense_group_reduce edge cases: S in (1, 1000, 16384), one "
          "slot, Zipf(1.1) slots, a mask counted twice, S in (4096, 8192, "
          "16384) with one count and one sum agree", flush=True)


def check_k3(dev):
    from clickhouse_tpu_torch.ops.sort_ops import (_topk_smallest32_plain,
                                                   _topk_smallest_plain,
                                                   topk_smallest,
                                                   topk_smallest32)
    g = torch.Generator(device="cpu").manual_seed(3)
    for n, k in ((7, 3), (7, 50), (5000, 100), (3_000_000, 4096),
                 (3_000_000, 1)):
        tok = torch.randint(-40, 40, (n,), generator=g) * (1 << 57)
        valid = torch.rand(n, generator=g) < 0.8
        desc = torch.arange(n, 0, -1, dtype=torch.int64)  # all rows admitted
        for tok, v in ((tok, valid), (tok, None), (desc, None)):
            want = _topk_smallest_plain(tok.to(dev),
                                        None if v is None else v.to(dev), k)
            got = topk_smallest(tok.to(dev),
                                None if v is None else v.to(dev), k)
            m = min(n if v is None else int(v.sum()), k)
            max_abs_err(got[:m], want[:m])
    for n, k in ((7, 3), (7, 50), (5000, 100), (3_000_000, 100),
                 (3_000_000, 4096), (3_000_000, 1)):
        rnd = torch.randint(-(1 << 31), (1 << 31) - 1, (n,), generator=g,
                            dtype=torch.int64).to(torch.int32)
        rnd[torch.rand(n, generator=g) < 0.2] = 7          # ties
        rnd[:4] = torch.tensor([-1, -2, -1, 0], dtype=torch.int32)[:n]
        valid = torch.rand(n, generator=g) < 0.8
        keys = {"random": rnd,
                # every row beats the k-th best so far: all rows admitted
                "descending": torch.arange(n, 0, -1, dtype=torch.int32),
                "ascending": torch.arange(n, dtype=torch.int32),
                # one key: ties across every block boundary
                "constant": torch.full((n,), 5, dtype=torch.int32)}
        for key in keys.values():
            for v in (valid, None):
                want = _topk_smallest32_plain(
                    key.to(dev), None if v is None else v.to(dev), k)
                got = topk_smallest32(key.to(dev),
                                      None if v is None else v.to(dev), k)
                m = min(n if v is None else int(v.sum()), k)
                max_abs_err(got[:m], want[:m])
    print("K3 topk_smallest edge cases (64-bit and 32-bit entries): ties, "
          "keys 2^32-2 and 2^32-1, invalid rows, k > n, monotone keys, "
          "ties across blocks agree", flush=True)


# multi-key sorts of the sort_key_columns, least significant key last
SORT_KEY_CHAINS = [["bool", "int32_bounded"], ["float64", "uint64", "int64"],
                   ["uint64", "float64", "float32", "bool"]]


def sort_key_columns(rng, n):
    """CPU SortKeys of n rows for every kind of key K4 sorts: signed and
    unsigned ints, UInt64 bits above 2^63, floats with NaN, -0.0 and +0.0,
    bools and a bounded int32 (Q2b's key)."""
    from clickhouse_tpu_torch.ops.sort_ops import SortKey
    f = rng.normal(0, 1, n)
    f[rng.random(n) < 0.05] = np.nan
    f[rng.random(n) < 0.05] = -0.0
    f[rng.random(n) < 0.05] = 0.0
    u = rng.integers(0, 4, n).astype(np.uint64) << np.uint64(62)
    return {
        "int64": SortKey(torch.from_numpy(rng.integers(-3, 3, n))),
        "uint64": SortKey(torch.from_numpy(u.view(np.int64)), unsigned=True),
        "float64": SortKey(torch.from_numpy(f)),
        "float32": SortKey(torch.from_numpy(f.astype(np.float32))),
        "int16": SortKey(torch.from_numpy(
            rng.integers(-300, 300, n).astype(np.int16))),
        "uint8": SortKey(torch.from_numpy(
            rng.integers(0, 256, n).astype(np.uint8))),
        "bool": SortKey(torch.from_numpy(rng.random(n) < 0.5),
                        bounds=(0, 1)),
        "int32_bounded": SortKey(torch.from_numpy(
            rng.integers(0, 1_000_003, n).astype(np.int32)),
            bounds=(0, 1_000_002)),
    }


# K4 row counts: one row, off the tile grid, one u32 tile (8,192 rows)
# and one more row, and more tiles than an H100 holds at once (132 SMs x
# 2 blocks x 8,192 rows), so the look-back waits on running tiles
K4_ROWS = (1, 4095, 8192, 8193, 1_000_003, 5_000_011)


def k4_keys(rng, n):
    """(key as u32 / u64 bits, significant bits) cases of K4 at n rows."""
    return [
        (torch.from_numpy(rng.integers(0, 1 << 21, n).astype(np.int32)), 21),
        (torch.from_numpy(rng.integers(0, 1 << 32, n, dtype=np.uint64)
                          .astype(np.uint32).view(np.int32)), 32),
        (torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, n,
                                       dtype=np.int64)), 64),
        (torch.from_numpy(rng.integers(0, 3, n).astype(np.int64) << 62), 64),
        # one digit takes every row of every tile
        (torch.full((n,), 5, dtype=torch.int32), 3),
        # the top digit (bits 14-20) is constant
        (torch.from_numpy((rng.integers(0, 1 << 14, n) | (77 << 14))
                          .astype(np.int32)), 21),
        (torch.zeros(n, dtype=torch.int64), 0)]


def check_k4(dev):
    """K4 against its plain version: raw keys (K4_ROWS: one row, one tile
    and one more row, more tiles than the card holds at once; all-equal
    keys, a constant top digit, u64 keys above 2^63, 0 bits; row ids and
    given values, and a u64 chain of two calls), and the whole pass plan of
    sort_rows (every key type's token, NaN and -0.0, invalid rows, no
    valid row, multi-key chains) on the card against the same call on the
    CPU copies."""
    import dataclasses
    from clickhouse_tpu_torch.ops.sort_ops import (
        _radix_sort_pairs_plain, radix_sort_pairs, sort_rows)
    rng = np.random.default_rng(6)
    calls = 0
    for n in K4_ROWS:
        perm = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev)
        for key, bits in k4_keys(rng, n):
            for vals in (None, perm):
                got = radix_sort_pairs(key.to(dev), bits, vals)
                want = _radix_sort_pairs_plain(key.to(dev), bits, vals)
                for a, b in zip(got, want):
                    max_abs_err(a, b)
                calls += 1
        # a chain: the low u64 key, then the high one in the order so far
        lo, hi = (torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, n,
                                                dtype=np.int64)).to(dev)
                  for _ in range(2))
        p_got = radix_sort_pairs(lo, 64)[1]
        p_want = _radix_sort_pairs_plain(lo, 64, None)[1]
        got = radix_sort_pairs(hi[p_got.long()], 64, p_got)
        want = _radix_sort_pairs_plain(hi[p_want.long()], 64, p_want)
        for a, b in zip(got, want):
            max_abs_err(a, b)
        calls += 1
    n = 1_000_003
    cols = sort_key_columns(rng, n)
    chains = [[k] for k in cols] + SORT_KEY_CHAINS
    valids = [None, torch.from_numpy(rng.random(n) < 0.8),
              torch.zeros(n, dtype=torch.bool)]
    for names in chains:
        for valid in valids:
            keys = [cols[k] for k in names]
            want, wk = sort_rows(keys, valid)
            got, gk = sort_rows(
                [dataclasses.replace(k, data=k.data.to(dev)) for k in keys],
                None if valid is None else valid.to(dev))
            m = n if valid is None else int(valid.sum())
            max_abs_err(got.cpu()[:m], want[:m])
            for a, b in zip(gk, wk):
                max_abs_err(a.cpu()[:m], b[:m])
            calls += 1
    print(f"K4 radix_sort_pairs edge cases: {calls} calls agree (raw keys "
          f"and a u64 chain at n in {K4_ROWS}; sort_rows over every key "
          f"type, chains, invalid rows and no valid row)", flush=True)


# K5's edge cases (k5_case): the look-back across tiles of 4,096 rows
K5_CASES = ("one_row", "under_a_tile", "tile_multiple_plus_one",
            "group_over_100_tiles", "boundary_at_tile_heads", "one_group",
            "group_a_row", "over_cap", "invalid_rows", "no_valid_row",
            "u64_keys", "two_keys", "four_keys", "five_keys",
            "u32_view_1_in", "u32_view_3_in", "u64_view_1_in")


def k5_case(name, rng):
    """(sorted key arrays (numpy, int32 or int64 bits), valid rows, group
    slots, rows to skip: the array is a view that starts there) of one K5
    edge case."""
    tile = 4096
    n = 1_000_003
    base = np.sort(rng.integers(0, 200_000, n))
    if name == "one_row":
        return [np.array([7], np.int32)], 1, 4, 0
    if name == "under_a_tile":
        return [np.sort(rng.integers(0, 300, 1000)).astype(np.int32)], \
            1000, 1 << 12, 0
    if name == "tile_multiple_plus_one":
        m = 3 * tile + 1
        return [np.sort(rng.integers(0, 2000, m)).astype(np.int32)], m, \
            1 << 12, 0
    if name == "group_over_100_tiles":
        k = np.concatenate([np.zeros(100), np.ones(120 * tile + 7),
                            2 + np.sort(rng.integers(0, 5000, 200_000))])
        return [k.astype(np.int32)], len(k), 1 << 14, 0
    if name == "boundary_at_tile_heads":
        m = 40 * tile + 17
        return [(np.arange(m) // tile).astype(np.int32)], m, 64, 0
    if name == "one_group":
        return [np.zeros(n, np.int32)], n, 1 << 20, 0
    if name == "group_a_row":
        return [np.arange(n, dtype=np.int64)], n, 1 << 20, 0
    if name == "over_cap":
        return [(np.arange(n) // 3).astype(np.int32)], n, 1024, 0
    if name == "invalid_rows":
        return [base.astype(np.int32)], n - 54_321, 1 << 18, 0
    if name == "no_valid_row":
        return [base.astype(np.int32)], 0, 1 << 18, 0
    if name == "u64_keys":
        u = np.sort(rng.integers(0, 1 << 64, n // 40, dtype=np.uint64,
                                 endpoint=False))
        return [np.repeat(u, 40).view(np.int64)], n - n % 40 - 99, 1 << 16, 0
    if name in ("two_keys", "four_keys", "five_keys"):
        extra = {"two_keys": 1, "four_keys": 3, "five_keys": 4}[name]
        keys = [base.astype(np.int32)]
        for p in (7, 3, 5, 2)[:extra]:
            k = np.where(base % p == 0, rng.integers(0, 2, n), 0)
            keys.append(k.astype(np.int64 if p % 2 else np.int32))
        return keys, n - 11, 1 << 18, 0
    if name.startswith("u32_view"):
        off = int(name.split("_")[2])
        return [base.astype(np.int32)], n - off - 5, 1 << 18, off
    if name == "u64_view_1_in":
        return [base.astype(np.int64) << 30], n - 1, 1 << 18, 1
    raise ValueError(name)


def k5_args(name, rng, dev):
    """One K5 edge case as the wrapper's arguments on `dev`."""
    keys, nv, cap_g, off = k5_case(name, rng)
    kd = [torch.from_numpy(k).to(dev)[off:] for k in keys]
    return kd, torch.tensor(nv, dtype=torch.int64, device=dev), cap_g


def check_k5(dev):
    """K5 against its plain version on every case of K5_CASES: one row, a
    part of a tile, a tile multiple and one row, a group over 100 tiles, a
    boundary at every tile's first row, one group, a group a row, more
    groups than slots, invalid rows, no valid row, u64 keys, two, four and
    five key arrays, and key arrays that do not start on a 16-byte
    boundary."""
    from clickhouse_tpu_torch.ops.scan_ops import (_segment_bounds_plain,
                                                   segment_bounds)
    rng = np.random.default_rng(7)
    for name in K5_CASES:
        kd, nvt, cap_g = k5_args(name, rng, dev)
        for a, b in zip(segment_bounds(kd, nvt, cap_g),
                        _segment_bounds_plain(kd, nvt, cap_g)):
            max_abs_err(a, b)
    print(f"K5 segment_bounds edge cases agree: {', '.join(K5_CASES)}",
          flush=True)


def grouped_rows(n, groups, dev, skew=None, seed=8):
    """(perm, gid) of n rows over `groups` groups, key-sorted on the card
    (a `skew` share of the rows in one group), the rows of each group in
    ascending row order: what K4 and K5 give K6."""
    g = torch.Generator(device=dev).manual_seed(seed)
    key = torch.randint(0, groups, (n,), generator=g, device=dev)
    if skew is not None:
        key[torch.rand(n, generator=g, device=dev) < skew] = groups // 2
    order = torch.sort(key, stable=True)
    ks = order.values
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = ks[1:] != ks[:-1]
    gid = (torch.cumsum(head.to(torch.int32), 0) - 1).to(torch.int32)
    return order.indices.to(torch.int32), gid


def k6_agrees(specs, perm, gid, cap_g, group_rows=None) -> float:
    """K6 (one segment_reduce_many call over `specs`) against its plain
    version, spec by spec, on the same inputs; float sums within
    n_g * eps * sum(|x|) a group of n_g masked-in rows.  -> max abs err."""
    from clickhouse_tpu_torch.ops.scan_ops import (_segment_reduce_plain,
                                                   segment_reduce_many)
    got = segment_reduce_many(specs, perm, gid, cap_g, group_rows=group_rows)
    err = 0.0
    for (op, data, mask, uns), g in zip(specs, got):
        want = _segment_reduce_plain(op, data, mask, perm, gid, cap_g, uns)
        err = max(err, k6_close(op, g, want, data, mask, perm, gid, cap_g,
                                uns))
    return err


def k6_close(op, got, want, data, mask, perm, gid, cap_g,
             unsigned=False) -> float:
    """One K6 result against the plain version's: exact, but for float
    sums within n_g * eps * sum(|x|) a group.  -> max abs err."""
    from clickhouse_tpu_torch.ops.scan_ops import (_built,
                                                   _segment_reduce_plain,
                                                   fsumx_column)
    if op == "fsumx":
        op, data = "sum", fsumx_column(data, unsigned)
    data = _built(data)
    if not (op == "sum" and got.is_floating_point()):
        if got.is_floating_point():     # min/max/any: the same bits
            bits = torch.int64 if got.dtype == torch.float64 else torch.int32
            got, want = got.view(bits), want.view(bits)
        return max_abs_err(got, want)
    scale = _segment_reduce_plain("sum", data.abs().to(torch.float64), mask,
                                  perm, gid, cap_g, False)
    cnt = _segment_reduce_plain("count", None, mask, perm, gid, cap_g,
                                False)
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        fail(f"K6 {op}: NaN groups differ")
    err = (got - want).abs()[~nan]
    if not bool((err <= (cnt.to(torch.float64) * F64_EPS * scale)[~nan])
                .all()):
        fail(f"K6 float sum beyond n_g * eps * sum(|x|) a group")
    return float(err.max()) if err.numel() else 0.0


def k6_values(rng, dtype, n):
    """n values of dtype for K6's cases (floats with -0.0 and NaN)."""
    if dtype.is_floating_point:
        x = torch.from_numpy(rng.normal(0, 1e6, n)).to(dtype)
        x[::97] = -0.0
        x[::89] = float("nan")
    elif dtype == torch.bool:
        x = torch.from_numpy(rng.random(n) < 0.5)
    else:
        info = torch.iinfo(dtype)
        x = torch.from_numpy(rng.integers(info.min, info.max, n,
                                          endpoint=True)).to(dtype)
    return x


# K6's Term divisors over int8, int16 and int32 storage: 2, 7, 1024 where
# it fits, -3 and the type's MIN and MAX
K6_TERM_DIVISORS = ((2, 7, -3, 127, -128), (2, 7, 1024, -3, 32767, -32768),
                    (2, 7, 1024, -3, (1 << 31) - 1, -(1 << 31)))


def k6_many_specs(rng, n, dev):
    """Spec lists of one K6 launch: Q2m's four ops over one column; two
    columns (int64, float64) under two masks and none, with counts;
    eleven specs over five columns, which take more than one launch;
    Q2s2's seven reductions over x and x % 7 as a Term; and every op over
    intDiv and modulo Terms of int8, int16 and int32 storage by
    K6_TERM_DIVISORS (more forms than one launch takes)."""
    from clickhouse_tpu_torch.ops.scan_ops import Term
    x = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, n)).to(dev)
    f = k6_values(rng, torch.float64, n).to(dev)
    m1 = torch.from_numpy(rng.random(n) < 0.3).to(dev)
    m2 = torch.from_numpy(rng.random(n) < 0.7).to(dev)
    narrow = [k6_values(rng, t, n).to(dev) for t in (torch.int8, torch.int16,
                                                     torch.int32)]
    i32 = narrow[2]
    u = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, n,
                                      dtype=np.int64)).to(dev)
    g = k6_values(rng, torch.float32, n).to(dev)
    # Terms (intDiv/modulo by a constant, formed in registers) over each
    # signed narrow storage with its MIN and MAX among the values
    for t in narrow:
        info = torch.iinfo(t.dtype)
        t[:2] = torch.tensor([info.min, info.max], dtype=t.dtype)
    mod7 = Term(i32, "mod", 7, torch.int64)
    return {
        "q2m": [("sum", x, None, False), ("min", x, None, False),
                ("max", x, None, False), ("any", x, None, False)],
        # the statistics' terms, formed in registers (OP_FSUMX): Q2s2's
        # shape (x and y as stored, squares and a product) and every
        # power over narrow, UInt64, float32 and float64 columns
        "f64_terms": [("fsumx", (i32, None, p), m1 if p % 2 else None,
                       (False, False)) for p in (1, 2, 3, 4)]
        + [("fsumx", (i32, narrow[0], 1), None, (False, False)),
           ("fsumx", (narrow[0], None, 2), m2, (False, False)),
           ("max", narrow[0], None, False), ("bxor", i32, None, False)],
        "f64_term_types": [
            ("fsumx", (u, None, 2), None, (True, False)),
            ("fsumx", (u, f, 1), m1, (True, False)),
            ("fsumx", (g, None, 3), None, (False, False)),
            ("fsumx", (f, None, 4), m2, (False, False)),
            ("fsumx", (narrow[1], g, 1), None, (False, False)),
            ("fsumx", (narrow[0], u, 4), None, (False, True))],
        "two_columns_two_masks": [
            ("sum", x, m1, False), ("min", f, m1, False),
            ("max", x, m2, False), ("sum", f, m2, False),
            ("count", None, m1, False), ("any", f, None, False),
            ("bxor", x, None, True), ("count", None, m2, False)],
        "split": [(op, c, m, False) for c in narrow + [x, f]
                  for op, m in (("min", m1), ("sum", None))]
        + [("band", x, m2, False)],
        # Q2s2's shape: max of x % 7, the statistics' terms of x and
        # x % 7, bxor of x: one source column, four forms
        "q2s2_terms": [("max", mod7, None, False),
                       ("fsumx", (i32, None, 1), None, (False, False)),
                       ("fsumx", (i32, None, 2), None, (False, False)),
                       ("fsumx", (i32, mod7, 1), None, (False, False)),
                       ("fsumx", (mod7, None, 1), None, (False, False)),
                       ("fsumx", (mod7, None, 2), None, (False, False)),
                       ("bxor", i32, None, False),
                       ("count", None, None, False)],
        # every op over each term kind, storage and divisor
        "term_ops": [(op, Term(src, kind, c, torch.int64), m, False)
                     for src, cs in zip(narrow, K6_TERM_DIVISORS)
                     for kind in ("div", "mod") for c in cs
                     for op, m in (("sum", None), ("min", m1),
                                   ("max", None), ("bxor", m2),
                                   ("any", m1))]
        + [("fsumx", (Term(narrow[1], "div", 1024, torch.int64),
                      Term(narrow[1], "mod", -3, torch.int32), 2), m2,
            (False, False)), ("band", Term(i32, "div", -3, torch.int32),
                              None, False)],
    }


def check_k6(dev):
    """K6 against its plain version: every op over every storage type, with
    no mask, a partial mask and a mask of no row (empty and fully masked
    groups), UInt64 bits, 3M rows where one group holds 40 %, and several
    specs in one call (k6_many_specs), with and without group_rows."""
    from clickhouse_tpu_torch.ops.scan_ops import _segment_reduce_plain
    rng = np.random.default_rng(9)
    n = 1_000_003
    perm, gid = grouped_rows(n, 70_000, dev)
    masks = [None, torch.from_numpy(rng.random(n) < 0.3).to(dev),
             torch.zeros(n, dtype=torch.bool, device=dev)]
    calls = 0
    for dtype in (torch.bool, torch.int8, torch.uint8, torch.int16,
                  torch.int32, torch.int64, torch.float32, torch.float64):
        x = k6_values(rng, dtype, n)
        for op in ("sum", "min", "max", "any", "bor", "band", "bxor",
                   "count"):
            if op in ("bor", "band", "bxor") and dtype.is_floating_point:
                continue
            for m in masks:
                for uns in ((False, True) if dtype == torch.int64
                            else (False,)):
                    k6_agrees([(op, None if op == "count" else x.to(dev), m,
                                uns)], perm, gid, 1 << 17)
                    calls += 1
    rows = _segment_reduce_plain("count", None, None, perm, gid, 1 << 17,
                                 False)
    for specs in k6_many_specs(rng, n, dev).values():
        for group_rows in (None, rows):
            k6_agrees(specs, perm, gid, 1 << 17, group_rows)
            calls += 1
    sperm, sgid = grouped_rows(3_000_000, 200_000, dev, skew=0.4)
    y = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, 3_000_000)).to(dev)
    for op in ("sum", "min", "max", "any", "count"):
        k6_agrees([(op, None if op == "count" else y, None, False)], sperm,
                  sgid, 1 << 18)
        calls += 1
    k6_agrees([(op, y, None, False) for op in ("sum", "min", "max", "any")],
              sperm, sgid, 1 << 18)
    calls += 1
    # many groups a warp (a run a row slot, each run its own atomic): two
    # rows a group and a group a row
    many = k6_many_specs(rng, n, dev)
    g = torch.Generator(device=dev).manual_seed(15)
    for p2, g2 in (grouped_rows(n, n // 2, dev, seed=15),
                   (torch.randperm(n, generator=g, device=dev).to(
                       torch.int32),
                    torch.arange(n, dtype=torch.int32, device=dev))):
        for case in ("q2m", "two_columns_two_masks", "q2s2_terms"):
            k6_agrees(many[case], p2, g2, n)
            calls += 1
    for case in ("term_ops", "q2s2_terms"):
        k6_agrees(many[case], perm, gid, 1 << 17)
        calls += 1
    print(f"K6 segment_reduce edge cases: {calls} calls agree (every op "
          f"and storage type, masks of some and of no row, a group of 40 % "
          f"of the rows, several specs over two columns and two masks in "
          f"one launch, Terms of int8/16/32 storage by {K6_TERM_DIVISORS}, "
          f"two rows a group and a group a row)",
          flush=True)


def k6_sorted_agree(specs, gid, cap_g, group_rows=None) -> float:
    """K6's sorted-order entry over `specs` (data and masks in sorted
    order) with the groups of `gid` given as their bounds, against its
    plain version over `gid` itself (which also holds the bounds' plain
    form to the group ids); float sums within n_g * eps * sum(|x|).
    -> max abs err."""
    from clickhouse_tpu_torch.ops.scan_ops import (_segment_reduce_plain,
                                                   bounds_of_gid,
                                                   gid_of_bounds,
                                                   segment_reduce_sorted)
    n = gid.shape[0]
    starts, ends = bounds_of_gid(gid, cap_g)
    if not torch.equal(gid_of_bounds(starts, ends, n),
                       torch.clamp(gid, max=cap_g)):
        fail("gid_of_bounds differs from the group ids")
    got = segment_reduce_sorted(specs, starts, ends, n,
                                group_rows=group_rows)
    e = 0.0
    for (op, d, m, u), r in zip(specs, got):
        want = _segment_reduce_plain(op, d, m, None, gid, cap_g, u)
        e = max(e, k6_close(op, r, want, d, m, None, gid, cap_g, u))
    return e


def sorted_gid(n, groups, dev, skew=None, seed=8, invalid=0):
    """Group ids of n sorted rows (grouped_rows'), the last `invalid` rows
    without a slot."""
    _, gid = grouped_rows(n, groups, dev, skew=skew, seed=seed)
    if invalid:
        gid[-invalid:] = torch.iinfo(torch.int32).max
    return gid


# K6 sorted entry's group layouts beyond the op cases: (rows, groups,
# cap_g, skew, invalid rows): one-row groups, more groups than slots (the
# rows past the last slot have none), a group over many tiles, groups of
# 2,049 rows (a boundary at every tile's second row), fewer groups than
# slots (empty slots past the last group)
K6_SORTED_LAYOUTS = ((50_001, 50_001, 1 << 16, None, 0),
                     (200_000, 150_000, 100_000, None, 0),
                     (3_000_000, 1_000, 1 << 11, 0.4, 7),
                     (2_049 * 300, 300, 512, None, 0),
                     (1_000_003, 70_000, 1 << 20, None, 5000))


def check_k6_sorted(dev):
    """K6's sorted-order entry (segment_reduce_sorted: data and masks
    already in sorted order, the groups as K5's starts and ends, no
    permutation and no group id) against its plain version: every op over
    int8, uint8, int16, int32, int64, float32, float64 and bool data, with
    no mask, a partial mask, a mask of no row and a mask of no row in
    every other group (fully masked groups), UInt64 bits, empty slots past
    the last group and invalid rows past the last valid one, several specs
    in one launch with and without group_rows (Terms among them), 3M rows
    where one group holds 40 %, and K6_SORTED_LAYOUTS."""
    rng = np.random.default_rng(12)
    n, cap_g = 1_000_003, 1 << 17
    gid = sorted_gid(n, 70_000, dev, seed=12, invalid=5000)
    masks = [None, torch.from_numpy(rng.random(n) < 0.3).to(dev),
             torch.zeros(n, dtype=torch.bool, device=dev),
             (gid % 2 == 1) & torch.from_numpy(rng.random(n) < 0.8).to(dev)]
    calls, err = 0, 0.0
    for dtype in (torch.bool, torch.int8, torch.uint8, torch.int16,
                  torch.int32, torch.int64, torch.float32, torch.float64):
        x = k6_values(rng, dtype, n).to(dev)
        for op in ("sum", "min", "max", "any", "bor", "band", "bxor",
                   "count"):
            if op in ("bor", "band", "bxor") and dtype.is_floating_point:
                continue
            for m in masks:
                for uns in ((False, True) if dtype == torch.int64
                            else (False,)):
                    err = max(err, k6_sorted_agree(
                        [(op, None if op == "count" else x, m, uns)], gid,
                        cap_g))
                    calls += 1
    from clickhouse_tpu_torch.ops.scan_ops import _segment_reduce_plain
    rows = _segment_reduce_plain("count", None, None, None, gid, cap_g,
                                 False)
    for specs in k6_many_specs(rng, n, dev).values():
        for group_rows in (None, rows):
            err = max(err, k6_sorted_agree(specs, gid, cap_g, group_rows))
            calls += 1
    sgid = sorted_gid(3_000_000, 200_000, dev, skew=0.4, seed=13)
    y = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, 3_000_000)).to(dev)
    f = k6_values(rng, torch.float64, 3_000_000).to(dev)
    for op in ("sum", "min", "max", "any", "count"):
        for d in (y, f):
            err = max(err, k6_sorted_agree(
                [(op, None if op == "count" else d, None, False)], sgid,
                1 << 18))
            calls += 1
    for rows_, groups, cg, skew, invalid in K6_SORTED_LAYOUTS:
        if groups == rows_:               # a group a row
            lgid = torch.arange(rows_, dtype=torch.int32, device=dev)
        elif skew is None and rows_ == groups * 2049:
            lgid = torch.arange(rows_, dtype=torch.int32,
                                device=dev) // 2049
        else:
            lgid = sorted_gid(rows_, groups, dev, skew=skew, seed=14,
                              invalid=invalid)
        lgid = torch.where(lgid >= cg, cg, lgid).to(torch.int32)
        d = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40,
                                          rows_)).to(dev)
        m = torch.from_numpy(rng.random(rows_) < 0.5).to(dev)
        err = max(err, k6_sorted_agree(
            [("sum", d, None, False), ("min", d, m, False),
             ("any", d, m, False), ("count", None, m, False),
             ("count", None, None, False)], lgid, cg))
        calls += 1
    print(f"K6 sorted-order entry edge cases: {calls} calls agree with the "
          f"plain version (every op and storage type, masks of some rows, "
          f"of no row and of no row in every other group, invalid rows, a "
          f"group of 40 % of the rows, several specs and Terms in one "
          f"launch, one-row groups, more groups than slots, a group over "
          f"many tiles); max abs err {err:g}", flush=True)
    return err


# K7's edge cases (k7_case): the direct-address join.  Words carry their
# proven range (as the executor gives them) unless a case says otherwise,
# so the table is narrow: label-like words in [0, 96] take one byte
K7_CASES = ("unique", "holes", "outside", "invalid_rows", "nullable_payload",
            "sentinel_below", "sentinel_above", "key_words", "presence",
            "int8_probe", "int16_probe", "int64_probe", "uint64_keys",
            "views_1_in", "views_2_in", "views_3_in", "width1_below",
            "width1_above", "width2_below", "width2_above", "width4_below",
            "width4_above", "packed_2_words", "packed_3_words",
            "packed_4_words", "packed_8_words", "rows_1", "rows_3",
            "rows_4k_plus_1", "int64_rows_3", "int8_payload",
            "wrapped_payload", "build_key_outside")
# a word's values at one edge of its width: (lowest value less the
# sentinel's side, span); the sentinel sits just outside
K7_WIDTHS = {"width1_below": (1, 255), "width1_above": (0, 255),
             "width2_below": (1, 65535), "width2_above": (0, 65535),
             "width4_below": (1, 1 << 24), "width4_above": (0, 1 << 24)}


def on_card(a, dev, off=0):
    """A numpy array on `dev`; off > 0: as a view that many rows into a
    longer tensor (so not on the allocation's alignment)."""
    a = np.ascontiguousarray(a)
    if off:
        a = np.concatenate([np.zeros(off, a.dtype), a])
    return torch.from_numpy(a).to(dev)[off:]


def _edge_word(rng, name, nb):
    """A width case's word entry: values at the bottom of the width with
    the sentinel just below them, or at its top with the sentinel just
    above; the 4-byte cases at the ends of int32."""
    below, span = K7_WIDTHS[name]
    if name.startswith("width4"):
        base = -2**31 if below else 2**31 - 1 - span
    else:
        base = int(rng.integers(-1000, 1000))
    vals = base + below + rng.integers(0, span, nb)
    vals[: 2] = (base + below, base + below + span - 1)      # both edges
    sentinel = base if below else base + span
    return ("word", vals.astype(np.int32), sentinel,
            (base + below, base + below + span - 1))


def k7_case(name, rng):
    """(build key, build valid, probe key, probe valid, words, lo, hi) of
    one K7 edge case, in numpy: words as the wrapper takes them (("word",
    int32 array, sentinel[, proven range]), ("key",), ("keyvalid",))."""
    lo, hi, nb, n = 0, 999_999, 600_000, 2_000_003
    kind = np.int32
    if name == "int8_probe":
        lo, hi, nb, n, kind = -100, 100, 150, 10_007, np.int8
    elif name == "int16_probe":
        lo, hi, nb, n, kind = -3000, 9000, 5000, 100_003, np.int16
    elif name in ("int64_probe", "int64_rows_3"):
        lo, hi, kind = -(1 << 40), -(1 << 40) + 999_999, np.int64
    n = {"rows_1": 1, "rows_3": 3, "int64_rows_3": 3,
         "rows_4k_plus_1": 4 * 250_007 + 1}.get(name, n)
    bk = rng.permutation(hi - lo + 1)[:nb].astype(np.int64) + lo
    if name == "unique":
        bk = rng.permutation(hi - lo + 1).astype(np.int64) + lo
        nb = len(bk)
    pk = rng.integers(lo, hi + 1, n)
    if name in ("outside", "int8_probe", "int16_probe"):
        span = 100 if name != "outside" else 1000
        pk = rng.integers(max(lo - span, np.iinfo(kind).min),
                          min(hi + span, np.iinfo(kind).max) + 1, n)
    bv = np.ones(nb, bool)
    pv = np.ones(n, bool)
    if name == "invalid_rows":
        bv = rng.random(nb) < 0.8
        pv = rng.random(n) < 0.7
    w = rng.integers(0, 97, nb).astype(np.int32)
    flag = (rng.random(nb) < 0.5).astype(np.int32)
    words = [("word", w, -1, (0, 96))]
    if name == "nullable_payload":
        words = [("word", w, 97, (0, 96)), ("word", flag, 2, (0, 1))]
    elif name == "sentinel_below":
        # words at the bottom of int32, the sentinel their lower bound - 1
        # (no proven range: four bytes a word)
        words = [("word", (w.astype(np.int64) - 2**31 + 5).astype(np.int32),
                  -2**31 + 4)]
    elif name == "sentinel_above":
        # words at the top of int32, the sentinel their upper bound + 1
        words = [("word", (w.astype(np.int64) + 2**31 - 100).astype(np.int32),
                  2**31 - 3)]
    elif name == "key_words":
        words = [("key",), ("word", w, -1, (0, 96)), ("keyvalid",)]
    elif name == "presence":
        words = []
    elif name in K7_WIDTHS:
        words = [_edge_word(rng, name, nb)]
    elif name.startswith("packed_"):
        # two to eight words of mixed widths side by side in one slot:
        # 2 + 1 bytes (a 4-byte slot), 4 + 1 + 1 (8), 4 + 4 + 2 + 1 (16),
        # eight of 4 bytes (32), with the key and its validity among them
        pool = [_edge_word(rng, "width1_above", nb), ("key",),
                _edge_word(rng, "width2_below", nb),
                _edge_word(rng, "width4_below", nb), ("keyvalid",),
                ("word", flag, 2, (0, 1)), _edge_word(rng, "width4_above",
                                                      nb)]
        words = {"packed_2_words": [pool[0], pool[1], pool[2]],
                 "packed_3_words": [pool[3], pool[0], pool[4], pool[5]],
                 "packed_4_words": [pool[0], pool[3], pool[2], pool[6],
                                    pool[1]],
                 "packed_8_words": [_edge_word(rng, "width4_" + (
                     "below" if j % 2 else "above"), nb)
                     for j in range(8)]}[name]
    elif name in ("int8_payload", "wrapped_payload"):
        # toInt8 of values in [0, 300]: stated as the int8 range (exact), or
        # as [0, 300], a range that does not hold (out_of_range set)
        w8 = rng.integers(0, 301, nb).astype(np.int8).astype(np.int32)
        w8[:2] = (-128, -1)
        words = [("word", w8, -129, (-128, 127))] \
            if name == "int8_payload" else [("word", w8, -1, (0, 300))]
    elif name == "build_key_outside":
        # one valid build key past the stated hi (out_of_range set)
        hi = int(bk.max()) - 1
    elif name == "uint64_keys":
        # UInt64 keys at and above 2^63 (int64 bits)
        lo = (1 << 63) + 5
        hi = lo + 999_999
        bk = (bk.astype(np.uint64) + np.uint64(lo)).view(np.int64)
        pk = (rng.integers(0, 1_000_100, n).astype(np.uint64)
              + np.uint64(lo - 50)).view(np.int64)
        kind = np.int64
    return bk, bv, pk.astype(kind), pv, words, lo, hi


def k7_args(name, rng, dev):
    """One K7 edge case as the wrapper's arguments on `dev` (views_1_in,
    views_2_in and views_3_in: every array a view that many rows into its
    tensor)."""
    bk, bv, pk, pv, words, lo, hi = k7_case(name, rng)
    off = int(name[6]) if name.startswith("views_") else 0

    def t(a):
        return on_card(a, dev, off)
    return (t(bk), t(bv), t(pk), t(pv),
            [(e[0], t(e[1])) + tuple(e[2:]) if e[0] == "word" else e
             for e in words], lo, hi)


def k7_outputs(res):
    """The outputs of one K7 call that its plain version defines: the
    out_of_range flag, and where it is 0 the match flags and the words (a
    stated range that does not hold leaves them undefined)."""
    if int(res.out_of_range):
        return [res.out_of_range]
    return [res.out_of_range, res.matched] + res.words


def check_k7(dev):
    """K7 against its plain version on every case of K7_CASES: unique keys
    filling the range, a range with holes, probe keys outside it, invalid
    build and probe rows, a Nullable payload (its validity word), the
    sentinel below and above the words (four bytes a word), the key's own
    words, a presence table, int8/int16/int64 probe keys, UInt64 keys
    above 2^63, views 1, 2 and 3 rows in, a narrow table at each width (1,
    2, 4 bytes) with the sentinel at that width's edges, two to eight
    words packed in one slot (4- to 32-byte slots), 1, 3 and 4k + 1
    probe rows (3 with int64 keys), a toInt8 payload over [0, 300] stated
    as the int8 range, and two stated ranges that do not hold (that
    payload stated as [0, 300], a build key past hi), which must set
    out_of_range."""
    from clickhouse_tpu_torch.ops.join_ops import (_dense_gather_join_plain,
                                                   dense_gather_join)
    rng = np.random.default_rng(17)
    for name in K7_CASES:
        bk, bv, pk, pv, words, lo, hi = k7_args(name, rng, dev)
        got = k7_outputs(dense_gather_join(bk, bv, pk, pv, words, lo, hi))
        want = k7_outputs(_dense_gather_join_plain(bk, bv, pk, pv, words,
                                                   lo, hi - lo + 1))
        if len(got) != len(want) or (len(want) == 1) != (
                name in ("wrapped_payload", "build_key_outside")):
            fail(f"K7 case {name}: out_of_range {int(got[0])}, plain "
                 f"{int(want[0])}")
        for a, b in zip(got, want):
            max_abs_err(a, b)
    print(f"K7 dense_join edge cases agree: {', '.join(K7_CASES)}",
          flush=True)


# K8's edge cases (k8_case): the hash table's build and probe
K8_CASES = ("unique", "duplicates", "one_key_word_i32", "two_key_words",
            "three_key_words", "four_key_words", "eight_key_words",
            "hash_collisions", "wraps_past_last_bucket", "float_keys",
            "one_key", "nothing_matches", "one_key_every_row", "one_word",
            "five_words", "ten_words", "six_words_i32", "views_1_in",
            "q4x_group_table", "payload_only_one_word",
            "payload_only_i32_two_words")
# cases run with K8's test hook: every row's 64-bit hash forced equal
K8_HASH_MASK = {"hash_collisions": 0}


def mix64_np(z):
    """csrc/hash_join.cu's mix64 (splitmix64's finaliser) over uint64."""
    with np.errstate(over="ignore"):
        z = z.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def k8_case(name, rng):
    """(build keys, build valid, probe keys, probe valid, build words) of
    one K8 edge case, in numpy (keys of one type a pair: int32 or int64,
    or float64 for float_keys)."""
    nb, n = 300_000, 1_000_003
    bv = rng.random(nb) < 0.95
    pv = rng.random(n) < 0.95
    words = [np.arange(nb, dtype=np.int32),
             rng.integers(-50, 50, nb).astype(np.int32)]
    if name in ("unique", "one_word", "five_words", "six_words_i32",
                "q4x_group_table", "payload_only_one_word",
                "payload_only_i32_two_words"):
        # keys of 8 bytes; of 4 for Q4x's (int32 storage) and the i32 cases
        top = 1 << (31 if name in ("q4x_group_table", "six_words_i32",
                                   "payload_only_i32_two_words") else 40)
        bk = [rng.permutation(np.unique(rng.integers(0, top, nb)))]
        nb = len(bk[0])
        bv, words = bv[:nb], [w[:nb] for w in words]
        pk = [np.where(rng.random(n) < 0.5, bk[0][rng.integers(0, nb, n)],
                       rng.integers(0, top, n))]
        if top < 1 << 40:
            bk, pk = [bk[0].astype(np.int32)], [pk[0].astype(np.int32)]
        if name in ("one_word", "payload_only_one_word"):  # Q4h's shape
            words = words[1:]
        elif name in ("five_words", "six_words_i32"):
            # a chunk of 4 in the payload, then one (two for a 4-byte key)
            # in the bucket
            words = [rng.integers(-9, 9, nb).astype(np.int32)
                     for _ in range(5 if name == "five_words" else 6)]
        elif name == "q4x_group_table":   # each key twice (Q4x's dim2)
            bk = [np.repeat(bk[0][: nb // 2], 2)]
            bv = np.ones(len(bk[0]), bool)
    elif name == "duplicates":
        bk = [rng.integers(0, nb // 20, nb).astype(np.int64)]
        pk = [rng.integers(0, nb // 10, n).astype(np.int64)]
    elif name.endswith("key_words") or name in ("one_key_word_i32",
                                                 "views_1_in",
                                                 "hash_collisions"):
        nk = {"one_key_word_i32": 1, "two_key_words": 2,
              "three_key_words": 3, "four_key_words": 4,
              "eight_key_words": 8, "views_1_in": 2,
              "hash_collisions": 2}[name]
        kinds = [np.int32, np.int64] * 4
        if name == "hash_collisions":
            # every hash equal: one run of every key, confirmed word by word
            nb, n = 3000, 20_003
            bv, pv = bv[:nb], pv[:n]
            words = [w[:nb] for w in words]
        hi = 3 if nk == 8 else 30
        bk = [rng.integers(0, hi, nb).astype(k) for k in kinds[:nk]]
        pk = [rng.integers(0, hi + 10, n).astype(k) for k in kinds[:nk]]
    elif name == "wraps_past_last_bucket":
        # 200 build rows (1,024 buckets) whose keys all hash to the last
        # bucket: their run wraps to bucket 0
        nb = 200
        cand = rng.integers(0, 1 << 40, 2_000_000).astype(np.int64)
        last = cand[(mix64_np(cand) & np.uint64(1023)) == np.uint64(1023)]
        bk = [np.unique(last)[:nb]]
        nb = len(bk[0])
        bv, words = np.ones(nb, bool), [w[:nb] for w in words]
        pk = [np.where(rng.random(n) < 0.7, bk[0][rng.integers(0, nb, n)],
                       rng.integers(0, 1 << 40, n))]
    elif name == "float_keys":
        pool = np.array([0.0, -0.0, np.nan, 1.5, -2.25, np.inf, 3.0])
        bk = [pool[rng.integers(0, 6, nb)]]
        pk = [pool[rng.integers(0, 7, n)]]
    elif name == "one_key":
        nb = 1
        bv, words = np.ones(1, bool), [np.array([42], np.int32)]
        bk = [np.array([7], np.int64)]
        pk = [rng.integers(0, 10, n).astype(np.int64)]
    elif name == "nothing_matches":
        bk = [rng.integers(0, 1000, nb).astype(np.int64) * 2]
        pk = [rng.integers(0, 1000, n).astype(np.int64) * 2 + 1]
    elif name == "one_key_every_row":
        bk = [np.full(nb, 5, np.int64)]
        pk = [rng.integers(4, 7, n).astype(np.int64)]
    elif name == "ten_words":
        bk = [rng.integers(0, nb, nb).astype(np.int64)]
        pk = [rng.integers(0, nb, n).astype(np.int64)]
        words = [rng.integers(-9, 9, nb).astype(np.int32) for _ in range(10)]
    else:
        raise ValueError(name)
    return bk, bv, pk, pv, words


def k8_args(name, rng, dev):
    """One K8 edge case as propagate_join's arguments on `dev` (views_1_in:
    every array a view one row into its tensor) and its keywords (the hash
    hook)."""
    bk, bv, pk, pv, words = k8_case(name, rng)

    def t(a):
        return on_card(a, dev, int(name == "views_1_in"))
    kw = {"hash_mask": K8_HASH_MASK[name]} if name in K8_HASH_MASK else {}
    return ([t(k) for k in bk], t(bv), [t(k) for k in pk], t(pv),
            [t(w) for w in words]), kw


def k8_plain(bk, bv, pk, pv, words):
    from clickhouse_tpu_torch.ops.join_ops import (_first_match_plain,
                                                   _take_words, key_words)
    match = _first_match_plain(key_words(bk), bv, key_words(pk), pv)
    return _take_words(match, words)


def k8_group_table(bk, bv, pk, pv):
    """The 1:N join's K8 (Q4x's shape): the group-index table that
    build_join_table builds on the card, probed by probe_join_table, and
    the plain lookup over the same groups.  -> (got, want): (matched,
    seg_start, seg_len) each."""
    from clickhouse_tpu_torch.ops.join_ops import (
        _first_match_plain, _take_words, build_join_table, key_words,
        probe_join_table)
    cap_g = 1 << (bk[0].shape[0] - 1).bit_length()
    tbl = build_join_table(bk, bv, cap_g)
    got = probe_join_table(tbl, pk, pv)
    real = torch.arange(cap_g, device=bk[0].device) < tbl.num_groups
    want = _take_words(_first_match_plain(
        key_words(tbl.key_cols), real, key_words(pk), pv),
        [tbl.seg_start, tbl.seg_len])
    return (got.matched, got.seg_start, got.seg_len), \
        (want[0], *want[1])


def k8_payload_only(bk, bv, pk, pv, words):
    """K8's build and probe with every word in the payload array (the
    wrapper's measurement hook), not in the bucket.  -> (matched, words)"""
    from clickhouse_tpu_torch.ops.join_ops import (
        _bool, _hash_build_cuda, _hash_probe_cuda, key_words)
    bw, pw = key_words(bk), key_words(pk)
    return _hash_probe_cuda(bw, pw, _hash_build_cuda(bw, _bool(bv)),
                            _bool(pv), list(words), words_in_bucket=False)


def k8_results(name, args, kw):
    """(got, want) of one K8 case: the match flags and the words."""
    from clickhouse_tpu_torch.ops.join_ops import propagate_join
    if name == "q4x_group_table":
        return k8_group_table(*args[:4])
    if name.startswith("payload_only"):
        got_m, got_w = k8_payload_only(*args)
    else:
        got = propagate_join(*args, **kw)
        got_m, got_w = got.matched, got.words
    want_m, want_w = k8_plain(*args)
    return [got_m] + got_w, [want_m] + want_w


def check_k8(dev):
    """K8 against its plain version on every case of K8_CASES (three runs
    each: where keys repeat, the smallest build row id must win whatever
    order the threads insert in): unique keys of 8 and of 4 bytes inline in
    the buckets, many duplicates, two to eight key words through the hash
    path, two-word keys whose 64-bit hashes are all forced equal (the
    word-by-word check), a run that wraps past the table's last bucket,
    float keys with -0.0, +0.0 and NaN, a table of one key, a probe where
    nothing matches, 300,000 build rows of one key, one word (in the
    bucket), two (in the bucket of a 4-byte key, else the payload), five,
    six and ten words (chunks of 4, the last in the bucket where it fits),
    two key words as views one row in, Q4x's group-index table over
    4-byte keys, and one word (8-byte key) and two (4-byte key) kept in
    the payload array rather than the bucket (the measurement hook)."""
    rng = np.random.default_rng(18)
    for name in K8_CASES:
        args, kw = k8_args(name, rng, dev)
        for _ in range(3):
            got, want = k8_results(name, args, kw)
            if len(got) != len(want):
                fail(f"K8 case {name}: {len(got)} outputs, want {len(want)}")
            for a, b in zip(got, want):
                max_abs_err(a, b)
    print(f"K8 hash_join edge cases agree (three runs each): "
          f"{', '.join(K8_CASES)}", flush=True)


# K9's edge cases (k9_case): the match expansion.  Those past many_tiles
# probe the one-pass design: a tile's output at the spill threshold (the
# join_ops.EXPAND_HEAVY_SLOTS) less one, at it and one above (one row
# holds it), heavy rows in adjacent rows and tiles, a tile with no output,
# the capacity falling mid-tile and mid-heavy-row, the row count (the
# rows past it invalid) cutting mid-tile with and without a mask and at
# 0, a row count not a multiple of 16, and views 1-3 rows into their
# storage (no 16-byte loads)
K9_CASES = ("zero_lengths", "inner", "left", "any", "left_any",
            "one_row_90_percent", "beyond_capacity", "no_probe_row",
            "many_tiles", "heavy_minus_1", "heavy_at", "heavy_plus_1",
            "heavy_adjacent", "empty_tile", "cap_mid_tile", "cap_mid_heavy",
            "count_mid_tile", "count_no_mask", "count_left", "count_zero",
            "ragged_n", "view_1", "view_2", "view_3")
K9_TILE = 4096          # kTile of csrc/expand_matches.cu
K9_REPS = 3             # runs of each case


def k9_lengths(matched, valid, seg_len, left, any_join, n_rows):
    """Each probe row's output slots, in numpy (K9's rule)."""
    v = np.arange(len(matched)) < n_rows
    if valid is not None:
        v &= valid
    lens = np.where(matched & v, seg_len.astype(np.int64), 0)
    if any_join:
        lens = np.minimum(lens, 1)
    if left:
        lens = np.where(v, np.maximum(lens, 1), 0)
    return lens


def k9_case(name, rng):
    """(matched, valid or None, seg_start, seg_len, out_cap, left,
    any_join, n_rows or None, view offset) of one K9 edge case, in
    numpy."""
    n = 1_000_003
    matched = rng.random(n) < 0.6
    valid = rng.random(n) < 0.9
    seg_len = np.where(matched, rng.integers(1, 6, n), 0).astype(np.int32)
    seg_start = np.where(matched, rng.integers(0, 1 << 20, n), 0).astype(
        np.int32)
    cap, left, any_join, n_rows, off = 4 * n, False, False, None, 0
    if name == "zero_lengths":
        seg_len[:] = 0
        matched[:] = False
    elif name == "left":
        left = True
    elif name == "any":
        any_join = True
    elif name == "left_any":
        left = any_join = True
    elif name == "one_row_90_percent":
        seg_len[n // 3] = 9 * n * 3
        matched[n // 3] = valid[n // 3] = True
        cap = 31 * n
    elif name == "beyond_capacity":
        cap = n
    elif name == "no_probe_row":
        return (np.zeros(0, bool), np.zeros(0, bool), np.zeros(0, np.int32),
                np.zeros(0, np.int32), 1024, False, False, None, 0)
    elif name == "many_tiles":
        n2 = 20_000_003
        matched = rng.random(n2) < 0.5
        valid = np.ones(n2, bool)
        seg_len = np.where(matched, 2, 0).astype(np.int32)
        seg_start = np.where(matched, 7, 0).astype(np.int32)
        cap = n2 + 1024
    elif name not in ("inner",):
        from clickhouse_tpu_torch.ops.join_ops import EXPAND_HEAVY_SLOTS
        heavy = EXPAND_HEAVY_SLOTS
        n = 5 * K9_TILE + 77
        matched, valid = matched[:n], valid[:n]
        seg_len, seg_start = seg_len[:n], seg_start[:n]
        t1 = slice(K9_TILE, 2 * K9_TILE)
        if name.startswith("heavy_") and name != "heavy_adjacent":
            # tile 1's output is one row's
            d = {"heavy_minus_1": -1, "heavy_at": 0, "heavy_plus_1": 1}[name]
            matched[t1] = False
            r = K9_TILE + 1234
            matched[r] = valid[r] = True
            seg_len[r] = heavy + d
        elif name == "heavy_adjacent":
            for r, m in ((K9_TILE - 1, 2), (K9_TILE, 2), (K9_TILE + 1, 3),
                         (2 * K9_TILE + 5, 3), (3 * K9_TILE + 4095, 1)):
                matched[r] = valid[r] = True
                seg_len[r] = m * heavy + r % 7
        elif name == "empty_tile":
            matched[t1] = False
        elif name in ("cap_mid_tile", "cap_mid_heavy"):
            if name == "cap_mid_heavy":
                r = 2 * K9_TILE + 100
                matched[r] = valid[r] = True
                seg_len[r] = 10 * heavy
            lens = k9_lengths(matched, valid, seg_len, False, False, n)
            first = np.concatenate([[0], np.cumsum(lens)])
            cap = int(first[2 * K9_TILE + 100]) + (
                3 * heavy + 17 if name == "cap_mid_heavy" else 1001)
        elif name in ("count_mid_tile", "count_left"):
            n_rows = 2 * K9_TILE + 1234
            left = name == "count_left"
        elif name == "count_no_mask":
            n_rows, valid = 3 * K9_TILE + 999, None
        elif name == "count_zero":
            n_rows, valid = 0, None
        elif name == "ragged_n":
            n = 3 * K9_TILE + 5
            matched, valid = matched[:n], valid[:n]
            seg_len, seg_start = seg_len[:n], seg_start[:n]
            n_rows = n - 2
        elif name.startswith("view_"):
            off = int(name[-1])
            n_rows = n - off
        else:
            raise ValueError(f"no K9 case {name}")
    return matched, valid, seg_start, seg_len, cap, left, any_join, n_rows, \
        off


def k9_args(name, rng, dev):
    """One K9 edge case as expand_matches' arguments on `dev`: (probe,
    probe_valid, out_capacity, left, any_join, n_rows)."""
    from clickhouse_tpu_torch.ops.join_ops import ProbeResult
    m, v, ss, sl, cap, left, any_join, n_rows, off = k9_case(name, rng)
    probe = ProbeResult(on_card(m, dev, off), on_card(ss, dev, off),
                        on_card(sl, dev, off))
    return (probe, None if v is None else on_card(v, dev, off), cap, left,
            any_join, n_rows)


def check_k9(dev):
    """K9 against its plain version on every case of K9_CASES, K9_REPS runs
    each: no match, INNER, LEFT (length at least 1), ANY (at most 1), both,
    one probe row holding 90 % of the output, an output count beyond the
    capacity (the count must exceed it, and the capacity check must fire
    on the card), no probe row, 20M probe rows (many look-back tiles), and
    the one-pass design's edges (K9_CASES' comment)."""
    from clickhouse_tpu_torch.ops.join_ops import (_expand_matches_plain,
                                                   expand_matches)
    rng = np.random.default_rng(19)
    for name in K9_CASES:
        args = k9_args(name, rng, dev)
        want = _expand_matches_plain(*args)
        for _ in range(K9_REPS):
            got = expand_matches(*args)
            for a, b in zip(got, want):
                max_abs_err(a, b)
        if name == "beyond_capacity" and int(got[3]) <= args[2]:
            fail(f"K9's beyond_capacity case counted {int(got[3])} rows, "
                 f"within its capacity {args[2]}")
        del got, want, args
    print(f"K9 expand_matches edge cases agree ({K9_REPS} runs each): "
          f"{', '.join(K9_CASES)}", flush=True)


K10_CASES = ("u0", "u1", "u3", "ragged_block", "short_values",
             "long_values", "odd_chars", "long_needle", "needle_past_stage",
             "int64_offsets", "chars_past_2gb")
K10_STAGE = 16384       # kStage of csrc/prefix_match.cu
K10_REPS = 3            # runs of each case


def k10_values(rng, name):
    """The dictionary values of one K10 case, as bytes."""
    def word(n):
        return bytes(rng.integers(97, 100, n).astype(np.uint8))
    if name == "u0":
        return []
    if name == "u1":
        return [word(5)]
    if name == "u3":
        return [word(3), b"", word(7)]
    if name == "short_values":
        return [word(int(k)) for k in rng.integers(0, 4, 2000)]
    if name == "long_values":
        return [word(int(k)) for k in rng.choice([64, 65, 66, 4000], 300)]
    if name == "needle_past_stage":
        base = word(K10_STAGE + 500)
        return [base, base[:-1] + b"x", b"y" + base[1:], base[:100],
                word(K10_STAGE + 3000)]
    # ragged_block, odd_chars, long_needle, int64_offsets: 1 to 120 bytes,
    # U not a multiple of the block; UTF-8 in some
    vals = [word(int(k)) for k in rng.integers(1, 120, 1000 + 37)]
    vals[3] = "ünïcødé-ß".encode()
    return vals


def k10_needles(rng, vals):
    """Needles of a case: empty, a value's prefix and suffix of several
    lengths, whole values, one longer than every value, a miss."""
    out = [b"", b"a", b"zz"]
    longest = max((len(v) for v in vals), default=0)
    for v in vals[:: max(1, len(vals) // 4)][:4]:
        for k in (1, 3, 21, 49, 64, 65, len(v)):
            out += [v[:k], v[-k:] if k else b""]
    out.append(b"a" * (longest + 1))
    return sorted(set(out), key=lambda b: (len(b), b))


def k10_args(name, rng, dev):
    """One K10 case on `dev`: (chars, offsets, needles)."""
    if name == "chars_past_2gb":
        # 2^21 + 3 values of 1,024 bytes: 2^31 + 3,072 chars, int64 offsets
        u, w = (1 << 21) + 3, 1024
        g = torch.Generator(device=dev).manual_seed(10)
        chars = torch.randint(97, 99, (u * w,), dtype=torch.uint8,
                              device=dev, generator=g)
        offsets = torch.arange(u + 1, dtype=torch.int64, device=dev) * w
        head = chars[:w].cpu().numpy().tobytes()
        tail = chars[-w:].cpu().numpy().tobytes()
        return chars, offsets, [b"", head[:1], head[:30], head, tail[-17:],
                                tail, b"a" * (w + 1)]
    vals = k10_values(rng, name)
    lens = np.array([len(v) for v in vals], np.int64)
    offsets = np.zeros(len(vals) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    chars = np.frombuffer(b"".join(vals), np.uint8)
    pad = 1 if name == "odd_chars" else 0   # chars at an odd address
    buf = torch.zeros(len(chars) + pad, dtype=torch.uint8, device=dev)
    buf[pad:] = torch.from_numpy(chars.copy()).to(dev)
    off = torch.from_numpy(offsets).to(dev)
    if name != "int64_offsets":
        off = off.to(torch.int32)
    return buf[pad:], off, k10_needles(rng, vals)


def check_k10(dev):
    """K10 against its plain version on every case of K10_CASES, prefix and
    suffix each with and without negate, K10_REPS runs each: 0, 1 and 3
    values, a value count off the block, values of 0-3 bytes, of 64-66 and
    4,000 bytes, chars at an odd address, needles past 48 bytes and past
    the kernel's shared-memory stage, int64 offsets, and chars past 2^31
    bytes."""
    from clickhouse_tpu_torch.ops.string_ops import (_prefix_match_plain,
                                                     prefix_match)
    rng = np.random.default_rng(23)
    calls = 0
    for name in K10_CASES:
        chars, offsets, needles = k10_args(name, rng, dev)
        for nd in needles:
            for suffix in (False, True):
                for negate in (False, True):
                    want = _prefix_match_plain(chars, offsets, nd, suffix,
                                               negate)
                    for _ in range(K10_REPS):
                        max_abs_err(prefix_match(chars, offsets, nd, suffix,
                                                 negate), want)
                        calls += 1
        del chars, offsets
    torch.cuda.synchronize()
    print(f"K10 prefix_match edge cases agree ({K10_REPS} runs each, "
          f"{calls} calls): {', '.join(K10_CASES)}", flush=True)


# -- slice 11: vector search (K11, Q8) ---------------------------------------

K11_CASES = ("w8", "w24", "w128", "w136", "zero_query", "n_off_block",
             "rows_past_n")
K11_RTOL, K11_ATOL = 1e-5, 1e-6   # see k11_error
N_VECS, W_VECS = 10_000_000, 128
K11_LIBRARY = "torch.mv(A, q)"


def k11_case(name, rng):
    """One K11 case as numpy: (A (cap, W) float32, zero past each row's
    length; lengths int32; q (W,) float32; n).  Ragged lengths hold 0, 1,
    W - 1 and W, row 5 is a zero row of full length; rows_past_n fills the
    rows past n with data and lengths, which K11 must not read."""
    w = {"w8": 8, "w24": 24, "w136": 136}.get(name, 128)
    rows = {"n_off_block": 1000 + 37}.get(name, 5000)
    cap = rows + (259 if name == "rows_past_n" else 0)
    lens = rng.integers(0, w + 1, cap).astype(np.int32)
    lens[:4] = [0, 1, w - 1, w]
    lens[5] = w
    a = rng.normal(size=(cap, w)).astype(np.float32)
    a[np.arange(w)[None, :] >= lens[:, None]] = 0
    a[5] = 0
    q = rng.normal(size=w).astype(np.float32)
    if name == "zero_query":
        q[:] = 0
    return a, lens, q, rows


def k11_error(got, want, A, lengths, q, op, n) -> float:
    """Largest |got - want| over rows < n after checking each row within
    K11_RTOL * |want| + K11_ATOL * scale: scale 1 for cosine, 1 + |a|^2 +
    |q[:len]|^2 for the others (the size of the float32 sums they come
    from; L2 is compared squared, as L2Squared).  Rows at and past n must
    be exactly the zero row's value."""
    from clickhouse_tpu_torch.ops.vector_ops import zero_row_distance
    g, w = got[:n].double(), want[:n].double()
    if op == "l2":
        g, w = g * g, w * w
    if op == "cosine":
        scale = torch.ones_like(w)
    else:
        a2 = torch.zeros(n, dtype=torch.float64, device=A.device)
        for lo in range(0, n, 1 << 20):
            blk = A[lo:lo + (1 << 20)][:n - lo].double()
            a2[lo:lo + blk.shape[0]] = (blk * blk).sum(1)
        pre = torch.cat([torch.zeros(1, dtype=torch.float64,
                                     device=A.device),
                         torch.cumsum(q.double() ** 2, 0)])
        scale = 1 + a2 + pre[lengths[:n].long().clamp(0, q.shape[0])]
    if not torch.equal(torch.isnan(g), torch.isnan(w)):
        fail(f"K11 {op}: NaN positions differ")
    bad = (g - w).abs() > K11_RTOL * w.abs() + K11_ATOL * scale
    if bool(bad.any()):
        i = int(torch.nonzero(bad)[0])
        fail(f"K11 {op}: row {i} gives {float(got[i])}, its plain version "
             f"{float(want[i])}")
    if not bool((got[n:] == zero_row_distance(op)).all()):
        fail(f"K11 {op}: a row past n = {n} is not the zero row's value")
    return float((got[:n].double() - want[:n].double()).abs().max()) \
        if n else 0.0


def check_k11(dev):
    """K11 against its plain version for each op on every case of
    K11_CASES: widths 8, 24, 128 and 136 (one and two float4 steps a
    lane), ragged lengths 0, 1, W - 1 and W, a zero row, a zero query
    (cosine 1), a row count off the block, and rows past n."""
    from clickhouse_tpu_torch.ops.vector_ops import (DISTANCE_OPS,
                                                     _vector_distance_plain,
                                                     vector_distance)
    rng = np.random.default_rng(31)
    worst = 0.0
    for name in K11_CASES:
        a, lens, q, n = k11_case(name, rng)
        A = torch.from_numpy(a).to(dev)
        L = torch.from_numpy(lens).to(dev)
        Q = torch.from_numpy(q).to(dev)
        for op in DISTANCE_OPS:
            got = vector_distance(A, L, Q, op, n)
            want = _vector_distance_plain(A, L, Q, op, n)
            worst = max(worst, k11_error(got, want, A, L, Q, op, n))
            if name == "zero_query" and op == "cosine" \
                    and not bool((got == 1).all()):
                fail("K11: cosine to a zero query is not 1")
    torch.cuda.synchronize()
    print(f"K11 vector_distance edge cases agree with the plain version "
          f"(each op; max |err| {worst:.3g}, within {K11_RTOL} relative + "
          f"{K11_ATOL} x the row's scale): {', '.join(K11_CASES)}",
          flush=True)


def q8_query() -> np.ndarray:
    """bench.py:544's query vector as Q8's literal gives it (5 decimals)."""
    q = np.random.default_rng(9).normal(size=W_VECS).astype(np.float32)
    return np.array([float(f"{x:.5f}") for x in q])


def slice11_queries():
    q = q8_query()
    body = "[" + ",".join(f"{x:.5f}" for x in q) + "]"
    q32 = f"CAST({body} AS Array(Float32))"
    return (("Q8", f"SELECT id FROM vecs ORDER BY cosineDistance(v, {q32}) "
                   f"LIMIT 10"),
            ("Q8l", f"SELECT id FROM vecs ORDER BY L2Distance(v, {body}) "
                    f"LIMIT 10"),
            ("Q8w", f"SELECT id FROM vecs WHERE id < 1000000 ORDER BY "
                    f"cosineDistance(v, {q32}) LIMIT 3"))


SLICE11_QUERIES = slice11_queries()
SLICE11_PATHS = {"Q8": {"vector_distance": 1, "topk_smallest": 1},
                 "Q8l": {"vector_distance": 1, "topk_smallest": 1},
                 "Q8w": {"vector_distance": 1, "topk_smallest": 1,
                         "masked_reduce": 1}}


def load_vecs(s):
    """vecs (id Int64, v Array(Float32)) in session s, as bench.py:538-543
    makes it: 10,000,000 x 128 normals from default_rng(8).  -> the matrix
    (numpy float32).  Prints the host seconds of the data and of the
    insert with its device block."""
    t0 = time.perf_counter()
    v = np.random.default_rng(8).normal(size=(N_VECS, W_VECS)).astype(
        np.float32)
    t1 = time.perf_counter()
    s.execute("CREATE TABLE vecs (id Int64, v Array(Float32))")
    s.insert_pydict("vecs", {"id": np.arange(N_VECS, dtype=np.int64),
                             "v": v})
    s.catalog.get_table("default", "vecs").read_block()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"vecs: {N_VECS} x {W_VECS} float32 made in {t1 - t0:.1f} s; "
          f"insert + device block {t2 - t1:.1f} s (host)", flush=True)
    return v


def vector_answers(v: np.ndarray):
    """Q8, Q8l and Q8w from numpy's float64 distances (1M rows at a time);
    fails unless the k-th and (k+1)-th distances lie further apart than
    the engine's float32 error could move them: each by K11's tolerance
    (k11_error; for L2 the squared distance's, over 2 d)."""
    q = q8_query()
    q32 = q.astype(np.float32).astype(np.float64)
    cos = np.empty(N_VECS)
    l2 = np.empty(N_VECS)
    a2 = np.empty(N_VECS)
    for lo in range(0, N_VECS, 1 << 20):
        blk = v[lo:lo + (1 << 20)].astype(np.float64)
        sq = (blk * blk).sum(1)
        a2[lo:lo + len(blk)] = sq
        cos[lo:lo + len(blk)] = 1 - blk @ q32 / np.maximum(
            np.sqrt(sq) * np.linalg.norm(q32), 1e-300)
        l2[lo:lo + len(blk)] = np.sqrt(np.maximum(sq - 2 * (blk @ q)
                                                  + q @ q, 0))
    tol = {"cos": K11_RTOL * np.abs(cos) + K11_ATOL,
           "l2": (K11_RTOL * l2 ** 2 + K11_ATOL * (1 + a2 + q @ q))
           / np.maximum(2 * l2, 1e-300)}
    out = {}
    for name, d, t, k in (("Q8", cos, tol["cos"], 10),
                          ("Q8l", l2, tol["l2"], 10),
                          ("Q8w", cos[:1_000_000], tol["cos"], 3)):
        order = np.argpartition(d, k + 1)[:k + 1]
        order = order[np.lexsort((order, d[order]))]
        gap = d[order[k]] - d[order[k - 1]]
        need = t[order[k]] + t[order[k - 1]]
        if gap <= need:
            fail(f"{name}: numpy's {k}-th and {k + 1}-th distances are "
                 f"{gap:.3g} apart, within the engine's float32 error "
                 f"{need:.3g}")
        out[name] = [(int(i),) for i in order[:k]]
        print(f"{name}: numpy's float64 top-{k}; the gap to the next row "
              f"{gap:.4g} (the float32 error of the two {need:.3g})",
              flush=True)
    return out


def slice11_path(s, want, per_query, launches, launch_rows, memory):
    """Q8, Q8l and Q8w over vecs (SLICE11_PATHS): K11 once over every row,
    K3 once (Q8, Q8w: its 32-bit entry; Q8l: its 64-bit one)."""
    cover = {q: ("vector_distance", N_VECS) for q, _ in SLICE11_QUERIES}
    return path_phase(s, SLICE11_QUERIES, SLICE11_PATHS, cover, want,
                      per_query, launches, launch_rows, memory,
                      "Q8, Q8l and Q8w")


def vector_args(session):
    """Run Q8 once more with K11's launch wrapper spied on; -> its K11
    call's arguments (A, lengths, q, op, n)."""
    from clickhouse_tpu_torch.ops import vector_ops
    got = []
    real = vector_ops._vector_distance_cuda

    def spy(*args):
        got.append(args)
        return real(*args)
    vector_ops._vector_distance_cuda = spy
    try:
        session.execute(SLICE11_QUERIES[0][1])
    finally:
        vector_ops._vector_distance_cuda = real
    if len(got) != 1:
        fail(f"Q8 gave K11 {len(got)} calls, not one")
    return got[0]


def vector_shapes(dev, args):
    """K11 at Q8's inputs (10,000,384 x 128 float32, cosine), held against
    its plain version and timed beside it and beside torch.mv(A, q) (the
    dot alone, for information: no one PyTorch call computes the
    distance), with its kernels a call (torch.profiler).  Bytes: A's rows
    below n read once, their lengths, the output."""
    from clickhouse_tpu_torch.ops.vector_ops import (_vector_distance_plain,
                                                     vector_distance)
    A, lengths, q, op, n = args
    call = (A, lengths, q, op, n)
    err = k11_error(vector_distance(*call), _vector_distance_plain(*call),
                    A, lengths, q, op, n)
    ms = cuda_ms(lambda: vector_distance(*call))
    plain = cuda_ms(lambda: _vector_distance_plain(*call), reps=5)
    lib = cuda_ms(lambda: torch.mv(A, q))
    nb = n * A.shape[1] * 4 + n * 4 + A.shape[0] * 4
    per_call = {}
    kernels = device_kernels(lambda: vector_distance(*call),
                             launches=per_call)
    print(f"vector_distance kernels a call at Q8's inputs (device ms): "
          f"{kernels}", flush=True)
    print(f"vector_distance at Q8's inputs ({n} rows of {A.shape[1]} "
          f"float32, capacity {A.shape[0]}, {op}): {ms:.4f} ms, {nb} bytes, "
          f"bound {bound_ms(nb):.4f} ms (share {bound_ms(nb) / ms:.3f}), "
          f"plain {plain:.4f} ms (max |err| {err:.3g} against it), "
          f"{K11_LIBRARY} {lib:.4f} ms", flush=True)
    return {"vector_distance": {
        "ms": ms, "plain_ms": plain, "bytes": nb, "bound_ms": bound_ms(nb),
        "max_abs_err": err, "library_ms": lib,
        "kernels_per_call": per_call}}


def peak_since(base: int, memory) -> int:
    """A query's peak device bytes above `base`: the allocator's peak and
    the peaks main's watches saw before they reset it."""
    return max([torch.cuda.max_memory_allocated()]
               + [p for p, _ in memory["grouping"]]
               + [r["peak_before"] for r in memory["dense"] + memory["k2"]]
               ) - base


def print_dense_split(name, memory, base, extra):
    """Where a dense GROUP BY's peak goes (main's watches): the dense
    grouping's own peak (the int64 slots and one key's offsets, then the
    int32 ids) and what K2's call is given and returns."""
    for r in memory["dense"]:
        print(f"{name}: the dense grouping holds {r['at_start'] - base} "
              f"bytes of the query at its start; its own peak {r['own']} "
              f"bytes above that (int64 slots and a key's int64 offsets); "
              f"its int32 ids {r['ids']} bytes; its budget check counted "
              f"{r['counted']} bytes", flush=True)
    for r in memory["k2"]:
        print(f"{name}: K2's call: the query holds {r['at_start'] - base} "
              f"bytes at its start; its inputs: ids {r['ids']}, base mask "
              f"{r['base']}, other masks {r['masks']}, summed values "
              f"{r['values']} bytes; its outputs {r['outputs']} bytes; its "
              f"own peak {r['own']} bytes above its start; the query's peak "
              f"{extra} bytes above what was allocated before it",
              flush=True)


def watch_dense(memory):
    """Wrap agg_ops.group_by_dense and mxu_segsum.mxu_group_reduce (each
    call passed on as it is) to record into memory["dense"] and
    memory["k2"] the bytes each holds, is given and returns.  -> a
    function that unwraps them."""
    from clickhouse_tpu_torch.ops import agg_ops, mxu_segsum
    dense_fn, k2_fn = agg_ops.group_by_dense, mxu_segsum.mxu_group_reduce

    def start():
        torch.cuda.synchronize()
        rec = {"peak_before": torch.cuda.max_memory_allocated(),
               "at_start": torch.cuda.memory_allocated()}
        torch.cuda.reset_peak_memory_stats()
        return rec

    def own(rec):
        torch.cuda.synchronize()
        rec["own"] = torch.cuda.max_memory_allocated() - rec["at_start"]

    def dense_watch(keys, *a, **kw):
        rec = start()
        out = dense_fn(keys, *a, **kw)
        own(rec)
        rec.update(ids=nbytes(out.group_ids), counted=agg_ops.
                   dense_group_bytes(keys[0].shape[0],
                                     kw.get("held_bytes", 0)))
        memory["dense"].append(rec)
        return out

    def k2_watch(ids, base_mask, count_masks, sum_specs, S):
        rec = start()
        rec.update(ids=nbytes(ids), base=nbytes(base_mask),
                   masks=nbytes([m for m in count_masks]
                                + [sp[3] for sp in sum_specs]),
                   values=nbytes([sp[0] for sp in sum_specs]))
        counts, sums = k2_fn(ids, base_mask, count_masks, sum_specs, S)
        own(rec)
        rec["outputs"] = nbytes(counts, sums)
        memory["k2"].append(rec)
        return counts, sums
    agg_ops.group_by_dense = dense_watch
    mxu_segsum.mxu_group_reduce = k2_watch

    def unwatch():
        agg_ops.group_by_dense = dense_fn
        mxu_segsum.mxu_group_reduce = k2_fn
    return unwatch


def main_path_args(session):
    """Run the main path's queries once more with each kernel's launch
    wrapper spied on, and return the arguments of each kernel's largest
    launch (K1: of each form, its filter terms and its bool mask; K4 and
    K5: of each query, as "radix_sort_pairs:Q2b"): the exact inputs the
    main path hands it."""
    from clickhouse_tpu_torch.ops import agg_ops, mxu_segsum, scan_ops, \
        sort_ops
    # kernel -> (module, wrapper, rows of a launch from its arguments)
    spied = {"masked_reduce": (agg_ops, "_masked_reduce_cuda",
                               lambda a: a[4]),
             "dense_group_reduce": (mxu_segsum, "_dense_group_reduce_cuda",
                                    lambda a: a[0].shape[0]),
             "topk_smallest": (sort_ops, "_topk_cuda",
                               lambda a: a[0].shape[0]),
             "radix_sort_pairs": (sort_ops, "_radix_sort_cuda",
                                  lambda a: a[0].shape[0]),
             "segment_bounds": (scan_ops, "_segment_bounds_cuda",
                                lambda a: a[0][0].shape[0]),
             "segment_reduce": (scan_ops, "_segment_reduce_many_cuda",
                                lambda a: a[6])}
    got, saved = {}, {}
    query = [""]
    for name, (mod, attr, rows_of) in spied.items():
        fn = saved[name] = getattr(mod, attr)

        def spy(*args, _fn=fn, _name=name, _rows_of=rows_of):
            rows = _rows_of(args)
            key = _name
            if _name in ("radix_sort_pairs", "segment_bounds"):
                key = f"{_name}:{query[0]}"
            elif _name == "masked_reduce" and not args[5]:
                key = f"{_name}:mask"
            if key not in got or rows > got[key][1]:
                got[key] = (args, rows)
            return _fn(*args)
        setattr(mod, attr, spy)
    try:
        for name, sql in QUERIES:
            query[0] = name
            session.execute(sql)
    finally:
        for name, (mod, attr, _) in spied.items():
            setattr(mod, attr, saved[name])
    return {name: args for name, (args, _) in got.items()}


def nbytes(*ts) -> int:
    """Bytes of the tensors among ts (lists flattened; None skipped)."""
    total = 0
    for t in ts:
        if isinstance(t, (list, tuple)):
            total += nbytes(*t)
        elif isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def k2_wide(dev) -> float:
    """K2 over S = 16,384 slots at 100M rows (the slot of x % 16,384 for
    the main path's column, one count and one sum of x), held against its
    plain version: the widest GROUP BY K2 takes.  -> kernel ms."""
    from clickhouse_tpu_torch.ops.mxu_segsum import (
        _dense_group_reduce_plain, dense_group_reduce)
    S = 16384
    x = torch.arange(N_ROWS, dtype=torch.int64, device=dev) \
        * 2654435761 % 1_000_003
    args = (x.remainder(S).to(torch.int32), None, [None], [x], [None], S)
    for a, b in zip(dense_group_reduce(*args),
                    _dense_group_reduce_plain(*args)):
        max_abs_err(a, b)
    ms = cuda_ms(lambda: dense_group_reduce(*args))
    nb = nbytes(args[0], x) + 2 * S * 8
    print(f"dense_group_reduce at S = {S}, one count and one int64 sum, "
          f"{N_ROWS} rows: {ms:.4f} ms, {nb} bytes, bound "
          f"{bound_ms(nb):.4f} ms (exact against the plain version)",
          flush=True)
    return ms


def device_kernels(call, reps=5, launches=None):
    """{kernel name: device ms per call} over `reps` calls of call(), the L2
    flushed before each, from a torch.profiler trace (the flush's own
    kernel left out).  launches: a dict that takes {kernel name: launches
    per call}."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    call()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                call()
            torch.cuda.synchronize()
        out, counts = {}, {}
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = getattr(e, "cuda_time_total", 0.0)
            if t > 0 and e.count >= reps and "fill" not in e.key.lower() \
                    and "memset" not in e.key.lower():
                out[e.key] = t / reps / 1e3
                counts[e.key] = e.count / reps
        if out:                 # a trace now and then holds no kernel of
            break               # call's, or no event at all: take another
    if launches is not None:
        launches.update(counts)
    return out


def k1_forms(dev, args, mask_args):
    """K1 at Q1's inputs (its filter as a term over x's int32 storage, the
    row bound, no mask) and at the main path's largest count over a bool
    mask (mask_args: the aggregated block's rows that _sort_block counts),
    each held against its plain version and timed beside it.  -> record of
    the kernels line."""
    from clickhouse_tpu_torch.ops.agg_ops import (_masked_reduce_plain,
                                                  masked_reduce)
    op, data, mask, unsigned, n_rows, terms = args
    if data is not None or mask is not None or len(terms) != 1 \
            or terms[0].storage.dtype != torch.int32 or n_rows < N_ROWS:
        fail(f"Q1 did not reach K1 as one int32 term over {N_ROWS} rows: "
             f"data {data is not None}, mask {mask is not None}, "
             f"{[t.storage.dtype for t in terms]}, {n_rows} rows")
    t = terms[0]

    def fused():
        return masked_reduce(op, None, None, n_rows=n_rows, terms=terms)

    def fused_plain():
        return _masked_reduce_plain(op, None, None, False, n_rows, terms)
    rec = dict(
        max_abs_err=max_abs_err(fused(), fused_plain()),
        ms=cuda_ms(fused), plain_ms=cuda_ms(fused_plain),
        library_ms=None,
        library="none: no single PyTorch call counts x > c "
                "(torch.count_nonzero(x > c) timed for information)",
        # the rows the kernel must read, 4 bytes each, and the count
        bytes=n_rows * t.storage.element_size() + 8,
        shape=f"count over {n_rows} rows of `x {t.cmp} {t.constant}`, x "
              f"stored as {t.storage.dtype}")
    x = t.storage
    c = t.constant
    info_ms = cuda_ms(lambda: torch.count_nonzero(x > c))
    kernels = device_kernels(fused)
    rec["kernels_per_call"] = len(kernels)
    print(f"masked_reduce at Q1's inputs, device kernels of one call "
          f"(torch.profiler): {kernels}; torch.count_nonzero(x > c) "
          f"{info_ms:.4f} ms, for information", flush=True)
    if len(kernels) != 1:
        fail(f"one K1 call ran {len(kernels)} device kernels: {kernels}")
    # the mask form, at the main path's largest bool-mask count
    mop, mdata, m, muns, mrows, mterms = mask_args
    if mdata is not None or m is None or mterms:
        fail(f"K1's largest mask-form launch is not a count over a mask: "
             f"data {mdata is not None}, mask {m is not None}, {mterms}")

    def mask_form():
        return masked_reduce(mop, None, m, n_rows=mrows)
    # the mask's rows below the row bound, and the count
    mb = mrows * m.element_size() + 8
    max_abs_err(mask_form(),
                _masked_reduce_plain(mop, None, m, False, mrows))
    rec.update(
        mask_form_ms=cuda_ms(mask_form),
        mask_form_plain_ms=cuda_ms(
            lambda: _masked_reduce_plain(mop, None, m, False, mrows)),
        mask_form_library_ms=cuda_ms(lambda: torch.sum(m[:mrows])),
        mask_form_bytes=mb, mask_form_bound_ms=bound_ms(mb),
        mask_form_shape=f"count over bool{tuple(m.shape)}, {mrows} rows")
    print(f"masked_reduce, mask form (count over bool{tuple(m.shape)}, "
          f"{mrows} rows, the main path's largest): "
          f"kernel {rec['mask_form_ms']:.4f} ms, plain "
          f"{rec['mask_form_plain_ms']:.4f} ms, library "
          f"{rec['mask_form_library_ms']:.4f} ms (torch.sum(mask)), {mb} "
          f"bytes, bound {bound_ms(mb):.4f} ms, share of bound "
          f"{bound_ms(mb) / rec['mask_form_ms']:.3f}", flush=True)
    return rec


def k3_split(call):
    """Device ms of K3's level 1 (k_topk_stream) and of its merge
    (k_topk_bound + k_topk_final) in one call, from a torch.profiler trace
    (device_kernels).  None where the trace holds no device time for
    them."""
    kernels = device_kernels(call)

    def ms(*names):
        return sum(t for k, t in kernels.items()
                   if any(n in k for n in names)) or None
    return ms("k_topk_stream"), ms("k_topk_bound", "k_topk_final")


def q_shapes(dev, args):
    """Each kernel on the inputs the main path gave it (100M rows), held
    against its plain version and timed beside it, beside one PyTorch call
    of the same function where there is one (timed here only; the port
    never calls it).  -> {name: record}."""
    from clickhouse_tpu_torch.ops.mxu_segsum import (
        _dense_group_reduce_plain, dense_group_reduce)
    from clickhouse_tpu_torch.ops.sort_ops import (
        _topk_smallest32_plain, _topk_smallest_plain, topk_smallest,
        topk_smallest32)
    out = {}
    for key in ("masked_reduce", "masked_reduce:mask"):
        if key not in args:
            fail(f"the main path gave {key} no launch")
    # Q1: count() with the filter `x > 500000` as a K1 term
    out["masked_reduce"] = k1_forms(dev, args["masked_reduce"],
                                    args["masked_reduce:mask"])
    # Q2: slot ids, base mask, counts for count() and the group count (one
    # mask, counted once), sum(x)
    k2 = args["dense_group_reduce"]
    ids, base, cms, svs, sms, S = k2
    got, want = dense_group_reduce(*k2), _dense_group_reduce_plain(*k2)
    out["dense_group_reduce"] = dict(
        max_abs_err=max(max_abs_err(a, b) for a, b in zip(got, want)),
        ms=cuda_ms(lambda: dense_group_reduce(*k2)),
        plain_ms=cuda_ms(lambda: _dense_group_reduce_plain(*k2), reps=5),
        library_ms=None,
        library="none: no single PyTorch call gives exact per-slot counts "
                "and int64 sums together",
        bytes=nbytes(ids, base, cms, svs, sms) + (len(cms) + len(svs)) * S * 8,
        shape=f"ids {tuple(ids.shape)} {ids.dtype}, base mask "
              f"{None if base is None else base.dtype}, {len(cms)} counts, "
              f"sums of {[v.dtype for v in svs]}, S = {S}")
    # its two halves alone: the counts, and the sums
    out["dense_group_reduce"]["counts_only_ms"] = cuda_ms(
        lambda: dense_group_reduce(ids, base, cms[:1], [], [], S))
    out["dense_group_reduce"]["sums_only_ms"] = cuda_ms(
        lambda: dense_group_reduce(ids, base, [], svs, sms, S))
    print(f"dense_group_reduce at Q2's inputs, counts alone "
          f"{out['dense_group_reduce']['counts_only_ms']:.4f} ms, sums alone "
          f"{out['dense_group_reduce']['sums_only_ms']:.4f} ms", flush=True)
    # the same reduction over skewed slots, where a warp's lanes share one:
    # every row in one slot (S = 1), and Zipf(1.1) slots over S = 1,024
    # (inverse CDF on the card, from a seed)
    n = ids.shape[0]
    gen = torch.Generator(device=dev).manual_seed(5)
    cdf = torch.cumsum(torch.arange(1, 1025, dtype=torch.float64,
                                    device=dev) ** -1.1, 0)
    zipf = torch.searchsorted(cdf / cdf[-1], torch.rand(
        n, generator=gen, dtype=torch.float64, device=dev)).clamp_(max=1023)
    for key, S_, sid in (("one_slot_ms", 1, torch.zeros_like(ids)),
                         ("zipf_ms", 1024, zipf.to(torch.int32))):
        ks = (sid, base, cms, svs, sms, S_)
        for a, b in zip(dense_group_reduce(*ks),
                        _dense_group_reduce_plain(*ks)):
            max_abs_err(a, b)
        out["dense_group_reduce"][key] = cuda_ms(
            lambda: dense_group_reduce(*ks))
    del zipf
    print(f"dense_group_reduce at 100M rows, skewed: one slot "
          f"{out['dense_group_reduce']['one_slot_ms']:.4f} ms, Zipf(1.1) over "
          f"1,024 slots {out['dense_group_reduce']['zipf_ms']:.4f} ms "
          f"(exact against the plain version)", flush=True)
    out["dense_group_reduce"]["wide_s_ms"] = k2_wide(dev)

    def bincount_index_add():
        # index_add_ sums in its source's type: x's int32 storage widened
        torch.bincount(ids, minlength=1024)
        torch.zeros(1024, dtype=torch.int64, device=dev).index_add_(
            0, ids, svs[0].to(torch.int64))
    print(f"dense_group_reduce for information: torch.bincount + "
          f"index_add_ at Q2's shape {cuda_ms(bincount_index_add):.4f} ms",
          flush=True)
    # Q3: ORDER BY x LIMIT 100 reads the u32 key (int32 bits) and the
    # block's row validity through the 32-bit entry
    key, dtype, valid, k = args["topk_smallest"][:4]
    if dtype != torch.int32:
        fail(f"Q3 took K3's {dtype} entry, not the 32-bit one")
    out["topk_smallest"] = dict(
        max_abs_err=max_abs_err(topk_smallest32(key, valid, k),
                                _topk_smallest32_plain(key, valid, k)),
        ms=cuda_ms(lambda: topk_smallest32(key, valid, k)),
        plain_ms=cuda_ms(lambda: _topk_smallest32_plain(key, valid, k),
                         reps=5),
        library_ms=cuda_ms(lambda: torch.topk(key, k, largest=False,
                                              sorted=True)),
        library=f"torch.topk(key, {k}, largest=False, sorted=True), time "
                f"only (its tie order is unpinned)",
        bytes=nbytes(key, valid) + k * 8,
        shape=f"key {tuple(key.shape)} {key.dtype}, valid "
              f"{None if valid is None else valid.dtype}, k = {k}")
    level1, merge = k3_split(lambda: topk_smallest32(key, valid, k))
    # the 64-bit entry at the same rows: the u64 order token of the key
    tok = key.to(torch.int64) & 0xFFFFFFFF
    max_abs_err(topk_smallest(tok, valid, k),
                _topk_smallest_plain(tok, valid, k))
    ms64 = cuda_ms(lambda: topk_smallest(tok, valid, k))
    b64 = nbytes(tok, valid) + k * 8
    out["topk_smallest"].update(level1_ms=level1, merge_ms=merge,
                                entry64_ms=ms64,
                                entry64_bound_ms=bound_ms(b64))
    print(f"topk_smallest 32-bit entry, device time by kernel "
          f"(torch.profiler): level 1 {level1} ms, merge {merge} ms; 64-bit "
          f"entry at Q3's rows {ms64:.4f} ms, bound {bound_ms(b64):.4f} ms "
          f"({b64} bytes)", flush=True)
    report(out)
    return out


def report(records):
    """Set each record's bound_ms from its bytes and print the record."""
    for name, r in records.items():
        r["bound_ms"] = bound_ms(r["bytes"])
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"{name} at the main path's shape ({r['shape']}): max_abs_err "
              f"{r['max_abs_err']}, kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {lib} ms ({r['library']}), "
              f"{r['bytes']} bytes, bound {r['bound_ms']:.4f} ms, share of "
              f"bound {r['bound_ms'] / r['ms']:.3f}"
              + (f"; {r['information']}" if "information" in r else "")
              + (f"; in L2: {r['l2_resident']}" if "l2_resident" in r
                 else ""), flush=True)


def k4_record(key, bits, vals):
    """K4 on one main-path input, held against its plain version and timed
    beside it and beside torch.sort.  -> record of the kernels line."""
    from clickhouse_tpu_torch.ops.sort_ops import (
        _radix_sort_pairs_plain, radix_sort_pairs, sort_pass_plan)
    n = key.shape[0]
    got = radix_sort_pairs(key, bits, vals)
    want = _radix_sort_pairs_plain(key, bits, vals)
    passes, digit = sort_pass_plan(bits)
    return dict(
        max_abs_err=max(max_abs_err(a, b) for a, b in zip(got, want)),
        ms=cuda_ms(lambda: radix_sort_pairs(key, bits, vals)),
        plain_ms=cuda_ms(lambda: _radix_sort_pairs_plain(key, bits, vals),
                         reps=5),
        library_ms=cuda_ms(lambda: torch.sort(key, stable=True)),
        library="torch.sort(key, stable=True)",
        # read each key (and value) once, write sorted keys and row ids
        bytes=nbytes(key, vals) + n * key.element_size() + n * 4,
        passes=passes, digit_bits=digit,
        shape=f"{n} {key.dtype} keys of {bits} bits, "
              f"{'row ids' if vals is None else 'given values'}: "
              f"{passes} passes of {digit}-bit digits")


def k5_record(keys, nv, cap_g):
    """K5 on one main-path input, held against its plain version and timed
    beside it and beside torch.unique_consecutive.  -> record of the
    kernels line."""
    from clickhouse_tpu_torch.ops.scan_ops import (_segment_bounds_plain,
                                                   segment_bounds)
    got = segment_bounds(keys, nv, cap_g)
    want = _segment_bounds_plain(keys, nv, cap_g)
    k0 = keys[0]
    return dict(
        max_abs_err=max(max_abs_err(a, b) for a, b in zip(got, want)),
        ms=cuda_ms(lambda: segment_bounds(keys, nv, cap_g)),
        plain_ms=cuda_ms(lambda: _segment_bounds_plain(keys, nv, cap_g),
                         reps=5),
        library_ms=cuda_ms(lambda: torch.unique_consecutive(
            k0, return_inverse=True, return_counts=True)),
        library="torch.unique_consecutive(key, return_inverse=True, "
                "return_counts=True)",
        # read the keys, write a group id a row and 16 bytes a slot
        bytes=nbytes(keys) + k0.shape[0] * 4 + cap_g * 16 + 8,
        shape=f"{len(keys)} sorted key array(s) of {k0.shape[0]} "
              f"{k0.dtype}, {cap_g} group slots")


def k6_bytes(specs, rows, cap_g, group_rows, permuted=True):
    """Bytes K6 over `specs` must move: a group id and a permutation entry
    a row (permuted; the sorted entry reads neither: each slot's start
    instead, 8 bytes a slot), each distinct source column's value (a
    Term's source once, however many forms read it) and each distinct mask
    byte a row; each op's state and each count kept a slot.  -> (bytes,
    launches, the gather sectors: a 32-byte sector a row a gathered source
    column or mask where the rows lie far apart, the permuted design's own
    floor, for information)."""
    from clickhouse_tpu_torch.ops.scan_ops import (_checked_spec,
                                                   _plan_launches)
    launches, _ = _plan_launches([_checked_spec(sp) for sp in specs],
                                 group_rows is not None)
    total = sectors = 0
    for la in launches:
        useful = sum(t.element_size() for t in la.data) \
            + sum(t.element_size() for t in la.masks)
        slots = cap_g * 8 * (len(la.specs) + len(la.counts))
        ids = rows * 8 if permuted else cap_g * 8
        total += ids + rows * useful + slots
        sectors += ids + rows * 32 * (len(la.data) + len(la.masks)) + slots
    return total, len(launches), sectors


def sort_shapes(dev, args):
    """K4, K5 and K6 on the inputs the main path gave them (K4 at Q2b's and
    Q2m's sorts, K5 at Q2b's bounds, K6 at Q2m's one launch), each held
    against its plain version and timed beside it and beside a PyTorch
    call of the same function where there is one.  -> {name: record}."""
    from clickhouse_tpu_torch.ops.scan_ops import (
        _segment_bounds_cuda, _segment_reduce_plain, segment_reduce,
        segment_reduce_many)
    from clickhouse_tpu_torch.ops.sort_ops import _radix_sort_cuda
    out = {}
    for q in ("Q2b", "Q2m"):
        for kernel in ("radix_sort_pairs", "segment_bounds"):
            if f"{kernel}:{q}" not in args:
                fail(f"{q} gave {kernel} no launch")
    key, bits, vals = args["radix_sort_pairs:Q2b"]
    rec = out["radix_sort_pairs"] = k4_record(key, bits, vals)
    # its kernels apart (a trace): one histogram for every pass, then one
    # scatter a pass
    per_call = {}
    split = device_kernels(lambda: _radix_sort_cuda(key, bits, vals),
                           launches=per_call)
    for part in ("hist", "scatter"):
        rec[f"{part}_ms"] = sum(
            t for k, t in split.items() if f"k_onesweep_{part}" in k) or None
    rec["kernels_per_call"] = per_call
    hists = sum(c for k, c in per_call.items() if "k_onesweep_hist" in k)
    scatters = sum(c for k, c in per_call.items()
                   if "k_onesweep_scatter" in k)
    if split and (hists != 1 or scatters != rec["passes"]
                  or len(per_call) != 2):
        fail(f"a K4 call ran {per_call} device kernels, not one histogram "
             f"and {rec['passes']} scatters")
    q2m = k4_record(*args["radix_sort_pairs:Q2m"])
    rec.update(q2m_ms=q2m["ms"], q2m_bound_ms=bound_ms(q2m["bytes"]),
               q2m_library_ms=q2m["library_ms"])
    print(f"radix_sort_pairs device time by kernel (torch.profiler): "
          f"{split}, launches a call {per_call}; at Q2m's inputs "
          f"({q2m['shape']}) "
          f"{q2m['ms']:.4f} ms, bound {rec['q2m_bound_ms']:.4f} ms, "
          f"torch.sort {q2m['library_ms']:.4f} ms", flush=True)
    rec = out["segment_bounds"] = k5_record(*args["segment_bounds:Q2b"])
    # one device kernel a call (a memset clears its look-back words)
    per_call = {}
    split = device_kernels(
        lambda: _segment_bounds_cuda(*args["segment_bounds:Q2b"]),
        launches=per_call)
    rec["kernels_per_call"] = per_call
    if split and (len(per_call) != 1 or any(
            "k_seg_onesweep" not in k or c != 1
            for k, c in per_call.items())):
        fail(f"a K5 call ran {per_call} device kernels, not one "
             f"k_seg_onesweep")
    q2m = k5_record(*args["segment_bounds:Q2m"])
    rec.update(q2m_ms=q2m["ms"], q2m_plain_ms=q2m["plain_ms"],
               q2m_bytes=q2m["bytes"], q2m_bound_ms=bound_ms(q2m["bytes"]),
               q2m_library_ms=q2m["library_ms"])
    # a yardstick of its streaming: a copy of the key array (the same read,
    # a write of the group ids' size)
    k0 = args["segment_bounds:Q2b"][0][0]
    rec["copy_ms"] = cuda_ms(lambda: k0.clone())
    print(f"segment_bounds at Q2b's inputs: {rec['ms']:.4f} ms against a "
          f"copy of its key array {rec['copy_ms']:.4f} ms", flush=True)
    print(f"segment_bounds device kernels of one call (torch.profiler): "
          f"{split}, launches a call {per_call}; at Q2m's inputs "
          f"({q2m['shape']}) {q2m['ms']:.4f} ms, plain "
          f"{q2m['plain_ms']:.4f} ms, bound {rec['q2m_bound_ms']:.4f} ms, "
          f"library {q2m['library_ms']:.4f} ms ({q2m['library']})",
          flush=True)
    if "segment_reduce" not in args:
        fail("the main path gave K6 no launch")
    # Q2m's one launch: its four aggregates over x's storage
    specs, perm, gid, cap_g, group_rows = args["segment_reduce"][:5]
    rows = gid.shape[0]
    nb, n_launch, _ = k6_bytes(specs, rows, cap_g, group_rows)
    if n_launch != 1:
        fail(f"Q2m's K6 specs take {n_launch} launches")

    def many():
        return segment_reduce_many(specs, perm, gid, cap_g,
                                   group_rows=group_rows)

    def many_plain():
        return [_segment_reduce_plain(op, d, m, perm, gid, cap_g, u)
                for op, d, m, u in specs]
    rec = dict(
        max_abs_err=k6_agrees(specs, perm, gid, cap_g, group_rows),
        ms=cuda_ms(many), plain_ms=cuda_ms(many_plain, reps=5),
        library_ms=None,
        library="none: no single PyTorch call gathers through the "
                "permutation and reduces each group",
        bytes=nb, specs=[op for op, _, _, _ in specs],
        shape=f"{', '.join(op for op, _, _, _ in specs)} in one launch over "
              f"{rows} sorted rows, columns "
              f"{sorted({str(d.dtype) for _, d, _, _ in specs})}, masks "
              f"{sum(m is not None for _, _, m, _ in specs)}, {cap_g} group "
              f"slots, group_rows {group_rows is not None}")
    # each op alone, as a one-spec call (which keeps a count for min, max
    # and any)
    rec["per_op_ms"] = {
        op: cuda_ms(lambda op=op, d=d, m=m, u=u: segment_reduce(
            op, d, m, perm, gid, cap_g, unsigned=u))
        for op, d, m, u in specs}
    # for information: torch.segment_reduce over the values gathered into
    # sorted order beforehand (floats only), at Q2m's groups
    data = next(d for op, d, _, _ in specs if d is not None)
    nvalid = int((gid < cap_g).sum())
    lengths = torch.bincount(gid[:nvalid].long())
    vals = data.index_select(0, perm[:nvalid]).to(torch.float64)
    info = cuda_ms(lambda: torch.segment_reduce(vals, "sum",
                                                lengths=lengths), reps=5)
    rec["information"] = (f"torch.segment_reduce(sum) over pre-gathered "
                          f"float64 values {info:.4f} ms")
    del vals
    # one group holding 40 % of 100M rows
    sperm, sgid = grouped_rows(N_ROWS, 1 << 20, dev, skew=0.4)
    x = data if data.shape[0] >= N_ROWS else torch.arange(
        N_ROWS, dtype=torch.int32, device=dev)
    k6_agrees([("sum", x, None, False)], sperm, sgid, 1 << 21)
    rec["skew_ms"] = cuda_ms(lambda: segment_reduce("sum", x, None, sperm,
                                                    sgid, 1 << 21))
    sb = N_ROWS * (8 + x.element_size()) + (1 << 21) * 8
    rec["skew_bound_ms"] = bound_ms(sb)
    print(f"segment_reduce over {N_ROWS} rows, one group holding 40 % of "
          f"them: {rec['skew_ms']:.4f} ms, bound "
          f"{rec['skew_bound_ms']:.4f} ms ({sb} bytes; agrees with the "
          f"plain version); each op alone at Q2m's inputs "
          f"{rec['per_op_ms']}", flush=True)
    del sperm, sgid
    out["segment_reduce"] = rec
    report(out)
    return out


def expected_answers(x: np.ndarray):
    q1 = [(int((x > 500000).sum()),)]
    k = x % 1024
    cnt = np.bincount(k, minlength=1024)
    # float64 weights are exact here: every partial sum is an integer below
    # 2^53 (the whole column sums to ~5e13)
    if int(x.sum()) >= 2**53:
        fail("numpy reference sum would not be exact")
    sums = np.bincount(k, weights=x.astype(np.float64),
                       minlength=1024).astype(np.int64)
    # ORDER BY c DESC: ties keep slot (= key) order, as the engine's top-k
    top = np.lexsort((np.arange(1024), -cnt))[:10]
    q2 = [(int(i), int(cnt[i]), int(sums[i])) for i in top]
    q3 = [(int(v),) for v in np.sort(np.partition(x, 100)[:100])]
    # Q2b: a group a distinct x, in ascending key order; ties of c keep it
    cnt_b = np.bincount(x)
    top_b = np.lexsort((np.arange(len(cnt_b)), -cnt_b))[:10]
    q2b = [(int(i), int(cnt_b[i])) for i in top_b]
    # Q2m: groups of intDiv(x, 4) (x >= 0: floor division) by (-s, k);
    # any(x) is the first row of the group in row order
    km = x // 4
    cnt_m = np.bincount(km)
    sum_m = np.bincount(km, weights=x.astype(np.float64)).astype(np.int64)
    top_m = np.lexsort((np.arange(len(sum_m)), -sum_m))[:10]
    q2m = []
    for g in top_m:
        rows = np.flatnonzero(km == g)
        q2m.append((int(g), int(cnt_m[g]), int(sum_m[g]),
                    int(x[rows].min()), int(x[rows].max()), int(x[rows[0]])))
    # slice 10: Q2's rows with the totals row (the key at 0); LIMIT 2 BY
    # intDiv(x, 4) keeps at most two rows a group; DISTINCT its groups
    total = (0, len(x), int(x.sum()))
    q2l = [(int(np.minimum(cnt_m, 2).sum()),)]
    q2d = [(int((cnt_m > 0).sum()),)]
    return {"Q1": q1, "Q2": q2, "Q2b": q2b, "Q2m": q2m, "Q3": q3,
            "Q2t": q2, "Q2t:totals": [total], "Q2l": q2l, "Q2d": q2d}


def string_answers():
    """Q7, Q7b, Q7d and Q7s over hits_s, from the integers behind the urls
    (each of N_S_DISTINCT values twice): the values whose decimal digits
    start with 1, and those ending in 99."""
    copies = N_S_ROWS // N_S_DISTINCT
    ones = sum(max(0, min(2 * 10 ** d, N_S_DISTINCT) - 10 ** d)
               for d in range(len(str(N_S_DISTINCT))))
    end99 = len(range(99, N_S_DISTINCT, 100))
    return {"Q7": [(N_S_DISTINCT,)], "Q7b": [(copies * ones,)],
            "Q7d": [(N_S_DISTINCT,)], "Q7s": [(copies * end99,)]}


def check_small_queries(ch):
    """SELECT without FROM, numbers() and INSERT ... VALUES with
    expressions through connect(device="cuda"), against numpy."""
    s = ch.connect(device="cuda")
    num = np.arange(1000, dtype=np.uint64)
    k = num % 7
    cases = [
        ("SELECT 1", [(1,)]),
        ("SELECT 1 + 2 AS a, 'x'", [(3, "x")]),
        ("SELECT count() FROM numbers(10)", [(10,)]),
        ("SELECT number % 7 AS k, count(), sum(number) FROM numbers(1000) "
         "GROUP BY k ORDER BY k",
         [(int(g), int((k == g).sum()), int(num[k == g].sum()))
          for g in range(7)]),
        ("SELECT number FROM numbers(5, 3)", [(5,), (6,), (7,)]),
    ]
    s.execute("CREATE TABLE ins (a Int64, b Int32)")
    s.execute("INSERT INTO ins VALUES (1+2, 4), (-7, 2*3)")
    cases.append(("SELECT a, b FROM ins ORDER BY a", [(-7, 6), (3, 4)]))
    for sql, want in cases:
        got = s.execute(sql).rows()
        if got != want:
            fail(f"{sql} returned {got}, numpy says {want}")
    print(f"{len(cases)} small queries on the card match numpy (SELECT "
          f"without FROM, numbers(), INSERT VALUES with expressions)",
          flush=True)


def load_hits(ch):
    """A cuda session with hits (x Int64) of N_ROWS rows on the device."""
    x = (np.arange(N_ROWS, dtype=np.int64) * 2654435761) % 1_000_003
    s = ch.connect(device="cuda")
    s.execute("CREATE TABLE hits (x Int64)")
    t0 = time.perf_counter()
    s.insert_pydict("hits", {"x": x})
    s.catalog.get_table("default", "hits").read_block()
    torch.cuda.synchronize()
    print(f"insert + device block of {N_ROWS} rows: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return s, x


def load_hits_s(s):
    """hits_s (url String) in session s, as bench.py:455-465 makes it;
    prints the host time of the table's device block (its dictionary: a
    sort of the urls).  The dictionary's chars are not built here: Q7b's
    first run builds them, under the governor's check."""
    t0 = time.perf_counter()
    urls = np.char.add(URL_PREFIX,
                       (np.arange(N_S_ROWS) % N_S_DISTINCT).astype(str))
    t1 = time.perf_counter()
    s.execute("CREATE TABLE hits_s (url String)")
    s.insert_pydict("hits_s", {"url": urls})
    del urls
    col = s.catalog.get_table("default", "hits_s").read_block()["url"]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"hits_s: {N_S_ROWS} urls made in {t1 - t0:.1f} s; insert + "
          f"device block (codes, {len(col.dictionary)} dictionary values) "
          f"{t2 - t1:.1f} s", flush=True)


def device_busy(s, sql, reps=QUERY_REPS, events_out=None):
    """(device-busy ms, device operations, wall ms, top) per run of sql,
    from a torch.profiler trace of `reps` runs (busy: the union of the
    intervals of the device's kernels, copies and fills; the wall is the
    traced one; top: the 8 device operations that take the most device
    time, as (name, ms a run)).  events_out, a list, gets each device
    operation's (name, start us, end us)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    s.execute(sql)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            s.execute(sql)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if events_out is not None:
        events_out.extend((e.name, e.time_range.start, e.time_range.end)
                          for e in events)
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    top = [(name[:70], t / reps / 1e3) for name, t in top]
    return busy / reps / 1e3, len(spans) / reps, wall / reps * 1e3, top


def time_queries(s):
    """Median wall of QUERY_REPS runs of each query (after one untimed run)
    and its peak device memory above what was allocated before it, beside
    the governor's estimate; then the device-busy time of Q1, Q2b, Q2m
    and the join queries from a trace, and Q4's wall over the probe
    roofline.  Uses only the public API (and the governor's estimate), so
    copied into an unpacked older checkout (``--queries``) it times that
    tree alike; a query that tree does not run (NotImplementedError_) is
    reported and skipped."""
    from clickhouse_tpu_torch.core.errors import (NotImplementedError_,
                                                  UnknownFunction)
    from clickhouse_tpu_torch.exec.streaming import \
        estimate_plan_device_bytes
    from clickhouse_tpu_torch.sql import parse
    ran = {}
    for name, sql in QUERIES + JOIN_QUERIES + SLICE10_QUERIES \
            + SLICE11_QUERIES + SLICE12_QUERIES + SLICE13_QUERIES:
        try:
            s.execute(sql)
        except (NotImplementedError_, UnknownFunction) as e:
            print(f"{name} not ported in this tree: {e}", flush=True)
            continue
        times = []
        for _ in range(QUERY_REPS):
            t0 = time.perf_counter()
            s.execute(sql)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        ran[name] = statistics.median(times) * 1e3
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        s.execute(sql)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        est = estimate_plan_device_bytes(s._plan(parse(sql), s.settings),
                                         s.catalog, s.settings)
        rows = N_S_ROWS if "hits_s" in sql else (
            N_VECS if "vecs" in sql else N_ROWS)
        print(f"{name} median wall {ran[name]:.3f} ms "
              f"over {QUERY_REPS} runs ({rows} rows); peak {peak} bytes "
              f"above what was allocated before it, the governor's "
              f"estimate {est} bytes: {sql}", flush=True)
    if "Q4" in ran:
        roof = probe_roofline(torch.device("cuda", 0))
        print(f"Q4 probe roofline (bench.py:509-525 on this card: one "
              f"gather tbl[idx] of {N_ROWS} int32 indices from a {N_DIM}-"
              f"entry int32 table, CUDA events, L2 flushed): {roof:.4f} ms; "
              f"Q4's median wall {ran['Q4']:.3f} ms is "
              f"{ran['Q4'] / roof:.2f}x it", flush=True)
    for name, sql in QUERIES + JOIN_QUERIES + SLICE10_QUERIES \
            + SLICE11_QUERIES + SLICE12_QUERIES + SLICE13_QUERIES:
        if name in BUSY_QUERIES and name in ran:
            busy, ops, wall, top = device_busy(s, sql)
            print(f"{name} under torch.profiler: device busy {busy:.4f} ms "
                  f"of {wall:.3f} ms wall a run, {ops:g} device operations "
                  f"a run", flush=True)
            if name != "Q1":
                print(f"{name} device ms a run by operation (the top 8): "
                      + "; ".join(f"{n} {t:.4f}" for n, t in top),
                      flush=True)


def load_join_tables(s):
    """The join queries' tables in session s: dim and fact as bench.py:492-507
    makes them, dim_h / fact_h (unique keys far apart, every 10th probe row
    without a match) and dim2 (each key twice).  -> (fact.fk, dim.label)
    as numpy, for the answers."""
    k = np.arange(N_DIM, dtype=np.int64)
    label = (k * 7) % 97
    i = np.arange(N_ROWS, dtype=np.int64)
    fk = (i * 40503) % N_DIM
    kh = k * 2654435761
    t0 = time.perf_counter()
    for name, cols in (("dim", {"k": k, "label": label}),
                       ("dim_h", {"k": kh, "label": label}),
                       ("dim2", {"k": k // 2, "label": label}),
                       ("fact", {"fk": fk}),
                       ("fact_h", {"fk": kh[fk] + (i % 10 == 0)})):
        s.execute(f"CREATE TABLE {name} ("
                  + ", ".join(f"{c} Int64" for c in cols) + ")")
        s.insert_pydict(name, cols)
        s.catalog.get_table("default", name).read_block()
    torch.cuda.synchronize()
    print(f"insert + device blocks of the join tables (dim, dim_h, dim2 of "
          f"{N_DIM} rows, fact and fact_h of {N_ROWS}): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return fk, label


def join_answers(fk, label):
    """count() and sum(label) of Q4, Q4h and Q4x, from numpy."""
    cnt = np.bincount(fk, minlength=N_DIM)
    # fact_h: every 10th row's key is one past a build key
    cnt_h = cnt - np.bincount(fk[::10], minlength=N_DIM)
    # dim2: key g holds the build rows 2g and 2g + 1
    half = N_DIM // 2
    pair = label[0::2] + label[1::2]
    return {"Q4": [(int(cnt.sum()), int((cnt * label).sum()))],
            "Q4h": [(int(cnt_h.sum()), int((cnt_h * label).sum()))],
            "Q4x": [(int(2 * cnt[:half].sum()),
                     int((cnt[:half] * pair).sum()))]}


def path_phase(s, queries, paths, cover, want, per_query, launches,
               launch_rows, memory, label, chars_built=None, agree=None):
    """Each query of `queries` once, checked against numpy (equal rows, or
    agree(name, rows) where given), with the launch counters set to 0
    before it and read after; fails unless it launched exactly the
    kernels of its path (`paths`), the kernel `cover` names over at least
    its rows, and built a dictionary's device chars exactly as often as
    `chars_built` says (default 0), each under the governor's check.  ->
    {query: (peak bytes above what was allocated before it, the
    governor's estimate)}."""
    from clickhouse_tpu_torch.exec.streaming import (
        effective_memory_budget, estimate_plan_device_bytes)
    from clickhouse_tpu_torch.ops import _native
    from clickhouse_tpu_torch.sql import parse
    out = {}
    for name, sql in queries:
        for v in memory.values():
            del v[:]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _native.reset_launches()
        res = s.execute(sql)
        rows = res.rows()
        per_query[name] = dict(_native.LAUNCHES)
        rows_of = {k: list(v) for k, v in _native.LAUNCH_ROWS.items()}
        extra = peak_since(base, memory)
        if not (agree(name, rows) if agree else rows == want[name]):
            fail(f"{name} returned {rows[:5]}, numpy says {want[name][:5]}")
        print_dense_split(name, memory, base, extra)
        if f"{name}:totals" in want:
            got = None if res.totals is None else [
                tuple(cell_value(v[0]) for v in res.totals.values())]
            if got != want[f"{name}:totals"]:
                fail(f"{name}'s totals are {got}, numpy says "
                     f"{want[name + ':totals']}")
        for k, v in rows_of.items():
            launches[k] += per_query[name][k]
            launch_rows[k] += v
        path = {k: paths[name].get(k, 0) for k in per_query[name]}
        if per_query[name] != path:
            fail(f"{name} launched {per_query[name]}; its path is "
                 f"{paths[name]} and nothing else")
        kernel, need = cover[name]
        covered = max(rows_of[kernel], default=0)
        if covered < need:
            fail(f"{name}'s {kernel} covered {covered} rows, not {need}")
        est = estimate_plan_device_bytes(s._plan(parse(sql), s.settings),
                                         s.catalog, s.settings)
        out[name] = (extra, est)
        built = list(memory["chars"])
        if len(built) != (chars_built or {}).get(name, 0) \
                or not all(checked for _, _, checked in built):
            fail(f"{name} built dictionary chars {built} (seconds, bytes, "
                 f"checked); its path builds "
                 f"{(chars_built or {}).get(name, 0)}, each checked")
        for secs, size, _ in built:
            left = effective_memory_budget(s.settings) - est
            print(f"{name}: built a dictionary's chars and offsets on the "
                  f"device ({size} bytes) in {secs:.3f} s, held first "
                  f"against the {left} bytes the governor's estimate "
                  f"({est} bytes) leaves of the budget; the peak below "
                  f"includes them", flush=True)
        print(f"{name}: launches "
              f"{ {k: v for k, v in per_query[name].items() if v} }, rows a "
              f"launch { {k: v for k, v in rows_of.items() if v} }; device "
              f"memory at its peak {extra} bytes above what was allocated "
              f"before it, the governor's estimate {est} bytes", flush=True)
    print(f"{label} match numpy, each on its kernel path", flush=True)
    return out


def cell_value(v):
    """A result cell as a Python value."""
    return v.item() if hasattr(v, "item") else v


def join_path(s, want, per_query, launches, launch_rows, memory):
    """Q4, Q4h and Q4x (JOIN_PATHS), their probe kernel over every probe
    row."""
    return path_phase(s, JOIN_QUERIES, JOIN_PATHS,
                      {q: (k, N_ROWS) for q, k in JOIN_PROBE.items()}, want,
                      per_query, launches, launch_rows, memory,
                      f"Q4, Q4h and Q4x over {N_ROWS} probe rows")


def slice10_path(s, want, per_query, launches, launch_rows, memory):
    """Q2t, Q2l and Q2d over hits, then Q7, Q7b, Q7d and Q7s over hits_s
    (SLICE10_PATHS), each one's first kernel over every row (K10: over
    every dictionary value)."""
    cover = {"Q2t": ("dense_group_reduce", N_ROWS),
             "Q2l": ("radix_sort_pairs", N_ROWS),
             "Q2d": ("radix_sort_pairs", N_ROWS),
             "Q7": ("radix_sort_pairs", N_S_ROWS),
             "Q7b": ("prefix_match", N_S_DISTINCT),
             "Q7d": ("radix_sort_pairs", N_S_ROWS),
             "Q7s": ("prefix_match", N_S_DISTINCT)}
    return path_phase(s, SLICE10_QUERIES, SLICE10_PATHS, cover, want,
                      per_query, launches, launch_rows, memory,
                      "Q2t, Q2l, Q2d, Q7, Q7b, Q7d and Q7s",
                      chars_built={"Q7b": 1})


def slice12_answers(x: np.ndarray):
    """Q2u, Q2ug, Q2q, Q2s2 and Q2g by numpy, and the scale of each float
    cell (STAT_TOL; 0: the cell must be equal).  The values of a group of
    x % 1024 are the residues k, k + 1024, ... below 1,000,003, each as
    often as bincount says; Q2s2's groups 0-9 from their rows in row
    order."""
    p = 1_000_003
    cnt = np.bincount(x, minlength=p)
    present = np.flatnonzero(cnt)
    u = np.bincount(present % 1024, minlength=1024)
    top = np.lexsort((np.arange(1024), -u))[:10]

    def at(vals, mult, q):
        # the floor(q * (n - 1))-th smallest of vals repeated mult times
        pos = int(math.floor(q * (int(mult.sum()) - 1)))
        return int(vals[np.searchsorted(np.cumsum(mult), pos,
                                        side="right")])
    q2q = []
    for k in range(10):
        vals = np.arange(k, p, 1024)
        q2q.append((k, at(vals, cnt[vals], 0.5),
                    [at(vals, cnt[vals], 0.1), at(vals, cnt[vals], 0.9)]))
    km = x % 1024
    rows = np.flatnonzero(km < 10)
    xs, ks = x[rows], km[rows]
    q2s2, scale_s2 = [], []
    for k in range(10):
        v = xs[ks == k]
        m = v % 7
        vf = v.astype(np.float64)
        ms2 = float(np.mean(vf * vf))
        q2s2.append((k, int(v[np.argmax(m)]), float(vf.var(ddof=1)),
                     float(vf.std()), float(np.corrcoef(vf, m)[0, 1]),
                     int(np.bitwise_xor.reduce(v))))
        scale_s2.append((0, 0, ms2, math.sqrt(ms2), 1.0, 0))
    vals = np.arange(p)
    n = len(x)
    mean = float((vals * cnt).sum()) / n
    var = float((cnt * (vals - mean) ** 2).sum()) / n
    ms_all = float((cnt * vals.astype(np.float64) ** 2).sum()) / n
    m7 = x % 7
    q2g = [(var, int(x[np.argmin(m7)]), at(vals, cnt, 0.5))]
    del m7
    return {"Q2u": [(len(present),)],
            "Q2ug": [(int(k), int(u[k])) for k in top],
            "Q2q": q2q, "Q2s2": q2s2, "Q2s2:scale": scale_s2,
            "Q2g": q2g, "Q2g:scale": [(ms_all, 0, 0)]}


def slice12_agree(want):
    """-> agree(name, rows) for path_phase: integers (and arrays) equal,
    each float within STAT_TOL of its cell's scale."""
    def agree(name, rows):
        scale = want.get(f"{name}:scale")
        if scale is None:
            return rows == want[name]
        if len(rows) != len(want[name]):
            return False
        for got, w, sc in zip(rows, want[name], scale):
            for g, v, c in zip(got, w, sc):
                if c == 0 and g != v:
                    return False
                if c and not (isinstance(g, float)
                              and abs(g - v) <= STAT_TOL * c):
                    return False
        return True
    return agree


def slice12_path(s, want, per_query, launches, launch_rows, memory):
    """Q2u, Q2ug, Q2q, Q2s2 and Q2g over hits (SLICE12_PATHS), their first
    sort (or K6 sorted-order entry) over every row; -> (the phase's peaks
    and estimates, the arguments of Q2ug's and Q2s2's K6 sorted-order
    calls, those of Q2s2's K6 permuted call)."""
    from clickhouse_tpu_torch.exprs.aggregates import GroupContext
    from clickhouse_tpu_torch.ops import scan_ops
    cover = {"Q2u": ("segment_reduce_sorted", N_ROWS),
             "Q2ug": ("segment_reduce_sorted", N_ROWS),
             "Q2q": ("radix_sort_pairs", N_ROWS),
             "Q2s2": ("segment_reduce_sorted", N_ROWS),
             "Q2g": ("radix_sort_pairs", N_ROWS)}
    entry, execute = scan_ops.segment_reduce_sorted, s.execute
    many = scan_ops.segment_reduce_many
    hold = GroupContext.hold
    current, got, held = [""], {}, {}

    def execute_watch(sql, *a, **kw):
        current[0] = sql
        return execute(sql, *a, **kw)

    def hold_watch(ctx, nbytes, what):
        # the aggregates' working set the governor held (passed on)
        hold(ctx, nbytes, what)
        held[current[0]] = max(held.get(current[0], 0), ctx.shared["bytes"])

    def entry_watch(specs, starts, ends, n, *, group_rows=None):
        # the call's inputs, kept to replay it (passed on as it is)
        if current[0] in (Q2UG, Q2S2):
            got["args" if current[0] == Q2UG else "q2s2_sorted"] = (
                list(specs), starts, ends, n, group_rows)
        return entry(specs, starts, ends, n, group_rows=group_rows)

    def many_watch(specs, perm, gid, cap_g, *, group_rows=None):
        # Q2s2's seven reductions, kept to replay them (passed on as is)
        if current[0] == Q2S2:
            got["q2s2"] = (list(specs), perm, gid, cap_g, group_rows)
        return many(specs, perm, gid, cap_g, group_rows=group_rows)
    s.execute, scan_ops.segment_reduce_sorted = execute_watch, entry_watch
    scan_ops.segment_reduce_many = many_watch
    GroupContext.hold = hold_watch
    try:
        out = path_phase(s, SLICE12_QUERIES, SLICE12_PATHS, cover, want,
                         per_query, launches, launch_rows, memory,
                         "Q2u, Q2ug, Q2q, Q2s2 and Q2g",
                         agree=slice12_agree(want))
    finally:
        s.execute, scan_ops.segment_reduce_sorted = execute, entry
        scan_ops.segment_reduce_many = many
        GroupContext.hold = hold
    if "args" not in got or "q2s2_sorted" not in got:
        fail("Q2ug or Q2s2 did not reach K6's sorted-order entry")
    if "q2s2" not in got:
        fail("Q2s2 did not reach K6's permuted entry")
    for name, sql in SLICE12_QUERIES:
        print(f"{name}: the aggregates' working set held against the "
              f"budget (GroupContext.hold: the grouping's perm and group "
              f"ids, the float64 columns, the holistic steps) "
              f"{held.get(sql, 0)} bytes; peak {out[name][0]} bytes, the "
              f"governor's estimate {out[name][1]} bytes", flush=True)
    return out, (got["args"], got["q2s2_sorted"]), got["q2s2"]


def k6_sorted_shape(dev, args, name="Q2ug"):
    """K6's sorted-order entry on the inputs a query gave it (Q2ug: its
    first-occurrence flags over 100M sorted rows; Q2s2: argMax's smallest
    row id at the best value): against its plain version, timed beside its
    bound and, for a count of flags, torch.segment_reduce(sum,
    lengths=group rows), which computes the same per-group sum of the
    flags (it takes floating types only: it gets a float32 copy of the
    flags, made before its timing)."""
    from clickhouse_tpu_torch.ops.scan_ops import (_segment_reduce_plain,
                                                   gid_of_bounds,
                                                   segment_reduce_sorted)
    specs, starts, ends, n, group_rows = args
    cap_g = starts.shape[0]
    # the bound's bytes: what the function needs, as
    # torch.segment_reduce(lengths=) reads it: each column and mask byte a
    # row, each group's bound (8 bytes a slot), each output (8 bytes a
    # slot a state).  K6 reads no group id
    nb, n_launch, _ = k6_bytes(specs, n, cap_g, group_rows, permuted=False)
    gid = gid_of_bounds(starts, ends, n)

    def sorted_call():
        return segment_reduce_sorted(specs, starts, ends, n,
                                     group_rows=group_rows)

    def plain():
        return [_segment_reduce_plain(op, d, m, None, gid, cap_g, u)
                for op, d, m, u in specs]
    got = sorted_call()
    err = 0.0
    for (op, d, m, u), g, w in zip(specs, got, plain()):
        err = max(err, k6_close(op, g, w, d, m, None, gid, cap_g, u))
    pre = "sorted" if name == "Q2ug" else "q2s2_sorted"
    rec = {f"{pre}_entry": "segment_reduce_sorted", f"{pre}_bytes": nb,
           f"{pre}_bound_ms": bound_ms(nb), f"{pre}_ms": cuda_ms(sorted_call),
           f"{pre}_plain_ms": cuda_ms(plain, reps=5),
           f"{pre}_shape": f"{[op for op, _, _, _ in specs]} over {n} "
                           f"sorted rows ({name}), {cap_g} group slots, "
                           f"{n_launch} launch",
           f"{pre}_max_abs_err": err}
    op, d, m, _ = specs[0]
    lib, what = None, "none"
    if len(specs) == 1 and op == "count" and group_rows is not None:
        n_valid = int(group_rows.sum())
        flags = m[:n_valid].to(torch.float32)
        out = torch.segment_reduce(flags, "sum", lengths=group_rows)
        if not torch.equal(out.to(torch.int64), got[0]):
            fail("torch.segment_reduce's sums of the flags differ from K6's")
        lib = cuda_ms(lambda: torch.segment_reduce(flags, "sum",
                                                   lengths=group_rows))
        what = ("torch.segment_reduce(float32 copy of the flags, 'sum', "
                "lengths=group rows)")
        del flags
    rec[f"{pre}_library_ms"], rec[f"{pre}_library"] = lib, what
    del gid
    print(f"segment_reduce_sorted (K6's sorted-order entry) at {name}'s "
          f"inputs ({rec[f'{pre}_shape']}): {rec[f'{pre}_ms']:.4f} ms, "
          f"plain {rec[f'{pre}_plain_ms']:.4f} ms, bound "
          f"{rec[f'{pre}_bound_ms']:.4f} ms ({nb} bytes; no group id "
          f"read), library {lib} ms ({what}); agrees with the plain "
          f"version (max abs err {err:g})", flush=True)
    return rec


def k6_q2s2_shape(args):
    """K6's permuted entry at Q2s2's inputs (its one launch: argMax's max
    of x % 7, the statistics' terms of x and x % 7 formed in registers,
    groupBitXor's bxor, over 100M rows through perm, x's int32 storage
    gathered once): against its plain version, timed beside its bound and
    its gather-sector floor."""
    from clickhouse_tpu_torch.ops.scan_ops import (_checked_spec,
                                                   _plan_launches,
                                                   _segment_reduce_plain,
                                                   segment_reduce_many)
    specs, perm, gid, cap_g, group_rows = args
    rows = gid.shape[0]
    nb, n_launch, sectors = k6_bytes(specs, rows, cap_g, group_rows)
    if n_launch != 1:
        fail(f"Q2s2's K6 specs take {n_launch} launches")
    la = _plan_launches([_checked_spec(sp) for sp in specs],
                        group_rows is not None)[0][0]
    sources = [f"{t.dtype}" for t in la.data]

    def many():
        return segment_reduce_many(specs, perm, gid, cap_g,
                                   group_rows=group_rows)

    def plain():
        return [_segment_reduce_plain(op, d, m, perm, gid, cap_g, u)
                for op, d, m, u in specs]
    rec = dict(q2s2_max_abs_err=k6_agrees(specs, perm, gid, cap_g,
                                          group_rows),
               q2s2_ms=cuda_ms(many), q2s2_plain_ms=cuda_ms(plain, reps=1),
               q2s2_bytes=nb, q2s2_bound_ms=bound_ms(nb),
               q2s2_sector_bytes=sectors,
               q2s2_sector_floor_ms=bound_ms(sectors),
               q2s2_sources=sources, q2s2_forms=len(la.forms),
               q2s2_shape=f"{[op for op, _, _, _ in specs]} in one launch "
                          f"over {rows} sorted rows, {cap_g} group slots, "
                          f"source columns {sources}, {len(la.forms)} "
                          f"forms")
    print(f"segment_reduce at Q2s2's inputs ({rec['q2s2_shape']}): "
          f"{rec['q2s2_ms']:.4f} ms, plain {rec['q2s2_plain_ms']:.4f} ms, "
          f"bound {rec['q2s2_bound_ms']:.4f} ms ({nb} bytes), the gather "
          f"sectors' floor {rec['q2s2_sector_floor_ms']:.4f} ms ({sectors} "
          f"bytes, for information); agrees with the plain version (max abs "
          f"err {rec['q2s2_max_abs_err']:g})", flush=True)
    return rec


def k6_turn(s):
    """K6 at the inputs Q2m, Q2ug and Q2s2 give it (each call of
    segment_reduce_many and segment_reduce_sorted kept as the executor made
    it, so an older tree's own arguments replay in that tree), timed, and
    the device-busy time of Q2m, Q2u, Q2ug and Q2s2: `--k6`, run in this
    tree and in an unpacked older checkout alike."""
    from clickhouse_tpu_torch.ops import scan_ops
    many, entry, calls = (scan_ops.segment_reduce_many,
                          scan_ops.segment_reduce_sorted, {})
    current = [""]

    def many_watch(*a, **kw):
        calls.setdefault((current[0], "segment_reduce"), (a, kw))
        return many(*a, **kw)

    def entry_watch(*a, **kw):
        calls.setdefault((current[0], "segment_reduce_sorted"), (a, kw))
        return entry(*a, **kw)
    scan_ops.segment_reduce_many = many_watch
    scan_ops.segment_reduce_sorted = entry_watch
    try:
        for name, sql in (("Q2m", Q2M), ("Q2ug", Q2UG), ("Q2s2", Q2S2)):
            current[0] = name
            s.execute(sql)
    finally:
        scan_ops.segment_reduce_many = many
        scan_ops.segment_reduce_sorted = entry
    for (name, kernel), (a, kw) in sorted(calls.items()):
        fn = many if kernel == "segment_reduce" else entry
        ms = cuda_ms(lambda: fn(*a, **kw))
        ops = [sp[0] for sp in a[0]]
        print(f"K6 {kernel} at {name}'s inputs ({ops}): {ms:.4f} ms",
              flush=True)
    for name, sql in (("Q2m", Q2M), ("Q2u", Q2U), ("Q2ug", Q2UG),
                      ("Q2s2", Q2S2)):
        busy, ops, wall, top = device_busy(s, sql)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        s.execute(sql)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        print(f"{name}: device busy {busy:.4f} ms of {wall:.3f} ms wall a "
              f"run, peak {peak} bytes above what was allocated before it",
              flush=True)


def join_args(session):
    """Run the join queries once more with K7's, K8's and K9's wrappers
    spied on; -> the arguments each was given: "dense_join" (Q4's K7
    call), "hash_join" (Q4h's propagate_join), "hash_join:probe" (Q4x's
    probe_join_table) and "expand_matches" (Q4x's K9 call)."""
    from clickhouse_tpu_torch.ops import join_ops
    spied = {"dense_join": "_dense_gather_join_cuda",
             "hash_join": "propagate_join",
             "hash_join:probe": "probe_join_table",
             "expand_matches": "_expand_matches_cuda"}
    got, saved = {}, {}
    for key, attr in spied.items():
        fn = saved[key] = getattr(join_ops, attr)

        def spy(*args, _fn=fn, _key=key):
            got[_key] = args
            return _fn(*args)
        setattr(join_ops, attr, spy)
    try:
        for _, sql in JOIN_QUERIES:
            session.execute(sql)
    finally:
        for key, attr in spied.items():
            setattr(join_ops, attr, saved[key])
    for key in spied:
        if key not in got:
            fail(f"the join queries gave {key} no call")
    return got


def string_args(session):
    """Run Q7b and Q7s once more with K10's launch wrapper spied on; ->
    {query: the arguments of its K10 call}."""
    from clickhouse_tpu_torch.ops import string_ops
    got = {}
    real = string_ops._prefix_match_cuda
    query = [""]

    def spy(*args):
        got[query[0]] = args
        return real(*args)
    string_ops._prefix_match_cuda = spy
    try:
        for name, sql in SLICE10_QUERIES:
            if name in ("Q7b", "Q7s"):
                query[0] = name
                session.execute(sql)
    finally:
        string_ops._prefix_match_cuda = real
    if set(got) != {"Q7b", "Q7s"}:
        fail(f"Q7b and Q7s gave K10 calls {sorted(got)}")
    return got


def k10_bytes(chars, offsets, needle: bytes, suffix: bool) -> int:
    """K10's bytes: the 32-byte sectors of the chars that hold a compared
    byte (the first or last p bytes of each value at least p bytes long;
    a prefix past a value's first differing byte is counted too), each
    value's offsets (U + 1), its output byte, and the needle."""
    off = offsets.to(torch.int64)
    p = len(needle)
    sectors = 0
    if p and chars.numel():
        start, end = off[:-1], off[1:]
        ok = end - start >= p
        first = (end - p if suffix else start)[ok]
        mark = torch.zeros(chars.numel() // 32 + 2, dtype=torch.bool,
                           device=chars.device)
        lo = first // 32
        hi = (first + p - 1) // 32
        for k in range((p + 31) // 32 + 1):
            idx = lo + k
            mark[idx[idx <= hi]] = True
        sectors = int(mark.sum())
    return min(32 * sectors, chars.numel()) + nbytes(offsets) \
        + offsets.numel() - 1 + p


def string_shapes(dev, args):
    """K10 at Q7b's inputs (the prefix of 21 bytes over the 25M-value
    dictionary's chars), held against its plain version and timed beside
    it, with its kernels a call (torch.profiler); and at Q7s's (a suffix of
    2 bytes, `suffix_*`).  No single PyTorch call computes the function:
    library_ms is null."""
    from clickhouse_tpu_torch.ops.string_ops import (_prefix_match_plain,
                                                     prefix_match)
    rec = {}
    for name, key in (("Q7b", ""), ("Q7s", "suffix_")):
        chars, offsets, needle, suffix, negate = args[name]
        call = (chars, offsets, needle, suffix, negate)
        err = max_abs_err(prefix_match(*call), _prefix_match_plain(*call))
        ms = cuda_ms(lambda: prefix_match(*call))
        plain = cuda_ms(lambda: _prefix_match_plain(*call), reps=5)
        nb = k10_bytes(chars, offsets, needle, suffix)
        rec.update({f"{key}ms": ms, f"{key}plain_ms": plain,
                    f"{key}bytes": nb, f"{key}bound_ms": bound_ms(nb)})
        if not key:
            per_call = {}
            kernels = device_kernels(lambda: prefix_match(*call),
                                     launches=per_call)
            rec.update(max_abs_err=err, library_ms=None,
                       kernels_per_call=per_call)
            print(f"prefix_match kernels a call at Q7b's inputs (device ms):"
                  f" {kernels}", flush=True)
        print(f"prefix_match at {name}'s inputs ({offsets.numel() - 1} "
              f"values, {chars.numel()} chars, {offsets.dtype} offsets, "
              f"needle of {len(needle)} bytes, suffix={suffix}): {ms:.4f} "
              f"ms, {nb} bytes, bound {bound_ms(nb):.4f} ms (share "
              f"{bound_ms(nb) / ms:.3f}), plain {plain:.4f} ms (exact "
              f"against it)", flush=True)
    return {"prefix_match": rec}


def k9_bytes(n: int, out_cap: int, with_mask: bool) -> int:
    """K9's bytes: each probe row's flag, segment start and length (and
    its mask) read once, each slot's row, build position and flag written
    once, and the count."""
    return n * (10 if with_mask else 9) + out_cap * 9 + 8


K9_HEAVY_SWEEP = (4096, 8192, 16384, 32768, 65536, 1 << 20)
K9_SWEEP_CASES = ("q4x", "rows_of_4", "rows_of_16", "one_row_90_percent")


def k9_case_args(name, dev):
    """expand_matches' arguments (probe, mask, capacity, left, any_join)
    of a timed K9 case: one_row_90_percent and many_tiles from k9_case,
    rows_of_4 and rows_of_16 (80M output rows from probe rows of that many
    matches each: a tile's output 4 or 16 times its rows)."""
    from clickhouse_tpu_torch.ops.join_ops import ProbeResult
    if name.startswith("rows_of_"):
        m = int(name.rsplit("_", 1)[1])
        n = 80_000_000 // m
        ones = torch.ones(n, dtype=torch.bool, device=dev)
        start = (torch.arange(n, device=dev, dtype=torch.int32) % 1000) * m
        return (ProbeResult(ones, start, torch.full_like(start, m)), ones,
                n * m + 1024, False, False)
    m, v, ss, sl, cap, left, any_join, _, _ = k9_case(
        name, np.random.default_rng(19))
    return (ProbeResult(on_card(m, dev), on_card(ss, dev), on_card(sl, dev)),
            on_card(v, dev), cap, left, any_join)


def k9_extra(dev, k9, rows):
    """K9 records beside the main path's call k9 (Q4x's): with the rows as
    the equivalent bool mask (`rows`), its scan pass alone (a capacity of
    1,024 slots), on one_row_90_percent and many_tiles
    (each held against the plain version), and each K9_SWEEP_CASES case at
    each spill threshold of K9_HEAVY_SWEEP (the threshold's choice), each
    held against the plain version too."""
    from clickhouse_tpu_torch.ops.join_ops import (_expand_matches_cuda,
                                                   _expand_matches_plain,
                                                   expand_matches)
    probe, _, out_cap, left, any_join, n_rows = k9
    n = probe.matched.shape[0]
    masked = (probe, rows, out_cap, left, any_join)
    got = expand_matches(*masked)
    for a, b in zip(got, expand_matches(*k9)):
        max_abs_err(a, b)
    del got
    # the scan pass alone: every probe row read, 1,024 slots written
    scan = (probe, None, 1024, left, any_join, n_rows)
    rec = dict(with_mask_ms=cuda_ms(lambda: expand_matches(*masked)),
               with_mask_bytes=k9_bytes(n, out_cap, True),
               with_mask_bound_ms=bound_ms(k9_bytes(n, out_cap, True)),
               scan_only_ms=cuda_ms(lambda: expand_matches(*scan)),
               scan_only_bound_ms=bound_ms(k9_bytes(n, 1024, False)))
    for name, key in (("one_row_90_percent", "heavy"),
                      ("many_tiles", "many_tiles")):
        a = k9_case_args(name, dev)
        for x, y in zip(expand_matches(*a), _expand_matches_plain(*a)):
            max_abs_err(x, y)
        b = k9_bytes(a[0].matched.shape[0], a[2], True)
        rec.update({f"{key}_ms": cuda_ms(lambda: expand_matches(*a)),
                    f"{key}_bytes": b, f"{key}_bound_ms": bound_ms(b)})
        del a
    sweep = {}
    for name in K9_SWEEP_CASES:
        a = k9 if name == "q4x" else k9_case_args(name, dev) + (None,)
        a = a[:5] + (a[0].matched.shape[0] if a[5] is None else a[5],)
        want = _expand_matches_plain(*a)
        sweep[name] = {}
        for h in K9_HEAVY_SWEEP:
            for x, y in zip(_expand_matches_cuda(*a, heavy=h), want):
                max_abs_err(x, y)
            sweep[name][h] = cuda_ms(lambda: _expand_matches_cuda(
                *a, heavy=h))
        del a, want
        print(f"K9 at {name} by spill threshold (slots: ms): "
              f"{sweep[name]}", flush=True)
    rec["threshold_ms"] = sweep
    return rec


def k9_turn(dev):
    """--k9: K9 alone at Q4x's inputs (made on the card as the main path
    makes them) with the probe rows as a bool mask, and as their row count
    where this tree's expand_matches takes one, and on one_row_90_percent
    and many_tiles; each held against the plain version once and timed.
    Uses only expand_matches' signature, so copied into an unpacked older
    checkout it times that tree's K9 alike (parent, change, change, parent
    in one call)."""
    import inspect
    from clickhouse_tpu_torch.core.column import pad_to
    from clickhouse_tpu_torch.ops.join_ops import (ProbeResult,
                                                   _expand_matches_plain,
                                                   expand_matches)
    n = pad_to(N_ROWS)
    i = torch.arange(n, device=dev)
    fk = torch.where(i < N_ROWS, (i * 40503) % N_DIM, 0)
    hit = fk < N_DIM // 2                  # dim2: keys 0..N_DIM/2 - 1, twice
    probe = ProbeResult(hit, torch.where(hit, 2 * fk, 0).to(torch.int32),
                        torch.where(hit, 2, 0).to(torch.int32))
    cap = pad_to(n + pad_to(N_DIM))
    cases = {"q4x_mask": (probe, i < N_ROWS, cap, False, False)}
    del i, fk, hit
    if "n_rows" in inspect.signature(expand_matches).parameters:
        cases["q4x_count"] = (probe, None, cap, False, False, N_ROWS)
    for name in ("one_row_90_percent", "many_tiles"):
        cases[name] = k9_case_args(name, dev)
    times = {}
    for name, a in cases.items():
        for x, y in zip(expand_matches(*a), _expand_matches_plain(*a)):
            max_abs_err(x, y)
        times[name] = cuda_ms(lambda: expand_matches(*a))
    print(f"K9 alone (ms, CUDA events, L2 flushed): {times}", flush=True)


def join_shapes(dev, args):
    """K7, K8 and K9 on the inputs the main path gave them (Q4's, Q4h's
    and Q4x's), each held against its plain version and timed beside it
    and beside one PyTorch call (K7: index_select from the table; K8: none,
    searchsorted of the probe keys over the sorted build keys for
    information; K9: repeat_interleave).  K7 and K8 are also timed with
    the build key's words beside `label` (K7's "key" word; K8's two words
    of dim_h.k), the output words the join carried before it built only
    what is read.  Every table a
    kernel gathers from here fits in the 50 MB L2, so bytes count each
    input once.  Fails unless Q4's K7 call carries `label` alone (no
    "key" word) and Q4h's K8 call one word.  -> {name: record}."""
    from clickhouse_tpu_torch.ops.join_ops import (
        _dense_gather_join_plain, _expand_lengths, _expand_matches_plain,
        _bool, _hash_build_cuda, _hash_probe_cuda, dense_gather_join,
        dense_slot_layout,
        expand_matches, hash_capacity, key_words, propagate_join)
    out = {}
    # K7: Q4's call, its build over dim's 1M rows, its probe over fact's
    bk, bv, pk, pv, entries, lo, R = args["dense_join"]
    if [e[0] for e in entries] != ["word"]:
        fail(f"Q4's K7 call carries {[e[0] for e in entries]}, not one "
             f"word (label)")
    hi = lo + R - 1
    n = pk.shape[0]
    word = entries[0]
    table = torch.full((R,), word[2], dtype=torch.int32, device=dev)
    keep = torch.ones_like(bk, dtype=torch.bool) if bv is None \
        else bv.to(torch.bool)
    table[(bk.long() - lo)[keep]] = word[1][keep]
    idx = pk if lo == 0 else (pk.long() - lo).clamp(0, R - 1)
    library_ms = cuda_ms(lambda: torch.index_select(table, 0, idx))
    del table, keep

    def k7_record(ents):
        got = dense_gather_join(bk, bv, pk, pv, ents, lo, hi)
        want = _dense_gather_join_plain(bk, bv, pk, pv, ents, lo, R)
        err = max([max_abs_err(got.matched, want.matched)]
                  + [max_abs_err(a, b) for a, b in zip(got.words,
                                                        want.words)])
        del got, want
        b = nbytes(bk, bv, pk, pv, [e[1] for e in ents if e[0] == "word"]) \
            + n + 4 * n * len(ents)
        return dict(max_abs_err=err, ms=cuda_ms(
            lambda: dense_gather_join(bk, bv, pk, pv, ents, lo, hi)),
            plain_ms=cuda_ms(lambda: _dense_gather_join_plain(
                bk, bv, pk, pv, ents, lo, R), reps=5), bytes=b,
            bound_ms=bound_ms(b))
    with_key = [("key",)] + entries
    rk = k7_record(with_key)
    wide = k7_record([("key",), word[:3]])     # no range: 4-byte slots
    out["dense_join"] = dict(
        **k7_record(entries), library_ms=library_ms,
        library="torch.index_select(table, 0, probe keys): the gather "
                "alone, from an int32 table built beforehand",
        with_key_ms=rk["ms"], with_key_bound_ms=rk["bound_ms"],
        with_key_plain_ms=rk["plain_ms"], with_key_bytes=rk["bytes"],
        with_key_4_byte_slots_ms=wide["ms"],
        l2_resident=f"the table: {R} slots of "
                    f"{dense_slot_layout(entries)[1]} byte(s)",
        shape=f"build {bk.shape[0]} {bk.dtype} keys, probe {n} {pk.dtype} "
              f"keys, output words {[e[0] for e in entries]} (with the "
              f"build key: {[e[0] for e in with_key]}), R = {R}")
    print(f"dense_join with the build key (key and label words): "
          f"{rk['ms']:.4f} ms, bound {rk['bound_ms']:.4f} ms "
          f"({rk['bytes']} bytes), plain {rk['plain_ms']:.4f} ms; with "
          f"4-byte slots (no proven range) {wide['ms']:.4f} ms", flush=True)
    # K8: Q4h's propagate_join (its build and its probe)
    bks, bvh, pks, pvh, words = args["hash_join"]
    if len(words) != 1:
        fail(f"Q4h's K8 call carries {len(words)} words, not one (label)")
    n = pks[0].shape[0]
    k64 = bks[0].to(torch.int64)
    words_k = [(k64 & 0xFFFFFFFF).to(torch.int32), (k64 >> 32).to(
        torch.int32)] + list(words)
    del k64

    def k8_record(ws):
        got = propagate_join(bks, bvh, pks, pvh, ws)
        want_m, want_w = k8_plain(bks, bvh, pks, pvh, ws)
        err = max([max_abs_err(got.matched, want_m)]
                  + [max_abs_err(a, b) for a, b in zip(got.words, want_w)])
        del got, want_m, want_w
        b = nbytes(bks, bvh, pks, pvh, ws) + n + 4 * n * len(ws)
        return dict(max_abs_err=err, ms=cuda_ms(
            lambda: propagate_join(bks, bvh, pks, pvh, ws)),
            plain_ms=cuda_ms(lambda: k8_plain(bks, bvh, pks, pvh, ws),
                             reps=3), bytes=b, bound_ms=bound_ms(b))
    rk = k8_record(words_k)
    # one layout for the words against the other, in turns (in the bucket,
    # in the payload array, in the payload array, in the bucket)
    pay_m, pay_w = k8_payload_only(bks, bvh, pks, pvh, words)
    inb = propagate_join(bks, bvh, pks, pvh, words)
    for a, b in zip([pay_m] + pay_w, [inb.matched] + inb.words):
        max_abs_err(a, b)
    del pay_m, pay_w, inb
    bw8, pw8 = key_words(bks), key_words(pks)
    bvb, pvb8 = _bool(bvh), _bool(pvh)
    layout_ms = {True: [], False: []}
    for inb in (True, False, False, True):
        layout_ms[inb].append(cuda_ms(lambda: _hash_probe_cuda(
            bw8, pw8, _hash_build_cuda(bw8, bvb), pvb8, list(words),
            words_in_bucket=inb)))
    del bw8, pw8, bvb, pvb8
    print(f"hash_join at Q4h's inputs, build and probe, words in the "
          f"bucket {layout_ms[True]} ms, in the payload array "
          f"{layout_ms[False]} ms (turns)", flush=True)
    sorted_bk = torch.sort(bks[0]).values
    info = cuda_ms(lambda: torch.searchsorted(sorted_bk, pks[0]))
    del sorted_bk
    out["hash_join"] = dict(
        **k8_record(words), library_ms=None,
        library="none: no single PyTorch call joins by key",
        information=f"torch.searchsorted(sorted build keys, probe keys) "
                    f"{info:.4f} ms",
        with_key_ms=rk["ms"], with_key_bound_ms=rk["bound_ms"],
        with_key_plain_ms=rk["plain_ms"], with_key_bytes=rk["bytes"],
        words_in_bucket_ms=layout_ms[True],
        words_in_payload_ms=layout_ms[False],
        l2_resident=f"the buckets ({hash_capacity(bks[0].shape[0])} of 16 "
                    f"bytes), the build keys and words",
        shape=f"build {bks[0].shape[0]} rows, probe {n} rows, keys "
              f"{[k.dtype for k in bks]}, {len(words)} word(s) (with the "
              f"build key: {len(words_k)})")
    print(f"hash_join with the build key (three words): {rk['ms']:.4f} ms, "
          f"bound {rk['bound_ms']:.4f} ms ({rk['bytes']} bytes), plain "
          f"{rk['plain_ms']:.4f} ms", flush=True)
    del words_k
    # K8's probe at Q4x's inputs: each probe row's group in the table of
    # dim2's 500,000 keys
    tbl, pkx, pvx = args["hash_join:probe"]
    bw, pw = key_words(tbl.key_cols), key_words(pkx)
    src = [tbl.seg_start, tbl.seg_len]
    nx = pw[0].shape[0]
    pvb = None if pvx is None else pvx.to(torch.bool)
    out["hash_join"]["q4x_probe_ms"] = cuda_ms(
        lambda: _hash_probe_cuda(bw, pw, tbl.buckets, pvb, src))
    inb_out = _hash_probe_cuda(bw, pw, tbl.buckets, pvb, src)
    pay_out = _hash_probe_cuda(bw, pw, tbl.buckets, pvb, src,
                               words_in_bucket=False)
    for a, b in zip([pay_out[0]] + pay_out[1], [inb_out[0]] + inb_out[1]):
        max_abs_err(a, b)
    del inb_out, pay_out
    layout_ms = {True: [], False: []}
    for inb in (True, False, False, True):
        layout_ms[inb].append(cuda_ms(lambda: _hash_probe_cuda(
            bw, pw, tbl.buckets, pvb, src, words_in_bucket=inb)))
    out["hash_join"]["q4x_probe_words_in_bucket_ms"] = layout_ms[True]
    out["hash_join"]["q4x_probe_words_in_payload_ms"] = layout_ms[False]
    print(f"hash_join's probe at Q4x's inputs, words in the bucket "
          f"{layout_ms[True]} ms, in the payload array {layout_ms[False]} "
          f"ms (turns)", flush=True)
    qb = nbytes(pw, pvx) + nx * 9
    out["hash_join"]["q4x_probe_bound_ms"] = bound_ms(qb)
    print(f"hash_join's probe at Q4x's inputs ({nx} probe rows, "
          f"{tbl.group_capacity} group slots, "
          f"{hash_capacity(tbl.group_capacity)} buckets): "
          f"{out['hash_join']['q4x_probe_ms']:.4f} ms, bound "
          f"{bound_ms(qb):.4f} ms ({qb} bytes)", flush=True)
    del tbl, pkx, pvx, bw, pw, src
    # K9: Q4x's expansion, 2 build rows for half the probe rows; the probe
    # rows' validity is their row count (no mask)
    probe, valid, out_cap, left, any_join, n_rows = args["expand_matches"]
    if valid is not None:
        fail("Q4x's K9 call was given a row mask, not the row count alone")
    k9 = (probe, valid, out_cap, left, any_join, n_rows)
    got = expand_matches(*k9)
    want = _expand_matches_plain(*k9)
    err = max(max_abs_err(a, b) for a, b in zip(got, want))
    total = int(got[3])
    del want, got
    n = probe.matched.shape[0]
    rows = torch.arange(n, device=dev) < n_rows
    lens = _expand_lengths(probe.matched, rows, probe.seg_len, left,
                           any_join)
    ar = torch.arange(n, device=dev)
    out["expand_matches"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: expand_matches(*k9)),
        plain_ms=cuda_ms(lambda: _expand_matches_plain(*k9), reps=3),
        library_ms=cuda_ms(lambda: torch.repeat_interleave(
            ar, lens, output_size=total)),
        library=f"torch.repeat_interleave(arange(N), lens, output_size="
                f"{total}): the probe row of each slot alone",
        bytes=k9_bytes(n, out_cap, False),
        shape=f"{n} probe rows ({n_rows} valid, as a row count), {total} "
              f"output rows, capacity {out_cap}")
    del ar, lens
    # the same with the rows as a bool mask (the inputs K9 took before the
    # probe rows came as a count), the heavy-row and many-tile cases, and
    # the spill threshold's sweep
    out["expand_matches"].update(k9_extra(dev, k9, rows))
    del rows
    report(out)
    # the kernels of one call (torch.profiler)
    for name, call in (
            ("dense_join", lambda: dense_gather_join(bk, bv, pk, pv,
                                                     entries, lo, hi)),
            ("hash_join", lambda: propagate_join(bks, bvh, pks, pvh,
                                                 words)),
            ("hash_join:with_key", lambda: propagate_join(
                bks, bvh, pks, pvh, [words[0]] * 3)),
            ("expand_matches", lambda: expand_matches(*k9))):
        per_call = {}
        split = device_kernels(call, launches=per_call)
        if name in out:
            out[name]["kernels_per_call"] = per_call
        print(f"{name} device ms by kernel (torch.profiler): {split}, "
              f"launches a call {per_call}", flush=True)
    return out


def probe_roofline(dev) -> float:
    """bench.py:509-525's probe roofline on this card: one gather of 100M
    int32 indices from a 1M-entry int32 table (tbl[idx]).  -> ms."""
    idx = ((torch.arange(N_ROWS, dtype=torch.int64, device=dev) * 40503)
           % N_DIM).to(torch.int32)
    tbl = torch.arange(N_DIM, dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: tbl[idx])
    del idx, tbl
    return ms


GATHER_TABLE_MB = (1, 4, 8, 16, 20, 24, 28, 32, 40, 48, 64)


def gather_curve(dev):
    """The card's random-gather time against the table's size: one
    index_select of N_ROWS uniform random int32 indices from int32 tables
    of GATHER_TABLE_MB megabytes (CUDA events, L2 flushed).  Where the
    time starts to rise is how much of a table that every SM reads the
    L2 keeps (K7's and K8's tables)."""
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    out = []
    for mb in GATHER_TABLE_MB:
        rows = (mb << 20) // 4
        tbl = torch.zeros(rows, dtype=torch.int32, device=dev)
        idx = torch.randint(0, rows, (N_ROWS,), device=dev, generator=g,
                            dtype=torch.int64).to(torch.int32)
        out.append((mb, cuda_ms(lambda: torch.index_select(tbl, 0, idx),
                                reps=5)))
        del tbl, idx
    print("random gathers of 4 bytes (index_select, 100M int32 indices) by "
          "table size: " + ", ".join(f"{mb} MB {ms:.4f} ms"
                                     for mb, ms in out), flush=True)
    return out


# -- slice 13: dates, times, math and bit functions (K12, hits_t) ------------

T_JULY_2013 = 1372636800            # 2013-07-01 00:00:00 UTC
JULY_SECONDS = 31 * 86400
Q_T = {
    "Qt1": "SELECT date_trunc('minute', t) AS m, count() AS c FROM hits_t "
           "WHERE d >= '2013-07-14' AND d <= '2013-07-15' GROUP BY m "
           "ORDER BY m LIMIT 10 OFFSET 1000",
    "Qt2": "SELECT toHour(t) AS h, toDayOfWeek(t) AS w, count(), sum(x) "
           "FROM hits_t GROUP BY h, w ORDER BY h, w",
    "Qt3": "SELECT toYYYYMMDD(t) AS day, count() FROM hits_t GROUP BY day "
           "ORDER BY day",
    "Qt4": "SELECT count() FROM hits_t WHERE t + INTERVAL 1 MONTH > "
           "toDateTime('2013-08-20 00:00:00') AND dateDiff('hour', "
           "toStartOfDay(t), t) >= 12",
    "Qt5": "SELECT round(avg(sqrt(x)), 3), max(log(x + 1)), "
           "sum(bitAnd(x, 255)) FROM hits_t"}
SLICE13_QUERIES = tuple(Q_T.items())
# each query's launches: one K12 launch a calendar function (Qt5's math
# is plain torch)
SLICE13_PATHS = {
    "Qt1": {"calendar_part": 1, "masked_reduce": 2, "radix_sort_pairs": 1,
            "segment_bounds": 1, "topk_smallest": 1},
    "Qt2": {"calendar_part": 2, "dense_group_reduce": 1, "masked_reduce": 1,
            "radix_sort_pairs": 1},
    "Qt3": {"calendar_part": 1, "masked_reduce": 1, "radix_sort_pairs": 2,
            "segment_bounds": 1},
    "Qt4": {"calendar_part": 2, "masked_reduce": 1},
    "Qt5": {"masked_reduce": 3}}
T_RTOL = 1e-12                  # floats against numpy's (sum order, ulps)
# (op, output numpy type, c0, c1) of every use the functions make of K12
K12_SPECS = (
    ("year", "uint16", 0, 0), ("quarter", "uint8", 0, 0),
    ("month", "uint8", 0, 0), ("day_of_month", "uint8", 0, 0),
    ("day_of_year", "uint16", 0, 0), ("day_of_week", "uint8", 0, 0),
    ("iso_year", "uint16", 0, 0), ("iso_week", "uint8", 0, 0),
    ("hour", "uint8", 0, 0), ("minute", "uint8", 0, 0),
    ("second", "uint8", 0, 0), ("yyyymm", "uint32", 0, 0),
    ("yyyymmdd", "uint32", 0, 0), ("yyyymmddhhmmss", "uint64", 0, 0),
    ("relative_quarter", "uint32", 0, 0), ("relative_month", "uint32", 0, 0),
    ("relative_month", "int64", 0, 0), ("relative_week", "uint32", 0, 0),
    ("floor_seconds", "uint32", 3600, 0), ("floor_seconds", "uint32", 1, 0),
    ("day_number", "int32", 0, 0), ("day_number", "uint32", 719528, 0),
    ("day_number", "int64", 0, 0), ("start_of_months", "int32", 1, 0),
    ("start_of_months", "int32", 3, 0), ("start_of_months", "int32", 12, 0),
    ("start_of_months", "int32", 60, 0), ("start_of_days", "int32", 7, 3),
    ("start_of_days", "int32", 7, 4), ("start_of_days", "int32", 35, 3),
    ("start_of_days", "int32", 5, 0), ("last_day_of_week", "int32", 4, 0),
    ("start_of_seconds", "int64", 60, 0),
    ("start_of_seconds", "int64", 86400, 0),
    ("start_of_seconds", "int64", 900, 0),
    ("last_day_of_month", "int32", 0, 0), ("add_months", "int32", 1, 0),
    ("add_months", "int64", -13, 0), ("add_months", "int64", 1200, 0))
K12_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64)
K12_ROWS = (1, 7, 8, 9, 4099, 1_000_003)   # one row, part of a group of 8
K12_EDGE_DATES = ("1900-02-28", "1900-03-01", "2000-02-29", "2000-03-01",
                  "2100-02-28", "2100-03-01", "1969-12-31", "1970-01-01",
                  "2012-12-31", "2013-01-01", "2013-01-31", "2014-12-29",
                  "2015-12-31", "2016-01-03", "1600-02-29", "0001-01-01",
                  "9999-12-31", "2013-07-14", "2013-07-31")


def k12_values(rng, dtype, seconds: bool, n: int) -> np.ndarray:
    """n values for K12 in storage `dtype`: the edge days (and their first
    and last seconds) that fit, then random values over the type's range
    (int64: over +-3e11, years far past 9999 and before 1)."""
    days = np.array([np.datetime64(d, "D").astype(np.int64)
                     for d in K12_EDGE_DATES])
    edge = np.concatenate([days * 86400, days * 86400 + 86399, [-1, 0, 1]]) \
        if seconds else np.concatenate([days, [-1, 0, 1]])
    info = np.iinfo(torch.empty((), dtype=dtype).numpy().dtype)
    lo, hi = max(info.min, -3 * 10**11), min(info.max, 3 * 10**11)
    edge = edge[(edge >= lo) & (edge <= hi)]
    out = rng.integers(lo, hi, n, endpoint=True)
    out[:min(n, len(edge))] = edge[:n]
    return out


# the run-time divisors K12's edge cases take through the ops that divide
# by c0 (the output type as K12_SPECS has it), with c1 in {0, 1, c0 - 1}
# where the op takes an anchor
K12_DIVISORS = (1, 2, 3, 5, 7, 60, 900, 3600, 86400, 604800, 2**31 - 1)
K12_DIVISOR_OPS = (("floor_seconds", "uint32", False),
                   ("start_of_seconds", "int64", True),
                   ("start_of_days", "int32", True))
K12_EDGE_ROWS = 4099
# constants past the 32-bit path's reach (calendar_ops.narrow_ok: the
# column goes to the int64 instance) or at its edges (a divisor above
# 2^31, folded anchors far below 0)
K12_CONSTANT_EDGES = (("floor_seconds", "uint32", 2**40, 0),
                      ("start_of_seconds", "int64", 2**31 + 7, 3),
                      ("start_of_seconds", "int64", 3600, -2**61),
                      ("start_of_days", "int32", 2**33, 4),
                      ("start_of_days", "int32", 7, -10**15),
                      ("start_of_months", "int32", 2**31, 0),
                      ("add_months", "int64", 12 * 2**30 + 1, 0),
                      ("add_months", "int32", -12 * 2**30, 0),
                      ("last_day_of_week", "int32", 2**62, 0),
                      ("day_number", "int32", 2**35 + 3, 0))


def k12_edge_cases(dtypes=K12_DTYPES):
    """Yield (values, storage dtype, seconds, op, out_np, c0, c1), values
    an int64 numpy array, over K12's edges: every int8 and every int16 day
    through every op use of K12_SPECS; every day's first and last second
    over int32's range, with INT32_MIN and INT32_MAX, through every op use
    as seconds; and each op that divides by c0 over K12_DIVISORS (c1 in
    {0, 1, c0 - 1}) and the constants of K12_CONSTANT_EDGES, both units,
    K12_EDGE_ROWS values of k12_values."""
    i32 = np.iinfo(np.int32)
    for dtype in (torch.int8, torch.int16):
        if dtype in dtypes:
            info = np.iinfo(torch.empty((), dtype=dtype).numpy().dtype)
            days = np.arange(info.min, info.max + 1, dtype=np.int64)
            for spec in K12_SPECS:
                yield (days, dtype, False) + spec
    if torch.int32 in dtypes:
        day = np.arange(i32.min // 86400, i32.max // 86400 + 1,
                        dtype=np.int64) * 86400
        secs = np.concatenate([day, day + 86399, [i32.min, i32.max]])
        secs = secs[(secs >= i32.min) & (secs <= i32.max)]
        for spec in K12_SPECS:
            yield (secs, torch.int32, True) + spec
    rng = np.random.default_rng(14)
    for dtype in dtypes:
        for seconds in (False, True):
            v = k12_values(rng, dtype, seconds, K12_EDGE_ROWS)
            for op, out_np, anchored in K12_DIVISOR_OPS:
                for c0 in K12_DIVISORS:
                    for c1 in ((0, 1, c0 - 1) if anchored else (0,)):
                        yield v, dtype, seconds, op, out_np, c0, c1
            for spec in K12_CONSTANT_EDGES:
                yield (v, dtype, seconds) + spec


def k12_cases(dev, dtypes=K12_DTYPES):
    """Yield (x, op, seconds, out_np, c0, c1) over every K12_SPECS op, both
    units and each storage type of `dtypes`, at each row count of K12_ROWS
    and as views 1-3 rows into the column (the scalar path); then the
    edges of k12_edge_cases."""
    rng = np.random.default_rng(12)
    for dtype in dtypes:
        for seconds in (False, True):
            base = torch.from_numpy(k12_values(
                rng, dtype, seconds, max(K12_ROWS) + 3)).to(dtype).to(dev)
            for n in K12_ROWS:
                for off in (0, 1, 2, 3):
                    x = base[off:off + n]
                    for op, out_np, c0, c1 in K12_SPECS:
                        yield x, op, seconds, out_np, c0, c1
    for v, dtype, seconds, op, out_np, c0, c1 in k12_edge_cases(dtypes):
        yield (torch.from_numpy(v).to(dtype).to(dev), op, seconds, out_np,
               c0, c1)


def check_k12(dev):
    """K12 against its plain version over every op of K12_SPECS, both units
    (days, seconds), every storage type (int8, int16, int32, int64), the
    edge days of K12_EDGE_DATES, K12_ROWS rows and views 1-3 rows in, and
    the edges of k12_edge_cases (every int8 and int16 day, every day's
    first and last second in int32, the divisors of K12_DIVISORS, the
    constants of K12_CONSTANT_EDGES): exact."""
    from clickhouse_tpu_torch.ops.calendar_ops import (_calendar_part_plain,
                                                       calendar_part)
    calls = 0
    for x, op, seconds, out_np, c0, c1 in k12_cases(dev):
        max_abs_err(calendar_part(x, op, seconds, out_np, c0, c1),
                    _calendar_part_plain(x, op, seconds, out_np, c0, c1))
        calls += 1
    torch.cuda.synchronize()
    edges = sum(1 for _ in k12_edge_cases())
    print(f"K12 calendar_part agrees with its plain version ({calls} "
          f"calls: {len(K12_SPECS)} op uses x 2 units x "
          f"{len(K12_DTYPES)} storage types x {len(K12_ROWS)} row counts x "
          f"4 offsets, and {edges} edge cases)", flush=True)


def hits_t_columns(n: int = N_ROWS):
    """hits_t: every second of July 2013 in a scattered order (as
    ClickBench's hits.EventTime), its day, and hits' x."""
    r = np.arange(n, dtype=np.int64) * 2654435761
    t = T_JULY_2013 + r % JULY_SECONDS
    return {"t": t, "d": (t // 86400).astype(np.int32), "x": r % 1_000_003}


def load_hits_t(s):
    """hits_t (t DateTime, d Date, x Int64) of N_ROWS rows in session s,
    on the device (t int32, d int16, x int32 by narrow storage); -> its
    columns as numpy, for the answers."""
    t0 = time.perf_counter()
    cols = hits_t_columns()
    t1 = time.perf_counter()
    s.execute("CREATE TABLE hits_t (t DateTime, d Date, x Int64)")
    s.insert_pydict("hits_t", cols)
    blk = s.catalog.get_table("default", "hits_t").read_block()
    torch.cuda.synchronize()
    print(f"hits_t: {N_ROWS} rows made in {t1 - t0:.1f} s; insert + device "
          f"block {time.perf_counter() - t1:.1f} s; storage "
          f"{ {k: str(blk[k].data.dtype) for k in cols} }", flush=True)
    return cols


def slice13_answers(cols):
    """Qt1-Qt5 by numpy's datetime64 conversions ([s] -> [m], [h], [D],
    [M], [Y]) and float64 math."""
    t, x = cols["t"], cols["x"]
    ts = t.astype("datetime64[s]")
    day = ts.astype("datetime64[D]")
    out = {}
    keep = (day >= np.datetime64("2013-07-14")) \
        & (day <= np.datetime64("2013-07-15"))
    mins, cnt = np.unique(ts[keep].astype("datetime64[m]"),
                          return_counts=True)
    out["Qt1"] = [(m.astype("datetime64[s]").astype(object), int(c))
                  for m, c in zip(mins[1000:1010], cnt[1000:1010])]
    hour = (ts - day).astype("timedelta64[h]").astype(np.int64)
    dow = (day - np.datetime64("1970-01-05")).astype(np.int64) % 7 + 1
    g = hour * 8 + dow
    c = np.bincount(g, minlength=24 * 8)
    # each group's sum below 2^53: exact in float64
    sx = np.bincount(g, weights=x.astype(np.float64), minlength=24 * 8)
    out["Qt2"] = [(h, w, int(c[h * 8 + w]), int(sx[h * 8 + w]))
                  for h in range(24) for w in range(1, 8) if c[h * 8 + w]]
    first = day.min()
    dcnt = np.bincount((day - first).astype(np.int64))
    days = first + np.flatnonzero(dcnt).astype("timedelta64[D]")
    month = days.astype("datetime64[M]")
    ymd = (month.astype("datetime64[Y]").astype(np.int64) + 1970) * 10000 \
        + (month.astype(np.int64) % 12 + 1) * 100 \
        + (days - month.astype("datetime64[D]")).astype(np.int64) + 1
    out["Qt3"] = [(int(a), int(b)) for a, b in zip(ymd, dcnt[dcnt > 0])]
    month = day.astype("datetime64[M]")
    # one month on: the same day and time of the next month (July's days
    # all exist in August)
    on = (month + 1).astype("datetime64[s]") + (ts - month.astype(
        "datetime64[s]"))
    q4 = (on > np.datetime64("2013-08-20T00:00:00")) & (hour >= 12)
    out["Qt4"] = [(int(q4.sum()),)]
    xf = x.astype(np.float64)
    out["Qt5"] = [(round(float(np.sqrt(xf).mean()), 3),
                   float(np.log(xf + 1).max()), int((x & 255).sum()))]
    return out


def slice13_agree(want):
    def agree(name, rows):
        w = want[name]
        return len(rows) == len(w) and all(
            len(g) == len(v) and all(
                math.isclose(a, b, rel_tol=T_RTOL) if isinstance(b, float)
                else a == b for a, b in zip(g, v))
            for g, v in zip(rows, w))
    return agree


def slice13_path(s, want, per_query, launches, launch_rows, memory):
    """Qt1-Qt5 over hits_t, each against numpy, launching exactly the
    kernels of SLICE13_PATHS, and each K12 launch (one a calendar function)
    over every row; -> {query: [(op, storage, rows, result type)]}, the
    K12 calls each query made."""
    from clickhouse_tpu_torch.ops import calendar_ops
    k12, execute = calendar_ops._calendar_part_cuda, s.execute
    calls, current = {}, [""]

    def k12_watch(x, code, seconds, out_np, c0, c1):
        # the call's op and input, recorded (passed on as it is)
        op = next(k for k, v in calendar_ops.OPS.items() if v == code)
        calls.setdefault(current[0], []).append(
            (op, str(x.dtype), x.numel(), str(np.dtype(out_np))))
        return k12(x, code, seconds, out_np, c0, c1)

    def execute_watch(sql, *a, **kw):
        current[0] = next(k for k, v in SLICE13_QUERIES if v == sql)
        return execute(sql, *a, **kw)
    cover = {q: ("calendar_part", N_ROWS) for q in ("Qt1", "Qt2", "Qt3",
                                                    "Qt4")}
    cover["Qt5"] = ("masked_reduce", N_ROWS)
    calendar_ops._calendar_part_cuda, s.execute = k12_watch, execute_watch
    try:
        path_phase(s, SLICE13_QUERIES, SLICE13_PATHS, cover, want, per_query,
                   launches, launch_rows, memory, "Qt1, Qt2, Qt3, Qt4 and Qt5",
                   agree=slice13_agree(want))
    finally:
        calendar_ops._calendar_part_cuda, s.execute = k12, execute
    for name, _ in SLICE13_QUERIES:
        got = calls.get(name, [])
        if any(n < N_ROWS for _, _, n, _ in got):
            fail(f"{name}'s K12 calls {got}: each must cover its {N_ROWS} "
                 f"rows")
        print(f"{name}: K12 calls (op, storage, rows, result) {got}",
              flush=True)
    return calls


# K12's calls on the main path that calendar_shapes replays: the row's
# key prefix, the op, its result type and constant; the last one reads t
# widened to int64 (the 64-bit path), for information
K12_SHAPES = (("", "hour", "uint8", 0),
              ("bucket_", "start_of_seconds", "int64", 60),
              ("yyyymmdd_", "yyyymmdd", "uint32", 0),
              ("add_months_", "add_months", "int64", 1),
              ("dow_", "day_of_week", "uint8", 0),
              ("start_of_day_", "start_of_seconds", "int64", 86400),
              ("yyyymmdd64_", "yyyymmdd", "uint32", 0))
K12_SHAPE_QUERY = {"": "Qt2", "bucket_": "Qt1", "yyyymmdd_": "Qt3",
                   "add_months_": "Qt4", "dow_": "Qt2",
                   "start_of_day_": "Qt4", "yyyymmdd64_": "Qt3"}


def calendar_shapes(dev, s):
    """K12 at Qt2's toHour, at Qt1's bucket (date_trunc('minute', t),
    `bucket_*`), at Qt3's toYYYYMMDD and Qt4's month step (the civil
    calendar's ops), at Qt2's toDayOfWeek and Qt4's toStartOfDay, over
    hits_t's t as the main path read it (int32 storage), and, for
    information, toYYYYMMDD over t widened to int64 (the 64-bit path),
    each held against its plain version and timed beside it, with its
    kernels a call (torch.profiler).  Bytes: each value read once, each
    result written once.  No single PyTorch call computes a calendar
    function: library_ms is null."""
    from clickhouse_tpu_torch.ops.calendar_ops import (_calendar_part_plain,
                                                       calendar_part)
    t = s.catalog.get_table("default", "hits_t").read_block()["t"].data
    t64 = t.to(torch.int64)
    rec = {"library_ms": None, "max_abs_err": 0.0}
    for key, op, out_np, c0 in K12_SHAPES:
        call = (t64 if key == "yyyymmdd64_" else t, op, True, out_np, c0)
        got = calendar_part(*call)
        rec["max_abs_err"] = max(rec["max_abs_err"], max_abs_err(
            got, _calendar_part_plain(*call)))
        ms = cuda_ms(lambda: calendar_part(*call))
        plain = cuda_ms(lambda: _calendar_part_plain(*call), reps=3)
        nb = nbytes(call[0], got)
        per_call = {}
        kernels = device_kernels(lambda: calendar_part(*call),
                                 launches=per_call)
        if list(per_call.values()) != [1]:
            fail(f"calendar_part {op} ran the device kernels {per_call} a "
                 f"call, not one kernel once")
        rec.update({f"{key}ms": ms, f"{key}plain_ms": plain,
                    f"{key}bytes": nb, f"{key}bound_ms": bound_ms(nb),
                    f"{key}kernels_per_call": per_call})
        print(f"calendar_part {op} at {K12_SHAPE_QUERY[key]}'s input "
              f"({t.numel()} {call[0].dtype} values -> {got.dtype}): "
              f"{ms:.4f} ms, "
              f"{nb} bytes, bound {bound_ms(nb):.4f} ms (share "
              f"{bound_ms(nb) / ms:.3f}), plain {plain:.4f} ms (exact "
              f"against it), library none; device kernels a call "
              f"{kernels}", flush=True)
        del got
    return {"calendar_part": rec}


def query_times(s, queries):
    """Median wall of QUERY_REPS runs of each query and its device-busy
    time from a torch.profiler trace (``--aggregates``, ``--calendar``)."""
    for name, sql in queries:
        s.execute(sql)
        times = []
        for _ in range(QUERY_REPS):
            t0 = time.perf_counter()
            s.execute(sql)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        busy, ops, wall, top = device_busy(s, sql)
        print(f"{name} median wall {statistics.median(times) * 1e3:.3f} ms "
              f"over {QUERY_REPS} runs; under torch.profiler: device busy "
              f"{busy:.4f} ms of {wall:.3f} ms wall a run, {ops:g} device "
              f"operations a run; top: "
              + "; ".join(f"{n} {t:.4f}" for n, t in top), flush=True)


def check_small_joins(ch):
    """The join forms over small tables on the card, row for row against
    the same session on the CPU (whose answers the tests hold against the
    JAX reference), and the capacity check of a 1:N join firing."""
    from clickhouse_tpu_torch.core.errors import CapacityError
    rng = np.random.default_rng(23)
    n, nd = 20_000, 1000
    fl_pool = np.array([0.0, -0.0, np.nan, 1.5, -2.25, 3.0])
    nk = rng.integers(0, 50, n).astype(object)
    nk[rng.random(n) < 0.2] = None
    dk = np.concatenate([np.arange(nd), np.arange(nd // 3)])
    tables = {
        "jf": {"fk": ("Int64", rng.integers(0, 2 * nd, n)),
               "w": ("Float64", rng.normal(size=n)),
               "s": ("String", np.asarray([f"s{v}" for v in
                                           rng.integers(0, 30, n)], object)),
               "nk": ("Nullable(Int64)", nk),
               "fl": ("Float64", fl_pool[rng.integers(0, 6, n)]),
               "a": ("Int32", rng.integers(0, 6, n).astype(np.int32))},
        "jd": {"k": ("Int64", np.arange(nd)),
               "label": ("Int64", (np.arange(nd) * 7) % 97),
               "big": ("UInt64", np.arange(nd).astype(np.uint64)
                       * np.uint64(2**40) + np.uint64(2**63)),
               "name": ("String", np.asarray([f"v{x % 13}" for x in
                                              range(nd)], object)),
               "f": ("Float64", np.arange(nd) * 0.5)},
        "jdd": {"k": ("Int64", dk), "label": ("Int64", (dk * 3) % 101),
                "name": ("String", np.asarray([f"d{x % 7}" for x in dk],
                                              object))},
        "js": {"s": ("String", np.asarray([f"s{v}" for v in range(15, 45)],
                                          object)),
               "v": ("Int64", np.arange(30))},
        "jn": {"nk": ("Nullable(Int64)", np.asarray(
            [None if v % 7 == 0 else v for v in range(60)], object)),
               "v": ("Int64", np.arange(60))},
        "jfl": {"fl": ("Float64", np.array([0.0, -0.0, np.nan, 1.5, 9.0])),
                "v": ("Int64", np.arange(5))},
        "jm": {"a": ("Int32", np.repeat(np.arange(6), 3).astype(np.int32)),
               "v": ("Int64", np.arange(18))},
    }
    queries = [
        "SELECT count(), sum(label) FROM jf INNER JOIN jd ON jf.fk = jd.k",
        "SELECT fk, label, big, name, f FROM jf INNER JOIN jd "
        "ON jf.fk = jd.k",
        "SELECT fk, label, big, name, f FROM jf LEFT JOIN jd "
        "ON jf.fk = jd.k SETTINGS join_dense_gather = 0",
        "SELECT fk, label, name FROM jf LEFT JOIN jd ON jf.fk = jd.k "
        "SETTINGS join_use_nulls = 1",
        "SELECT k, label, fk FROM jf RIGHT JOIN jd ON jf.fk = jd.k",
        "SELECT count() FROM jf LEFT SEMI JOIN jdd ON jf.fk = jdd.k",
        "SELECT fk, w FROM jf LEFT ANTI JOIN jdd ON jf.fk = jdd.k",
        "SELECT fk, label, name FROM jf ANY LEFT JOIN jdd ON jf.fk = jdd.k",
        "SELECT fk, label, name FROM jf INNER JOIN jdd ON jf.fk = jdd.k",
        "SELECT fk, label, name FROM jf LEFT JOIN jdd ON jf.fk = jdd.k",
        "SELECT fk, w, label FROM jf INNER JOIN jdd ON jf.fk = jdd.k "
        "AND jdd.label > 50",
        "SELECT jf.s, v FROM jf INNER JOIN js ON jf.s = js.s",
        "SELECT jf.nk, v FROM jf LEFT JOIN jn ON jf.nk = jn.nk",
        "SELECT jf.fl, v FROM jf INNER JOIN jfl ON jf.fl = jfl.fl",
        "SELECT jf.a, v, fk FROM jf INNER JOIN jm ON jf.a = jm.a",
        "SELECT jm.a, jfl.v FROM jm CROSS JOIN jfl",
        "SELECT jm.a, jfl.v FROM jm INNER JOIN jfl ON jm.a < jfl.v",
        # chains whose middle key nothing reads (J3: it is not built)
        "SELECT count(), sum(jd.label), sum(jn.v) FROM jf INNER JOIN jd "
        "ON jf.fk = jd.k INNER JOIN jn ON jf.a = jn.v",
        "SELECT count(), sum(jd.label), sum(jdd.label) FROM jf INNER JOIN jd "
        "ON jf.fk = jd.k INNER JOIN jdd ON jd.label = jdd.k",
        "SELECT count(), sum(js.v), sum(jd.label) FROM jf INNER JOIN jd "
        "ON jf.fk = jd.k ANY RIGHT JOIN js ON jf.s = js.s",
    ]
    got_s, want_s = ch.connect(device="cuda"), ch.connect(device="cpu")
    for name, cols in tables.items():
        for s in (got_s, want_s):
            s.execute(f"CREATE TABLE {name} ("
                      + ", ".join(f"{c} {t}" for c, (t, _) in cols.items())
                      + ")")
            s.insert_pydict(name, {c: v for c, (_, v) in cols.items()})
    for sql in queries:
        got, want = got_s.execute(sql).rows(), want_s.execute(sql).rows()
        if len(got) != len(want) or any(
                len(g) != len(w) or not all(_same(a, b) for a, b in zip(g, w))
                for g, w in zip(got, want)):
            fail(f"{sql} on the card differs from the CPU: "
                 f"{got[:3]} vs {want[:3]} ({len(got)} vs {len(want)} rows)")
    try:
        got_s.execute("SELECT fk, label FROM jf INNER JOIN jdd "
                      "ON jf.fk = jdd.k SETTINGS max_joined_rows = 1024, "
                      "capacity_autotune = 0")
    except CapacityError as e:
        if e.setting != "max_joined_rows":
            fail(f"the 1:N join's capacity check named {e.setting}")
    else:
        fail("a 1:N join over its max_joined_rows raised no CapacityError")
    print(f"{len(queries)} small join queries on the card match the CPU row "
          f"for row (INNER, LEFT, RIGHT, SEMI, ANTI, ANY, 1:N, residual, "
          f"String, Nullable and Float64 keys, CROSS, non-equi, chains of "
          f"three tables); a 1:N "
          f"join past max_joined_rows raised CapacityError", flush=True)


def _same(a, b) -> bool:
    """One value of a row: equal, both NULL, both NaN, or floats within
    FLOAT_RTOL (sums add in another order on the card)."""
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return math.isclose(a, b, rel_tol=FLOAT_RTOL, abs_tol=0.0)
    return a == b


def sass_report(source: str):
    """Compile csrc/<source>.cu alone with the build's flags and -Xptxas
    -v; print its nvcc time and, for each kernel instance, its registers,
    spill stores, static shared bytes, the blocks of 256 threads an SM
    holds by those two (65,536 registers, 228 KB of shared memory less
    1 KB a block, 64 warps), SASS instructions and CALL instructions
    (cuobjdump -sass), then the instances, their register range and those
    holding a CALL.  Writes only under the package's _build/."""
    import re
    from clickhouse_tpu_torch.ops import _native
    nvcc = _native._nvcc()
    tools = nvcc.rsplit("/", 1)[0]
    obj = _native.BUILD_DIR / f"sass_{source}.o"
    obj.parent.mkdir(parents=True, exist_ok=True)
    cmd = [nvcc, *_native.NVCC_FLAGS, "-Xptxas", "-v", "-I",
           str(_native.CSRC_DIR), "-c", "-o", str(obj),
           str(_native.CSRC_DIR / f"{source}.cu")]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if p.returncode:
        fail(f"nvcc exited {p.returncode}: {p.stderr[-4000:]}")
    sass = subprocess.run([f"{tools}/cuobjdump", "-sass", str(obj)],
                          capture_output=True, text=True, check=True).stdout
    obj.unlink()
    regs, spills, smem, cur = {}, {}, {}, None
    for line in (p.stdout + p.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        cur = m.group(1) if m else cur
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and cur:
            spills[cur] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            regs[cur] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m and cur:
            smem[cur] = int(m.group(1))

    def blocks(name):
        by_regs = 65536 // (-(-regs[name] // 8) * 8 * 256)
        by_smem = (228 << 10) // (smem.get(name, 0) + 1024)
        return min(by_regs, by_smem, 8)
    instrs, calls, fn = {}, {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = m.group(1)
        elif fn and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            instrs[fn] = instrs.get(fn, 0) + 1
            calls[fn] = calls.get(fn, 0) + bool(re.search(r"\bCALL\b",
                                                          line))
    names = sorted(regs)
    shown = subprocess.run([f"{tools}/cu++filt"], input="\n".join(names),
                           capture_output=True, text=True).stdout.split("\n")
    for name, pretty in zip(names, shown):
        print(f"{pretty.replace('(anonymous namespace)::', '')}: "
              f"{regs[name]} registers, {spills.get(name, 0)} bytes spill "
              f"stores, {smem.get(name, 0)} bytes shared, {blocks(name)} "
              f"blocks of 256 threads an SM, {instrs.get(name, 0)} SASS "
              f"instructions, {calls.get(name, 0)} CALL", flush=True)
    print(f"{source}.cu: nvcc {secs:.1f} s; {len(names)} kernel instances, "
          f"{min(regs.values())}-{max(regs.values())} registers, "
          f"{sum(1 for n in names if spills.get(n))} spilling, "
          f"{sum(1 for n in names if calls.get(n))} holding a CALL",
          flush=True)


# -- slice 16: out-of-core streaming (Q5, Q5b, Q6 over 1B rows) ------------
STREAM_ROWS = 1_000_000_000             # bench.py:37-38
STREAM_PIECE = 250_000_000              # bench.py inserts in 250M pieces
JOIN_DIM = 10_000_000
STREAM_CHUNK_ROWS = 1 << 27             # stream_chunk_bytes / int32 storage
STREAM_SQL = (
    ("Q5", "SELECT count() FROM big WHERE x > 500000 "
           "SETTINGS stream_readers = 2"),
    ("Q5b", "SELECT x % 1024 AS k, count() AS c, sum(x) FROM big GROUP BY k "
            "ORDER BY c DESC LIMIT 10 SETTINGS stream_readers = 2"),
    ("Q6", "SELECT count(), sum(label) FROM fact INNER JOIN dim "
           "ON fact.fk = dim.k SETTINGS stream_readers = 2"),
    # Q5 with the host PREWHERE off: every row crosses the link, in the
    # parts' aligned chunks (the packed and unpacked transport compared)
    ("Q5np", "SELECT count() FROM big WHERE x > 500000 SETTINGS "
             "stream_readers = 2, optimize_move_to_prewhere = 0"),
)
STREAM_WARM = 3                         # warm runs timed after the cold one
STREAM_TURNS = 10                       # Q5np packed/unpacked runs in turns
# K13's cases: (w4, lo, half, rows, output type); offsets below zero, an
# odd row count, a part's short last chunk, each output width
K13_CASES = ((4, -7, 1025, 2049, torch.int8), (8, 0, 4097, 8193, torch.uint8),
             (8, -133, 3, 5, torch.int16), (12, -2053, 65_537, 100_001,
                                            torch.int16),
             (20, 0, 1 << 20, (1 << 21) - 3, torch.int32),
             (20, -300, STREAM_CHUNK_ROWS // 2, 115_782_272, torch.int32),
             (24, 0, 1 << 20, 1 << 21, torch.int32),
             (24, -(1 << 23) - 5, 999_999, 1_999_997, torch.int32),
             (28, -(1 << 27) - 1, 1 << 19, (1 << 20) - 1, torch.int32),
             (28, (1 << 40) - 3, 1 << 19, (1 << 20) - 1, torch.int64))


# the other streamed programs, over the same tables and dim_g
GRACE_DIM = 600_000_000                 # dim_g: 3e9 bytes, 8 grace buckets
PROGRAM_SQL = (
    ("Q5t", "SELECT x FROM big ORDER BY x DESC LIMIT 100 SETTINGS "
            "stream_readers = 2", "TopKProgram"),
    ("Q5c", "SELECT x FROM big WHERE x % 1000 = 7 SETTINGS "
            "stream_readers = 2", "CollectProgram"),
    ("Q5h", "SELECT quantileExact(0.5)(x), count() FROM big "
            "WHERE x % 100 = 7 SETTINGS stream_readers = 2",
     "CollectProgram"),
    ("Q5t2", "SELECT x % 1000 AS k, x FROM big WHERE x > 500000 "
             "ORDER BY k DESC, x LIMIT 10 SETTINGS stream_readers = 2",
     "TopKProgram"),
    # keys too wide to pack into K3's 31 bits (x * x spans 40): each chunk
    # is lowered and sorted by K4 a slice of TOPK_SORT_ROWS rows at a time
    ("Q5t3", "SELECT x % 1000 AS k, x FROM big ORDER BY k DESC, x * x "
             "LIMIT 10 SETTINGS stream_readers = 2", "TopKProgram"),
    ("Q6g", "SELECT count(), sum(label) FROM fact INNER JOIN dim_g "
            "ON fact.fk = dim_g.k SETTINGS stream_readers = 2",
     "StreamProgram"),
    ("Q6x", "SELECT count(), sum(label), sum(number) FROM dim CROSS JOIN "
            "numbers(100) SETTINGS stream_readers = 2", "StreamProgram"),
)
PROGRAM_EVENT = {"Q6g": "GraceJoinBuckets", "Q6x": "BlowupStreamedQueries"}
# K14's cases: (name, capacity, row bound or None, the mask (a density, a
# bit in the middle, the first version's tile edges, every run's edges, a
# density in the last tile alone, or None), K1 terms, rows in).  A size
# given as (tiles, rows) is that many of K14's tiles (read from the
# library, chtt_compact_tile_rows) and rows.
K14_STEP = 4096                         # rows of a tile's step (a run a thread)
K14_CASES = (("one row", 1, None, 1.0, 0, 0),
             ("a tile and a row", 4097, None, 0.5, 0, 0),
             ("empty", 3 * 4096 + 17, None, 0.0, 0, 0),
             ("full", 1_000_003, None, 1.0, 0, 0),
             ("one bit", 1_000_003, None, "one", 0, 0),
             ("tile edges", 3 * 4096 + 17, None, "edges", 0, 0),
             ("half", 1_000_003, None, 0.5, 0, 0),
             ("row bound", 20_000, 10_001, 0.5, 0, 0),
             ("mask and terms", 1_000_003, 999_999, 0.7, 2, 0),
             ("terms alone", 1_000_003, None, None, 2, 0),
             ("views 1 row in", 100_003, None, 0.3, 2, 1),
             ("views 3 rows in", 100_003, None, 0.3, 2, 3),
             ("a chunk at 0.1 %", STREAM_CHUNK_ROWS, None, 0.001, 0, 0),
             ("a new tile and a row", (1, 1), None, 0.5, 0, 0),
             ("three new tiles and 17 rows, tile and run edges", (3, 17),
              None, "runs", 0, 0),
             ("a row bound inside a thread's runs", (2, 100),
              (1, 5 * K14_STEP + 3 * 16 + 7), 0.5, 0, 0),
             ("a row bound inside a thread's runs, terms", (2, 100),
              (1, 9 * K14_STEP + 200 * 16 + 9), 0.6, 2, 0),
             ("every tile empty but the last", (5, 33), None, ("last", 0.5),
              0, 0),
             ("a mask view 1 row in over new tiles", (3, 5), None, 0.3, 0,
              1),
             ("a dense 2^27-row mask", STREAM_CHUNK_ROWS, None, 0.5, 0, 0))


def stream_paths(chunks: dict, slices: int = 0) -> dict:
    """The kernels each streamed query launches, by its chunks: K13 a
    chunk (one packed column), then Q5 K1 a chunk (its filter as a term)
    and one K1 a merge of the GROUP BY () carry (count()'s state is the
    group count); Q5b K2 a chunk and K4, K5 and K6 a merge of the keyed
    carry (1,024 + 1,024 slots, whose valid ones K1 counts), then the
    upper plan's K1 (the sorted block's row count) and K3; Q6 K8 (dim's
    10M keys pass join_dense_table_entries, 8M: the hash join, as in the
    reference) and two K1 a chunk (count and sum(label)) and two K1 a
    merge."""
    out = {}
    for name, n in chunks.items():
        m = n - 1
        if name in ("Q5", "Q5np", "Q5np_unpacked"):
            p = {"masked_reduce": n + m}
        elif name == "Q5b":
            p = {"dense_group_reduce": n, "radix_sort_pairs": m,
                 "segment_bounds": m, "segment_reduce": m,
                 "topk_smallest": 1, "masked_reduce": m + 1}
        elif name in ("Q6", "Q6g"):
            p = {"hash_join": n, "masked_reduce": 2 * n + 2 * m}
        else:
            p = program_path(name, n, slices)
        if name not in ("Q5np_unpacked", "Q6x"):
            p["unpack_pairs"] = n
        out[name] = p
    return out


def program_path(name: str, n: int, slices: int = 0) -> dict:
    """The kernels of PROGRAM_SQL's streamed queries over n chunks (besides
    K13 a chunk): Q5t K3 a chunk (x's bounds: the 32-bit entry) and K4 a
    merge of the carried 1,024 rows with a chunk's; Q5t2 K3 a chunk over
    its two keys packed into one 32-bit key from their bounds, K1 the
    chunk's rows (the PREWHERE's term) and K4 a merge; Q5t3 K4 a slice of
    its chunks (its 51 bits of keys and row flag one 64-bit word) and a
    merge of each slice's rows into the carry; Q5c K14 a
    chunk; Q5h K14 a chunk, then the upper plan's holistic GROUP BY ()
    over the collected rows (two K4 sorts, K5, three K1); Q6x (dim's chunks,
    not packed) a cross join a chunk (K4, K5 and K8 over numbers(100)'s
    build rows, K8's probe, K9) and four K1 a chunk, three a merge (Q6g
    is Q6's path, 8 buckets a chunk each)."""
    m = n - 1
    return {"Q5t": {"topk_smallest": n, "radix_sort_pairs": m},
            "Q5t2": {"topk_smallest": n, "radix_sort_pairs": m,
                     "masked_reduce": n},
            "Q5t3": {"radix_sort_pairs": 2 * slices - 1},
            "Q5c": {"compact_rows": n},
            "Q5h": {"compact_rows": n, "radix_sort_pairs": 2,
                    "segment_bounds": 1, "masked_reduce": 3},
            "Q6x": {"radix_sort_pairs": n, "segment_bounds": n,
                    "hash_join": 2 * n, "expand_matches": n,
                    "masked_reduce": 4 * n + 3 * m},
            }[name]


def k13_case(w4, lo, half, rows, out_dtype, seed=13):
    """(packed bytes on the host, the values they hold): rows values in
    [lo, lo + 2^w4), the rest of the 2 * half slots lo (padding), packed
    as ChunkSource.encode_column packs them."""
    rng = np.random.default_rng(seed + w4 + half)
    cap = 2 * half
    v = np.zeros(cap, np.uint64)
    v[:rows] = rng.integers(0, 1 << w4, rows, dtype=np.uint64)
    if rows:
        v[0], v[rows - 1] = 0, (1 << w4) - 1
    pairs = v[:half] | (v[half:] << np.uint64(w4))
    bpp = w4 // 4
    data = np.ascontiguousarray(pairs.astype("<u8").view(np.uint8).reshape(
        half, 8)[:, :bpp]).reshape(-1)
    want = v.astype(np.int64) + np.int64(lo)
    return data, want, bpp


def check_k13(dev):
    """K13 against its plain version on the card over K13_CASES, and
    both against the values that were packed."""
    from clickhouse_tpu_torch.ops.chunk_ops import (_unpack_pairs_plain,
                                                    unpack_pairs)
    for w4, lo, half, rows, out_dtype in K13_CASES:
        data, want, bpp = k13_case(w4, lo, half, rows, out_dtype)
        d = torch.from_numpy(data).to(dev)
        got = unpack_pairs(d, w4, lo, bpp, 2 * half, out_dtype)
        plain = _unpack_pairs_plain(d, w4, lo, bpp, 2 * half, out_dtype)
        max_abs_err(got, plain)
        ref = torch.from_numpy(want).to(out_dtype)
        if not torch.equal(got.cpu(), ref):
            fail(f"K13 (w4={w4}, lo={lo}, {2 * half} rows, {out_dtype}) "
                 f"unpacked other values than were packed")
    print(f"K13 matches its plain version and the packed values over "
          f"{len(K13_CASES)} cases (w4 4-28, offsets below zero, odd row "
          f"counts, a part's short last chunk, int8/uint8/int16/int32/"
          f"int64)", flush=True)


def k14_tile_rows() -> int:
    """Rows of K14's tile, as the built kernel reports them."""
    from clickhouse_tpu_torch.ops import _native
    return _native.library().chtt_compact_tile_rows()


def k14_rows(case, dev):
    """A K14_CASES case as the RowMask K14 reads: a bool mask, a row
    bound, K1 terms over an int32 and an int8 column with validity, each
    a view `shift` rows into its tensor."""
    from clickhouse_tpu_torch.ops.agg_ops import RowMask, Term
    _, cap, bound, mask, n_terms, shift = case
    tile = k14_tile_rows()
    cap, bound = (v if v is None or isinstance(v, int)
                  else v[0] * tile + v[1] for v in (cap, bound))
    rng = np.random.default_rng(cap + 7 * n_terms + shift)
    n = cap + shift
    m = None
    if mask == "one":
        m = np.zeros(n, bool)
        m[shift + cap // 2] = True
    elif mask == "edges":
        m = np.zeros(n, bool)
        for r in (0, 15, 16, 4095, 4096, 8191, 8192, cap - 1):
            m[shift + min(r, cap - 1)] = True
    elif mask == "runs":
        # each run's first and last row (so each step's and tile's edges),
        # the row after each tile's first and the last row
        r = np.arange(cap)
        m = np.zeros(n, bool)
        m[shift:] = (r % 16 == 0) | (r % 16 == 15) | (r % tile == 1) \
            | (r == cap - 1)
    elif isinstance(mask, tuple):          # ("last", density)
        m = np.zeros(n, bool)
        last = shift + (cap - 1) // tile * tile
        m[last:] = rng.random(n - last) < mask[1]
    elif mask is not None:
        m = rng.random(n) < mask
    terms = []
    if n_terms:
        x = torch.from_numpy(rng.integers(-1000, 1000, n).astype(np.int32))
        y = torch.from_numpy(rng.integers(-100, 100, n).astype(np.int8))
        yv = torch.from_numpy((rng.random(n) < 0.9).astype(np.uint8))
        i64 = np.dtype(np.int64)
        terms = [Term(x.to(dev)[shift:], None, i64, "greater", i64, -500),
                 Term(y.to(dev)[shift:], yv.to(dev)[shift:], i64,
                      "notEquals", i64, 7)]
    mt = None if m is None else torch.from_numpy(m).to(dev)[shift:]
    return RowMask(cap, dev, cap if bound is None else bound, tuple(terms),
                   mt)


def check_k14(dev):
    """K14 against its plain version on the card over K14_CASES: the
    count and the first `count` indices equal (the slots past the count
    are unspecified), one launch a call."""
    from clickhouse_tpu_torch.ops import _native
    from clickhouse_tpu_torch.ops.filter_ops import (_compact_rows_plain,
                                                     compact_rows)
    for case in K14_CASES:
        rows = k14_rows(case, dev)
        before = _native.LAUNCHES["compact_rows"]
        idx, count = compact_rows(rows)
        torch.cuda.synchronize()
        if _native.LAUNCHES["compact_rows"] != before + 1:
            fail(f"K14 ({case[0]}) did not launch once")
        pidx, pcount = _compact_rows_plain(rows)
        c = int(count)
        if c != int(pcount) or not torch.equal(idx[:c], pidx[:c]):
            fail(f"K14 ({case[0]}): count {c} against {int(pcount)}, or "
                 f"other indices than its plain version")
    print(f"K14 matches its plain version over {len(K14_CASES)} cases (one "
          f"row to a 2^27-row chunk, empty, full, one bit, the tiles' edges "
          f"(tiles of {k14_tile_rows()} rows) and each run's, a row bound "
          f"inside a thread's runs, every tile empty but the last, K1 terms "
          f"with and without a mask, views 1 and 3 rows in, a dense 2^27-row "
          f"mask)", flush=True)


def h2d_roofline(dev):
    """Host->device copy rate (bytes/s) of three distinct 1 GiB buffers,
    the best of the three (bench.py:357-365), from page-locked and from
    pageable memory."""
    out = {}
    for pinned in (True, False):
        probes = [torch.full((1 << 28,), i, dtype=torch.int32,
                             pin_memory=pinned) for i in range(3)]
        torch.zeros(1 << 28, dtype=torch.int32).to(dev)
        ts = []
        for p in probes:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p.to(dev, non_blocking=pinned)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        out["pinned" if pinned else "pageable"] = probes[0].nbytes / min(ts)
        del probes
    return out


def chunk_copy_ms(src, dev):
    """Device time (CUDA events) of copying each of src's chunks, from its
    encode cache, to the device one after another, as the program's copy
    stream does: what the link takes of a warm run, which a trace of the
    run may not show whole (its copies are the feeder thread's)."""
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(src.num_chunks):
        for d, v in src.chunk(i)[0].values():
            for a in (d, v):
                if a is not None:
                    torch.from_numpy(a).to(dev, non_blocking=True)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def traced_copies(events):
    """(count, ms) of the host->device copies of 1 ms or more in a trace's
    device operations: a streamed chunk's (a chunk is 335 MB or more)."""
    spans = [(b - a) / 1e3 for n, a, b in events
             if n.startswith("Memcpy HtoD") and b - a >= 1e3]
    return len(spans), sum(spans)


def load_stream_tables(ch):
    """bench.py's big (1B rows of x) and fact (1B rows of fk) and dim
    (10M rows), inserted in 250M pieces; -> (session, numpy answers,
    rows of big and of fact).  Cut (and printed) where the host's memory
    cannot hold them."""
    total_gb = int(subprocess.run(["free", "-g"], capture_output=True,
                                  text=True).stdout.split()[7])
    rows = STREAM_ROWS if total_gb >= 64 else STREAM_ROWS * total_gb // 64
    print(f"streaming phase: host memory {total_gb} GiB (free -g total); "
          f"big and fact {rows} rows each"
          + ("" if rows == STREAM_ROWS else f" (cut from {STREAM_ROWS})"),
          flush=True)
    s = ch.connect(device="cuda")
    s.execute("CREATE TABLE big (x Int64)")
    s.execute("CREATE TABLE fact (fk Int64)")
    s.execute("CREATE TABLE dim (k Int64, label Int64)")
    s.execute("CREATE TABLE dim_g (k Int64, label Int64)")
    t0 = time.perf_counter()
    n_gt, counts, sums = 0, np.zeros(1024, np.int64), np.zeros(1024,
                                                                np.int64)
    label_sum = 0
    lab = (np.arange(JOIN_DIM, dtype=np.int64) * 7) % 97
    tops, tops2, tops3, c7, h7 = [], [], [], [], []
    for lo in range(0, rows, STREAM_PIECE):
        hi = min(lo + STREAM_PIECE, rows)
        x = (np.arange(lo, hi, dtype=np.int64) * 2654435761) % 1_000_003
        n_gt += int(np.count_nonzero(x > 500000))
        k = x & 1023
        counts += np.bincount(k, minlength=1024)
        sums += np.bincount(k, weights=x, minlength=1024).astype(np.int64)
        # PROGRAM_SQL: Q5t's 100 largest, Q5t2's 10 first of (x % 1000 DESC,
        # x) above 500000 (Q5t3's of every row: x * x orders as x), Q5c's
        # rows in row order, Q5h's values
        x32 = x.astype(np.int32)
        tops.append(np.partition(x32, len(x32) - 100)[-100:])
        r = x32 % 1000
        above = x32 > 500000
        key = ((999 - r).astype(np.int64) << 21) | x32
        tops2.append(np.partition(key[above], 9)[:10])
        tops3.append(np.partition(key, 9)[:10])
        c7.append(x32[r == 7])
        h7.append(x32[r % 100 == 7])
        s.insert_pydict("big", {"x": x})
        fk = (np.arange(lo, hi, dtype=np.int64) * 40503) % JOIN_DIM
        label_sum += int(np.bincount(fk, minlength=JOIN_DIM) @ lab)
        s.insert_pydict("fact", {"fk": fk})
        del x, k, fk, x32, r, above, key
    s.insert_pydict("dim", {"k": np.arange(JOIN_DIM, dtype=np.int64),
                            "label": lab})
    # dim_g: 600M rows (3e9 bytes: int32 k, int8 label), above the 2 GiB
    # threshold, so Q6g takes the grace join; its first 10M rows are dim's
    g_rows = GRACE_DIM * rows // STREAM_ROWS
    for lo in range(0, g_rows, STREAM_PIECE):
        kg = np.arange(lo, min(lo + STREAM_PIECE, g_rows), dtype=np.int64)
        s.insert_pydict("dim_g", {"k": kg, "label": (kg * 7) % 97})
        del kg
    h = np.concatenate(h7)
    q = int(np.partition(h, (len(h) - 1) // 2)[(len(h) - 1) // 2])
    t2 = np.sort(np.concatenate(tops2))[:10]
    t3 = np.sort(np.concatenate(tops3))[:10]
    want = {"Q5": [(n_gt,)], "Q5np": [(n_gt,)], "Q6": [(rows, label_sum)],
            "Q5b": (counts, sums),
            "Q5t": [(int(v),) for v in
                    np.sort(np.concatenate(tops))[::-1][:100]],
            "Q5t2": [(999 - int(v >> 21), int(v & ((1 << 21) - 1)))
                     for v in t2],
            "Q5t3": [(999 - int(v >> 21), int(v & ((1 << 21) - 1)))
                     for v in t3],
            "Q5c": [(int(v),) for v in np.concatenate(c7)],
            "Q5h": [(q, len(h))], "Q6g": [(rows, label_sum)],
            "Q6x": [(JOIN_DIM * 100, 100 * int(lab.sum()),
                     JOIN_DIM * 4950)]}
    print(f"streaming tables built in {time.perf_counter() - t0:.1f} s "
          f"(dim_g {g_rows} rows)", flush=True)
    return s, want, rows


def stream_agree(name, rows, want) -> bool:
    if name != "Q5b":
        return rows == want[name]
    counts, sums = want["Q5b"]
    top = sorted(counts.tolist(), reverse=True)[:10]
    return len(rows) == 10 and [c for _, c, _ in rows] == top and all(
        c == counts[k] and sm == sums[k] for k, c, sm in rows)


def streaming_phase(ch, dev, launches, launch_rows, sketch=None):
    """Q5, Q5b and Q6 (and Q5np, packed and not) over 1B rows through
    connect(device="cuda"): each streams (StreamedQueries), reads the
    expected chunks, equals numpy, launches exactly stream_paths and holds
    less device memory above what was allocated before it than its
    streamed column's bytes; prints the H2D roofline, each query's cold
    and warm walls, wire rate, io_stats, device-busy time and peak; then
    program_phase over the same tables, and sketch(session) where given.  -> (K13's replay record, K14's,
    the queries' numbers)."""
    import gc
    from clickhouse_tpu_torch.ops import _native
    from clickhouse_tpu_torch.storage.table import ChunkSource
    roof = h2d_roofline(dev)
    print(f"host->device copy of a distinct 1 GiB buffer, best of 3: pinned "
          f"{roof['pinned'] / 1e9:.3f} GB/s, pageable "
          f"{roof['pageable'] / 1e9:.3f} GB/s", flush=True)
    s, want, rows = load_stream_tables(ch)
    parts = -(-rows // STREAM_PIECE)
    per_part = -(-STREAM_PIECE // STREAM_CHUNK_ROWS)
    aligned = sum(-(-min(STREAM_PIECE, rows - i * STREAM_PIECE)
                    // STREAM_CHUNK_ROWS) for i in range(parts))
    chunks = {"Q5": -(-want["Q5"][0][0] // STREAM_CHUNK_ROWS),
              "Q5b": aligned, "Q6": aligned, "Q5np": aligned,
              "Q5np_unpacked": aligned}
    paths = stream_paths(chunks)
    print(f"{parts} parts of up to {STREAM_PIECE} rows, {per_part} chunks "
          f"of {STREAM_CHUNK_ROWS} rows a full part; the paths: {paths}",
          flush=True)
    table_big = s.catalog.get_table("default", "big")
    dim_bytes = s.catalog.get_table("default", "dim").physical_bytes()
    chunk_bytes = s.settings.stream_chunk_bytes
    column_bytes = {"Q5": table_big.physical_bytes(),
                    "Q5np": table_big.physical_bytes(),
                    "Q5np_unpacked": table_big.physical_bytes(),
                    "Q5b": table_big.physical_bytes(),
                    "Q6": s.catalog.get_table(
                        "default", "fact").physical_bytes()}
    runs = list(STREAM_SQL) + [("Q5np_unpacked", dict(STREAM_SQL)["Q5np"])]
    record, progs = {}, {}
    # stream_readers = 2 must run the read pool: count its runs
    from clickhouse_tpu_torch.storage import read_pool
    pool_runs = [0]
    iter_ordered = read_pool.ParallelChunkReader.iter_ordered

    def counted(self):
        pool_runs[0] += 1
        return iter_ordered(self)
    read_pool.ParallelChunkReader.iter_ordered = counted
    for name, sql in runs:
        if name == "Q5np_unpacked":
            # the same chunks, the column's int32 storage over the link
            # (ChunkSource(pack=False), put in the table's source cache)
            key = table_big._chunk_source_cache[0]
            table_big._chunk_source_cache = (key, ChunkSource(
                table_big, ["x"], key[2], pack=False))
            s._stream_cache.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = s.profile_events.get("StreamedQueries", 0)
        _native.reset_launches()
        t0 = time.perf_counter()
        pool_before = pool_runs[0]
        got = s.execute(sql).rows()
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        if pool_runs[0] != pool_before + 1:
            fail(f"{name} did not run the read pool (stream_readers = 2)")
        mine = dict(_native.LAUNCHES)
        rows_of = {k: list(v) for k, v in _native.LAUNCH_ROWS.items()}
        peak = torch.cuda.max_memory_allocated() - base
        want_name = "Q5np" if name == "Q5np_unpacked" else name
        if not stream_agree(want_name, got, want):
            fail(f"{name} returned {got[:5]}, numpy says "
                 f"{want[want_name] if name != 'Q5b' else 'other groups'}")
        if s.profile_events.get("StreamedQueries", 0) != before + 1:
            fail(f"{name} did not stream")
        prog = next(v[0] for k, v in s._stream_cache.items() if k[0] == sql)
        if prog.io_stats["chunks"] != chunks[name]:
            fail(f"{name} read {prog.io_stats['chunks']} chunks, not "
                 f"{chunks[name]}")
        if name == "Q5np_unpacked" and prog.src.packed:
            fail("Q5np_unpacked's source packs")
        path = {k: paths[name].get(k, 0) for k in mine}
        if mine != path:
            fail(f"{name} launched { {k: v for k, v in mine.items() if v} };"
                 f" its path is {paths[name]} and nothing else")
        if peak >= column_bytes[name]:
            fail(f"{name} held {peak} bytes of device memory above what was "
                 f"allocated before it, not below its streamed column's "
                 f"{column_bytes[name]} bytes")
        for k, v in rows_of.items():
            launches[k] += mine[k]
            launch_rows[k] += v
        io_cold = dict(prog.io_stats)
        warm = []
        for _ in range(STREAM_WARM):
            t0 = time.perf_counter()
            if s.execute(sql).rows() != got:
                fail(f"{name}'s warm run returned other rows")
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
        prog = progs[name] = next(v[0] for k, v in s._stream_cache.items()
                                  if k[0] == sql)
        copy_ms = chunk_copy_ms(prog.src, dev)
        events = []
        busy, ops, wall, top = device_busy(s, sql, reps=1, events_out=events)
        n_copies, traced_ms = traced_copies(events)
        per_row = sum(b for _, _, b in prog.src.packed.values()) / 2 or 4
        wire = prog.src.total_rows * per_row
        pinned_ms = wire / roof["pinned"] * 1e3
        # the trace holds the run's device time only where it holds a
        # copy a chunk and their time comes to the replayed copies'
        whole = n_copies >= chunks[name] and traced_ms >= 0.9 * copy_ms
        med = statistics.median(warm)
        record[name] = {"cold_s": cold, "warm_s": med, "peak": peak,
                        "busy_ms": busy, "busy_whole": whole,
                        "copy_ms": copy_ms}
        print(f"{name}: {chunks[name]} chunks through the read pool; "
              f"cold {cold:.3f} s, warm "
              f"median {med:.3f} s of {STREAM_WARM} ({[round(w, 3) for w in warm]});"
              f" {rows / med / 1e9:.3f} G rows/s; wire {wire / med / 1e9:.3f}"
              f" GB/s ({prog.src.total_rows} rows, {per_row:g} B a row) = "
              f"{wire / med / roof['pinned']:.3f} of the pinned copy rate; "
              f"io_stats cold {io_cold}, warm (last run) {prog.io_stats}; "
              f"chunk copies replayed {copy_ms:.3f} ms (the wire bytes at "
              f"the pinned rate: {pinned_ms:.3f} ms); the trace holds "
              f"{n_copies} chunk copies of {chunks[name]} chunks, "
              f"{traced_ms:.3f} ms: device busy {busy:.3f} ms"
              + ("" if whole else " (partial: the trace misses copies)")
              + f" of {wall:.3f} ms wall, {ops:g} device operations, top "
              + "; ".join(f"{n} {t:.3f}" for n, t in top[:5])
              + f"; peak {peak} bytes above what was allocated before it "
              f"(3 x stream_chunk_bytes + the build side: "
              f"{3 * chunk_bytes + (dim_bytes if name == 'Q6' else 0)}); "
              f"launches { {k: v for k, v in mine.items() if v} }",
              flush=True)
    # packed against unpacked, in turns, each program as the session runs
    # it (its chunks in the encode caches)
    turns = {"Q5np": [], "Q5np_unpacked": []}
    for _ in range(STREAM_TURNS):
        for name in turns:
            t0 = time.perf_counter()
            progs[name].run(s)
            torch.cuda.synchronize()
            turns[name].append(time.perf_counter() - t0)
    read_pool.ParallelChunkReader.iter_ordered = iter_ordered
    packed, unpacked = (statistics.median(turns[n]) for n in turns)
    print(f"Q5np in turns, {STREAM_TURNS} runs each: packed median "
          f"{packed:.4f} s (min {min(turns['Q5np']):.4f}), unpacked median "
          f"{unpacked:.4f} s (min {min(turns['Q5np_unpacked']):.4f}); "
          f"packing " + ("pays" if packed < unpacked else "does not pay")
          + " on this card's link, by these walls (the chunk copies "
          f"replayed: packed {record['Q5np']['copy_ms']:.1f} ms, unpacked "
          f"{record['Q5np_unpacked']['copy_ms']:.1f} ms a run)", flush=True)
    # K13 at Q5np's and Q6's first chunk (a full one), from the caches
    bytes_of = {}
    for name in ("Q5np", "Q6"):
        src = progs[name].src
        col = src.columns[0]
        data = src.chunk(0)[0][col][0]
        bytes_of[name] = (torch.from_numpy(data).to(dev), src.packed[col],
                          src.chunk_rows,
                          dt_of(src.storage[col]))
    del progs, prog
    # PROGRAM_SQL's programs over the same tables (the chunk source cache
    # starts empty: Q5np_unpacked left its unpacked source there)
    s._stream_cache.clear()
    table_big._chunk_source_cache = None
    gc.collect()
    masks = program_phase(s, dev, want, rows, roof, launches, launch_rows,
                          record)
    if sketch is not None:
        s._stream_cache.clear()
        sketch(s)
    del s
    gc.collect()
    torch.cuda.empty_cache()
    k14 = k14_shape(masks, dev)
    del masks
    torch.cuda.empty_cache()
    return k13_shape(bytes_of), k14, record


def program_phase(s, dev, want, rows, roof, launches, launch_rows, record):
    """Q5t, Q5t2, Q5t3 (TopKProgram), Q5c, Q5h (CollectProgram), Q6g (the
    grace join) and Q6x (blow-up streaming) over the streaming phase's
    tables: each moves its counter, runs its program over the expected
    chunks, equals numpy, launches exactly stream_paths and holds less
    device memory above what was allocated before it than the 12 GiB
    budget (and, but for Q6x, whose streamed table is 50 MB, than its
    streamed columns' bytes); prints its cold wall, the median of
    STREAM_WARM warm walls, wire rate, chunk copies replayed (Q5c: the
    bytes io_stats says it copied back, against the reference's whole
    chunks) and device-busy time.  -> the row masks K14 was given over
    Q5c's and Q5h's chunks (a run apart), by query."""
    from clickhouse_tpu_torch.exec import streaming
    from clickhouse_tpu_torch.ops import _native, filter_ops
    from clickhouse_tpu_torch.storage import read_pool
    cat = s.catalog
    big, fact = cat.get_table("default", "big"), cat.get_table("default",
                                                               "fact")
    budget = s.settings.max_device_memory_bytes
    chunk_rows = STREAM_CHUNK_ROWS
    aligned = sum(-(-p.num_rows // chunk_rows) for p in big.parts)
    # Q5t3's K4 slices: each chunk's rows in TOPK_SORT_ROWS steps
    slices = sum(-(-min(chunk_rows, p.num_rows - lo)
                   // streaming.TOPK_SORT_ROWS)
                 for p in big.parts for lo in range(0, p.num_rows,
                                                    chunk_rows))
    n_gt = want["Q5"][0][0]
    # each query's program, as the session builds it
    created = []
    program = streaming._program

    def program_watch(*a, **kw):
        created.append(program(*a, **kw))
        return created[-1]
    streaming._program = program_watch
    pool_runs = [0]
    iter_ordered = read_pool.ParallelChunkReader.iter_ordered

    def counted(self):
        pool_runs[0] += 1
        return iter_ordered(self)
    read_pool.ParallelChunkReader.iter_ordered = counted
    problems, masks = [], {}
    try:
        for name, sql, cls in PROGRAM_SQL:
            event = PROGRAM_EVENT.get(name, "StreamedQueries")
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            before = {e: s.profile_events.get(e, 0) for e in
                      ("StreamedQueries", "GraceJoinBuckets",
                       "BlowupStreamedQueries")}
            del created[:]
            pool_before = pool_runs[0]
            _native.reset_launches()
            t0 = time.perf_counter()
            res = s.execute(sql)
            torch.cuda.synchronize()
            cold = time.perf_counter() - t0
            got = res.rows()
            mine = dict(_native.LAUNCHES)
            rows_of = {k: list(v) for k, v in _native.LAUNCH_ROWS.items()}
            peak = torch.cuda.max_memory_allocated() - base
            prog = created[-1] if created else None
            moved = {e: s.profile_events.get(e, 0) - v
                     for e, v in before.items()}
            if prog is None or type(prog).__name__ != cls:
                problems.append(f"{name} ran {type(prog).__name__}, not "
                                f"{cls}")
                continue
            if name == "Q6x":
                n_chunks = -(-JOIN_DIM // prog.src.chunk_rows)
                # the cross join's 1e9 rows of label and number
                streamed = JOIN_DIM * 100 * 16
            elif name == "Q6g":
                n_chunks = sum(max(1, -(-src.total_rows // chunk_rows))
                               for src, _ in prog.sources)
                streamed = fact.physical_bytes() + cat.get_table(
                    "default", "dim_g").physical_bytes()
            else:
                n_chunks = -(-n_gt // chunk_rows) if name == "Q5t2" \
                    else aligned
                streamed = big.physical_bytes()
            path = stream_paths({name: n_chunks}, slices)[name]
            if not stream_agree(name, got, want):
                problems.append(f"{name} returned {got[:3]}... ({len(got)} "
                                f"rows), numpy says {want[name][:3]}... "
                                f"({len(want[name])} rows)")
            want_moved = {"StreamedQueries": 0 if name == "Q6x" else 1,
                          "GraceJoinBuckets": 8 if name == "Q6g" else 0,
                          "BlowupStreamedQueries": 1 if name == "Q6x"
                          else 0}
            if moved != want_moved:
                problems.append(f"{name} moved {moved}, not {want_moved}")
            if prog.io_stats["chunks"] != n_chunks:
                problems.append(f"{name} read {prog.io_stats['chunks']} "
                                f"chunks, not {n_chunks}")
            if mine != {k: path.get(k, 0) for k in mine}:
                problems.append(
                    f"{name} launched { {k: v for k, v in mine.items() if v} }"
                    f"; its path is {path} and nothing else")
            if n_chunks > len(prog.sources) and pool_runs[0] == pool_before:
                problems.append(f"{name} did not run the read pool")
            if peak >= budget or (name != "Q6x" and peak >= streamed):
                problems.append(f"{name} held {peak} bytes above what was "
                                f"allocated before it: the budget is "
                                f"{budget}, its streamed columns "
                                f"{streamed} bytes")
            for k, v in rows_of.items():
                launches[k] += mine[k]
                launch_rows[k] += v
            io_cold = dict(prog.io_stats)
            warm = []
            for _ in range(STREAM_WARM):
                t0 = time.perf_counter()
                res = s.execute(sql)
                torch.cuda.synchronize()
                warm.append(time.perf_counter() - t0)
                if res.rows() != got:
                    problems.append(f"{name}'s warm run returned other rows")
            prog = created[-1] if created and name == "Q6x" else prog
            copy_ms = sum(chunk_copy_ms(src, dev) for src, _ in prog.sources)
            wire = sum(src.total_rows * (sum(b for _, _, b in
                                             src.packed.values()) / 2 or
                                         sum(np.dtype(src.storage[c]).itemsize
                                             for c in src.columns))
                       for src, _ in prog.sources)
            extra = ""
            if prog.grace is not None:
                build_ms = sum(chunk_copy_ms(b, dev) for b in prog.grace[1])
                build_bytes = sum(sum(d.nbytes + (v.nbytes if v is not None
                                                  else 0)
                                      for d, v in b.chunk(0)[0].values())
                                  for b in prog.grace[1])
                wire += build_bytes
                copy_ms += build_ms
                extra += (f"; {len(prog.grace[1])} build buckets of "
                          f"{prog.grace[1][0].chunk_rows} slots, "
                          f"{build_bytes} bytes copied a run ({build_ms:.3f}"
                          f" ms replayed)")
            if name == "Q5t3":
                extra += f"; {slices} K4 slices"
            if name == "Q5c":
                back = io_cold["back_bytes"]
                ref_back = aligned * chunk_rows * 9
                extra += (f"; {back} bytes copied back (io_stats; "
                          f"{len(got)} rows) against the reference's whole "
                          f"chunks' {ref_back} (int64 values and a validity "
                          f"byte a row: {ref_back / max(back, 1):.0f}x)")
            events = []
            busy, ops, wall, top = device_busy(s, sql, reps=1,
                                               events_out=events)
            n_copies, traced_ms = traced_copies(events)
            med = statistics.median(warm)
            record[name] = {"cold_s": cold, "warm_s": med, "peak": peak,
                            "busy_ms": busy, "copy_ms": copy_ms,
                            "chunks": n_chunks}
            print(f"{name} ({cls}): {n_chunks} chunks of "
                  f"{prog.src.chunk_rows} rows; cold {cold:.3f} s, warm "
                  f"median {med:.3f} s of {STREAM_WARM} "
                  f"({[round(w, 3) for w in warm]}); wire "
                  f"{wire / med / 1e9:.3f} GB/s ({wire:.0f} bytes) = "
                  f"{wire / med / roof['pinned']:.3f} of the pinned copy "
                  f"rate; chunk_copy_ms {copy_ms:.3f}; io_stats cold "
                  f"{io_cold}, warm {prog.io_stats}; device busy "
                  f"{busy:.3f} ms of {wall:.3f} ms wall ({n_copies} chunk "
                  f"copies traced, {traced_ms:.3f} ms), {ops:g} device "
                  f"operations, top " + "; ".join(
                      f"{n} {t:.3f}" for n, t in top[:5])
                  + f"; peak {peak} bytes above the start (budget {budget},"
                  f" streamed {streamed}); counters {moved}; launches "
                  f"{ {k: v for k, v in mine.items() if v} }" + extra,
                  flush=True)
        # K14's inputs over Q5c's and Q5h's chunks, a run apart (the timed
        # runs hold nothing extra)
        compact = filter_ops.compact_rows
        for name in ("Q5c", "Q5h"):
            def compact_watch(rows, seen=masks.setdefault(name, [])):
                seen.append(rows)
                return compact(rows)
            filter_ops.compact_rows = compact_watch
            try:
                s.execute(dict((n, q) for n, q, _ in PROGRAM_SQL)[name])
            finally:
                filter_ops.compact_rows = compact
    finally:
        streaming._program = program
        read_pool.ParallelChunkReader.iter_ordered = iter_ordered
    if problems:
        fail("; ".join(problems))
    return masks


def k14_dense_mask(dev):
    """A 2^27-row bool mask, each row kept with probability 0.5 (seeded)."""
    g = torch.Generator(device=dev)
    g.manual_seed(14)
    return torch.rand(STREAM_CHUNK_ROWS, generator=g, device=dev) < 0.5


def k14_time(label, rows):
    """K14 on one RowMask against its plain version (must agree), timed
    beside its plain version, torch.nonzero(mask).squeeze(1) (a bool mask
    without terms), and, for the phase split, K1's count of the same
    selection (the card's practical rate for reading it) and a fill of
    the kept rows' int32 slots (their writes alone); prints a line.
    -> its numbers."""
    from clickhouse_tpu_torch.ops.filter_ops import (_compact_rows_plain,
                                                     compact_rows,
                                                     compact_rows_bytes)
    idx, count = compact_rows(rows)
    pidx, pcount = _compact_rows_plain(rows)
    c = int(count)
    if c != int(pcount) or not torch.equal(idx[:c], pidx[:c]):
        fail(f"K14 at {label} differs from its plain version")
    del pidx
    n = min(rows.n_rows, rows.capacity)
    ms = cuda_ms(lambda: compact_rows(rows))
    plain_ms = cuda_ms(lambda: _compact_rows_plain(rows), reps=3)
    lib_ms = cuda_ms(lambda: torch.nonzero(rows.mask).squeeze(1)) \
        if rows.mask is not None and not rows.terms else None
    read_ms = cuda_ms(rows.count)
    kept = idx[:c]
    fill_ms = cuda_ms(kept.zero_) if c else 0.0
    del idx, kept
    nb = compact_rows_bytes(n, c)
    print(f"K14 at {label} ({n} rows, {c} kept, a bool mask"
          f"{' and terms' if rows.terms else ''}): {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch.nonzero "
          f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}; K1's count "
          f"of the same mask {read_ms:.4f} ms ({n / read_ms / 1e6:.1f} GB/s)"
          f", the kept slots' fill {fill_ms:.4f} ms, the rest (scan, "
          f"look-back chain, staging) {ms - read_ms - fill_ms:.4f} ms; {nb} "
          f"bytes, bound {bound_ms(nb):.4f} ms (share "
          f"{bound_ms(nb) / ms:.2f})", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "k1_count_ms": read_ms, "fill_ms": fill_ms, "bytes": nb,
            "bound_ms": bound_ms(nb), "shape": f"{n} rows, {c} kept"}


def k14_shape(masks, dev):
    """K14 replayed on the row masks of Q5c's and Q5h's chunks (masks:
    {query: [RowMask a chunk]}) and on a dense 2^27-row mask (k14_time
    each).  -> the numbers of Q5c's first chunk, Q5h's (q5h_*) and the
    dense mask's (dense_*)."""
    out = {"max_abs_err": 0.0}
    for name, pre in (("Q5c", ""), ("Q5h", "q5h_")):
        for i, rows in enumerate(masks[name]):
            r = k14_time(f"{name}'s chunk {i}", rows)
            if i == 0:
                out.update({pre + k: v for k, v in r.items()})
    from clickhouse_tpu_torch.ops.agg_ops import RowMask
    r = k14_time("a dense 2^27-row mask (50 %)",
                 RowMask.of(k14_dense_mask(dev)))
    out.update({"dense_" + k: v for k, v in r.items()})
    return out


def k14_turn(dev):
    """K14's cases, then K14 timed (k14_time) on the masks of Q5c's and
    Q5h's first chunks, made on the card as the streaming phase's table
    holds them (x = (row * 2654435761) % 1_000_003; x % 1000 = 7 and x %
    100 = 7), and on a dense 2^27-row mask: `--k14`, run in this tree and
    in an unpacked older checkout alike."""
    from clickhouse_tpu_torch.ops.agg_ops import RowMask
    check_k14(dev)
    x = torch.arange(STREAM_CHUNK_ROWS, dtype=torch.int64, device=dev) \
        * 2654435761 % 1_000_003
    for name, m in (("Q5c's chunk 0", 1000), ("Q5h's chunk 0", 100)):
        k14_time(name + " (made on the card)", RowMask.of(x % m == 7))
    del x
    k14_time("a dense 2^27-row mask (50 %)", RowMask.of(k14_dense_mask(dev)))


def dt_of(np_dtype):
    from clickhouse_tpu_torch.core import dtypes
    return dtypes.torch_dtype_of(np_dtype)


def k13_shape(bytes_of):
    """K13 replayed at Q5np's and Q6's chunk inputs against its plain
    version: ms, plain_ms, bytes and bound_ms (library: none; Q6's are the
    record's main numbers, Q5np's under q5_*)."""
    from clickhouse_tpu_torch.ops.chunk_ops import (_unpack_pairs_plain,
                                                    unpack_pairs,
                                                    unpack_pairs_bytes)
    out = {"library_ms": None, "max_abs_err": 0.0}
    for name, (d, (w4, off, bpp), cap, out_dtype) in bytes_of.items():
        got = unpack_pairs(d, w4, off, bpp, cap, out_dtype)
        plain = _unpack_pairs_plain(d, w4, off, bpp, cap, out_dtype)
        out["max_abs_err"] = max(out["max_abs_err"], max_abs_err(got, plain))
        del got, plain
        ms = cuda_ms(lambda: unpack_pairs(d, w4, off, bpp, cap, out_dtype))
        plain_ms = cuda_ms(lambda: _unpack_pairs_plain(d, w4, off, bpp, cap,
                                                       out_dtype), reps=3)
        nb = unpack_pairs_bytes(cap, bpp, out_dtype)
        pre = "" if name == "Q6" else "q5_"
        out.update({f"{pre}ms": ms, f"{pre}plain_ms": plain_ms,
                    f"{pre}bytes": nb, f"{pre}bound_ms": bound_ms(nb),
                    f"{pre}shape": f"w4={w4} bpp={bpp} cap={cap} "
                                   f"{out_dtype}"})
        print(f"K13 at {name}'s chunk ({cap} values, w4 {w4}, {bpp} B a "
              f"pair, {out_dtype}): {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"{nb} bytes, bound {bound_ms(nb):.4f} ms (share "
              f"{bound_ms(nb) / ms:.2f})", flush=True)
    return out



# -- slice 19: the sketch aggregates and the row hashes (K15, K16) ---------
QU1 = "SELECT uniq(x) FROM hits"
QU2 = ("SELECT x % 1024 AS k, uniq(x), uniqCombined(x, x % 7) FROM hits "
       "GROUP BY k ORDER BY k LIMIT 10")
QU3 = "SELECT count() FROM hits WHERE cityHash64(x) % 16 = 3"
QS1 = ("SELECT x % 1024 AS k, topK(5)(x % 37), entropy(x % 37) FROM hits "
       "GROUP BY k ORDER BY k LIMIT 10")
QS2 = ("SELECT x % 1024 AS k, groupArray(8)(x), groupUniqArray(8)(x % 5) "
       "FROM hits GROUP BY k ORDER BY k LIMIT 10")
SKETCH_QUERIES = (("Qu1", QU1), ("Qu2", QU2), ("Qu3", QU3), ("Qs1", QS1),
                  ("Qs2", QS2))
SKETCH_STREAM_SQL = (
    ("Q5u", "SELECT uniq(x) FROM big SETTINGS stream_readers = 2"),
    ("Q5ub", "SELECT x % 1024 AS k, uniq(x) FROM big GROUP BY k ORDER BY k "
             "LIMIT 10 SETTINGS stream_readers = 2"))
# the kernels each sketch query must reach, each at least once
SKETCH_PATHS = {
    "Qu1": ("hll_update", "hll_finalize"),
    "Qu2": ("radix_sort_pairs", "segment_bounds", "hll_update_rows",
            "hll_cells", "hll_finalize"),
    "Qu3": ("row_hash", "masked_reduce"),
    "Qs1": ("radix_sort_pairs", "segment_bounds", "segment_reduce_sorted"),
    "Qs2": ("radix_sort_pairs", "segment_bounds", "segment_reduce_sorted"),
    "Q5u": ("unpack_pairs", "hll_update", "hll_merge", "hll_finalize"),
    "Q5ub": ("unpack_pairs", "radix_sort_pairs", "segment_bounds",
             "hll_update_rows", "hll_cells", "hll_merge", "hll_finalize")}
# the kernels a sketch query must not reach: Qu2's and Q5ub's keys (x %
# 1024) take K16's row-order entry, never its perm entry
SKETCH_NOT = {"Qu2": ("hll_update",), "Q5ub": ("hll_update",)}
HLL_KERNELS = ("hll_update", "hll_update_rows", "hll_cells", "hll_merge",
               "hll_finalize")
# every x of hits and big: each residue of the prime 1,000,003 appears
HLL_DISTINCT = 1_000_003
ENTROPY_RTOL = 1e-9     # the port sums a run's terms, numpy p log2 p
SKETCH_REPS = 5         # timed runs of each sketch query
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def hash_combine_np(h, x):
    """ops/hash_ops.hash_combine over uint64 in numpy."""
    with np.errstate(over="ignore"):
        return mix64_np(h ^ (mix64_np(x) + _GOLDEN + (h << np.uint64(6))
                             + (h >> np.uint64(2))))


def hll_registers_np(gid, h, groups, m):
    """(groups, m) uint8 registers of the hashes h in groups gid."""
    log2m = m.bit_length() - 1
    reg = (h & np.uint64(m - 1)).astype(np.int64)
    w = (h >> np.uint64(log2m)) | (np.uint64(1) << np.uint64(64 - log2m))
    low = w & (~w + np.uint64(1))
    rho = np.log2(low.astype(np.float64)).astype(np.uint8) + np.uint8(1)
    out = np.zeros((groups, m), np.uint8)
    np.maximum.at(out, (gid, reg), rho)
    return out


def hll_estimate_np(regs):
    """The reference's finalize of (groups, m) registers in numpy
    float32."""
    g, m = regs.shape
    b = regs.reshape(g, m // 8, 8).astype(np.float32)
    z = np.zeros(g, np.float32)
    v = np.zeros(g, np.int64)
    for k in range(8):
        z = z + np.exp2(-b[:, :, k]).sum(axis=1, dtype=np.float32)
        v = v + (b[:, :, k] == 0).sum(axis=1)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    e = np.float32(alpha * m * m) / np.maximum(z, np.float32(1e-9))
    lc = np.float32(m) * np.log(np.float32(m) / np.maximum(v, 1).astype(
        np.float32))
    e = np.where((e <= 2.5 * m) & (v > 0), lc, e)
    return np.round(e).astype(np.int64)


def sketch_answers(x: np.ndarray):
    """numpy's answers to the sketch queries over hits' x (and big's, the
    same distinct values): the registers of Qu1 (m = 4,096) and Qu2's two
    uniqs (1,024 groups of m = 64) from the distinct values, the
    estimates, Qu3's count, Qs1's top 5 and entropy, and Qs2's arrays
    from the first 400,000 rows."""
    t0 = time.perf_counter()
    counts = np.bincount(x, minlength=HLL_DISTINCT)
    vals = np.flatnonzero(counts).astype(np.int64)
    if len(vals) != HLL_DISTINCT:
        fail(f"hits holds {len(vals)} distinct x, not {HLL_DISTINCT}")
    u = vals.view(np.uint64)
    h = mix64_np(u)
    k = vals % 1024
    r1 = hll_registers_np(np.zeros(len(vals), np.int64), h, 1, 4096)
    r2 = hll_registers_np(k, h, 1024, 64)
    r3 = hll_registers_np(k, hash_combine_np(h, (vals % 7).view(np.uint64)),
                          1024, 64)
    e1, e2, e3 = (hll_estimate_np(r) for r in (r1, r2, r3))
    want = {"Qu1": [(int(e1[0]),)], "Qu1:registers": r1,
            "Qu2": [(g, int(e2[g]), int(e3[g])) for g in range(10)],
            "Qu2:registers": (r2, r3),
            "Qu3": [(int(counts[vals[(h % np.uint64(16)) == 3]].sum()),)]}
    want["Q5u"], want["Q5u:registers"] = want["Qu1"], r1
    want["Q5ub"] = [(g, int(e2[g])) for g in range(10)]
    want["Q5ub:registers"] = (r2,)
    qs1 = []
    for g in range(10):
        sel = vals[k == g]
        cnt = np.bincount(sel % 37, weights=counts[sel], minlength=37)
        vs = np.flatnonzero(cnt)
        order = vs[np.lexsort((vs, -cnt[vs]))]
        p = cnt[vs] / cnt[vs].sum()
        qs1.append((g, [int(v) for v in order[:5]],
                    float(-(p * np.log2(p)).sum())))
    want["Qs1"] = qs1
    head = x[:400_000]
    qs2 = []
    for g in range(10):
        rows = head[head % 1024 == g]
        v5 = rows % 5
        _, first = np.unique(v5, return_index=True)
        qs2.append((g, [int(v) for v in rows[:8]],
                    [int(v) for v in v5[np.sort(first)][:8]]))
    want["Qs2"] = qs2
    print(f"sketch answers (numpy, {len(vals)} distinct x): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return want


def sketch_agree(name, rows, want) -> bool:
    """Exact rows, but an HLL estimate within 1 of numpy's float32 one
    (the kernel sums 2^-register in another order) and an entropy within
    ENTROPY_RTOL."""
    w = want[name]
    estimates = name in ("Qu1", "Qu2", "Q5u", "Q5ub")
    if len(rows) != len(w):
        return False
    for got, exp in zip(rows, w):
        if len(got) != len(exp):
            return False
        for i, (a, b) in enumerate(zip(got, exp)):
            if isinstance(b, float):
                ok = math.isclose(a, b, rel_tol=ENTROPY_RTOL)
            elif isinstance(b, list):
                ok = list(a) == b
            elif estimates and (i > 0 or name in ("Qu1", "Q5u")):
                ok = abs(a - b) <= 1
            else:
                ok = a == b
            if not ok:
                return False
    return True


class SketchWatch:
    """Watches the sketch path while a query runs (each call passed on as
    it is): the states each HLL finalize is given, and the inputs of the
    first K15 call, of the first K16 update, cells' copy, finalize and
    merge of each query, to replay them."""

    def __init__(self):
        from clickhouse_tpu_torch.exprs import agg_sketch
        from clickhouse_tpu_torch.ops import hash_ops, sketch_ops
        self.mods = (agg_sketch, hash_ops, sketch_ops)
        self.query, self.states, self.args = "", {}, {}
        fin = agg_sketch.HLLUniqAgg.finalize
        orig = {"row_hash": hash_ops.row_hash,
                "hll_update": sketch_ops.hll_update,
                "hll_update_rows": sketch_ops.hll_update_rows,
                "hll_cells": sketch_ops.hll_cells,
                "hll_merge": sketch_ops.hll_merge}
        self.orig = dict(orig, finalize=fin)

        def finalize(agg, st):
            if self.query:
                self.states.setdefault(self.query, []).append(st[0])
            return fin(agg, st)

        def keep(name):
            def call(*a, **kw):
                key = (self.query, name)
                if self.query and (name == "hll_merge"
                                   or key not in self.args):
                    self.args[key] = (a, kw)   # a merge: the last one
                return orig[name](*a, **kw)
            return call
        agg_sketch.HLLUniqAgg.finalize = finalize
        hash_ops.row_hash = keep("row_hash")
        sketch_ops.hll_update = keep("hll_update")
        sketch_ops.hll_update_rows = keep("hll_update_rows")
        sketch_ops.hll_cells = keep("hll_cells")
        sketch_ops.hll_merge = keep("hll_merge")

    def close(self):
        agg_sketch, hash_ops, sketch_ops = self.mods
        agg_sketch.HLLUniqAgg.finalize = self.orig["finalize"]
        hash_ops.row_hash = self.orig["row_hash"]
        for name in ("hll_update", "hll_update_rows", "hll_cells",
                     "hll_merge"):
            setattr(sketch_ops, name, self.orig[name])


def check_registers(name, states, want):
    """The port's HLL states of a query against numpy's registers, bit for
    bit: each state's first rows are numpy's groups, the rest empty."""
    exp = want.get(f"{name}:registers")
    if exp is None:
        return
    exp = exp if isinstance(exp, tuple) else (exp,)
    if len(states) != len(exp):
        fail(f"{name} finalized {len(states)} HLL states, not {len(exp)}")
    for st, r in zip(states, exp):
        g = r.shape[0]
        if st.shape[1] != r.shape[1]:
            fail(f"{name}'s state has m = {st.shape[1]}, numpy's "
                 f"{r.shape[1]}")
        if not np.array_equal(st[:g].cpu().numpy(), r):
            fail(f"{name}'s registers differ from numpy's")
        if bool(st[g:].any()):
            fail(f"{name}'s state holds registers past its {g} groups")
    print(f"{name}: {len(states)} HLL state(s) of "
          f"{tuple(states[0].shape)} registers equal numpy's bit for bit",
          flush=True)


def sketch_query(s, name, sql, want, watch, per_query, launches,
                 launch_rows, timed=True):
    """One sketch query on its path: numpy's answer, its registers, the
    kernels of SKETCH_PATHS, its peak beside the governor's estimate,
    then its wall (median of SKETCH_REPS) and device-busy time."""
    from clickhouse_tpu_torch.exec.streaming import estimate_plan_device_bytes
    from clickhouse_tpu_torch.ops import _native
    from clickhouse_tpu_torch.sql import parse
    watch.query = name
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _native.reset_launches()
    t0 = time.perf_counter()
    rows = s.execute(sql).rows()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    mine = dict(_native.LAUNCHES)
    rows_of = {k: list(v) for k, v in _native.LAUNCH_ROWS.items()}
    peak = torch.cuda.max_memory_allocated() - base
    per_query[name] = mine
    watch.query = ""                   # the timed runs are not watched
    if not sketch_agree(name, rows, want):
        fail(f"{name} returned {rows[:4]}, numpy says {want[name][:4]}")
    check_registers(name, watch.states.pop(name, []), want)
    missing = [k for k in SKETCH_PATHS[name] if mine[k] < 1]
    if missing:
        fail(f"{name} launched no {missing}: "
             f"{ {k: v for k, v in mine.items() if v} }")
    barred = [k for k in SKETCH_NOT.get(name, ()) if mine[k]]
    if barred:
        fail(f"{name} launched {barred}: "
             f"{ {k: v for k, v in mine.items() if v} }")
    for k, v in rows_of.items():
        launches[k] += mine[k]
        launch_rows[k] += v
    est = estimate_plan_device_bytes(s._plan(parse(sql), s.settings),
                                     s.catalog, s.settings)
    rec = {"first_s": first, "peak": peak, "estimate": est,
           "launches": {k: v for k, v in mine.items() if v}}
    if timed:
        walls = []
        for _ in range(SKETCH_REPS):
            t0 = time.perf_counter()
            s.execute(sql)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        busy, ops, wall, top = device_busy(s, sql, reps=2)
        rec.update(wall_ms=statistics.median(walls) * 1e3, busy_ms=busy,
                   ops=ops, top=top)
    print(f"{name}: matches numpy; launches {rec['launches']} (rows a "
          f"launch { {k: v for k, v in rows_of.items() if v} }); first run "
          f"{first:.3f} s; peak {peak} bytes above what was allocated "
          f"before it, the governor's estimate {est} bytes"
          + (f"; wall median {rec['wall_ms']:.3f} ms of {SKETCH_REPS}; "
             f"device busy {rec['busy_ms']:.3f} ms a run, "
             f"{rec['ops']:g} device operations; top "
             + "; ".join(f"{n} {t:.3f}" for n, t in rec["top"])
             if timed else ""), flush=True)
    return rec


def sketch_phase(s, want, watch, per_query, launches, launch_rows):
    """Qu1-Qu3, Qs1 and Qs2 over hits through the session, each on its
    kernel path and against numpy (registers bit for bit)."""
    out = {}
    for name, sql in SKETCH_QUERIES:
        out[name] = sketch_query(s, name, sql, want, watch, per_query,
                                 launches, launch_rows)
    print("Qu1, Qu2, Qu3, Qs1 and Qs2 match numpy, each on its kernel path",
          flush=True)
    return out


def sketch_stream_phase(s, want, watch, per_query, launches, launch_rows):
    """Q5u and Q5ub over big (1B rows, streamed): each streams, its carry
    merged by K16, its registers numpy's; a cold and STREAM_WARM warm
    runs timed."""
    out = {}
    for name, sql in SKETCH_STREAM_SQL:
        before = s.profile_events.get("StreamedQueries", 0)
        rec = sketch_query(s, name, sql, want, watch, per_query, launches,
                           launch_rows, timed=False)
        if s.profile_events.get("StreamedQueries", 0) != before + 1:
            fail(f"{name} did not stream")
        warm = []
        for _ in range(STREAM_WARM):
            t0 = time.perf_counter()
            s.execute(sql)
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
        busy, ops, wall, top = device_busy(s, sql, reps=1)
        rec.update(warm_s=statistics.median(warm), busy_ms=busy, top=top)
        print(f"{name}: cold {rec['first_s']:.3f} s, warm median "
              f"{rec['warm_s']:.3f} s of {STREAM_WARM}; device busy "
              f"{busy:.3f} ms of {wall:.3f} ms wall (a floor: the trace may "
              f"miss the feeder's copies), {ops:g} device operations; top "
              + "; ".join(f"{n} {t:.3f}" for n, t in top[:5]), flush=True)
        out[name] = rec
    return out


# K15's cases: (name, column types); the values seeded, K15_ROWS rows
K15_ROWS = 1_000_003
K15_CASES = ("int8", "int16", "int32", "int64", "uint8", "bool",
             "u64_above_2_63", "f32", "f64", "f64_in_f32", "code",
             "term_mod", "term_div_int8", "nullable_data", "const_and_col",
             "cols2", "cols3", "cols4", "cols6", "view_1", "view_3",
             "one_row")


def k15_case(name, dev, n=K15_ROWS):
    """(HashArgs on dev, rows) of a K15 case: every storage type, UInt64
    above 2^63, a Float64 stored as float32, a dictionary code, intDiv /
    modulo terms, a NULL row's stored value (K15 hashes it; the caller's
    validity masks it), a constant, 2-6 columns, views 1 and 3 rows in,
    one row."""
    from clickhouse_tpu_torch.ops.hash_ops import HashArg
    from clickhouse_tpu_torch.ops.scan_ops import Term
    rng = np.random.default_rng(len(name) * 7 + 19)
    if name == "one_row":
        n = 1
        return [HashArg(torch.tensor([-7], dtype=torch.int64, device=dev)),
                HashArg(torch.tensor([2.5], device=dev), "f32")], n

    def col(dtype, lo=None, hi=None, rows=n):
        if dtype == "bool":
            return torch.from_numpy(rng.random(rows) < 0.5).to(dev)
        if dtype in ("float32", "float64"):
            v = rng.normal(0, 1e3, rows).astype(dtype)
            v[:min(rows, 4)] = [np.nan, -0.0, 0.0, np.inf][:min(rows, 4)]
            return torch.from_numpy(v).to(dev)
        info = np.iinfo(dtype)
        v = rng.integers(info.min if lo is None else lo,
                         info.max if hi is None else hi, rows, dtype=dtype)
        return torch.from_numpy(v).to(dev)
    i32 = col("int32")
    if name in ("int8", "int16", "int32", "int64", "uint8", "bool"):
        return [HashArg(col(name))], n
    if name == "u64_above_2_63":
        v = col("int64")
        v[::3] = v[::3] | (-(1 << 63))
        return [HashArg(v)], n
    if name in ("f32", "f64"):
        return [HashArg(col("float32" if name == "f32" else "float64"),
                        name)], n
    if name == "f64_in_f32":
        return [HashArg(col("float32"), "f64")], n
    if name == "code":
        return [HashArg(col("int32", 0, 25_000_000))], n
    if name == "term_mod":
        return [HashArg(Term(i32, "mod", 7, torch.int64))], n
    if name == "term_div_int8":
        return [HashArg(Term(col("int8"), "div", -3, torch.int64))], n
    if name == "nullable_data":
        v = col("int64")
        v[::5] = 0                       # NULL rows' stored zeros
        return [HashArg(v)], n
    if name == "const_and_col":
        return [HashArg(torch.tensor(-5, dtype=torch.int64, device=dev)),
                HashArg(i32)], n
    if name.startswith("cols"):
        pool = [HashArg(i32), HashArg(col("float32"), "f32"),
                HashArg(col("int16")), HashArg(col("float64"), "f64"),
                HashArg(Term(i32, "div", 1000, torch.int64)),
                HashArg(col("bool"))]
        return pool[:int(name[4:])], n
    off = int(name[-1])
    big = col("int32", rows=n + off)
    return [HashArg(big[off:]), HashArg(col("int16", rows=n + off)[off:])], n


def check_k15(dev):
    """K15 against its plain version on the card over K15_CASES: bit for
    bit."""
    from clickhouse_tpu_torch.ops import hash_ops
    for name in K15_CASES:
        args, n = k15_case(name, dev)
        got = hash_ops.row_hash(args, n)
        plain = hash_ops._fold(hash_ops.plain_values(args, n), args[0].kind)
        if not torch.equal(got, plain):
            fail(f"K15 ({name}) differs from its plain version")
    print(f"K15 matches its plain version bit for bit over "
          f"{len(K15_CASES)} cases (every storage type, UInt64 above 2^63, "
          f"floats with NaN/-0.0/inf, a Float64 stored as float32, codes, "
          f"terms, a NULL row's data, a constant, 1-6 columns, views, one "
          f"row)", flush=True)


# K16's update cases: (name, log2 m, grouping, rows, extra)
K16_UPDATE_CASES = tuple(
    [(f"trivial_m{1 << b}", b, "trivial", 1_000_003, None)
     for b in range(6, 13)]
    + [("trivial_mask_rows", 12, "trivial", 2_000_001, "mask_rows"),
       ("trivial_bool_arg", 10, "trivial", 1_000_003, "bool_arg"),
       ("trivial_three_args", 10, "trivial", 1_000_003, "three_args"),
       ("trivial_six_args", 12, "trivial", 300_001, "six_args")]
    + [(f"sorted_m{1 << b}", b, "sorted", 1_000_003, None)
       for b in (6, 8, 10, 12)]
    + [("sorted_mask_skew", 6, "sorted", 2_000_001, "mask_skew"),
       ("sorted_two_args", 6, "sorted", 1_000_003, "two_args")]
    # the row-order entry: Qu2's key (x % 1024, 256 KB of u32 cells), m =
    # 4,096 over 1,024 slots (16 MB of cells), 16 slots
    # at m = 1,024, two keys, a Nullable key (validity, data zeroed where
    # NULL, a negative least value), an int64 key, an int8 key with a
    # constant key, slots of no group and groups past cap_g, a mask, a
    # row bound, two columns, an int64 column
    + [("rows_qu2", 6, "rows", 1_000_003, "qu2"),
       ("rows_m4096_cells", 12, "rows", 1_000_003, "qu2"),
       ("rows_m1024_16_slots", 10, "rows", 1_000_003, "span16"),
       ("rows_two_keys", 6, "rows", 1_000_003, "two_keys"),
       ("rows_nullable", 8, "rows", 1_000_003, "nullable"),
       ("rows_int64_key", 6, "rows", 1_000_003, "int64"),
       ("rows_int8_const_key", 8, "rows", 300_001, "int8_const"),
       ("rows_missing_groups", 6, "rows", 1_000_003, "missing"),
       ("rows_mask_two_args", 6, "rows", 2_000_001, "mask_two_args"),
       ("rows_row_bound", 6, "rows", 1_000_003, "row_bound"),
       ("rows_int64_arg", 6, "rows", 1_000_003, "int64_arg")])


def k16_update_case(case, dev):
    """(args, m, cap_g, keyword arguments of hll_update) of a K16 update
    case: x as the hits column (int32), a Bool or an int64 column in its
    place, a mask, a row bound below the column, 2, 3 and 6 columns; the
    sort grouping's perm (random) and group ids (ascending, some rows past
    cap_g), a group of 40 % of the rows; the row-order entry's keys and
    table (k16_rows_case)."""
    from clickhouse_tpu_torch.ops.hash_ops import HashArg
    from clickhouse_tpu_torch.ops.scan_ops import Term
    name, log2m, kind, n, extra = case
    rng = np.random.default_rng(log2m * 31 + n % 97)
    x = torch.from_numpy((rng.integers(0, 1 << 40, n) % 1_000_003)
                         .astype(np.int32)).to(dev)
    args = [HashArg(x)]
    if extra == "bool_arg":
        args = [HashArg(torch.from_numpy(rng.random(n) < 0.5).to(dev))]
    if extra == "int64_arg":
        args = [HashArg(x.to(torch.int64) * 2654435761 - (1 << 40))]
    if extra == "two_args":
        args.append(HashArg(Term(x, "mod", 7, torch.int64)))
    if extra == "three_args":
        args += [HashArg(Term(x, "mod", 7, torch.int64)),
                 HashArg(torch.from_numpy(rng.normal(0, 1, n).astype(
                     np.float32)).to(dev), "f64")]
    if extra == "six_args":
        args += [HashArg(Term(x, "div", d, torch.int64))
                 for d in (3, 5, 7, 11, 13)]
    m = 1 << log2m
    mask = torch.from_numpy(rng.random(n) < 0.7).to(dev) \
        if extra in ("mask_rows", "mask_skew") else None
    if kind == "trivial":
        kw = {"n_rows": n - 1000 if extra == "mask_rows" else None,
              "mask": mask}
        return args, m, 1024, kw
    if kind == "rows":
        return k16_rows_case(extra, rng, x, args, m, n, dev)
    cap_g = 1 << 14
    g = rng.integers(0, cap_g + 64, n)
    if extra == "mask_skew":
        g[rng.random(n) < 0.4] = 7
    gid = torch.from_numpy(np.minimum(np.sort(g), cap_g).astype(np.int32)
                           ).to(dev)
    perm = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev)
    return args, m, cap_g, {"perm": perm, "gid": gid, "mask": mask}


def k16_rows_case(extra, rng, x, args, m, n, dev):
    """(args, m, cap_g, keyword arguments) of a row-order K16 update case
    (k16_update_case's "rows" kind): its keys (sketch_ops.SlotKey) and
    slot -> group table as a sort grouping gives them (the groups in slot
    order, those with no row absent; cap_g 1 << 14 unless the case cuts
    it)."""
    from clickhouse_tpu_torch.ops.hash_ops import HashArg
    from clickhouse_tpu_torch.ops.scan_ops import Term
    from clickhouse_tpu_torch.ops.sketch_ops import SlotKey
    xn = x.cpu().numpy().astype(np.int64)
    kw = {"n_rows": None, "mask": None}
    if extra in ("qu2", "missing", "mask_two_args", "row_bound",
                 "int64_arg"):
        cols = [((xn % 1024).astype(np.int32), 0, 1024)]
    elif extra == "span16":
        cols = [((xn % 16).astype(np.int16), 0, 16)]
    elif extra == "two_keys":
        cols = [((xn % 32).astype(np.int32), 0, 32),
                ((xn % 7 - 3).astype(np.int8), -3, 7)]
    elif extra == "nullable":
        valid = rng.random(n) < 0.8
        data = np.where(valid, xn % 101 - 60, 0).astype(np.int32)
        cols = [(valid, 0, 2), (data, -60, 101)]
    elif extra == "int64":
        cols = [(xn % 600 - (1 << 40), -(1 << 40), 600)]
    else:                                  # int8_const
        cols = [(np.asarray(3, np.int64), 2, 4),
                ((xn % 200 - 100).astype(np.int8), -100, 200)]
    slots, mult, slot = 1, 1, np.zeros(n, np.int64)
    for v, lo, span in cols:
        slot += (np.broadcast_to(v, (n,)).astype(np.int64) - lo) * mult
        mult *= span
    slots = mult
    present = np.zeros(slots, bool)
    present[slot] = True
    if extra == "missing":
        present[rng.random(slots) < 0.2] = False
    table = np.where(present, np.cumsum(present) - 1, -1).astype(np.int32)
    cap_g = 1 << 14 if extra != "missing" else 700
    if extra == "mask_two_args":
        kw["mask"] = torch.from_numpy(rng.random(n) < 0.6).to(dev)
        args = args + [HashArg(Term(x, "mod", 7, torch.int64))]
    if extra == "row_bound":
        kw["n_rows"] = n - 777
    kw["keys"] = [SlotKey(torch.tensor(v, device=dev), lo, span)
                  for v, lo, span in cols]
    kw["table"] = torch.from_numpy(table).to(dev)
    return args, m, cap_g, kw


def k16_update(args, m, cap_g, kw, plain=False):
    """K16's update of a K16_UPDATE_CASES case (its entry by the case's
    keyword arguments), or its plain version."""
    from clickhouse_tpu_torch.ops import sketch_ops
    log2m = m.bit_length() - 1
    if "keys" in kw:
        if not plain:
            return sketch_ops.hll_update_rows(
                args, m, cap_g, kw["keys"], kw["table"],
                n_rows=kw["n_rows"], mask=kw["mask"])
        n = sketch_ops._rows_of_keys(args, kw["keys"], kw["mask"],
                                     kw["n_rows"])
        return sketch_ops._hll_update_rows_plain(
            args, log2m, cap_g, n, kw["keys"], kw["table"], kw["mask"])
    if not plain:
        return sketch_ops.hll_update(args, m, cap_g, **kw)
    n = kw.get("n_rows")
    n = n if n is not None else (kw["perm"].shape[0] if "perm" in kw
                                 else args[0].tensor().shape[0])
    return sketch_ops._hll_update_plain(args, log2m, cap_g, n,
                                        kw.get("perm"), kw.get("gid"),
                                        kw.get("mask"))


# K16's cells' copy cases: (name, log2 m, slots, cap_g)
K16_CELLS_CASES = (("m64", 6, 1024, 1 << 14), ("m4096", 12, 1024, 2048),
                   ("groups_past_cap", 10, 16, 12))


def k16_cells_case(case, dev):
    """(cells, table, cap_g) of a K16_CELLS_CASES case: (slots, m) int32
    registers 0-65, half of them empty; each slot a distinct group of
    [0, slots + 8), a fifth of them none (-1), some at cap_g and above."""
    name, log2m, slots, cap_g = case
    rng = np.random.default_rng(log2m * 7 + slots)
    cells = rng.integers(0, 66, (slots, 1 << log2m)).astype(np.int32)
    cells[rng.random(cells.shape) < 0.5] = 0
    table = rng.permutation(slots + 8)[:slots].astype(np.int32)
    table[rng.random(slots) < 0.2] = -1
    return (torch.from_numpy(cells).to(dev), torch.from_numpy(table).to(dev),
            cap_g)


# K16's merge and finalize cases: (name, log2 m, groups, partial rows)
K16_MERGE_CASES = (("q5ub_carry", 6, 1 << 22, 1 << 23),
                   ("empty_groups", 8, 50_000, 60_000),
                   ("m4096", 12, 1024, 2048),
                   ("trivial", 12, 1024, 2048))


def k16_registers(seed, rows, m, dev):
    """(rows, m) registers as data makes them, drawn on dev: rho is 1 +
    the trailing zeros of a random byte (geometric, 1-9), 60 % of them
    empty."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    b = torch.randint(0, 256, (rows, m), generator=gen, device=dev)
    lut = torch.tensor([9] + [(v & -v).bit_length() for v in range(1, 256)],
                       dtype=torch.uint8, device=dev)
    r = lut[b]
    r[torch.rand((rows, m), generator=gen, device=dev) < 0.6] = 0
    return r


def k16_merge_case(case, dev):
    """(partial states, groups, keyword arguments of hll_merge): the
    partial rows' groups ascending with empty groups among them, read
    through a random perm, a mask of the partials that take part; the
    trivial case one group of every row."""
    name, log2m, groups, rows = case
    rng = np.random.default_rng(log2m + rows % 101)
    st = k16_registers(log2m + rows % 101, rows, 1 << log2m, dev)
    mask = torch.from_numpy(rng.random(rows) < 0.9).to(dev)
    if name == "trivial":
        return st, groups, {"mask": mask}
    gid = np.sort(rng.integers(0, groups, rows))
    if name == "empty_groups":
        gid = np.sort(rng.integers(0, groups // 3, rows) * 3)
    starts = np.searchsorted(gid, np.arange(groups))
    ends = np.searchsorted(gid, np.arange(groups), side="right")
    return st, groups, {
        "starts": torch.from_numpy(starts).to(dev),
        "ends": torch.from_numpy(ends).to(dev),
        "perm": torch.from_numpy(rng.permutation(rows).astype(np.int32)).to(
            dev), "mask": mask}


def k16_estimates_agree(got, plain, what):
    """K16's estimates against its plain version's: within 1 (the float32
    sum's order), and 1 off for at most 1 % of the groups."""
    d = (got - plain).abs()
    off = int((d > 0).sum())
    if int(d.max()) > 1 or off > max(2, got.numel() // 100):
        fail(f"K16's finalize ({what}) is {int(d.max())} off its plain "
             f"version ({off} groups differ)")
    return off


def check_k16(dev):
    """K16's three entries against their plain versions on the card: the
    update under the trivial grouping and the sort grouping (through perm
    and in row order) at m from 64 to 4,096 (bit for bit), the merge over K16_MERGE_CASES (bit for bit)
    and the finalize of each merged state (within 1)."""
    from clickhouse_tpu_torch.ops import sketch_ops
    for case in K16_UPDATE_CASES:
        args, m, cap_g, kw = k16_update_case(case, dev)
        got = k16_update(args, m, cap_g, kw)
        if not torch.equal(got, k16_update(args, m, cap_g, kw, plain=True)):
            fail(f"K16's update ({case[0]}) differs from its plain version")
    for case in K16_CELLS_CASES:
        cells, table, cap_g = k16_cells_case(case, dev)
        if not torch.equal(sketch_ops.hll_cells(cells, table, cap_g),
                           sketch_ops._hll_cells_plain(cells, table, cap_g)):
            fail(f"K16's cells' copy ({case[0]}) differs from its plain "
                 f"version")
    off = 0
    for case in K16_MERGE_CASES:
        st, groups, kw = k16_merge_case(case, dev)
        got = sketch_ops.hll_merge(st, groups, **kw)
        plain = sketch_ops._hll_merge_plain(
            st, groups, kw.get("starts"), kw.get("ends"), kw.get("perm"),
            kw.get("mask"))
        if not torch.equal(got, plain):
            fail(f"K16's merge ({case[0]}) differs from its plain version")
        off += k16_estimates_agree(sketch_ops.hll_finalize(got),
                                   sketch_ops._hll_finalize_plain(plain),
                                   case[0])
        del st, got, plain
    print(f"K16 matches its plain versions: {len(K16_UPDATE_CASES)} update "
          f"cases bit for bit (GROUP BY (), the sort grouping through perm "
          f"and in row order from its keys: m 64-4,096, 256 KB and 16 MB "
          f"of cells, 1-2 keys, a Nullable key, masks, row bounds, 1-6 "
          f"columns), {len(K16_CELLS_CASES)} cells' copies bit for bit, "
          f"{len(K16_MERGE_CASES)} merges bit for bit (Q5ub's carry, empty "
          f"groups, m 4,096, GROUP BY ()), their finalizes within 1 ({off} "
          f"groups 1 off)", flush=True)


# K16's row-order entry against its perm entry, over hits' x keyed by x %
# slots: (slots, log2 m, cap_g).  Qu2's 1,024 slots at m = 64 (256 KB of
# cells), 2,048 and 3,072, and 1,024 at m = 4,096 (16 MB: the most the
# route takes, HLL_ROWS_MAX_CELLS)
K16_LAYOUT_CASES = ((1024, 6, 1 << 22), (2048, 6, 1 << 22),
                    (3072, 6, 1 << 22), (1024, 12, 2048))


def k16_perm_of(keys, table, n, cap_g, mask):
    """perm and group ids (int32) of the sort grouping of the first n rows
    by their keys' slots, as group_by_sort gives them: the rows in slot
    order (stable), a row's group table[slot] (cap_g where none)."""
    slot = torch.zeros(n, dtype=torch.int64, device=table.device)
    mult = 1
    for k in keys:
        v = k.data[:n] if k.data.dim() else k.data.expand(n)
        slot += (v.to(torch.int64) - k.lo) * mult
        mult *= k.span
    perm = torch.sort(slot, stable=True).indices
    g = table.to(torch.int64)[slot[perm]]
    del slot
    return perm.to(torch.int32), torch.where(g < 0, cap_g, g).to(torch.int32)


def k16_split(args, m, cap_g, n, mask):
    """K16's GROUP BY () update at Qu1's inputs taken apart, each a whole
    call with its state's fill and the update's blocks: the hashes alone,
    the shared registers with nothing flushed (chtt_hll_split), the
    update; the state's fill alone."""
    import ctypes
    from clickhouse_tpu_torch.ops import _native, sketch_ops
    from clickhouse_tpu_torch.ops.hash_ops import MAX_HASH_COLS, fold_args
    a = fold_args(args, MAX_HASH_COLS)
    log2m = m.bit_length() - 1
    dev = args[0].tensor().device
    lib = _native.library()

    def part(probe):
        def run():
            state = torch.zeros((cap_g, m), dtype=torch.uint8, device=dev)
            ka, keep = sketch_ops._hll_args(a, log2m, cap_g, n, mask, state)
            blocks = _native.grid_blocks(
                dev, n, per_sm=lib.chtt_hll_rows_per_sm(ctypes.byref(ka)))
            _native.check(lib.chtt_hll_split(ctypes.byref(ka), probe, blocks,
                                             _native.stream_ptr(dev)),
                          "hll_update's split")
            del keep
            return state
        return run
    out = {"hash_ms": cuda_ms(part(1)), "no_flush_ms": cuda_ms(part(2)),
           "update_ms": cuda_ms(lambda: sketch_ops.hll_update(
               args, m, cap_g, n_rows=n, mask=mask)),
           "state_fill_ms": cuda_ms(lambda: torch.zeros(
               (cap_g, m), dtype=torch.uint8, device=dev))}
    print("K16's GROUP BY () update split at Qu1's inputs (ms, each call "
          "with its state's fill): " + ", ".join(
              f"{k[:-3]} {v:.4f}" for k, v in out.items()), flush=True)
    return out


def k16_layouts(args, n, mask):
    """K16's update over hits' x keyed by x % slots (K16_LAYOUT_CASES):
    the row-order entry (u32 cells) and the perm entry (perm and group ids
    of the same grouping), the states equal, each timed."""
    from clickhouse_tpu_torch.ops import sketch_ops
    x = args[0].tensor()
    out = []
    for slots, log2m, cap_g in K16_LAYOUT_CASES:
        m = 1 << log2m
        keys = [sketch_ops.SlotKey((x[:n] % slots).to(torch.int32), 0,
                                   slots)]
        table = torch.arange(slots, dtype=torch.int32, device=x.device)
        perm, gid = k16_perm_of(keys, table, n, cap_g, mask)

        runs = {"cells": lambda: sketch_ops.hll_update_rows(
                    args, m, cap_g, keys, table, n_rows=n, mask=mask),
                "perm": lambda: sketch_ops.hll_update(
                    args, m, cap_g, perm=perm, gid=gid, mask=mask)}
        first = None
        for f in runs.values():
            st = f()
            if first is None:
                first = st
            elif not torch.equal(st, first):
                fail(f"K16's layouts differ at {slots} slots, m = {m}")
        del first, st
        rec = {"slots": slots, "m": m, "cap_g": cap_g,
               **{f"{k}_ms": cuda_ms(f) for k, f in runs.items()}}
        print(f"K16's update keyed by x % {slots} (m = {m}, {cap_g} slots): "
              + ", ".join(f"{k} {rec[k + '_ms']:.4f} ms" for k in runs),
              flush=True)
        out.append(rec)
        del perm, gid, keys, runs
    return out


def sketch_shapes(dev, watch):
    """K15 and K16 replayed on the inputs the main path gave them, each
    beside its plain version and its bound (bytes / 3.35 TB/s): K15 at
    Qu3's; K16's update at Qu1's (GROUP BY (), and its split: k16_split)
    and Qu2's (the sort grouping in row order, its cells' copy, and its
    perm entry on the same grouping's perm and group ids: the value read
    through perm, its gather-sector floor), its layouts against the perm
    entry
    (k16_layouts), its finalize at Qu2's state and its merge at Q5ub's
    last carry merge (or, in a run without it, at K16_MERGE_CASES'
    carry).  Library: none
    (no PyTorch call computes splitmix64 or an HLL register max); for
    information, scatter_reduce_(..., "amax") of Qu1's precomputed
    (index, rho)."""
    from clickhouse_tpu_torch.ops import hash_ops, sketch_ops
    out = {}
    (a, kw) = watch.args[("Qu3", "row_hash")]
    args, n = a[0], a[1] if len(a) > 1 else kw.get("n")
    got = hash_ops.row_hash(args, n)
    plain = hash_ops._fold(hash_ops.plain_values(args, n), args[0].kind)
    err = max_abs_err(got, plain)
    del got, plain
    nb = hash_ops.row_hash_bytes(args, n)
    k15 = {"ms": cuda_ms(lambda: hash_ops.row_hash(args, n)),
           "plain_ms": cuda_ms(lambda: hash_ops._fold(
               hash_ops.plain_values(args, n), args[0].kind), reps=3),
           "bytes": nb, "bound_ms": bound_ms(nb), "library_ms": None,
           "max_abs_err": err,
           "shape": f"{n} rows, {[str(x.tensor().dtype) for x in args]}"}
    out["row_hash"] = k15
    print(f"K15 at Qu3's inputs ({k15['shape']}): {k15['ms']:.4f} ms, plain "
          f"{k15['plain_ms']:.4f} ms, {nb} bytes, bound "
          f"{k15['bound_ms']:.4f} ms (share "
          f"{k15['bound_ms'] / k15['ms']:.3f})", flush=True)

    hll = {"library_ms": None}
    (args, m, cap_g), kw = watch.args[("Qu1", "hll_update")]
    n = kw.get("n_rows") if kw.get("n_rows") is not None \
        else args[0].tensor().shape[0]
    got = sketch_ops.hll_update(args, m, cap_g, **kw)
    plain = sketch_ops._hll_update_plain(args, m.bit_length() - 1, cap_g, n,
                                         None, None, kw.get("mask"))
    hll["max_abs_err"] = max_abs_err(got, plain)
    del got, plain
    nb = sketch_ops.hll_update_bytes(args, n, cap_g, m, mask=kw.get("mask"))
    hll.update(ms=cuda_ms(lambda: sketch_ops.hll_update(args, m, cap_g,
                                                        **kw)),
               plain_ms=cuda_ms(lambda: sketch_ops._hll_update_plain(
                   args, m.bit_length() - 1, cap_g, n, None, None,
                   kw.get("mask")), reps=3),
               bytes=nb, bound_ms=bound_ms(nb),
               shape=f"GROUP BY (): {n} rows, m = {m}, {cap_g} slots")
    h = hash_ops.row_hash(args[:1], args[0].tensor().shape[0])[:n]
    reg, rho = sketch_ops._reg_rho(h, m.bit_length() - 1)
    state = torch.zeros(cap_g * m, dtype=torch.uint8, device=dev)
    hll["scatter_amax_ms"] = cuda_ms(lambda: state.scatter_reduce_(
        0, reg, rho, "amax"))
    del h, reg, rho, state
    print(f"K16's update at Qu1's inputs ({hll['shape']}): {hll['ms']:.4f} "
          f"ms, plain {hll['plain_ms']:.4f} ms, {nb} bytes, bound "
          f"{hll['bound_ms']:.4f} ms (share {hll['bound_ms'] / hll['ms']:.3f})"
          f"; for information, scatter_reduce_(amax) of the precomputed "
          f"(register, rho) {hll['scatter_amax_ms']:.4f} ms", flush=True)
    hll["split"] = k16_split(args, m, cap_g, n, kw.get("mask"))
    (args, m, cap_g, keys, table), kw = watch.args[("Qu2", "hll_update_rows")]
    mask = kw.get("mask")
    n = sketch_ops._rows_of_keys(args, keys, mask, kw.get("n_rows"))
    log2m = m.bit_length() - 1
    state = sketch_ops.hll_update_rows(args, m, cap_g, keys, table, **kw)
    plain = sketch_ops._hll_update_rows_plain(args, log2m, cap_g, n, keys,
                                              table, mask)
    hll["max_abs_err"] = max(hll["max_abs_err"], max_abs_err(state, plain))
    del plain
    nb = sketch_ops.hll_update_bytes(args, n, cap_g, m, keys=keys, mask=mask)
    hll.update(
        rows_ms=cuda_ms(lambda: sketch_ops.hll_update_rows(
            args, m, cap_g, keys, table, **kw)),
        rows_plain_ms=cuda_ms(lambda: sketch_ops._hll_update_rows_plain(
            args, log2m, cap_g, n, keys, table, mask), reps=3),
        rows_bytes=nb, rows_bound_ms=bound_ms(nb),
        rows_shape=f"the sort grouping in row order: {n} rows, "
                   f"{len(keys)} key(s) of {table.shape[0]} slots, m = {m}, "
                   f"{cap_g} slots, {len(args)} column(s)")
    print(f"K16's row-order update at Qu2's inputs ({hll['rows_shape']}): "
          f"{hll['rows_ms']:.4f} ms, plain {hll['rows_plain_ms']:.4f} ms, "
          f"{nb} bytes, bound {hll['rows_bound_ms']:.4f} ms (share "
          f"{hll['rows_bound_ms'] / hll['rows_ms']:.3f})", flush=True)
    (cells, table_c, cap_c), _ = watch.args[("Qu2", "hll_cells")]
    got = sketch_ops.hll_cells(cells, table_c, cap_c)
    hll["max_abs_err"] = max(hll["max_abs_err"], max_abs_err(
        got, sketch_ops._hll_cells_plain(cells, table_c, cap_c)))
    del got
    nb = sketch_ops.hll_cells_bytes(cells.shape[0], cells.shape[1], cap_c)
    hll.update(
        cells_ms=cuda_ms(lambda: sketch_ops.hll_cells(cells, table_c, cap_c)),
        cells_plain_ms=cuda_ms(lambda: sketch_ops._hll_cells_plain(
            cells, table_c, cap_c), reps=3),
        cells_bytes=nb, cells_bound_ms=bound_ms(nb),
        cells_shape=f"{tuple(cells.shape)} u32 cells into {cap_c} group "
                    f"rows")
    print(f"K16's cells' copy at Qu2's inputs ({hll['cells_shape']}): "
          f"{hll['cells_ms']:.4f} ms (in the row-order update's), plain "
          f"{hll['cells_plain_ms']:.4f} ms, {nb} bytes, bound "
          f"{hll['cells_bound_ms']:.4f} ms (share "
          f"{hll['cells_bound_ms'] / hll['cells_ms']:.3f})", flush=True)
    del cells, table_c
    # the perm entry at the same inputs: the grouping's perm and group ids
    # made from the keys (a stable sort of the slots)
    perm, gid = k16_perm_of(keys, table, n, cap_g, mask)
    kw_perm = {"perm": perm, "gid": gid, "mask": mask}
    got = sketch_ops.hll_update(args, m, cap_g, **kw_perm)
    if not torch.equal(got, state):
        fail("K16's perm entry and row-order entry differ at Qu2's inputs")
    del got
    nb = sketch_ops.hll_update_bytes(args, n, cap_g, m, True, mask=mask)
    perm64 = perm.long()
    # the value read through perm costs a 32-byte sector a row
    sectors = nb + sum(n * (32 - a.tensor().element_size()) for a in args
                       if a.tensor().dim() == 1)
    hll.update(
        sorted_ms=cuda_ms(lambda: sketch_ops.hll_update(args, m, cap_g,
                                                        **kw_perm)),
        sorted_plain_ms=cuda_ms(lambda: sketch_ops._hll_update_plain(
            args, log2m, cap_g, n, perm, gid, mask), reps=3),
        sorted_bytes=nb, sorted_bound_ms=bound_ms(nb),
        sorted_sector_bytes=sectors, sorted_sector_floor_ms=bound_ms(sectors),
        # for information: the value's gather through perm alone
        sorted_gather_ms=cuda_ms(lambda: args[0].tensor().index_select(
            0, perm64)),
        sorted_shape=f"the sort grouping: {n} rows through perm, m = {m}, "
                     f"{cap_g} slots, {len(args)} column(s)")
    print(f"K16's perm update at Qu2's inputs ({hll['sorted_shape']}): "
          f"{hll['sorted_ms']:.4f} ms, plain {hll['sorted_plain_ms']:.4f} "
          f"ms, {nb} bytes, bound {hll['sorted_bound_ms']:.4f} ms (share "
          f"{hll['sorted_bound_ms'] / hll['sorted_ms']:.3f}); the gather "
          f"sectors' floor {hll['sorted_sector_floor_ms']:.4f} ms; for "
          f"information, index_select of the first column by perm "
          f"{hll['sorted_gather_ms']:.4f} ms", flush=True)
    del perm, gid, perm64, kw_perm
    hll["layouts"] = k16_layouts(args, n, mask)
    del args, kw, keys, table, mask
    got = sketch_ops.hll_finalize(state)
    off = k16_estimates_agree(got, sketch_ops._hll_finalize_plain(state),
                              "Qu2's state")
    nb = sketch_ops.hll_finalize_bytes(state.shape[0], state.shape[1])
    hll.update(
        finalize_ms=cuda_ms(lambda: sketch_ops.hll_finalize(state)),
        finalize_plain_ms=cuda_ms(lambda: sketch_ops._hll_finalize_plain(
            state), reps=3),
        finalize_bytes=nb, finalize_bound_ms=bound_ms(nb),
        finalize_off_by_one=off,
        finalize_shape=f"{tuple(state.shape)} registers")
    print(f"K16's finalize at Qu2's state ({hll['finalize_shape']}): "
          f"{hll['finalize_ms']:.4f} ms, plain "
          f"{hll['finalize_plain_ms']:.4f} ms, {nb} bytes, bound "
          f"{hll['finalize_bound_ms']:.4f} ms (share "
          f"{hll['finalize_bound_ms'] / hll['finalize_ms']:.3f}); {off} "
          f"estimates 1 off the plain version's", flush=True)
    del state, got
    key = ("Q5ub", "hll_merge")
    if key in watch.args:
        (a, kw) = watch.args[key]
        st, groups = a
        where = "Q5ub's last carry merge"
    else:
        st, groups, kw = k16_merge_case(K16_MERGE_CASES[0], dev)
        where = "K16_MERGE_CASES' carry (Q5ub not run)"
    got = sketch_ops.hll_merge(st, groups, **kw)
    plain = sketch_ops._hll_merge_plain(st, groups, kw.get("starts"),
                                        kw.get("ends"), kw.get("perm"),
                                        kw.get("mask"))
    hll["max_abs_err"] = max(hll["max_abs_err"], max_abs_err(got, plain))
    del got, plain
    nb = sketch_ops.hll_merge_bytes(st, groups, **kw)
    hll.update(
        merge_ms=cuda_ms(lambda: sketch_ops.hll_merge(st, groups, **kw)),
        merge_plain_ms=cuda_ms(lambda: sketch_ops._hll_merge_plain(
            st, groups, kw.get("starts"), kw.get("ends"), kw.get("perm"),
            kw.get("mask")), reps=3),
        merge_bytes=nb, merge_bound_ms=bound_ms(nb),
        merge_shape=f"{where}: {tuple(st.shape)} partial registers into "
                    f"{groups} groups")
    print(f"K16's merge at {hll['merge_shape']}: {hll['merge_ms']:.4f} ms, "
          f"plain {hll['merge_plain_ms']:.4f} ms, {nb} bytes, bound "
          f"{hll['merge_bound_ms']:.4f} ms (share "
          f"{hll['merge_bound_ms'] / hll['merge_ms']:.3f})", flush=True)
    out["hll"] = hll
    watch.args.clear()
    return out


def load_big(ch):
    """A cuda session with big (x Int64): STREAM_ROWS rows of bench.py's
    formula in STREAM_PIECE parts, as load_stream_tables makes it (the
    --sketch phase's own, without the other tables)."""
    s = ch.connect(device="cuda")
    s.execute("CREATE TABLE big (x Int64)")
    t0 = time.perf_counter()
    for lo in range(0, STREAM_ROWS, STREAM_PIECE):
        x = (np.arange(lo, min(lo + STREAM_PIECE, STREAM_ROWS),
                       dtype=np.int64) * 2654435761) % 1_000_003
        s.insert_pydict("big", {"x": x})
        del x
    print(f"big ({STREAM_ROWS} rows) built in {time.perf_counter() - t0:.1f}"
          f" s", flush=True)
    return s


def sketch_turn(ch, dev):
    """--sketch: K15's and K16's cases, the sketch queries over hits and
    big on their paths, and K15 and K16 at their inputs."""
    from clickhouse_tpu_torch.ops import _native
    check_k15(dev)
    check_k16(dev)
    s, x = load_hits(ch)
    want = sketch_answers(x)
    del x
    launches = {k: 0 for k in _native.LAUNCHES}
    launch_rows = {k: [] for k in _native.LAUNCHES}
    watch = SketchWatch()
    try:
        sketch_phase(s, want, watch, {}, launches, launch_rows)
        del s
        torch.cuda.empty_cache()
        sb = load_big(ch)
        sketch_stream_phase(sb, want, watch, {}, launches, launch_rows)
        del sb
    finally:
        watch.close()
    torch.cuda.empty_cache()
    shapes = sketch_shapes(dev, watch)
    print(json.dumps({k: {kk: vv for kk, vv in v.items()}
                      for k, v in shapes.items()}), flush=True)
    print(json.dumps({"launches": {k: launches[k] for k in
                                   ("row_hash",) + HLL_KERNELS}}), flush=True)


# -- K17 segmented_scan and K18 segmented_search ------------------------------

K17_TILE = 512          # K17_TILE_ROWS: a warp-tile of csrc/segmented_scan.cu
K17_WARPS_PER_SM = 24   # kWarpsPerSm: chunks a card of SMs holds at once
K17_ROWS = (1, 17, K17_TILE - 1, K17_TILE, K17_TILE + 1, 3 * K17_TILE + 17,
            4097, 1_000_003)
# enough rows that a chunk holds several warp-tiles (over 132 SMs x 24
# warps x 512 rows)
K17_CHUNK_ROWS = 9_000_011
K17_DTYPES = ("bool", "int8", "uint8", "int16", "int32", "int64", "uint64",
              "float32", "float64", "row_index")
K17_LAYOUTS = ("one_segment", "one_row_segments", "random_segments",
               "tile_edges")
K17_MASKS = ("none", "random", "all_masked")


def k17_values(rng, name, n, dev):
    """(data or None, unsigned) of K17_DTYPES' `name` over n rows: extremes
    that wrap a sum, UInt64 bits at and above 2^63, NaN and -0.0."""
    if name == "row_index":
        return None, False
    if name == "bool":
        return torch.from_numpy(rng.random(n) < 0.5).to(dev), False
    if name in ("float32", "float64"):
        x = rng.normal(0, 1e3, n)
        x[rng.random(n) < 0.01] = np.nan
        x[rng.random(n) < 0.01] = -0.0
        return torch.from_numpy(x.astype(name)).to(dev), False
    if name == "uint64":
        v = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
        v[rng.random(n) < 0.1] = -1
        return torch.from_numpy(v).to(dev), True
    info = np.iinfo(name)
    v = rng.integers(info.min, int(info.max) + 1, n, dtype=np.int64)
    v[rng.random(n) < 0.05] = info.max
    v[rng.random(n) < 0.05] = info.min
    return torch.from_numpy(v.astype(name)).to(dev), False


def k17_chunk_rows(n, sms):
    """Rows of one of K17's chunks over n rows on a card of `sms` SMs (the
    .cu's plan: warp-tiles spread over sms x K17_WARPS_PER_SM warps)."""
    tiles = -(-n // K17_TILE)
    return -(-tiles // (sms * K17_WARPS_PER_SM)) * K17_TILE


def k17_boundary(rng, layout, n, dev, chunk=None):
    """K17_LAYOUTS' `layout` over n rows (None: one segment); "tile_edges"
    starts segments at every warp-tile's first and last row, and
    "chunk_edges" at every chunk's of `chunk` rows (with a few random
    ones)."""
    if layout == "one_segment":
        return None
    if layout == "one_row_segments":
        return torch.ones(n, dtype=torch.bool, device=dev)
    b = rng.random(n) < (0.01 if layout == "random_segments" else
                         1e-5 if layout == "chunk_edges" else 0.0)
    if layout == "tile_edges":
        b[::K17_TILE] = True
        b[K17_TILE - 1::K17_TILE] = True
    if layout == "chunk_edges":
        b[::chunk] = True
        b[chunk - 1::chunk] = True
    return torch.from_numpy(b).to(dev)


def k17_mask(rng, kind, n, dev):
    if kind == "none":
        return None
    if kind == "all_masked":
        return torch.zeros(n, dtype=torch.bool, device=dev)
    return torch.from_numpy(rng.random(n) < 0.7).to(dev)


def k17_agree(op, got, want, data, boundary, mask, reverse):
    """Integers and min/max/first/last exact (NaN where NaN); float sums
    within n * eps of the scan of |x| (the kernel adds a tile's values in
    another order than the plain version's doubling passes)."""
    from clickhouse_tpu_torch.ops.scan_ops import _segmented_scan_plain
    if got.dtype != want.dtype or got.shape != want.shape:
        fail(f"K17 {op}: {got.dtype}{tuple(got.shape)} against "
             f"{want.dtype}{tuple(want.shape)}")
    if not (op == "sum" and got.is_floating_point()):
        same = torch.equal(got, want) if not got.is_floating_point() else \
            bool(((got == want) | (torch.isnan(got) & torch.isnan(want)))
                 .all())
        if not same:
            bad = int(((got != want) & ~(torch.isnan(got.double())
                                         & torch.isnan(want.double())))
                      .nonzero()[0])
            what = data.dtype if data is not None else "row index"
            fail(f"K17 {op} reverse={reverse} {what}: row {bad} "
                 f"{got[bad].item()} against {want[bad].item()}")
        return 0.0
    scale = _segmented_scan_plain(
        "sum", torch.nan_to_num(data.double().abs(), posinf=0.0), boundary,
        mask, reverse, False, data.shape[0])
    eps = np.finfo(np.float32 if got.dtype == torch.float32
                   else np.float64).eps
    g, w = got.double(), want.double()
    nan = torch.isnan(w)
    if not torch.equal(torch.isnan(g), nan):
        fail(f"K17 sum: NaN rows differ")
    err = (g - w).abs()[~nan]
    tol = (scale * data.shape[0] * eps + 1e-300)[~nan]
    if bool((err > tol).any()):
        fail(f"K17 float sum beyond n * eps * scan(|x|): {float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def k17_calls(data, boundary, mask):
    """The (op, reverse) pairs K17 is checked over for one input: every op
    both ways (the row index, nothing read, needs a boundary or a
    mask)."""
    from clickhouse_tpu_torch.ops.scan_ops import SCAN_OPS
    if data is None and boundary is None and mask is None:
        return []
    return [(op, rev) for op in SCAN_OPS for rev in (False, True)]


def k17_float_repeats(dev, n):
    """A float64 sum with boundaries over n rows, twice: the two results
    must agree bit for bit (K17 adds in a fixed order)."""
    from clickhouse_tpu_torch.ops.scan_ops import segmented_scan
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.normal(0, 1e6, n)).to(dev)
    b = torch.from_numpy(rng.random(n) < 1e-4).to(dev)
    one = segmented_scan("sum", x, b).view(torch.int64)
    two = segmented_scan("sum", x, b).view(torch.int64)
    if not torch.equal(one, two):
        fail(f"K17 float64 sum over {n} rows differs from run to run")


def check_k17(dev):
    """K17 against its plain version on the card: every op, both
    directions, K17_DTYPES (bool, every integer width, UInt64 bits at and
    above 2^63, floats with NaN and -0.0, the row index: every kernel
    instance), K17_LAYOUTS (one segment, one-row segments, random
    segments, boundaries at every warp-tile's first and last row), masks
    of none, some and every row, at K17_ROWS rows (one row, part of a
    thread's 16, a warp-tile less one, a warp-tile, a warp-tile and a
    row, three and 17 rows, a million rows); K17_CHUNK_ROWS rows with
    boundaries at every chunk's first and last row, chunks of several
    warp-tiles; a float64 sum over 100,003 and K17_CHUNK_ROWS rows twice,
    bit for bit; and a sum that wraps past 2^63."""
    from clickhouse_tpu_torch.ops import _native, scan_ops
    from clickhouse_tpu_torch.ops.scan_ops import (_segmented_scan_plain,
                                                   segmented_scan)
    if _native.library().chtt_scan_tile_rows() != K17_TILE \
            or scan_ops.K17_TILE_ROWS != K17_TILE:
        fail("K17's warp-tile is not chip_smoke.K17_TILE")
    rng = np.random.default_rng(17)
    calls = 0
    err = 0.0

    def run(data, uns, boundary, mask):
        nonlocal calls, err
        for op, reverse in k17_calls(data, boundary, mask):
            n = (data if data is not None else boundary if boundary
                 is not None else mask).shape[0]
            got = segmented_scan(op, data, boundary, mask, reverse=reverse,
                                 unsigned=uns)
            want = _segmented_scan_plain(op, data, boundary, mask, reverse,
                                         uns, n)
            err = max(err, k17_agree(op, got, want, data, boundary, mask,
                                     reverse))
            calls += 1

    for n in K17_ROWS:
        for name in K17_DTYPES:
            data, uns = k17_values(rng, name, n, dev)
            for layout in K17_LAYOUTS:
                if n < 2 * K17_TILE and layout == "tile_edges":
                    continue
                boundary = k17_boundary(rng, layout, n, dev)
                for mkind in K17_MASKS:
                    if n == 1_000_003 and mkind == "all_masked" \
                            and layout != "random_segments":
                        continue
                    run(data, uns, boundary, k17_mask(rng, mkind, n, dev))
    n = K17_CHUNK_ROWS
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunk = k17_chunk_rows(n, sms)
    if _native.library().chtt_scan_chunks(n, sms) != -(-n // chunk):
        fail("K17's chunks are not chip_smoke.k17_chunk_rows'")
    for name in ("bool", "int32", "uint64", "float64", "row_index"):
        data, uns = k17_values(rng, name, n, dev)
        for layout in ("one_segment", "chunk_edges"):
            boundary = k17_boundary(rng, layout, n, dev, chunk)
            for mkind in ("none", "random"):
                run(data, uns, boundary, k17_mask(rng, mkind, n, dev))
    k17_float_repeats(dev, 100_003)
    k17_float_repeats(dev, K17_CHUNK_ROWS)
    # a sum past INT64_MAX wraps mod 2^64 as the plain version's
    big = torch.full((8193,), (1 << 62) + 12345, dtype=torch.int64,
                     device=dev)
    got = segmented_scan("sum", big, None)
    want = _segmented_scan_plain("sum", big, None, None, False, False, 8193)
    if not torch.equal(got, want) or int(got[1]) >= 0:
        fail("K17 sum does not wrap mod 2^64")
    torch.cuda.synchronize()
    print(f"K17 segmented_scan: {calls + 3} calls agree with the plain "
          f"version (max float error {err:.3g}; chunks of {chunk} rows at "
          f"{n} rows; float64 sums repeat bit for bit); launches "
          f"{_native.LAUNCHES['segmented_scan']}", flush=True)


K18_ROWS = (1, 1000, 1_000_003)
K18_TILE = 2048          # queries a block of csrc/segmented_search.cu
K18_BRANCHES = ("window", "unordered", "wide")
K18_CASES = ("one_segment_sorted", "many_segments_sorted", "straddle",
             "sparse_wide", "one_out_of_order", "empty_segments",
             "extremes", "extremes_unsigned")
_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


def _k18_sorted(rng, n, n_seg, lo, hi, uns):
    """n rows in n_seg segments (some empty), sorted by (segment, key as
    u64 where uns): (seg, vals)."""
    seg = np.sort(rng.integers(0, n_seg, n))
    vals = rng.integers(lo, hi, n, dtype=np.int64)
    if uns:
        vals[rng.random(n) < 0.4] |= np.int64(_I64_MIN)
    key = vals ^ np.int64(_I64_MIN) if uns else vals
    o = np.lexsort((key, seg))
    return seg[o], vals[o]


def k18_case(name, small=False):
    """A K18_CASES case as numpy arrays: {"table": int64, "seg": each
    table row's segment (sorted) or None for the one-segment form,
    "n_seg", "queries": int64, "qseg": int32 or None, "unsigned",
    "expect": the branch of K18_BRANCHES its tiles should take}.  small:
    sizes for the CPU tests (the same shapes, fewer rows)."""
    rng = np.random.default_rng(K18_CASES.index(name) + 180)
    k = 10 if small else 1
    if name in ("one_segment_sorted", "one_out_of_order"):
        n = 1_000_003 // k
        vals = np.sort(rng.integers(0, n // 10, n)).astype(np.int64)
        q = vals - 10
        if name == "one_out_of_order":
            q[1000::K18_TILE] += n // 10
        return {"table": vals, "seg": None, "n_seg": 1, "queries": q,
                "qseg": None, "unsigned": False,
                "expect": "unordered" if name == "one_out_of_order"
                else "window"}
    if name in ("many_segments_sorted", "straddle"):
        n, n_seg = (300_000 // k, 1000 // k) if name == "many_segments_sorted" \
            else (300_000 // k, 200 // k)
        uns = name == "straddle"
        seg, vals = _k18_sorted(rng, n, n_seg, -(1 << 40), 1 << 40, uns)
        q = vals if uns else vals - 5
        return {"table": vals, "seg": seg, "n_seg": n_seg, "queries": q,
                "qseg": seg.astype(np.int32), "unsigned": uns,
                "expect": "window"}
    if name == "sparse_wide":
        n = 1_000_003 // k
        vals = np.sort(rng.integers(-(1 << 50), 1 << 50, n))
        q = np.sort(rng.integers(-(1 << 50), 1 << 50, 40_000 // k))
        return {"table": vals, "seg": np.zeros(n, np.int64), "n_seg": 1,
                "queries": q, "qseg": np.zeros(len(q), np.int32),
                "unsigned": False, "expect": "wide"}
    if name == "empty_segments":
        # most segments empty; a query into every segment besides the
        # rows' own, in (segment, key) order
        n, n_seg = 50_000 // k, 20_000 // k
        seg, vals = _k18_sorted(rng, n, n_seg // 8, -(1 << 30), 1 << 30,
                                False)
        seg = seg * 8
        qseg = np.concatenate([seg, np.arange(n_seg)])
        q = np.concatenate([vals + 1, rng.integers(-(1 << 31), 1 << 31,
                                                   n_seg)])
        o = np.lexsort((q, qseg))
        return {"table": vals, "seg": seg, "n_seg": n_seg, "queries": q[o],
                "qseg": qseg[o].astype(np.int32), "unsigned": False,
                "expect": "window"}
    # extremes: values and queries at INT64_MIN, +-(2^63 - 1) and between,
    # signed over one segment, unsigned over many
    uns = name == "extremes_unsigned"
    n, n_seg = 200_000 // k, (1 if not uns else 50)
    seg, vals = _k18_sorted(rng, n, n_seg, -(1 << 62), 1 << 62, uns)
    ends = np.flatnonzero(np.r_[seg[1:] != seg[:-1], True])
    vals[ends] = -1 if uns else _I64_MAX        # each segment's largest
    starts = np.r_[0, ends[:-1] + 1]
    vals[starts] = 0 if uns else _I64_MIN
    q = np.concatenate([np.full(3000, -_I64_MAX), vals,
                        np.full(3000, _I64_MAX)])
    qseg = np.concatenate([np.zeros(3000, np.int64), seg,
                           np.full(3000, n_seg - 1)])
    key = q ^ np.int64(_I64_MIN) if uns else q
    o = np.lexsort((key, qseg))
    return {"table": vals, "seg": seg if uns else None, "n_seg": n_seg,
            "queries": q[o], "qseg": qseg[o].astype(np.int32) if uns
            else None, "unsigned": uns, "expect": "window"}


def k18_tensors(case, dev):
    """A k18_case's table, queries, gid, starts, ends on `dev`."""
    t = torch.from_numpy(case["table"]).to(dev)
    q = torch.from_numpy(case["queries"]).to(dev)
    if case["qseg"] is None:
        return t, q, None, None, None
    ar = np.arange(case["n_seg"])
    starts = np.searchsorted(case["seg"], ar, "left")
    ends = np.searchsorted(case["seg"], ar, "right")
    return (t, q, torch.from_numpy(case["qseg"]).to(dev),
            torch.from_numpy(starts).to(dev), torch.from_numpy(ends).to(dev))


def k18_branches(table, queries, side, gid, starts, ends, unsigned):
    """The tiles of one K18 call by the branch each took (K18_BRANCHES),
    through the wrapper's launch with the diagnostic counters (no launch
    counted); {} in a tree without them (an older checkout)."""
    from clickhouse_tpu_torch.ops import search as search_ops
    if not hasattr(search_ops, "_search_launch"):
        return {}
    counts = torch.zeros(3, dtype=torch.int64, device=table.device)
    out = torch.empty(queries.shape[0], dtype=torch.int64,
                      device=table.device)
    search_ops._search_launch(table, queries, side, gid, starts, ends,
                              unsigned, out, counts)
    return dict(zip(K18_BRANCHES, counts.tolist()))


def check_k18_case(name, dev):
    """One K18_CASES case, both sides: the kernel against its plain
    version, and its tiles in the branch the case is built for (every
    tile, but for "unordered": at least one) -> the branch counts."""
    from clickhouse_tpu_torch.ops.search import (_segmented_search_plain,
                                                 segmented_search)
    case = k18_case(name)
    t, q, gid, starts, ends = k18_tensors(case, dev)
    uns = case["unsigned"]
    tiles = -(-q.shape[0] // K18_TILE)
    for side in ("left", "right"):
        got = segmented_search(t, q, side, gid=gid, starts=starts, ends=ends,
                               unsigned=uns)
        want = _segmented_search_plain(t, q, side, gid, starts, ends, uns)
        if not torch.equal(got, want):
            bad = int((got != want).nonzero()[0])
            fail(f"K18 {name} side={side}: query {bad} {got[bad].item()} "
                 f"against {want[bad].item()}")
        br = k18_branches(t, q, side, gid, starts, ends, uns)
        want_n = 1 if case["expect"] == "unordered" else tiles
        if br[case["expect"]] < want_n:
            fail(f"K18 {name} side={side}: tiles by branch {br}, expected "
                 f"{case['expect']} for {want_n} of {tiles}")
    return br


def check_k18(dev):
    """K18 against its plain version on the card: tables of K18_ROWS rows
    in 1, 7 and ~n/50 segments (and empty segments), queries below,
    above and equal to their segment's keys and between them, both
    sides, signed and unsigned (values above 2^63), the one-segment form,
    segment ids outside [0, segments) (clamped), and the reference's
    searchsorted_seg and searchsorted forms; then K18_CASES (sorted
    queries over one segment and many, tiles straddling segments' ends,
    empty segments, queries at +-(2^63 - 1), one query out of order in
    each tile, a stretch wider than the shared-memory window), each in
    the branch it is built for."""
    from clickhouse_tpu_torch.ops import _native
    from clickhouse_tpu_torch.ops.search import (_segmented_search_plain,
                                                 searchsorted,
                                                 searchsorted_seg,
                                                 segmented_search)
    rng = np.random.default_rng(18)
    calls = 0
    for n in K18_ROWS:
        for n_seg in (1, 7, max(1, n // 50)):
            for uns in (False, True):
                seg = np.sort(rng.integers(0, n_seg, n))
                lo = -(1 << 63) if uns else -(1 << 40)
                vals = rng.integers(lo, 1 << 40, n, dtype=np.int64)
                if uns:
                    vals[rng.random(n) < 0.3] |= np.int64(-(1 << 63))
                order_key = vals ^ np.int64(-(1 << 63)) if uns else vals
                o = np.lexsort((order_key, seg))
                seg, vals, order_key = seg[o], vals[o], order_key[o]
                starts = np.searchsorted(seg, np.arange(n_seg), "left")
                ends = np.searchsorted(seg, np.arange(n_seg), "right")
                q = np.concatenate([vals, vals + 1, vals - 1,
                                    rng.integers(lo, 1 << 40, n),
                                    np.full(3, -(1 << 63)),
                                    np.full(3, (1 << 63) - 1)])
                qg = np.concatenate([seg, seg, seg,
                                     rng.integers(0, n_seg, n),
                                     [0, n_seg - 1, n_seg + 5],
                                     [0, n_seg - 1, -3]]).astype(np.int32)
                t = torch.from_numpy(vals).to(dev)
                qt = torch.from_numpy(q).to(dev)
                gt = torch.from_numpy(qg).to(dev)
                st = torch.from_numpy(starts).to(dev)
                en = torch.from_numpy(ends).to(dev)
                for side in ("left", "right"):
                    for gid in (gt, None):
                        kw = dict(gid=gid, starts=st if gid is not None
                                  else None,
                                  ends=en if gid is not None else None)
                        if gid is None:
                            tt = torch.sort(t ^ (-(1 << 63)) if uns else t
                                            ).values
                            tt = tt ^ (-(1 << 63)) if uns else tt
                        else:
                            tt = t
                        got = segmented_search(tt, qt, side, unsigned=uns,
                                               **kw)
                        want = _segmented_search_plain(
                            tt, qt, side, gid, kw["starts"], kw["ends"],
                            uns)
                        if not torch.equal(got, want):
                            bad = int((got != want).nonzero()[0])
                            fail(f"K18 n={n} segments={n_seg} side={side} "
                                 f"unsigned={uns}: query {bad} "
                                 f"{got[bad].item()} against "
                                 f"{want[bad].item()}")
                        calls += 1
                sg = torch.from_numpy(seg).to(dev)
                got = searchsorted_seg(sg, t, sg, qt[:n], "right",
                                       unsigned=uns)
                ref = np.array([np.searchsorted(
                    order_key[starts[g]:ends[g]], ok, "right") + starts[g]
                    for g, ok in zip(seg[:200], order_key[:200])])
                if not np.array_equal(got[:200].cpu().numpy(), ref):
                    fail("K18 searchsorted_seg against numpy")
                calls += 1
    a = torch.arange(0, 3000, 3, device=dev)
    v = torch.arange(-5, 3005, device=dev)
    if not torch.equal(searchsorted(a, v, "left").cpu(),
                       torch.searchsorted(a.cpu(), v.cpu())):
        fail("K18 searchsorted against torch.searchsorted")
    branches = {name: check_k18_case(name, dev) for name in K18_CASES}
    calls += 2 * len(K18_CASES)
    torch.cuda.synchronize()
    print(f"K18 segmented_search: {calls + 1} calls agree with the plain "
          f"version; tiles by branch (right side): {json.dumps(branches)}; "
          f"launches {_native.LAUNCHES['segmented_search']}", flush=True)


P_WIN = "PARTITION BY x % 1024 ORDER BY x"
# each window column w is checked by sum(w) and sum(cityHash64(x, w)) (both
# wrap mod 2^64): rows tied on x are alike, so the pair checks the whole
# multiset of (x, w); a float column by its sum alone
WINDOW_COLUMNS = {
    "Qw1": (("rn", f"row_number() OVER ({P_WIN})"),
            ("rk", f"rank() OVER ({P_WIN})"),
            ("dr", f"dense_rank() OVER ({P_WIN})")),
    "Qw2": (("a", f"sum(x) OVER ({P_WIN})"),
            ("b", f"sum(x) OVER ({P_WIN} ROWS BETWEEN 100 PRECEDING AND "
                  f"CURRENT ROW)"),
            ("c", "avg(x) OVER (PARTITION BY x % 1024)")),
    "Qw3": (("s", f"sum(x) OVER ({P_WIN} RANGE BETWEEN 1000 PRECEDING AND "
                  f"1000 FOLLOWING)"),
            ("n", f"count() OVER ({P_WIN} RANGE BETWEEN 1000 PRECEDING AND "
                  f"1000 FOLLOWING)")),
    "Qw4": (("mx", f"max(x) OVER ({P_WIN} ROWS BETWEEN UNBOUNDED PRECEDING "
                   f"AND CURRENT ROW)"),
            ("mn", f"min(x) OVER ({P_WIN} ROWS BETWEEN CURRENT ROW AND "
                   f"UNBOUNDED FOLLOWING)"),
            ("m5", f"max(x) OVER ({P_WIN} ROWS BETWEEN 5 PRECEDING AND 5 "
                   f"FOLLOWING)"),
            ("lg", f"lag(x) OVER ({P_WIN})"),
            ("ld", f"lead(x, 2) OVER ({P_WIN})"),
            ("lv", f"last_value(x) OVER ({P_WIN} ROWS BETWEEN 3 PRECEDING "
                   f"AND 3 FOLLOWING)")),
    "Qw5": (("rs", "sum(x) OVER (ORDER BY x ROWS UNBOUNDED PRECEDING)"),
            ("rc", "count() OVER (ORDER BY x RANGE BETWEEN 10 PRECEDING AND "
                   "10 FOLLOWING)")),
}
FLOAT_WINDOW_COLUMNS = ("c",)


def window_sql(name):
    cols = WINDOW_COLUMNS[name]
    outer = []
    for c, _ in cols:
        outer.append(f"sum({c})")
        if c not in FLOAT_WINDOW_COLUMNS:
            outer.append(f"sum(cityHash64(x, {c}))")
    inner = ", ".join(f"{e} AS {c}" for c, e in cols)
    return f"SELECT {', '.join(outer)} FROM (SELECT x, {inner} FROM hits)"


WINDOW_QUERIES = tuple((q, window_sql(q)) for q in WINDOW_COLUMNS) + (
    ("Qr1", "SELECT x % 16 AS a, x % 7 AS b, count(), sum(x) FROM hits "
            "GROUP BY ROLLUP(a, b)"),
    ("Qr2", "SELECT x % 16 AS a, x % 7 AS b, count(), sum(x) FROM hits "
            "GROUP BY CUBE(a, b)"),
    ("Qr3", "SELECT count(), sum(y) FROM (SELECT x AS y FROM hits WHERE "
            "x < 300000 UNION ALL SELECT x + 1 AS y FROM hits WHERE "
            "x > 700000)"),
    ("Qi1", "SELECT x FROM hits WHERE x % 1000 = 7 INTERSECT SELECT x FROM "
            "hits WHERE x % 7 = 0"),
    ("Qi2", "SELECT x FROM hits WHERE x % 1000 = 7 EXCEPT SELECT x FROM "
            "hits WHERE x % 7 = 0"))
# the kernels each query must launch (at least once), and those it must not
WINDOW_PATHS = {"Qw1": ("radix_sort_pairs", "segment_bounds",
                        "segmented_scan"),
                "Qw2": ("radix_sort_pairs", "segment_bounds",
                        "segmented_scan"),
                "Qw3": ("radix_sort_pairs", "segment_bounds",
                        "segmented_scan", "segmented_search"),
                "Qw4": ("radix_sort_pairs", "segment_bounds",
                        "segmented_scan"),
                "Qw5": ("radix_sort_pairs", "segment_bounds",
                        "segmented_scan", "segmented_search"),
                "Qr1": ("dense_group_reduce",), "Qr2": ("dense_group_reduce",),
                "Qr3": ("masked_reduce",),
                "Qi1": ("radix_sort_pairs", "segment_bounds",
                        "segmented_scan"),
                "Qi2": ("radix_sort_pairs", "segment_bounds",
                        "segmented_scan")}
# K18 launches exactly: a RANGE offset frame's two edges, shared by the
# calls over that frame
WINDOW_SEARCHES = {"Qw3": 2, "Qw5": 2}
WINDOW_REPS = 3          # timed runs of each query (and traced runs)
WINDOW_FLOAT_RTOL = 1e-12   # avg's sum: float64 prefix differences
WINDOW_BUDGET = 40 << 30    # max_device_memory_bytes for the window queries


def _hash_sum(h0, w, valid=None) -> tuple:
    """(sum(w), sum(hash_combine(h0, w))) mod 2^64 over the rows, in
    8M-row slices on 8 threads (numpy lets go of the GIL)."""
    from concurrent.futures import ThreadPoolExecutor
    n = w.shape[0]
    step = 1 << 23

    def part(i):
        ww = w[i:i + step].astype(np.uint64)
        hh = hash_combine_np(h0[i:i + step], ww)
        if valid is not None:
            v = valid[i:i + step]
            ww, hh = ww[v], hh[v]
        return (int(ww.sum(dtype=np.uint64)), int(hh.sum(dtype=np.uint64)))
    with ThreadPoolExecutor(8) as ex:
        parts = list(ex.map(part, range(0, n, step)))
    m = (1 << 64) - 1
    return (sum(p[0] for p in parts) & m, sum(p[1] for p in parts) & m)


def _distinct_hash_sum(d, c, w) -> tuple:
    """The same over rows where each distinct x d (count c) has one w."""
    m = (1 << 64) - 1
    with np.errstate(over="ignore"):
        h = hash_combine_np(mix64_np(d.astype(np.uint64)),
                            w.astype(np.uint64))
        cu = c.astype(np.uint64)
        return (int((w.astype(np.uint64) * cu).sum(dtype=np.uint64)) & m,
                int((h * cu).sum(dtype=np.uint64)) & m)


def window_answers(x: np.ndarray):
    """numpy's answers to WINDOW_QUERIES over hits' x: the sorted rows of
    P_WIN built from each distinct x's count (one stable order of the
    packed key (x % 1024) << 20 | x, made without a 100M-row sort), the
    window columns per distinct value where tied rows share them, per row
    where they do not."""
    t0 = time.perf_counter()
    M = 1_000_003
    cnt = np.bincount(x, minlength=M)
    vals = np.flatnonzero(cnt)
    m = (1 << 64) - 1
    want = {}

    def pairs_of(name, got):
        row = []
        for (col, _), pair in zip(WINDOW_COLUMNS[name], got):
            row.extend(pair if col not in FLOAT_WINDOW_COLUMNS
                       else pair[:1])
        want[name] = [tuple(row)]

    # P's order of the distinct values, their partitions and counts
    key = ((vals % 1024) << 20) | vals
    d = vals[np.argsort(key, kind="stable")]
    dk = ((d % 1024) << 20) | d
    c = cnt[d]
    part = d % 1024
    cum = np.cumsum(c)
    first = cum - c                               # a value's first row
    pb = np.r_[True, part[1:] != part[:-1]]
    pidx = np.cumsum(pb) - 1
    pstart_d = first[pb][pidx]                    # its partition's first row
    pend_d = np.r_[first[pb][1:], cum[-1]][pidx] - 1
    n = int(cum[-1])
    xs = np.repeat(d, c)                          # the rows in P's order
    h0 = mix64_np(xs.astype(np.uint64))
    row_pstart = np.repeat(pstart_d, c)
    row_pend = np.repeat(pend_d, c)
    i = np.arange(n, dtype=np.int64)
    # Qw1
    rn = i - row_pstart + 1
    rank_d = first - pstart_d + 1
    dense_d = np.arange(len(d)) - np.flatnonzero(pb)[pidx] + 1
    pairs_of("Qw1", [_hash_sum(h0, rn), _distinct_hash_sum(d, c, rank_d),
                     _distinct_hash_sum(d, c, dense_d)])
    del rn
    # Qw2: running with peers, ROWS 100 PRECEDING, the partition's mean
    dc = d * c
    seg_cum = np.cumsum(dc)
    a_d = seg_cum - np.r_[0, seg_cum][np.flatnonzero(pb)][pidx]
    S = np.cumsum(xs)
    lo = np.maximum(i - 100, row_pstart)
    b = S - np.where(lo > 0, S[np.maximum(lo - 1, 0)], 0)
    psum = np.add.reduceat(dc, np.flatnonzero(pb)).astype(np.float64)
    pcnt = np.add.reduceat(c, np.flatnonzero(pb))
    c_sum = float((psum / pcnt * pcnt).sum())
    pairs_of("Qw2", [_distinct_hash_sum(d, c, a_d), _hash_sum(h0, b),
                     (c_sum,)])
    del S, lo, b
    # Qw3: the values within 1000 of each value in its partition
    lo_k = np.searchsorted(dk, ((d % 1024) << 20) | np.maximum(d - 1000, 0),
                           "left")
    hi_k = np.searchsorted(dk, ((d % 1024) << 20) | (d + 1000), "right")
    cs_ = np.r_[0, np.cumsum(dc)]
    cc_ = np.r_[0, np.cumsum(c)]
    pairs_of("Qw3", [_distinct_hash_sum(d, c, cs_[hi_k] - cs_[lo_k]),
                     _distinct_hash_sum(d, c, cc_[hi_k] - cc_[lo_k])])
    # Qw4: x ascends within a partition
    m5 = xs[np.minimum(i + 5, row_pend)]
    lag_ok = i - 1 >= row_pstart
    lg = xs[np.maximum(i - 1, 0)]
    ld_ok = i + 2 <= row_pend
    ld = xs[np.minimum(i + 2, n - 1)]
    lv = xs[np.minimum(i + 3, row_pend)]
    pairs_of("Qw4", [_distinct_hash_sum(d, c, d), _distinct_hash_sum(d, c, d),
                     _hash_sum(h0, m5), _hash_sum(h0, lg, lag_ok),
                     _hash_sum(h0, ld, ld_ok), _hash_sum(h0, lv)])
    del m5, lg, ld, lv, lag_ok, ld_ok, xs, h0, row_pstart, row_pend
    # Qw5: one partition ordered by x
    c2 = cnt[vals]
    xs2 = np.repeat(vals, c2)
    rs = np.cumsum(xs2)
    h2 = mix64_np(xs2.astype(np.uint64))
    cc2 = np.r_[0, np.cumsum(c2)]
    lo2 = np.searchsorted(vals, vals - 10, "left")
    hi2 = np.searchsorted(vals, vals + 10, "right")
    pairs_of("Qw5", [_hash_sum(h2, rs),
                     _distinct_hash_sum(vals, c2, cc2[hi2] - cc2[lo2])])
    del xs2, rs, h2, i
    # Qr1, Qr2: the groups of (a, b) and their rollups
    a, b_ = vals % 16, vals % 7
    cells_c = np.zeros((16, 7), np.int64)
    cells_s = np.zeros((16, 7), np.int64)
    np.add.at(cells_c, (a, b_), c2)
    np.add.at(cells_s, (a, b_), vals * c2)

    def rows(sets):
        out = []
        for keep_a, keep_b in sets:
            cc = cells_c.sum(axis=tuple(ax for ax, k in ((0, keep_a),
                                                          (1, keep_b))
                                        if not k), keepdims=True)
            ss = cells_s.sum(axis=tuple(ax for ax, k in ((0, keep_a),
                                                          (1, keep_b))
                                        if not k), keepdims=True)
            for ia in range(cc.shape[0]):
                for ib in range(cc.shape[1]):
                    if cc[ia, ib]:
                        out.append((ia if keep_a else 0, ib if keep_b else 0,
                                    int(cc[ia, ib]), int(ss[ia, ib])))
        return sorted(out)
    want["Qr1"] = rows(((1, 1), (1, 0), (0, 0)))
    want["Qr2"] = rows(((1, 1), (1, 0), (0, 1), (0, 0)))
    lo_v, hi_v = vals < 300000, vals > 700000
    want["Qr3"] = [(int(c2[lo_v].sum() + c2[hi_v].sum()),
                    int((vals[lo_v] * c2[lo_v]).sum()
                        + ((vals[hi_v] + 1) * c2[hi_v]).sum()))]
    left = vals % 1000 == 7
    both = left & (vals % 7 == 0)
    want["Qi1"] = sorted((int(v),) for v in np.repeat(vals[both], c2[both]))
    only = left & ~both
    want["Qi2"] = sorted((int(v),) for v in np.repeat(vals[only], c2[only]))
    print(f"numpy's window answers: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return want


def window_agree(name, rows, want) -> bool:
    if name in ("Qr1", "Qr2", "Qi1", "Qi2"):
        return sorted(rows) == want
    if name == "Qw2":
        got, exp = rows[0], want[0]
        return got[:4] == exp[:4] and abs(got[4] - exp[4]) <= \
            WINDOW_FLOAT_RTOL * abs(exp[4])
    return rows == want


def window_path(s, want, per_query, launches, launch_rows, memory=None):
    """Qw1-Qw5, Qr1-Qr3 and Qi1-Qi2 once each through the public API,
    each against numpy, with the launch counters set to 0 just before it
    and read just after; fails unless each query launched the kernels of
    WINDOW_PATHS.  Prints each query's peak device memory beside the
    governor's estimate."""
    from clickhouse_tpu_torch.exec import executor
    from clickhouse_tpu_torch.exec.streaming import \
        estimate_plan_device_bytes
    from clickhouse_tpu_torch.ops import _native
    from clickhouse_tpu_torch.sql import parse
    held = []
    hold = executor._hold_bytes

    def hold_watch(ctx, need, what):
        held.append(need)
        return hold(ctx, need, what)
    executor._hold_bytes = hold_watch
    try:
        for name, sql in WINDOW_QUERIES:
            del held[:]
            _window_query(s, name, sql, want, per_query, launches,
                          launch_rows, held)
    finally:
        executor._hold_bytes = hold


def _window_query(s, name, sql, want, per_query, launches, launch_rows,
                  held):
    """One query of window_path: against numpy, its launches and its
    peak beside the governor's estimate and `held`, what the executor held
    against the budget (_hold_bytes)."""
    from clickhouse_tpu_torch.exec.streaming import \
        estimate_plan_device_bytes
    from clickhouse_tpu_torch.ops import _native
    from clickhouse_tpu_torch.sql import parse
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _native.reset_launches()
    t0 = time.perf_counter()
    rows = s.execute(sql, settings={
        "max_device_memory_bytes": WINDOW_BUDGET}).rows()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per_query[name] = dict(_native.LAUNCHES)
    rows_of = {k: list(v) for k, v in _native.LAUNCH_ROWS.items()}
    peak = torch.cuda.max_memory_allocated() - base
    if not window_agree(name, rows, want[name]):
        fail(f"{name} returned {rows[:4]}..., numpy says "
             f"{want[name][:4]}...")
    for k, v in rows_of.items():
        launches[k] += per_query[name][k]
        launch_rows[k] += v
    missing = [k for k in WINDOW_PATHS[name] if not per_query[name][k]]
    if missing:
        fail(f"{name} did not launch {missing}: {per_query[name]}")
    if per_query[name]["segmented_search"] != WINDOW_SEARCHES.get(name, 0):
        fail(f"{name} launched K18 {per_query[name]['segmented_search']} "
             f"times, not {WINDOW_SEARCHES.get(name, 0)}")
    est = estimate_plan_device_bytes(s._plan(parse(sql), s.settings),
                                     s.catalog, s.settings)
    used = {k: v for k, v in per_query[name].items() if v}
    print(f"{name}: matches numpy; first run {wall:.3f} s; launches "
          f"{used}; K17 rows {rows_of['segmented_scan'][:6]}, K18 rows "
          f"{rows_of['segmented_search']}; peak {peak} bytes above "
          f"what was allocated before it; the governor's estimate "
          f"{est}; held by the window or set operation "
          f"{max(held, default=0)}", flush=True)


K17_PASSES = {1: "reduce", 2: "carry_scan", 3: "downsweep", 0: "whole"}


def k17_split(op, data, boundary, mask=None, reverse=False):
    """K17 at one input taken apart: each pass of one call alone through
    the library's chtt_segmented_scan_split (K17_PASSES; the arguments as
    the wrapper makes them, the scratch's contents whatever the last pass
    left), and the whole call through the same entry.  {} in a tree
    without the entry (an older checkout)."""
    import ctypes
    from clickhouse_tpu_torch.ops import _native, scan_ops
    lib = _native.library()
    if not hasattr(lib, "chtt_segmented_scan_split") \
            or not hasattr(scan_ops, "_scan_args"):
        return {}
    dev = data.device if data is not None else boundary.device
    n = (data if data is not None else boundary).shape[0]
    args, out, keep = scan_ops._scan_args(op, data, boundary, mask, reverse,
                                          False, n, dev)

    def part(p):
        return lambda: _native.check(lib.chtt_segmented_scan_split(
            ctypes.byref(args), p, _native.stream_ptr(dev)), "K17 split")
    res = {f"{name}_ms": cuda_ms(part(p)) for p, name in K17_PASSES.items()}
    del keep, out
    print("K17 split (ms, each pass of one call alone): " + ", ".join(
        f"{k[:-3]} {v:.4f}" for k, v in res.items()), flush=True)
    return res


def window_shapes(dev):
    """K17 and K18 alone at Qw5's and Qw3's inputs (made as the executor
    makes them, on the card): K17 the one-segment unmasked sum of Qw5's x
    in sorted order (int32 storage read, int64 written) and its max, K18
    Qw5's RANGE frame's left edge (one segment) and Qw3's (a partition a
    query), each beside its plain version and a PyTorch call of the same
    function: torch.cumsum and torch.cummax for K17, torch.searchsorted
    for K18's one-segment form; K17's sum also pass by pass (k17_split)
    and K18's tiles by branch at both (k18_branches)."""
    from clickhouse_tpu_torch.ops import search as search_ops
    from clickhouse_tpu_torch.ops.scan_ops import (_segmented_scan_plain,
                                                   segmented_scan)
    from clickhouse_tpu_torch.ops.search import _segmented_search_plain
    x = ((torch.arange(N_ROWS, device=dev, dtype=torch.int64) * 2654435761)
         % 1_000_003)
    xs, _ = torch.sort(x)
    x32 = xs.to(torch.int32)
    out = {}
    # K17 at Qw5: the running sum of the sorted x over one segment
    got = segmented_scan("sum", x32, None)
    want = _segmented_scan_plain("sum", x32, None, None, False, False,
                                 N_ROWS)
    err = max_abs_err(got, want)
    lib = torch.cumsum(x32, 0)
    if not torch.equal(lib, got):
        fail("K17 against torch.cumsum at Qw5")
    ms = cuda_ms(lambda: segmented_scan("sum", x32, None))
    plain = cuda_ms(lambda: _segmented_scan_plain(
        "sum", x32, None, None, False, False, N_ROWS), reps=3)
    lib_ms = cuda_ms(lambda: torch.cumsum(x32, 0))
    nb = N_ROWS * 4 + N_ROWS * 8
    split = k17_split("sum", x32, None)
    mx_ms = cuda_ms(lambda: segmented_scan("max", x32, None))
    cummax_ms = cuda_ms(lambda: torch.cummax(x32, 0))
    # K17 at Qw1's dense_rank: a bool's sum over 1,024 partitions
    pb = torch.zeros(N_ROWS, dtype=torch.bool, device=dev)
    pb[::N_ROWS // 1024] = True
    tie = pb | torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          xs[1:] != xs[:-1]])
    bool_ms = cuda_ms(lambda: segmented_scan("sum", tie, pb))
    first_ms = cuda_ms(lambda: segmented_scan("first", None, tie))
    rev_ms = cuda_ms(lambda: segmented_scan("first", None, tie,
                                            reverse=True))
    out["segmented_scan"] = {
        "ms": ms, "plain_ms": plain, "bytes": nb, "bound_ms": bound_ms(nb),
        "library_ms": lib_ms, "max_abs_err": err, "max_ms": mx_ms,
        "cummax_ms": cummax_ms, "bool_sum_ms": bool_ms,
        "bool_sum_bound_ms": bound_ms(N_ROWS * 2 * 1 + N_ROWS * 8),
        "first_index_ms": first_ms, "reverse_first_index_ms": rev_ms,
        "first_index_bound_ms": bound_ms(N_ROWS * 1 + N_ROWS * 8),
        "split": split}
    del got, want, lib, tie, pb
    # K18 at Qw5: the tokens of the sorted x, queries x - 10 (one segment)
    tok = xs ^ (-(1 << 63))
    q = (xs - 10) ^ (-(1 << 63))
    got = search_ops.segmented_search(tok, q, "left", unsigned=True)
    want = _segmented_search_plain(tok, q, "left", None, None, None, True)
    err = max_abs_err(got, want)
    lib = torch.searchsorted(xs, xs - 10)
    if not torch.equal(lib, got):
        fail("K18 against torch.searchsorted at Qw5")
    ms = cuda_ms(lambda: search_ops.segmented_search(tok, q, "left",
                                                     unsigned=True))
    plain = cuda_ms(lambda: _segmented_search_plain(
        tok, q, "left", None, None, None, True), reps=3)
    lib_ms = cuda_ms(lambda: torch.searchsorted(xs, xs - 10))
    nb = 3 * N_ROWS * 8
    # K18 at Qw3: P's sorted tokens, a partition a query
    key = ((x % 1024) << 20) | x
    ks, perm = torch.sort(key)
    xp = x.index_select(0, perm)
    part = xp % 1024
    tok3 = xp ^ (-(1 << 63))
    q3 = (xp - 1000) ^ (-(1 << 63))
    gid = part.to(torch.int32)
    starts = torch.searchsorted(part, torch.arange(1024, device=dev))
    ends = torch.searchsorted(part, torch.arange(1024, device=dev),
                              right=True)
    got3 = search_ops.segmented_search(tok3, q3, "left", gid=gid,
                                       starts=starts, ends=ends,
                                       unsigned=True)
    want3 = _segmented_search_plain(tok3, q3, "left", gid, starts, ends,
                                    True)
    err = max(err, max_abs_err(got3, want3))
    ms3 = cuda_ms(lambda: search_ops.segmented_search(
        tok3, q3, "left", gid=gid, starts=starts, ends=ends, unsigned=True))
    nb3 = 3 * N_ROWS * 8 + N_ROWS * 4
    tiles5 = k18_branches(tok, q, "left", None, None, None, True)
    tiles3 = k18_branches(tok3, q3, "left", gid, starts, ends, True)
    print(f"K18 tiles by branch: Qw5 {tiles5}, Qw3 {tiles3}", flush=True)
    out["segmented_search"] = {
        "ms": ms, "plain_ms": plain, "bytes": nb, "bound_ms": bound_ms(nb),
        "library_ms": lib_ms, "max_abs_err": err, "qw3_ms": ms3,
        "qw3_bytes": nb3, "qw3_bound_ms": bound_ms(nb3),
        "qw5_tiles": tiles5, "qw3_tiles": tiles3}
    for k, v in out.items():
        print(f"{k} at its inputs: {json.dumps(v)}", flush=True)
    return out


def window_times(s):
    """Each window query's median wall of WINDOW_REPS runs and its
    device-busy time from a torch.profiler trace of WINDOW_REPS runs."""
    for name, sql in WINDOW_QUERIES:
        cfg = {"max_device_memory_bytes": WINDOW_BUDGET}
        times = []
        for _ in range(WINDOW_REPS):
            t0 = time.perf_counter()
            s.execute(sql, settings=cfg)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        busy, ops, wall, top = device_busy(
            s, sql + f" SETTINGS max_device_memory_bytes = {WINDOW_BUDGET}",
            reps=WINDOW_REPS)
        print(f"{name} median wall {statistics.median(times) * 1e3:.3f} ms "
              f"over {WINDOW_REPS} runs; under torch.profiler: device busy "
              f"{busy:.4f} ms of {wall:.3f} ms wall a run, {ops:g} device "
              f"operations a run; top: "
              + "; ".join(f"{n} {t:.4f}" for n, t in top), flush=True)


def window_turn(ch, dev, s=None, want=None):
    """--window: K17's and K18's cases, the window, union and set-operation
    queries over hits on their paths, their times, and K17 and K18 at
    Qw5's and Qw3's inputs.  -> (shapes, launches, launch_rows)."""
    from clickhouse_tpu_torch.ops import _native
    t0 = time.perf_counter()
    check_k17(dev)
    check_k18(dev)
    if s is None:
        s, x = load_hits(ch)
        want = window_answers(x)
        del x
    launches = {k: 0 for k in _native.LAUNCHES}
    launch_rows = {k: [] for k in _native.LAUNCHES}
    window_path(s, want, {}, launches, launch_rows)
    window_times(s)
    shapes = window_shapes(dev)
    print(f"window phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return shapes, launches, launch_rows


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    import clickhouse_tpu_torch as ch
    from clickhouse_tpu_torch.ops import _native

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    if sys.argv[1:2] == ["--sass"] and len(sys.argv) == 3:
        sass_report(sys.argv[2])
        return

    t0 = time.perf_counter()
    _native.library()
    print(f"kernel build (nvcc, sm_90a) + load: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if sys.argv[1:] == ["--k2-wide"]:
        # uses only dense_group_reduce and its plain version, so it runs
        # beside a checkout of an earlier tree to time K2 there alike
        k2_wide(dev)
        return
    if sys.argv[1:] == ["--queries"]:
        s = load_hits(ch)[0]
        load_join_tables(s)
        load_hits_s(s)
        try:
            load_vecs(s)
        except Exception as e:      # a tree without Array columns
            print(f"vecs not loaded in this tree: {e}", flush=True)
        load_hits_t(s)
        time_queries(s)
        return
    if sys.argv[1:] == ["--vectors"]:
        # K11's edge cases, Q8, Q8l and Q8w on their path, and K11 at
        # Q8's inputs, alone
        check_k11(dev)
        s = ch.connect(device="cuda")
        want = vector_answers(load_vecs(s))
        memory = {"count": [], "grouping": [], "chars": [], "dense": [],
                  "k2": []}
        launches = {k: 0 for k in _native.LAUNCHES}
        launch_rows = {k: [] for k in _native.LAUNCHES}
        slice11_path(s, want, {}, launches, launch_rows, memory)
        vector_shapes(dev, vector_args(s))
        for name, sql in SLICE11_QUERIES:
            busy, ops, wall, top = device_busy(s, sql)
            print(f"{name} under torch.profiler: device busy {busy:.4f} ms "
                  f"of {wall:.3f} ms wall a run, {ops:g} device operations "
                  f"a run; top: "
                  + "; ".join(f"{n} {t:.4f}" for n, t in top), flush=True)
        return
    if sys.argv[1:] == ["--calendar"]:
        # K12's cases, Qt1-Qt5 on their path, K12 at Qt2's and Qt1's
        # inputs, and the five queries' times
        check_k12(dev)
        s = ch.connect(device="cuda")
        want = slice13_answers(load_hits_t(s))
        memory = {"count": [], "grouping": [], "chars": [], "dense": [],
                  "k2": []}
        launches = {k: 0 for k in _native.LAUNCHES}
        launch_rows = {k: [] for k in _native.LAUNCHES}
        slice13_path(s, want, {}, launches, launch_rows, memory)
        calendar_shapes(dev, s)
        query_times(s, SLICE13_QUERIES)
        return
    if sys.argv[1:] == ["--gathers"]:
        gather_curve(dev)
        return
    if sys.argv[1:] == ["--k9"]:
        k9_turn(dev)
        return
    if sys.argv[1:] == ["--k14"]:
        k14_turn(dev)
        return
    if sys.argv[1:] == ["--k6"]:
        # K6's three main-path uses and their queries' device-busy time;
        # copied into an unpacked older checkout it times that tree alike
        k6_turn(load_hits(ch)[0])
        return
    if sys.argv[1:] == ["--streaming"]:
        # K13's and K14's cases, then Q5, Q5b, Q6 and Q5np streamed over
        # 1B rows and PROGRAM_SQL's queries on their paths, K13 at their
        # chunks and K14 at Q5c's, Q5h's and a dense mask
        check_k13(dev)
        check_k14(dev)
        launches = {k: 0 for k in _native.LAUNCHES}
        launch_rows = {k: [] for k in _native.LAUNCHES}
        k13, k14, _ = streaming_phase(ch, dev, launches, launch_rows)
        print(json.dumps({"unpack_pairs": k13, "compact_rows": k14,
                          "launches": {k: launches[k] for k in (
                              "unpack_pairs", "compact_rows")}}),
              flush=True)
        return
    if sys.argv[1:] == ["--sketch"]:
        sketch_turn(ch, dev)
        return
    if sys.argv[1:] == ["--scan-search"]:
        # K17's and K18's cases and the two kernels at Qw5's and Qw3's
        # inputs (no query); copied into an older checkout it times that
        # tree alike
        check_k17(dev)
        check_k18(dev)
        print(json.dumps(window_shapes(dev)), flush=True)
        return
    if sys.argv[1:] == ["--window"]:
        shapes, launches, _ = window_turn(ch, dev)
        print(json.dumps({"launches": {k: launches[k] for k in (
            "segmented_scan", "segmented_search")}, **shapes}), flush=True)
        return
    if sys.argv[1:] == ["--aggregates"]:
        # K6's cases (both entries), Q2u, Q2ug, Q2q, Q2s2 and Q2g on their
        # path, K6's sorted-order entry at Q2ug's inputs, and the five
        # queries' times
        check_k6(dev)
        check_k6_sorted(dev)
        s, x = load_hits(ch)
        want = slice12_answers(x)
        del x
        memory = {"count": [], "grouping": [], "chars": [], "dense": [],
                  "k2": []}
        launches = {k: 0 for k in _native.LAUNCHES}
        launch_rows = {k: [] for k in _native.LAUNCHES}
        _, sorted_args, q2s2_args = slice12_path(s, want, {}, launches,
                                                 launch_rows, memory)
        k6_sorted_shape(dev, sorted_args[0])
        k6_sorted_shape(dev, sorted_args[1], "Q2s2")
        k6_q2s2_shape(q2s2_args)
        del sorted_args, q2s2_args
        query_times(s, SLICE12_QUERIES)
        return

    for check in (check_k1, check_k2, check_k3, check_k4, check_k5,
                  check_k6, check_k6_sorted, check_k7, check_k8, check_k9,
                  check_k10, check_k11, check_k12, check_k13, check_k14,
                  check_k15, check_k16, check_k17, check_k18):
        check(dev)
        print(f"[{time.perf_counter() - t0:.1f} s] {check.__name__} done",
              flush=True)
    check_small_queries(ch)
    check_small_joins(ch)
    print(f"[{time.perf_counter() - t0:.1f} s] small queries done",
          flush=True)

    s, x = load_hits(ch)
    want = expected_answers(x)
    want.update(slice12_answers(x))
    want.update(join_answers(*load_join_tables(s)))
    want.update(sketch_answers(x))
    want.update(window_answers(x))
    del x
    load_hits_s(s)
    want.update(string_answers())
    want.update(vector_answers(load_vecs(s)))
    want.update(slice13_answers(load_hits_t(s)))
    print(f"[{time.perf_counter() - t0:.1f} s] tables loaded", flush=True)

    # the main path, once, through the public API: each query with the
    # launch counters set to 0 just before it and read just after.  Two
    # wrappers are watched on the way (each call passed on as it is): K1's,
    # for its launches with and without filter terms, and K4's, for the
    # bits it sorts
    from clickhouse_tpu_torch.core.column import Dictionary
    from clickhouse_tpu_torch.ops import agg_ops, sort_ops
    per_query = {}
    launches = {k: 0 for k in _native.LAUNCHES}
    launch_rows = {k: [] for k in _native.LAUNCHES}
    k1_forms_seen = {"fused": 0, "mask_form": 0}
    k4_calls = []
    memory = {"count": [], "grouping": [], "chars": [], "dense": [],
              "k2": []}
    k1_cuda, k4_cuda = agg_ops._masked_reduce_cuda, sort_ops._radix_sort_cuda
    sort_rows, sort_rows_bytes = sort_ops.sort_rows, sort_ops.sort_rows_bytes
    group_by_sort = agg_ops.group_by_sort
    device_chars = Dictionary.device_chars

    def k1_watch(*a):
        k1_forms_seen["fused" if a[5] else "mask_form"] += 1
        return k1_cuda(*a)

    def k4_watch(keys, bits, values):
        k4_calls.append((keys.shape[0], bits))
        return k4_cuda(keys, bits, values)

    def sort_rows_watch(*a, **kw):
        # the working set the governor held against the budget: the
        # sort's (sort_rows_bytes) and what the caller holds beside it
        counted = []

        def bytes_watch(*b):
            counted.append(sort_rows_bytes(*b))
            return counted[-1]
        sort_ops.sort_rows_bytes = bytes_watch
        try:
            return sort_rows(*a, **kw)
        finally:
            sort_ops.sort_rows_bytes = sort_rows_bytes
            memory["count"].append(sum(counted) + kw.get("held_bytes", 0))

    def group_watch(*a, **kw):
        # the sort grouping's own peak above what was allocated at its
        # start (the query's peak so far kept aside)
        torch.cuda.synchronize()
        peak_before = torch.cuda.max_memory_allocated()
        at_start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = group_by_sort(*a, **kw)
        torch.cuda.synchronize()
        memory["grouping"].append(
            (peak_before, torch.cuda.max_memory_allocated() - at_start))
        return out
    def chars_watch(d, device, check=None):
        # a dictionary's chars built on the device (not a cached copy):
        # (seconds, bytes, whether the governor's check was given)
        if str(torch.device(device)) in d._chars:
            return device_chars(d, device, check)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = device_chars(d, device, check)
        torch.cuda.synchronize()
        memory["chars"].append((time.perf_counter() - t0, nbytes(*out),
                                check is not None))
        return out
    unwatch_dense = watch_dense(memory)
    sketch_watch = SketchWatch()
    agg_ops._masked_reduce_cuda = k1_watch
    sort_ops._radix_sort_cuda = k4_watch
    sort_ops.sort_rows = sort_rows_watch
    agg_ops.group_by_sort = group_watch
    Dictionary.device_chars = chars_watch
    try:
        main_path(s, want, per_query, launches, launch_rows, k1_forms_seen,
                  k4_calls, memory)
        join_path(s, want, per_query, launches, launch_rows, memory)
        slice10_path(s, want, per_query, launches, launch_rows, memory)
        slice11_path(s, want, per_query, launches, launch_rows, memory)
        _, sorted_args, q2s2_args = slice12_path(
            s, want, per_query, launches, launch_rows, memory)
        k12_calls = slice13_path(s, want, per_query, launches, launch_rows,
                                 memory)
        sketch_recs = sketch_phase(s, want, sketch_watch, per_query,
                                   launches, launch_rows)
        window_path(s, want, per_query, launches, launch_rows)
    finally:
        unwatch_dense()
        agg_ops._masked_reduce_cuda = k1_cuda
        sort_ops._radix_sort_cuda = k4_cuda
        sort_ops.sort_rows = sort_rows
        agg_ops.group_by_sort = group_by_sort
        Dictionary.device_chars = device_chars
    print(f"[{time.perf_counter() - t0:.1f} s] main path done", flush=True)
    time_queries(s)
    window_times(s)
    print(f"[{time.perf_counter() - t0:.1f} s] query times done", flush=True)

    args = main_path_args(s)
    shapes = q_shapes(dev, args)
    shapes.update(sort_shapes(dev, args))
    del args
    k6 = shapes["segment_reduce"]
    k6.update(k6_sorted_shape(dev, sorted_args[0]))
    k6.update(k6_sorted_shape(dev, sorted_args[1], "Q2s2"))
    k6.update(k6_q2s2_shape(q2s2_args))
    k6["max_abs_err"] = max(k6["max_abs_err"], k6.pop("sorted_max_abs_err"),
                            k6.pop("q2s2_sorted_max_abs_err"),
                            k6.pop("q2s2_max_abs_err"))
    del sorted_args, q2s2_args
    shapes.update(join_shapes(dev, join_args(s)))
    shapes.update(string_shapes(dev, string_args(s)))
    shapes.update(vector_shapes(dev, vector_args(s)))
    shapes.update(calendar_shapes(dev, s))
    shapes["calendar_part"]["k12_calls"] = k12_calls
    shapes.update(window_shapes(dev))
    print(f"[{time.perf_counter() - t0:.1f} s] kernel times done",
          flush=True)
    # the streaming phase over 1B rows, after the earlier tables are freed
    import gc
    del s
    gc.collect()
    torch.cuda.empty_cache()
    shapes["unpack_pairs"], shapes["compact_rows"], _ = streaming_phase(
        ch, dev, launches, launch_rows, sketch=lambda sb: sketch_recs.update(
            sketch_stream_phase(sb, want, sketch_watch, per_query, launches,
                                launch_rows)))
    sketch_watch.close()
    print(f"[{time.perf_counter() - t0:.1f} s] streaming phase done",
          flush=True)
    shapes.update(sketch_shapes(dev, sketch_watch))
    print(f"[{time.perf_counter() - t0:.1f} s] K15 and K16 at their inputs "
          f"done", flush=True)
    launches["hll"] = sum(launches[k] for k in HLL_KERNELS)
    launch_rows["hll"] = launch_rows["hll_update"] \
        + launch_rows["hll_update_rows"]
    shapes["hll"].update({f"launches_{k[4:]}": launches[k]
                          for k in HLL_KERNELS})
    for name in ("radix_sort_pairs", "segment_reduce", "segment_bounds"):
        shapes[name]["launches_per_query"] = {
            q: per_query[q][name] + (per_query[q]["segment_reduce_sorted"]
                                     if name == "segment_reduce" else 0)
            for q in ("Q2b", "Q2m", "Q4x")
            + tuple(q for q, _ in SLICE12_QUERIES)}
    shapes["segment_reduce"]["launches_sorted"] = \
        launches["segment_reduce_sorted"]
    shapes["segment_reduce"]["launches_permuted"] = launches["segment_reduce"]
    launches["segment_reduce"] += launches["segment_reduce_sorted"]
    launch_rows["segment_reduce"] += launch_rows["segment_reduce_sorted"]
    for name in ("dense_join", "hash_join", "expand_matches"):
        shapes[name]["launches_per_query"] = {
            q: per_query[q][name] for q, _ in JOIN_QUERIES}
    shapes["masked_reduce"].update(
        launches_fused=k1_forms_seen["fused"],
        launches_mask_form=k1_forms_seen["mask_form"])
    print(f"masked_reduce launches on the main path: "
          f"{k1_forms_seen['fused']} with filter terms, "
          f"{k1_forms_seen['mask_form']} without (bool-mask counts)",
          flush=True)
    kernel_line(card, shapes, launches, launch_rows)


def main_path(s, want, per_query, launches, launch_rows, k1_forms_seen,
              k4_calls, memory):
    """Q1, Q2, Q2b, Q2m and Q3 once each, checked against numpy, with the
    launch counters set to 0 before each and read after; fails unless
    each query reached the kernels of its path.  memory: the sort checks'
    counts and the sort groupings' peaks, filled by main's watches."""
    from clickhouse_tpu_torch.ops import _native
    for name, sql in QUERIES:
        k1_before = dict(k1_forms_seen)
        del k4_calls[:]
        for v in memory.values():
            del v[:]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _native.reset_launches()
        rows = s.execute(sql).rows()
        per_query[name] = dict(_native.LAUNCHES)
        rows_of = {k: list(v) for k, v in _native.LAUNCH_ROWS.items()}
        extra = peak_since(base, memory)
        if rows != want[name]:
            fail(f"{name} returned {rows[:5]}..., numpy says "
                 f"{want[name][:5]}...")
        for k, v in rows_of.items():
            launches[k] += per_query[name][k]
            launch_rows[k] += v
        # the rows of this query's largest launch of each kernel
        big = {k: max(v, default=0) for k, v in rows_of.items()}
        print_dense_split(name, memory, base, extra)
        k1_split = {f: k1_forms_seen[f] - k1_before[f] for f in k1_before}
        print(f"{name}: K1 launches {k1_split}; device memory at its peak "
              f"{extra} bytes above what was allocated before it",
              flush=True)
        if name in ("Q2b", "Q2m"):
            for kernel in ("radix_sort_pairs", "segment_bounds") + (
                    ("segment_reduce",) if name == "Q2m" else ()):
                if big[kernel] < N_ROWS:
                    fail(f"{name} did not reach {kernel} over {N_ROWS} "
                         f"rows: {per_query[name]}, largest launch "
                         f"{big[kernel]} rows")
            # one sort; Q2m's four aggregates in ONE K6 launch, Q2b's
            # count() in none
            k6 = 1 if name == "Q2m" else 0
            if per_query[name]["radix_sort_pairs"] != 1 \
                    or per_query[name]["segment_reduce"] != k6:
                fail(f"{name} launched K4 {per_query[name]['radix_sort_pairs']}"
                     f" times (want 1) and K6 "
                     f"{per_query[name]['segment_reduce']} (want {k6})")
            if len(memory["count"]) != 1 or len(memory["grouping"]) != 1:
                fail(f"{name} made {len(memory['count'])} sort checks and "
                     f"{len(memory['grouping'])} sort groupings, not one")
            count, own = memory["count"][0], memory["grouping"][0][1]
            print(f"{name}: K4 calls (rows, bits) {k4_calls}; the "
                  f"governor's count for the sort grouping (sort_rows_bytes "
                  f"+ key arrays + K5's outputs and scratch) {count} bytes; "
                  f"the query's peak {extra} bytes above what was allocated "
                  f"before it (count - peak {count - extra}); the sort "
                  f"grouping's own peak {own} bytes above what was "
                  f"allocated at its start (count - own peak "
                  f"{count - own})", flush=True)
            print(f"{name}: K4, K5{', K6' if name == 'Q2m' else ''} over "
                  f"{big['radix_sort_pairs']} rows; launches "
                  f"{per_query[name]}", flush=True)
        elif any(per_query[name][k] for k in ("radix_sort_pairs",
                                              "segment_bounds",
                                              "segment_reduce")):
            fail(f"{name} launched a sort kernel: {per_query[name]}")
        if name == "Q1":
            # one K1 launch over every row, and no row mask on the way (a
            # bool mask of the rows alone would take N_ROWS bytes)
            if per_query["Q1"]["masked_reduce"] != 1 \
                    or big["masked_reduce"] < N_ROWS:
                fail(f"Q1 did not reach K1 once over {N_ROWS} rows: "
                     f"{per_query['Q1']}, {rows_of['masked_reduce']}")
            if extra >= N_ROWS:
                fail(f"Q1 allocated {extra} bytes of device memory")
            print(f"Q1: one K1 launch over {big['masked_reduce']} rows; "
                  f"{extra} bytes of device memory allocated at its peak",
                  flush=True)
    for name, kernel in (("Q1", "masked_reduce"),
                         ("Q2", "dense_group_reduce"),
                         ("Q3", "topk_smallest")):
        if per_query[name][kernel] < 1:
            fail(f"{name} did not launch {kernel}: {per_query[name]}")
    print(f"Q1, Q2, Q2b, Q2m and Q3 match numpy; launches per query: "
          f"{per_query}", flush=True)


def kernel_line(card, shapes, launches, launch_rows):
    """Print the card and the kernels line, then the last line."""
    sources = {"masked_reduce": ("clickhouse_tpu_torch/csrc/masked_reduce.cu",
                                 "scratch/q1_profile.py:92"),
               "dense_group_reduce": (
                   "clickhouse_tpu_torch/csrc/dense_group_reduce.cu",
                   "clickhouse_tpu/ops/mxu_segsum.py:51"),
               "topk_smallest": ("clickhouse_tpu_torch/csrc/topk_smallest.cu",
                                 "clickhouse_tpu/ops/sort_ops.py:110"),
               "radix_sort_pairs": (
                   "clickhouse_tpu_torch/csrc/radix_sort.cu",
                   "clickhouse_tpu/ops/agg_ops.py:227"),
               "segment_bounds": (
                   "clickhouse_tpu_torch/csrc/segment_bounds.cu",
                   "clickhouse_tpu/ops/scan_ops.py:52"),
               "segment_reduce": (
                   "clickhouse_tpu_torch/csrc/segment_reduce.cu",
                   "clickhouse_tpu/ops/scan_ops.py:147"),
               "dense_join": ("clickhouse_tpu_torch/csrc/dense_join.cu",
                              "clickhouse_tpu/ops/join_ops.py:65"),
               "hash_join": ("clickhouse_tpu_torch/csrc/hash_join.cu",
                             "clickhouse_tpu/ops/join_ops.py:131"),
               "expand_matches": (
                   "clickhouse_tpu_torch/csrc/expand_matches.cu",
                   "clickhouse_tpu/ops/join_ops.py:328"),
               "prefix_match": ("clickhouse_tpu_torch/csrc/prefix_match.cu",
                                "clickhouse_tpu/exprs/functions.py:611"),
               "vector_distance": (
                   "clickhouse_tpu_torch/csrc/vector_distance.cu",
                   "clickhouse_tpu/exprs/functions_ext.py:2204"),
               "calendar_part": (
                   "clickhouse_tpu_torch/csrc/calendar_part.cu",
                   "clickhouse_tpu/exprs/functions.py:1043"),
               "unpack_pairs": (
                   "clickhouse_tpu_torch/csrc/unpack_pairs.cu",
                   "clickhouse_tpu/exec/streaming.py:930"),
               "compact_rows": (
                   "clickhouse_tpu_torch/csrc/compact_rows.cu",
                   "clickhouse_tpu/ops/filter_ops.py:26"),
               "row_hash": ("clickhouse_tpu_torch/csrc/row_hash.cu",
                            "clickhouse_tpu/ops/hash_ops.py:179"),
               "hll": ("clickhouse_tpu_torch/csrc/hll.cu",
                       "clickhouse_tpu/exprs/agg_sketch.py:301"),
               "segmented_scan": (
                   "clickhouse_tpu_torch/csrc/segmented_scan.cu",
                   "clickhouse_tpu/ops/scan_ops.py:86"),
               "segmented_search": (
                   "clickhouse_tpu_torch/csrc/segmented_search.cu",
                   "clickhouse_tpu/ops/search.py:52")}
    kernels = []
    for name, (src, repl) in sources.items():
        r = shapes[name]
        full = N_VECS if name == "vector_distance" else \
            STREAM_CHUNK_ROWS if name in ("unpack_pairs", "compact_rows") \
            else N_ROWS
        big = sum(1 for m in launch_rows[name] if m >= full)
        print(f"{name}: {launches[name]} launches on the main path, {big} "
              f"of them over {full} rows", flush=True)
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": repl, "launches": launches[name],
                        f"launches_at_{full // 1_000_000}M_rows": big,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": "bytes", "bytes": r["bytes"],
                        "library_ms": r["library_ms"],
                        **{k: v for k, v in r.items() if k in EXTRA_KEYS}})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
