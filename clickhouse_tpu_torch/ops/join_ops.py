"""Joins: the direct-address join (K7), the hash join (K8) and the match
expansion (K9).

Reference: clickhouse_tpu/ops/join_ops.py.  There every step is a sort,
because a TPU's random gathers and scatters are slow: the N:1 join sorts
concat(build, probe) and carries the build rows' words down each key run
with cumulative maxima; the 1:N join groups the build side, sorts the
unique build keys with the probe keys, and expands the matches by merging
the cumulative match counts with the output slots.  The card gathers well
from its 50 MB L2, so the port runs the joins the reference engine
(ClickHouse's HashJoin) runs, with the same observable results:

  * ``dense_gather_join`` -- unique build keys in a small proven range
    [lo, hi]: one table of R = hi - lo + 1 slots a payload word, one
    gather a probe row (K7, csrc/dense_join.cu);
  * ``propagate_join`` -- N:1, ANY, SEMI and ANTI joins: an open-addressing
    hash table of the build keys, probed once a probe row; a probe row
    matches the SMALLEST build row id among the rows with its key (the
    reference's "first inserted" ANY choice) and takes that row's words
    (K8, csrc/hash_join.cu);
  * ``build_join_table`` / ``probe_join_table`` -- the 1:N join: the build
    side grouped by key (``agg_ops.group_by_sort``: K4, K5), K8's table
    over the unique keys holding group indices, and a probe that gives
    each probe row its group's (seg_start, seg_len) in key-sorted build
    order;
  * ``expand_matches`` -- one output row a match, probe-major, build rows
    in key-sorted order (ascending build row id within a key) (K9,
    csrc/expand_matches.cu).

Keys compare exactly: integers by value in their unified type, floats by
bit pattern (the reference compares ``sortable_bits`` tokens, so -0.0 and
+0.0 are two keys and a NaN matches a NaN of the same bits), strings by
their codes in one merged dictionary.  A probe_valid of None lets every
probe row match: the caller masks the rows past its valid ones.

A CPU tensor takes each kernel's plain version; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ..core.errors import NotImplementedError_
from . import _native, agg_ops, sort_ops

__all__ = ["PropagateResult", "JoinTable", "ProbeResult",
           "dense_gather_join", "propagate_join", "build_join_table",
           "probe_join_table", "expand_matches", "expand_matches_bytes",
           "EXPAND_HEAVY_SLOTS", "key_words",
           "hash_capacity", "hash_join_bytes", "SlotWord",
           "dense_slot_layout"]

_KINDS = {"word": 0, "key": 1, "keyvalid": 2}   # OutKind of dense_join.cu
_EXPAND_TILE = 4096                # kTile of csrc/expand_matches.cu
_EXPAND_SLOTS = 4096               # kSlots of csrc/expand_matches.cu
# K9's spill threshold: a tile whose output holds more slots is written by
# the spill grid, 4,096 slots a block, not by the block that scanned it
EXPAND_HEAVY_SLOTS = 65536


@dataclasses.dataclass
class PropagateResult:
    """Per-probe-row join result in raw probe order (no expansion)."""
    matched: torch.Tensor          # (Np,) bool
    words: List[torch.Tensor]      # each (Np,) int32, 0 where unmatched
    # K7 only: 0-d int32, 1 where a valid build row's key lies outside
    # [lo, hi] or a word outside its stated range (the words are then not
    # to be trusted), else 0
    out_of_range: Optional[torch.Tensor] = None


@dataclasses.dataclass
class JoinTable:
    """Build-side index in key-sorted group order."""
    key_cols: List[torch.Tensor]   # each (G,) unique key values per group
    seg_start: torch.Tensor        # (G,) int32 start into row_order
    seg_len: torch.Tensor          # (G,) int32 rows per group (0: padding)
    row_order: torch.Tensor        # int32 build row ids, key-sorted
    num_groups: torch.Tensor       # 0-d int64
    # K8's buckets over key_cols (group indices), 16 bytes each as two
    # int64; None on the CPU
    buckets: Optional[torch.Tensor] = None

    @property
    def group_capacity(self) -> int:
        return int(self.seg_start.shape[0])


@dataclasses.dataclass
class ProbeResult:
    """Per-probe-row match info (raw probe row order)."""
    matched: torch.Tensor          # (N,) bool
    seg_start: torch.Tensor        # (N,) int32 into row_order (0: unmatched)
    seg_len: torch.Tensor          # (N,) int32 build matches (0: unmatched)


def _check_rows(name: str, t: Optional[torch.Tensor], n: int, dev,
                dtypes=None):
    if t is None:
        return
    if t.dim() != 1 or t.shape[0] != n or t.device != dev \
            or (dtypes is not None and t.dtype not in dtypes):
        raise ValueError(f"{name}: a 1-d tensor of {n} rows on {dev}"
                         + (f", one of {dtypes}" if dtypes else "")
                         + f" was expected, got {tuple(t.shape)} "
                         f"{t.dtype} on {t.device}")


def _route(name: str, dev) -> bool:
    """True for the kernel, False for the plain version."""
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for {dev}")
    return True


def _bool(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.to(torch.bool).contiguous()


# -- K7: direct-address join ------------------------------------------------

_DENSE_KEY_DTYPES = (torch.bool, torch.int8, torch.uint8, torch.int16,
                     torch.int32, torch.int64)


def _wrap64(v: int) -> int:
    """v as the int64 bits of its value mod 2^64."""
    return ((int(v) + (1 << 63)) % (1 << 64)) - (1 << 63)


def dense_gather_join(build_key: torch.Tensor,
                      build_valid: Optional[torch.Tensor],
                      probe_key: torch.Tensor,
                      probe_valid: Optional[torch.Tensor],
                      build_words: Sequence, lo: int,
                      hi: int) -> PropagateResult:
    """N:1 join against a dense direct-address table (K7).

    The (unique) build keys lie in the proven range [lo, hi]; a table of
    R = hi - lo + 1 slots holds each build row's words (a slot where no
    build row lies holds every word's sentinel), and a probe row takes its
    key's slot.  Requires unique build keys, or no words (SEMI/ANTI
    presence checks).

    build_key, probe_key -- integer keys (int8/16/32/64, uint8, bool; UInt64
        as int64 bits), each in its own storage type
    build_words -- entries ("word", int32 (Nb,) tensor, sentinel[, (lo,
        hi)]) with a sentinel provably outside the word's values, and
        optionally the word's proven range (the kernel then keeps the word
        in fewer bytes), ("key",) for the join key's own value (the probe
        key as int32 where matched) and ("keyvalid",) for its validity
        (the match flag)
    -> matched (a valid probe row whose key has a build row), one int32
       word an entry (0 where unmatched) and out_of_range: the ranges are
       the caller's proof, which the call checks (a valid build row whose
       key or stated word range does not hold sets it).
    """
    R = int(hi) - int(lo) + 1
    if not 1 <= R < 1 << 31:
        raise ValueError(f"dense_gather_join: {R} table slots")
    entries = list(build_words)
    if len(entries) > _native.K7_MAX_ENTRIES:
        raise ValueError(f"dense_gather_join: more than "
                         f"{_native.K7_MAX_ENTRIES} output words")
    nb, n = build_key.shape[0], probe_key.shape[0]
    dev = probe_key.device
    _check_rows("dense_gather_join", build_key, nb, dev, _DENSE_KEY_DTYPES)
    _check_rows("dense_gather_join", probe_key, n, dev, _DENSE_KEY_DTYPES)
    _check_rows("dense_gather_join", build_valid, nb, dev)
    _check_rows("dense_gather_join", probe_valid, n, dev)
    for e in entries:
        if e[0] not in _KINDS:
            raise ValueError(f"dense_gather_join: unknown entry {e[0]!r}")
        if e[0] == "word":
            _check_rows("dense_gather_join", e[1], nb, dev)
    if _route("dense_gather_join", dev):
        return _dense_gather_join_cuda(build_key, build_valid, probe_key,
                                       probe_valid, entries, lo, R)
    return _dense_gather_join_plain(build_key, build_valid, probe_key,
                                    probe_valid, entries, lo, R)


@dataclasses.dataclass
class SlotWord:
    """Where K7 keeps one word in a table slot: the field holds (word -
    base) mod 2^(8 bytes) at byte `offset`; `empty` is the field of the
    sentinel (a slot without a build row)."""
    entry: Optional[int]       # its index in the entries; None: presence
    bytes: int                 # 1, 2 or 4
    base: int                  # int32
    empty: int                 # unsigned field value
    lo: int = 0                # the stated range: (word - lo) mod 2^32
    span: int = 0xFFFFFFFF     # <= span (every word without a range)
    offset: int = 0


def dense_slot_layout(entries) -> Tuple[List[SlotWord], int]:
    """K7's table slot for these entries: each "word" in the fewest bytes
    (1, 2 or 4) that its proven range and sentinel need (4 without a
    range), the widest first, each on a multiple of its width; no word: a
    presence byte (1 where a build row lies, sentinel 0).  -> (the words,
    first deciding the match; the slot's bytes, a power of two)."""
    words = []
    for i, e in enumerate(entries):
        if e[0] != "word":
            continue
        sentinel = int(e[2])
        bounds = e[3] if len(e) > 3 else None
        rng = {}
        if bounds is None:
            nbytes, base = 4, 0
        else:
            rng = {"lo": int(bounds[0]) & 0xFFFFFFFF,
                   "span": int(bounds[1]) - int(bounds[0])}
            lo_, hi_ = min(int(bounds[0]), sentinel), max(int(bounds[1]),
                                                         sentinel)
            span = hi_ - lo_
            nbytes, base = (1, lo_) if span < 1 << 8 else \
                (2, lo_) if span < 1 << 16 else (4, 0)
        mask = (1 << (8 * nbytes)) - 1
        words.append(SlotWord(i, nbytes, base, (sentinel - base) & mask,
                              **rng))
    if not words:
        words.append(SlotWord(None, 1, 0, 0, lo=1, span=0))
    words.sort(key=lambda w: -w.bytes)         # stable: the entries' order
    off = 0
    for w in words:
        w.offset = off
        off += w.bytes
    return words, 1 << max(off - 1, 0).bit_length()


def _u32(v: int) -> int:
    return int(v) & 0xFFFFFFFF


def _dense_gather_join_cuda(build_key, build_valid, probe_key, probe_valid,
                            entries, lo, R):
    dev = probe_key.device
    n = probe_key.shape[0]
    bk, pk = build_key.contiguous(), probe_key.contiguous()
    bv, pv = _bool(build_valid), _bool(probe_valid)
    words, slot_bytes = dense_slot_layout(entries)
    # R slots, padded to 16 bytes (the init kernel writes whole 16 bytes)
    table = torch.empty(-(-R * slot_bytes // 16) * 16, dtype=torch.uint8,
                        device=dev)
    matched = torch.empty(n, dtype=torch.bool, device=dev)
    out_of_range = torch.empty((), dtype=torch.int32, device=dev)
    args = _native.K7Args(
        build_key=bk.data_ptr(), build_valid=None if bv is None
        else bv.data_ptr(), n_build=bk.shape[0], probe_key=pk.data_ptr(),
        probe_valid=None if pv is None else pv.data_ptr(), n_probe=n,
        lo=_wrap64(lo), R=R, table=table.data_ptr(),
        matched=matched.data_ptr(), out_of_range=out_of_range.data_ptr(),
        build_dtype=_native.dtype_code(bk.dtype),
        probe_dtype=_native.dtype_code(pk.dtype), slot_bytes=slot_bytes,
        n_words=len(words), n_outs=len(entries))
    keep = []                       # tensors the launch reads
    where = {}
    for j, w in enumerate(words):
        src = None
        if w.entry is not None:
            src = entries[w.entry][1].to(torch.int32).contiguous()
            keep.append(src)
            where[w.entry] = w
        args.w[j] = _native.K7Word(
            src=None if src is None else src.data_ptr(), base=_u32(w.base),
            bytes=w.bytes, offset=w.offset, empty=w.empty, lo=w.lo,
            span=w.span)
    outs: List[torch.Tensor] = []
    for i, e in enumerate(entries):
        out = torch.empty(n, dtype=torch.int32, device=dev)
        outs.append(out)
        w = where.get(i)
        args.o[i] = _native.K7Out(
            out=out.data_ptr(), kind=_KINDS[e[0]],
            base=0 if w is None else _u32(w.base),
            bytes=4 if w is None else w.bytes,
            offset=0 if w is None else w.offset)
    rc = _native.library().chtt_dense_join(ctypes.byref(args),
                                           _native.stream_ptr(dev))
    _native.check(rc, "dense_gather_join")
    _native.count_launch("dense_join", n)
    return PropagateResult(matched=matched, words=outs,
                           out_of_range=out_of_range)


def _dense_gather_join_plain(build_key, build_valid, probe_key, probe_valid,
                             entries, lo, R):
    """Plain PyTorch version of K7 (the reference's scatter and gathers)."""
    lo = _wrap64(lo)
    boff = build_key.to(torch.int64) - lo
    bok = (boff >= 0) & (boff < R)
    bvalid = torch.ones_like(bok) if build_valid is None \
        else build_valid.to(torch.bool)
    bad = bvalid & ~bok
    bok &= bvalid
    for e in entries:
        if e[0] == "word" and len(e) > 3 and e[3] is not None:
            w = e[1].to(torch.int64)
            bad |= bok & ((w < int(e[3][0])) | (w > int(e[3][1])))
    bidx = torch.where(bok, boff, R)
    poff = probe_key.to(torch.int64) - lo
    inb = (poff >= 0) & (poff < R)
    if probe_valid is not None:
        inb &= probe_valid.to(torch.bool)
    pidx = poff.clamp(0, R - 1)
    matched = None
    gathered = {}
    for i, e in enumerate(entries):
        if e[0] != "word":
            continue
        t = torch.full((R + 1,), int(e[2]), dtype=torch.int32,
                       device=probe_key.device)
        t[bidx] = e[1].to(torch.int32)
        g = t[:R][pidx]
        if matched is None:
            matched = inb & (g != int(e[2]))
        gathered[i] = g
    if matched is None:
        pres = torch.zeros(R + 1, dtype=torch.int32, device=probe_key.device)
        pres[bidx] = 1
        matched = inb & (pres[:R][pidx] != 0)
    zero = torch.zeros((), dtype=torch.int32, device=probe_key.device)
    words = []
    for i, e in enumerate(entries):
        if e[0] == "word":
            words.append(torch.where(matched, gathered[i], zero))
        elif e[0] == "key":
            words.append(torch.where(matched, probe_key.to(torch.int32),
                                     zero))
        else:
            words.append(matched.to(torch.int32))
    return PropagateResult(matched=matched, words=words,
                           out_of_range=bad.any().to(torch.int32))


# -- K8: hash join ------------------------------------------------------------

def key_words(keys: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The join keys as K8 compares them: 4-byte or 8-byte words, equal
    exactly when the keys are (floats by bit pattern: float32 as int32
    bits, float64 as int64 bits; narrower integers and bools widened to
    int32)."""
    out = []
    for k in keys:
        if k.dtype == torch.float64:
            k = k.contiguous().view(torch.int64)
        elif k.dtype == torch.float32:
            k = k.contiguous().view(torch.int32)
        elif k.dtype not in (torch.int32, torch.int64):
            k = k.to(torch.int32)
        out.append(k.contiguous())
    return out


def hash_capacity(n_build: int) -> int:
    """K8's bucket count for n_build build rows: a power of two of at least
    twice the rows (and 1,024)."""
    return max(1024, 1 << max(0, 2 * max(n_build, 1) - 1).bit_length())


def _check_key_count(n_keys: int) -> None:
    if n_keys > _native.K8_MAX_KEYS:
        raise NotImplementedError_(
            f"joins on more than {_native.K8_MAX_KEYS} key columns are not "
            f"ported to the CUDA engine yet")


def _key_pairs(name, build_keys, probe_keys):
    """Each key pair as K8's words of one type (the probe key cast to the
    build key's type first, as the reference's propagate_join does)."""
    if not build_keys or len(build_keys) != len(probe_keys):
        raise ValueError(f"{name}: one probe key a build key, at least one")
    _check_key_count(len(build_keys))
    bw = key_words(build_keys)
    pw = key_words([p.to(b.dtype) for b, p in zip(build_keys, probe_keys)])
    return bw, pw


_ALL_ONES = (1 << 64) - 1


def _hash_args(bw, pw, build_valid, probe_valid, buckets, hash_mask):
    args = _native.K8Args(nk=len(bw), table=buckets.data_ptr(),
                          cap=buckets.shape[0] // 2,
                          hash_mask=hash_mask & _ALL_ONES)
    for i, (b, p) in enumerate(zip(bw, pw)):
        args.build[i] = b.data_ptr()
        args.probe[i] = p.data_ptr() if p is not None else None
        args.bytes[i] = b.element_size()
    args.n_build = bw[0].shape[0]
    args.build_valid = None if build_valid is None \
        else build_valid.data_ptr()
    if pw[0] is not None:
        args.n_probe = pw[0].shape[0]
        args.probe_valid = None if probe_valid is None \
            else probe_valid.data_ptr()
    return args


def _hash_build_cuda(bw, build_valid, hash_mask=-1):
    """K8's table build: the buckets (16 bytes each, as int64 pairs: key
    word, then row id and word) over the valid build rows."""
    dev = bw[0].device
    buckets = torch.empty(2 * hash_capacity(bw[0].shape[0]),
                          dtype=torch.int64, device=dev)
    args = _hash_args(bw, [None] * len(bw), build_valid, None, buckets,
                      hash_mask)
    rc = _native.library().chtt_hash_build(ctypes.byref(args),
                                           _native.stream_ptr(dev))
    _native.check(rc, "hash_join build")
    return buckets


def _payload_stride(n_words: int, in_bucket: int = 1) -> int:
    """int32 words a build row of K8's payload array for one probe launch
    of n_words words (0: they ride in the bucket, which holds `in_bucket`:
    two for one 4-byte key, else one)."""
    return 0 if n_words <= in_bucket else n_words if n_words <= 2 else 4


def _in_bucket(bw) -> int:
    """The words a K8 bucket holds itself for these key words."""
    return 2 if len(bw) == 1 and bw[0].element_size() == 4 else 1


def _hash_probe_cuda(bw, pw, buckets, probe_valid, src, hash_mask=-1,
                     words_in_bucket=True):
    """K8's probe: (matched, one int32 word a probe row for each source
    word, 0 where unmatched).  Each launch first writes its words into the
    buckets (or the payload array, by build row); more than K8_MAX_WORDS
    source words take another launch a chunk.  words_in_bucket=False (a
    measurement hook) keeps every word in the payload array."""
    dev = pw[0].device
    n = pw[0].shape[0]
    matched = torch.empty(n, dtype=torch.bool, device=dev)
    outs = [torch.empty(n, dtype=torch.int32, device=dev) for _ in src]
    src = [w.to(torch.int32).contiguous() for w in src]
    step = _native.K8_MAX_WORDS
    in_bucket = _in_bucket(bw) if words_in_bucket else 0
    # the first chunk is the widest
    stride = _payload_stride(min(len(src), step), in_bucket)
    payload = torch.empty(bw[0].shape[0] * stride, dtype=torch.int32,
                          device=dev) if stride else None
    for c in range(0, max(len(src), 1), step):
        args = _hash_args(bw, pw, None, probe_valid, buckets, hash_mask)
        args.matched = matched.data_ptr() if c == 0 else None
        chunk = src[c:c + step]
        args.n_words = len(chunk)
        args.stride = _payload_stride(len(chunk), in_bucket)
        args.payload = payload.data_ptr() if args.stride else None
        for i, (w, o) in enumerate(zip(chunk, outs[c:c + step])):
            args.src[i] = w.data_ptr()
            args.out[i] = o.data_ptr()
        rc = _native.library().chtt_hash_probe(ctypes.byref(args),
                                               _native.stream_ptr(dev))
        _native.check(rc, "hash_join probe")
    return matched, outs


def hash_join_bytes(n_build: int, n_probe: int, n_words: int) -> int:
    """Device bytes of K8's build and one probe beyond its inputs, at most:
    the buckets (16 bytes each), the payload array (as if a bucket held
    one word), the match flags and the output words."""
    stride = _payload_stride(min(n_words, _native.K8_MAX_WORDS))
    return hash_capacity(n_build) * 16 + n_build * 4 * stride \
        + n_probe * (1 + 4 * n_words)


def _first_match_plain(bw, build_valid, pw, probe_valid) -> torch.Tensor:
    """Plain version of K8's lookup: each probe row's smallest build row id
    with its key words (int64, -1 where none)."""
    dev = pw[0].device
    nb, n = bw[0].shape[0], pw[0].shape[0]
    bk = torch.stack([w.to(torch.int64) for w in bw], 1)
    pk = torch.stack([w.to(torch.int64) for w in pw], 1)
    rows = torch.arange(nb, dtype=torch.int64, device=dev)
    if build_valid is not None:
        keep = build_valid.to(torch.bool)
        bk, rows = bk[keep], rows[keep]
    if bk.shape[0] == 0 or n == 0:
        return torch.full((n,), -1, dtype=torch.int64, device=dev)
    uniq, inv = torch.unique(torch.cat([bk, pk]), dim=0, return_inverse=True)
    first = torch.full((uniq.shape[0],), nb, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, inv[:bk.shape[0]], rows, "amin")
    hit = first[inv[bk.shape[0]:]]
    if probe_valid is not None:
        hit = torch.where(probe_valid.to(torch.bool), hit, nb)
    return torch.where(hit < nb, hit, -1)


def _take_words(match: torch.Tensor, src) -> Tuple[torch.Tensor, list]:
    matched = match >= 0
    idx = match.clamp(min=0)
    zero = torch.zeros((), dtype=torch.int32, device=match.device)
    words = []
    for w in src:
        w = w.to(torch.int32)
        g = w[idx] if w.shape[0] else torch.zeros_like(idx, dtype=torch.int32)
        words.append(torch.where(matched, g, zero))
    return matched, words


def propagate_join(build_keys: Sequence[torch.Tensor],
                   build_valid: Optional[torch.Tensor],
                   probe_keys: Sequence[torch.Tensor],
                   probe_valid: Optional[torch.Tensor],
                   build_words: Sequence[torch.Tensor], *,
                   hash_mask: int = -1) -> PropagateResult:
    """N:1 / ANY / SEMI / ANTI join by hash table (K8, one build and one
    probe): each valid probe row matches the smallest build row id among
    the valid build rows with its keys, and takes that row's 32-bit words
    (0 where unmatched).

    build_keys, probe_keys -- the join keys, pairwise of one unified type
    build_words -- int32 (Nb,) words of the build-side output columns
    hash_mask -- a test hook: the kernel's 64-bit hash is ANDed with it (0
        makes every row's hash equal); the result does not depend on it
    """
    bw, pw = _key_pairs("propagate_join", build_keys, probe_keys)
    nb, n = bw[0].shape[0], pw[0].shape[0]
    dev = pw[0].device
    for b, p in zip(bw, pw):
        _check_rows("propagate_join", b, nb, dev)
        _check_rows("propagate_join", p, n, dev)
    _check_rows("propagate_join", build_valid, nb, dev)
    _check_rows("propagate_join", probe_valid, n, dev)
    for w in build_words:
        _check_rows("propagate_join", w, nb, dev)
    if nb >= 1 << 30 or n >= 1 << 31:
        raise ValueError(f"propagate_join: {nb} build and {n} probe rows")
    if _route("propagate_join", dev):
        buckets = _hash_build_cuda(bw, _bool(build_valid), hash_mask)
        matched, words = _hash_probe_cuda(bw, pw, buckets, _bool(probe_valid),
                                          list(build_words), hash_mask)
        _native.count_launch("hash_join", n)
        return PropagateResult(matched=matched, words=words)
    matched, words = _take_words(
        _first_match_plain(bw, build_valid, pw, probe_valid), build_words)
    return PropagateResult(matched=matched, words=words)


def build_join_table(keys: Sequence[torch.Tensor],
                     row_valid: torch.Tensor, group_capacity: int, *,
                     max_bytes: Optional[int] = None,
                     secondary: Sequence[sort_ops.SortKey] = ()
                     ) -> JoinTable:
    """The 1:N join's build side: its rows grouped by key (K4, K5), and, on
    the card, K8's table over the unique keys (group index a bucket).
    max_bytes: the grouping's limit on its working set; secondary: keys
    ordering each key's rows (ASOF's token), stably."""
    _check_key_count(len(keys))
    g = agg_ops.group_by_sort([sort_ops.SortKey(k) for k in keys],
                              row_valid, group_capacity, max_bytes=max_bytes,
                              secondary=secondary)
    gidx = torch.arange(group_capacity, dtype=torch.int64,
                        device=g.num_groups.device)
    real = gidx < g.num_groups
    seg_len = torch.where(real, g.ends - g.starts, 0).to(torch.int32)
    key_cols = list(g.unique_keys)
    buckets = None
    if _route("build_join_table", g.num_groups.device):
        # sized by the group capacity: the group count stays on the device
        # (reading it would stall the host mid-query)
        buckets = _hash_build_cuda(key_words(key_cols), real)
        _native.count_launch("hash_join", group_capacity)
    return JoinTable(key_cols=key_cols,
                     seg_start=g.starts.to(torch.int32), seg_len=seg_len,
                     row_order=g.perm, num_groups=g.num_groups,
                     buckets=buckets)


def probe_join_table(table: JoinTable, probe_keys: Sequence[torch.Tensor],
                     probe_valid: Optional[torch.Tensor]) -> ProbeResult:
    """Each probe row's group: matched, and the group's (seg_start,
    seg_len) into row_order (0, 0 where unmatched) (K8's probe)."""
    bw, pw = _key_pairs("probe_join_table", table.key_cols, probe_keys)
    n = pw[0].shape[0]
    dev = pw[0].device
    for p in pw:
        _check_rows("probe_join_table", p, n, dev)
    _check_rows("probe_join_table", probe_valid, n, dev)
    src = [table.seg_start, table.seg_len]
    if _route("probe_join_table", dev):
        if table.buckets is None:
            raise ValueError("probe_join_table: the table has no buckets")
        matched, (ss, sl) = _hash_probe_cuda(bw, pw, table.buckets,
                                             _bool(probe_valid), src)
        _native.count_launch("hash_join", n)
        return ProbeResult(matched=matched, seg_start=ss, seg_len=sl)
    real = torch.arange(table.group_capacity, device=dev) < table.num_groups
    matched, (ss, sl) = _take_words(
        _first_match_plain(bw, real, pw, probe_valid), src)
    return ProbeResult(matched=matched, seg_start=ss, seg_len=sl)


# -- K9: match expansion ------------------------------------------------------

def expand_matches(probe: ProbeResult, probe_valid: Optional[torch.Tensor],
                   out_capacity: int, left: bool = False,
                   any_join: bool = False, n_rows: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """Expand 1-to-N matches into output row pairs (K9).

    A probe row is valid below `n_rows` (None: every row) where
    `probe_valid` holds (None: everywhere), the parts K1 takes.

    Returns (probe_row_idx, build_pos, match_mask, out_count):
      probe_row_idx[j] -- int32 source probe row of output row j
      build_pos[j]     -- int32 key-sorted build position (index into
                          row_order; 0 for LEFT-join null rows)
      match_mask[j]    -- False for LEFT-join null rows and past out_count
      out_count        -- 0-d int64: the output rows needed, which may
                          exceed out_capacity (the caller's check)
    Slots at or past out_count hold 0, 0, False.
    """
    n = probe.matched.shape[0]
    dev = probe.matched.device
    for t in (probe.seg_start, probe.seg_len, probe_valid):
        _check_rows("expand_matches", t, n, dev)
    if not 1 <= out_capacity < 1 << 31 or n >= 1 << 31:
        raise ValueError(f"expand_matches: {n} probe rows, out_capacity "
                         f"{out_capacity}")
    n_rows = n if n_rows is None else max(0, min(int(n_rows), n))
    if _route("expand_matches", dev):
        return _expand_matches_cuda(probe, probe_valid, out_capacity, left,
                                    any_join, n_rows)
    return _expand_matches_plain(probe, probe_valid, out_capacity, left,
                                 any_join, n_rows)


def expand_matches_bytes(n: int, out_capacity: int) -> int:
    """Device bytes an expand_matches call over n probe rows allocates: 9
    bytes a slot (row, build position, flag), the count, and K9's status
    words (a look-back word a tile, the tile counter, two spill words an
    output tile)."""
    words = -(-n // _EXPAND_TILE) + 1 + 2 * -(-out_capacity // _EXPAND_SLOTS)
    return 9 * out_capacity + 8 + 8 * words


def _expand_lengths(matched, valid, seg_len, left, any_join):
    lens = torch.where(matched & valid, seg_len.to(torch.int64), 0)
    if any_join:
        lens = torch.clamp(lens, max=1)
    if left:
        lens = torch.where(valid, torch.clamp(lens, min=1), 0)
    return lens


def _expand_matches_cuda(probe, probe_valid, out_cap, left, any_join,
                         n_rows, heavy=EXPAND_HEAVY_SLOTS):
    dev = probe.matched.device
    n = probe.matched.shape[0]
    matched, valid = _bool(probe.matched), _bool(probe_valid)
    seg_start = probe.seg_start.to(torch.int32).contiguous()
    seg_len = probe.seg_len.to(torch.int32).contiguous()
    tiles = -(-n // _EXPAND_TILE)
    words = tiles + 1 + 2 * -(-out_cap // _EXPAND_SLOTS)
    out_count = torch.empty((), dtype=torch.int64, device=dev)
    status = torch.empty(words, dtype=torch.int64, device=dev)
    p_idx = torch.empty(out_cap, dtype=torch.int32, device=dev)
    build_pos = torch.empty(out_cap, dtype=torch.int32, device=dev)
    mask = torch.empty(out_cap, dtype=torch.bool, device=dev)
    ins = [t for t in (matched, valid, seg_start, seg_len) if t is not None]
    args = _native.K9Args(
        matched=matched.data_ptr(),
        valid=None if valid is None else valid.data_ptr(),
        seg_start=seg_start.data_ptr(), seg_len=seg_len.data_ptr(), n=n,
        n_rows=n_rows, out_cap=out_cap, heavy=heavy, left=int(left),
        any_join=int(any_join),
        vec=int(all(t.data_ptr() % 16 == 0 for t in ins)), tiles=tiles,
        out_count=out_count.data_ptr(), status=status.data_ptr(),
        p_idx=p_idx.data_ptr(), build_pos=build_pos.data_ptr(),
        mask=mask.data_ptr())
    rc = _native.library().chtt_expand_matches(ctypes.byref(args),
                                               _native.stream_ptr(dev))
    _native.check(rc, "expand_matches")
    _native.count_launch("expand_matches", n)
    return p_idx, build_pos, mask, out_count


def _expand_matches_plain(probe, probe_valid, out_cap, left, any_join,
                          n_rows=None):
    """Plain PyTorch version of K9: the slot's row by a binary search of
    the cumulative lengths."""
    dev = probe.matched.device
    n = probe.matched.shape[0]
    valid = torch.arange(n, device=dev) < (n if n_rows is None else n_rows)
    if probe_valid is not None:
        valid = valid & probe_valid.to(torch.bool)
    matched = probe.matched.to(torch.bool)
    lens = _expand_lengths(matched, valid, probe.seg_len, left, any_join)
    cum = torch.cumsum(lens, 0)
    out_count = cum[-1] if n else torch.zeros((), dtype=torch.int64,
                                              device=dev)
    j = torch.arange(out_cap, dtype=torch.int64, device=dev)
    live = j < out_count
    p = torch.searchsorted(cum, j, right=True).clamp(max=max(n - 1, 0))
    p = torch.where(live, p, 0)
    if n:
        first = (cum - lens)[p]
        bpos = probe.seg_start.to(torch.int64)[p] + (j - first)
        hit = (matched & valid)[p]
    else:
        bpos = torch.zeros_like(j)
        hit = torch.zeros_like(live)
    return (p.to(torch.int32), torch.where(live, bpos, 0).to(torch.int32),
            live & hit, out_count)
