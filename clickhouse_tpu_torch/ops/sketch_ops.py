"""HyperLogLog registers: K16's update, merge and finalize.

The state of uniq (exprs/agg_sketch.HLLUniqAgg) is a (groups, m) uint8
tensor: register r of a group in byte r of its row, which is the
reference's (groups, m / 8) u64 limb matrix byte for byte (limb l holds
register 8l + k in byte k, little-endian).  A register is the largest
rho of the rows that fall in it: a row's register is h & (m - 1) and its
rho 1 + the count of trailing zeros of (h >> log2 m) | 2^(64 - log2 m),
h its row hash (hash_ops.hash_columns).  The registers depend only on the
set of (group, hash) pairs, not on the order of the rows.

Reference: HLLUniqAgg.update / merge / finalize
(clickhouse_tpu/exprs/agg_sketch.py:301-370), which sorts the rows by
(keys, register, -rho) because the TPU has no scatter; K16 (csrc/hll.cu)
takes each row's group from the query's own grouping and maxes the
(group, register) byte in place.  Its update has two ways in: in row
order (:func:`hll_update` under GROUP BY (), :func:`hll_update_rows`
where the GROUP BY keys have small proven ranges: a row's slot from its
keys into u32 cells, which :func:`hll_cells` copies into the groups by a
slot -> group table from the grouping's unique keys), and through the
sort grouping's perm and group ids (:func:`hll_update`).

Each entry takes its plain version for CPU tensors and launches its kernel
for CUDA tensors (or raises).
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Sequence

import torch

from . import _native
from .hash_ops import (MAX_HASH_COLS, HashArg, _check_args, _fold, _n_rows,
                       fold_args, hash_cols, plain_values)

__all__ = ["hll_update", "hll_update_rows", "hll_cells", "hll_merge",
           "hll_finalize", "hll_update_bytes", "hll_cells_bytes",
           "hll_merge_bytes", "hll_finalize_bytes", "hll_slot_table",
           "hll_rows_scratch_bytes", "SlotKey",
           "HLL_ROWS_MAX_CELLS", "MAX_SLOT_KEYS",
           "log2_of"]

# the row-order update's keys at most (csrc/hll.cu kMaxSlotKeys)
MAX_SLOT_KEYS = _native.K16_MAX_SLOT_KEYS
# the row-order update's registers (the product of the keys' spans times
# m) at most: a u32 cell each in device memory, 16 MB (on an H100,
# PERF.md: 0.89 ms at 1,024 slots of 4,096 registers against the perm
# entry's 3.32); a larger key space takes the perm entry
HLL_ROWS_MAX_CELLS = 1 << 22


@dataclasses.dataclass(frozen=True)
class SlotKey:
    """One GROUP BY key of the row-order update: its values as stored (a
    bool or integer tensor; 0-d: one value for every row), the least value
    lo of its proven range and the range's span.  A row's slot is its
    keys' digits (value - lo) in mixed radix, the first key varying
    fastest (agg_ops.group_by_dense's slot)."""
    data: torch.Tensor
    lo: int
    span: int


def log2_of(m: int) -> int:
    """log2 of a register count m, a power of two in [64, 4096]."""
    if m < 64 or m > 4096 or m & (m - 1):
        raise ValueError(f"hll: {m} registers (a power of two, 64-4096)")
    return m.bit_length() - 1


def _device(args: Sequence[HashArg]) -> torch.device:
    return args[0].tensor().device


def hll_update(args: Sequence[HashArg], m: int, cap_g: int, *,
               n_rows: Optional[int] = None,
               perm: Optional[torch.Tensor] = None,
               gid: Optional[torch.Tensor] = None,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (cap_g, m) uint8 registers of the rows, hashed over `args`.

    GROUP BY () (perm and gid None): the rows below n_rows where `mask`
    holds, all in group 0.  The sort grouping: perm (int32, a sorted
    position's row) and gid (int32, its group, cap_g or more for a row of
    no group), the rows where the raw-order `mask` holds.  mask: bool or
    None (every row)."""
    log2m = log2_of(m)
    _check_args(args)
    if (perm is None) != (gid is None):
        raise ValueError("hll_update: perm and gid go together")
    dev = _device(args)
    if perm is None:
        n = _rows(args, n_rows)
    else:
        if perm.shape != gid.shape or perm.dim() != 1:
            raise ValueError("hll_update: perm and gid of one length")
        n = perm.shape[0]
    if mask is not None and mask.dtype != torch.bool:
        raise ValueError("hll_update: mask must be bool")
    if dev.type == "cpu":
        return _hll_update_plain(args, log2m, cap_g, n, perm, gid, mask)
    if dev.type != "cuda":
        raise RuntimeError(f"hll_update: no kernel for {dev}")
    args = fold_args(args, MAX_HASH_COLS)
    if perm is None:
        return _hll_rows_cuda(args, log2m, cap_g, n, [], None, mask)
    return _hll_update_cuda(args, log2m, cap_g, n, perm, gid, mask)


def hll_update_rows(args: Sequence[HashArg], m: int, cap_g: int,
                    keys: Sequence[SlotKey], table: torch.Tensor, *,
                    n_rows: Optional[int] = None,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (cap_g, m) uint8 registers of a sort grouping's rows taken in
    row order: a row's slot from its `keys` (SlotKey), its group
    table[slot] (int32, one entry a slot, -1: no group), the rows below
    n_rows where the raw-order `mask` holds (bool; None: every row).  A
    row whose key lies outside its range, or whose slot has no group,
    counts nowhere.  The same registers as :func:`hll_update` through
    the grouping's perm and group ids, bit for bit: the registers depend
    only on the (group, hash) pairs."""
    log2m = log2_of(m)
    _check_args(args)
    keys = list(keys)
    if not keys or len(keys) > MAX_SLOT_KEYS:
        raise ValueError(f"hll_update_rows: 1 to {MAX_SLOT_KEYS} keys")
    slots = math.prod(k.span for k in keys)
    if table.dim() != 1 or table.shape[0] != slots \
            or table.dtype != torch.int32:
        raise ValueError("hll_update_rows: table must be int32, one entry "
                         "a slot")
    for k in keys:
        if k.data.is_floating_point() or k.data.dim() > 1 or k.span < 1:
            raise ValueError("hll_update_rows: keys are bool or integer "
                             "tensors with a span of 1 or more")
    if mask is not None and mask.dtype != torch.bool:
        raise ValueError("hll_update_rows: mask must be bool")
    n = _rows_of_keys(args, keys, mask, n_rows)
    dev = _device(args)
    if dev.type == "cpu":
        return _hll_update_rows_plain(args, log2m, cap_g, n, keys, table,
                                      mask)
    if dev.type != "cuda":
        raise RuntimeError(f"hll_update_rows: no kernel for {dev}")
    return _hll_rows_cuda(fold_args(args, MAX_HASH_COLS), log2m, cap_g, n,
                          keys, table, mask)


def _rows_of_keys(args, keys, mask, n_rows) -> int:
    """The rows a row-order update reads: the first column's, key's or
    mask's length, cut to n_rows."""
    cap = _n_rows(args)
    if cap is None:
        cap = next((k.data.shape[0] for k in keys if k.data.dim() == 1),
                   mask.shape[0] if mask is not None else int(n_rows or 0))
    return cap if n_rows is None else max(0, min(int(n_rows), cap))


def hll_slot_table(unique_keys: Sequence[torch.Tensor],
                   num_groups: torch.Tensor, keys: Sequence[SlotKey]
                   ) -> Optional[torch.Tensor]:
    """The slot -> group table (int32, one entry a slot, -1: no group) of
    a sort grouping whose groups' keys are `unique_keys` (each (cap_g,),
    in the order of `keys`), or None where a group's key lies outside
    its key's range or the groups outnumber the slots: one host read.

    A group's unique keys are its rows' keys, so when every group's key
    lies in range, so does every row's.  Distinct keys in range have
    distinct slots, so the groups fit min(cap_g, slots) rows; only those
    are read."""
    slots = math.prod(k.span for k in keys)
    dev = num_groups.device
    g = min(unique_keys[0].shape[0], slots)
    idx = torch.arange(g, device=dev)
    valid = idx < num_groups
    slot = torch.zeros(g, dtype=torch.int64, device=dev)
    inside = torch.ones(g, dtype=torch.bool, device=dev)
    mult = 1
    for uk, k in zip(unique_keys, keys):
        d = uk[:g].to(torch.int64) - k.lo
        inside &= (d >= 0) & (d < k.span)
        slot += d * mult
        mult *= k.span
    if bool((num_groups > slots) | (valid & ~inside).any()):
        return None
    table = torch.full((slots + 1,), -1, dtype=torch.int32, device=dev)
    table.scatter_(0, torch.where(valid, slot, slots), idx.to(torch.int32))
    return table[:slots]


def _rows(args: Sequence[HashArg], n_rows: Optional[int]) -> int:
    """The rows an update reads: the columns' length (n_rows where every
    arg is 0-d), cut to n_rows."""
    cap = _n_rows(args)
    cap = cap if cap is not None else int(n_rows or 0)
    return cap if n_rows is None else max(0, min(int(n_rows), cap))


def _reg_rho(h: torch.Tensor, log2m: int):
    """(register, rho) of row hashes h (int64 bits), in plain torch."""
    reg = h & ((1 << log2m) - 1)
    w = (h >> log2m) & ((1 << (64 - log2m)) - 1)
    wg = w | (1 << (64 - log2m))
    low = wg & -wg                         # the lowest set bit, 2^ctz
    rho = torch.frexp(low.to(torch.float64)).exponent   # ctz + 1
    return reg, rho.to(torch.uint8)


def _hll_update_plain(args, log2m, cap_g, n, perm, gid, mask):
    m = 1 << log2m
    dev = _device(args)
    state = torch.zeros(cap_g * m, dtype=torch.uint8, device=dev)
    if perm is None:
        rows = torch.arange(n, dtype=torch.int64, device=dev)
        g = torch.zeros(n, dtype=torch.int64, device=dev)
    else:
        keep = (gid >= 0) & (gid < cap_g)
        rows = perm.to(torch.int64)[keep]
        g = gid.to(torch.int64)[keep]
    if mask is not None:
        sel = mask[rows]
        rows, g = rows[sel], g[sel]
    if rows.numel() == 0:
        return state.view(cap_g, m)
    vals = [v[rows] for v in plain_values(args, _rows(args, None) or n)]
    reg, rho = _reg_rho(_fold(vals, args[0].kind), log2m)
    state.scatter_reduce_(0, g * m + reg, rho, "amax")
    return state.view(cap_g, m)


def _hll_update_rows_plain(args, log2m, cap_g, n, keys, table, mask):
    """hll_update_rows in plain torch: the rows in row order, each row's
    slot and group, scatter_reduce_(..., "amax") of its rho."""
    m = 1 << log2m
    dev = _device(args)
    state = torch.zeros(cap_g * m, dtype=torch.uint8, device=dev)
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    if mask is not None:
        rows = rows[mask[:n]]
    slot = torch.zeros_like(rows)
    inside = torch.ones_like(rows, dtype=torch.bool)
    mult = 1
    for k in keys:
        v = (k.data[:n] if k.data.dim() else k.data.expand(n))[rows] \
            .to(torch.int64) - k.lo
        inside &= (v >= 0) & (v < k.span)
        slot += v * mult
        mult *= k.span
    g = table.to(torch.int64)[slot.clamp(0, mult - 1)]
    keep = inside & (g >= 0) & (g < cap_g)
    rows, g = rows[keep], g[keep]
    if rows.numel() == 0:
        return state.view(cap_g, m)
    vals = [v[rows] for v in plain_values(args, _rows(args, None) or n)]
    reg, rho = _reg_rho(_fold(vals, args[0].kind), log2m)
    state.scatter_reduce_(0, g * m + reg, rho, "amax")
    return state.view(cap_g, m)


def _hll_args(args, log2m, cap_g, n, mask, state):
    """K16Args of an update (one slot: GROUP BY () or through perm) and
    the tensors to keep alive while it runs; state None: none given."""
    cols, keep = hash_cols(args)
    a = _native.K16Args()
    for i in range(len(args)):
        a.cols[i] = cols[i]
    a.n_cols, a.log2m, a.n, a.cap_g, a.slots = len(args), log2m, n, cap_g, 1
    if mask is not None:
        mask = mask.contiguous()
        keep.append(mask)
        a.mask = mask.data_ptr()
    if state is not None:
        a.state = state.data_ptr()
    return a, keep


def _hll_update_cuda(args, log2m, cap_g, n, perm, gid, mask):
    dev = _device(args)
    state = torch.zeros((cap_g, 1 << log2m), dtype=torch.uint8, device=dev)
    if n == 0:
        return state
    a, keep = _hll_args(args, log2m, cap_g, n, mask, state)
    perm, gid = perm.contiguous(), gid.contiguous()
    if perm.dtype != torch.int32 or gid.dtype != torch.int32:
        raise ValueError("hll_update: perm and gid must be int32")
    a.perm, a.gid = perm.data_ptr(), gid.data_ptr()
    rc = _native.library().chtt_hll_update(
        ctypes.byref(a), _native.grid_blocks(dev, n, per_sm=16),
        _native.stream_ptr(dev))
    _native.check(rc, "hll_update")
    _native.count_launch("hll_update", n)
    del keep
    return state


def hll_rows_scratch_bytes(keys: Sequence[SlotKey], m: int, device) -> int:
    """Device bytes a keyed row-order update takes beside its state: its
    u32 cells and an int32 copy of each key stored in another type (4
    bytes a row); none on the CPU."""
    if torch.device(device).type != "cuda":
        return 0
    copies = sum(4 * k.data.shape[0] for k in keys
                 if k.data.dim() == 1 and k.data.dtype != torch.int32)
    return 4 * math.prod(k.span for k in keys) * m + copies


def _int32_key(k: SlotKey):
    """(int32 values, least value) of a key as the kernel reads it: an
    int32 key as it is; another as its digits value - lo (one pass; a
    value outside the range as -1, which no slot takes)."""
    if k.data.dtype == torch.int32:
        return k.data.contiguous(), k.lo
    d = k.data.to(torch.int64) - k.lo
    d = torch.where((d < 0) | (d >= k.span), -1, d)
    return d.to(torch.int32).contiguous(), 0


def _hll_rows_cuda(args, log2m, cap_g, n, keys, table, mask):
    """K16's row-order update, one launch at its instance's occupancy:
    GROUP BY () (no key) into the state (each block's registers in shared
    memory, byte-maxed into it at the block's end); keyed into u32 cells
    in device memory, which hll_cells copies into the slots' groups."""
    dev = _device(args)
    m = 1 << log2m
    if n == 0:
        return torch.zeros((cap_g, m), dtype=torch.uint8, device=dev)
    state = None if keys else torch.zeros((cap_g, m), dtype=torch.uint8,
                                          device=dev)
    a, keep = _hll_args(args, log2m, cap_g, n, mask, state)
    slots = 1
    for i, k in enumerate(keys):
        t, lo = _int32_key(k)
        keep.append(t)
        sk = a.keys[i]
        sk.data, sk.lo, sk.span, sk.mult = t.data_ptr(), lo, k.span, slots
        sk.stride = int(t.dim() == 1)
        slots *= k.span
    a.n_keys, a.slots = len(keys), slots
    if keys:
        cells = torch.zeros((slots, m), dtype=torch.int32, device=dev)
        a.cells = cells.data_ptr()
    lib = _native.library()
    occ = lib.chtt_hll_rows_per_sm(ctypes.byref(a))
    if occ < 1:
        raise ValueError(f"hll_update: K16 refuses {slots} slots of {m} "
                         f"registers")
    counter = "hll_update_rows" if keys else "hll_update"
    rc = lib.chtt_hll_update(ctypes.byref(a), _native.grid_blocks(
        dev, n, per_sm=occ), _native.stream_ptr(dev))
    _native.check(rc, counter)
    _native.count_launch(counter, n)
    del keep
    return hll_cells(cells, table, cap_g) if keys else state


def hll_cells(cells: torch.Tensor, table: torch.Tensor,
              cap_g: int) -> torch.Tensor:
    """The (cap_g, m) uint8 state of a keyed row-order update's (slots, m)
    int32 register cells (each 0-65): slot s's registers as bytes in row
    table[s] (int32, one entry a slot, distinct; -1 or cap_g and above:
    none), the other rows 0."""
    if cells.dim() != 2 or cells.dtype != torch.int32:
        raise ValueError("hll_cells: cells must be (slots, m) int32")
    log2m = log2_of(cells.shape[1])
    if table.dim() != 1 or table.shape[0] != cells.shape[0] \
            or table.dtype != torch.int32:
        raise ValueError("hll_cells: table must be int32, one entry a slot")
    if cells.device.type == "cpu":
        return _hll_cells_plain(cells, table, cap_g)
    if cells.device.type != "cuda":
        raise RuntimeError(f"hll_cells: no kernel for {cells.device}")
    state = torch.zeros((cap_g, 1 << log2m), dtype=torch.uint8,
                        device=cells.device)
    cells = _native.aligned16(cells.contiguous())
    table = table.contiguous()
    rc = _native.library().chtt_hll_cells(
        cells.data_ptr(), cells.shape[0], log2m, table.data_ptr(), cap_g,
        state.data_ptr(), _native.stream_ptr(cells.device))
    _native.check(rc, "hll_cells")
    _native.count_launch("hll_cells", cells.shape[0])
    return state


def _hll_cells_plain(cells, table, cap_g):
    state = torch.zeros((cap_g, cells.shape[1]), dtype=torch.uint8,
                        device=cells.device)
    g = table.to(torch.int64)
    ok = (g >= 0) & (g < cap_g)
    state[g[ok]] = cells[ok].to(torch.uint8)
    return state


def hll_cells_bytes(slots: int, m: int, cap_g: int) -> int:
    """Bytes hll_cells moves: the cells (4 bytes a register) and the table
    read once, the state written once."""
    return 4 * slots * m + 4 * slots + cap_g * m


def hll_update_bytes(args: Sequence[HashArg], n: int, cap_g: int, m: int,
                     sorted_rows: bool = False,
                     keys: Sequence[SlotKey] = (),
                     mask: Optional[torch.Tensor] = None) -> int:
    """Bytes K16's update moves: each column and key as stored read once a
    row, the mask (a byte a row) where given, through perm perm and gid
    (4 bytes each a row), the state written once."""
    cols = sum(n * t.element_size() for t in
               [a.tensor() for a in args] + [k.data for k in keys]
               if t.dim() == 1)
    return cols + (n if mask is not None else 0) \
        + (8 * n if sorted_rows else 0) + cap_g * m


def hll_merge(states: torch.Tensor, n_groups: int, *,
              starts: Optional[torch.Tensor] = None,
              ends: Optional[torch.Tensor] = None,
              perm: Optional[torch.Tensor] = None,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n_groups, m) uint8: each group's per-byte max over its partial
    states' rows (a row where `mask` holds; none: 0).  The groups' rows
    are sorted positions [starts[g], ends[g]) read through perm (K5's and
    the sort's, int64 and int32); starts None: group 0 is every row of
    `states`, the others none (GROUP BY ())."""
    if states.dim() != 2 or states.dtype != torch.uint8:
        raise ValueError("hll_merge: states must be (rows, m) uint8")
    log2m = log2_of(states.shape[1])
    if (starts is None) != (ends is None) or (perm is not None
                                              and starts is None):
        raise ValueError("hll_merge: starts, ends and perm go together")
    if mask is not None and mask.dtype != torch.bool:
        raise ValueError("hll_merge: mask must be bool")
    if states.device.type == "cpu":
        return _hll_merge_plain(states, n_groups, starts, ends, perm, mask)
    if states.device.type != "cuda":
        raise RuntimeError(f"hll_merge: no kernel for {states.device}")
    return _hll_merge_cuda(states, n_groups, log2m, starts, ends, perm, mask)


def _hll_merge_plain(states, n_groups, starts, ends, perm, mask):
    n_in, m = states.shape
    dev = states.device
    out = torch.zeros((n_groups, m), dtype=torch.uint8, device=dev)
    if starts is None:
        rows = torch.arange(n_in, device=dev)
        g = torch.zeros(n_in, dtype=torch.int64, device=dev)
        if n_groups == 0:
            return out
    else:
        lens = (ends - starts).clamp(min=0)
        g = torch.repeat_interleave(torch.arange(n_groups, device=dev), lens)
        first = torch.repeat_interleave(starts, lens)
        pos = first + torch.arange(g.shape[0], device=dev) - \
            torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens)
        rows = pos if perm is None else perm.to(torch.int64)[pos]
    if mask is not None:
        sel = mask[rows]
        rows, g = rows[sel], g[sel]
    idx = (g * m)[:, None] + torch.arange(m, device=dev)[None, :]
    flat = out.view(-1)
    flat.scatter_reduce_(0, idx.reshape(-1), states[rows].reshape(-1),
                         "amax")
    return out


def _hll_merge_cuda(states, n_groups, log2m, starts, ends, perm, mask):
    dev = states.device
    m = 1 << log2m
    out = torch.empty((n_groups, m), dtype=torch.uint8, device=dev)
    if n_groups == 0:
        return out
    states = states.contiguous()
    keep = [states]

    def ptr(t, dtype):
        if t is None:
            return None
        if t.dtype != dtype:
            raise ValueError(f"hll_merge: {t.dtype}, want {dtype}")
        t = t.contiguous()
        keep.append(t)
        return t.data_ptr()
    rc = _native.library().chtt_hll_merge(
        states.data_ptr(), ptr(starts, torch.int64), ptr(ends, torch.int64),
        ptr(perm, torch.int32), ptr(mask, torch.bool), states.shape[0],
        n_groups, log2m, out.data_ptr(),
        _native.grid_blocks(dev, n_groups * m // 4, per_sm=8),
        _native.stream_ptr(dev))
    _native.check(rc, "hll_merge")
    _native.count_launch("hll_merge", states.shape[0])
    del keep
    return out


def hll_merge_bytes(states: torch.Tensor, n_groups: int, *,
                    starts: Optional[torch.Tensor] = None,
                    ends: Optional[torch.Tensor] = None,
                    perm: Optional[torch.Tensor] = None,
                    mask: Optional[torch.Tensor] = None) -> int:
    """Bytes K16's merge moves on these inputs (hll_merge's): each group's
    bounds (16 bytes) and merged registers written; each row in a group
    its perm entry and mask byte; each row that takes part its registers
    (the rows in no group and the masked-out rows' are not read)."""
    n_in, m = states.shape
    if starts is None:
        pos = torch.arange(n_in, device=states.device)
    else:
        lens = (ends - starts).clamp(min=0)
        pos = torch.repeat_interleave(starts, lens) + torch.arange(
            int(lens.sum()), device=states.device) - torch.repeat_interleave(
                torch.cumsum(lens, 0) - lens, lens)
    rows = pos if perm is None else perm.to(torch.int64)[pos]
    taking = int(mask[rows].sum()) if mask is not None else rows.numel()
    per_row = (4 if perm is not None else 0) + (1 if mask is not None else 0)
    return n_groups * (m + (16 if starts is not None else 0)) \
        + rows.numel() * per_row + taking * m


def hll_finalize(state: torch.Tensor) -> torch.Tensor:
    """The (groups,) int64 estimates of (groups, m) uint8 registers: the
    reference's formula in float32 (Z = sum of 2^-register, V = zero
    registers, alpha = 0.7213 / (1 + 1.079 / m), E = alpha m^2 / Z, m
    ln(m / V) where E <= 2.5 m and V > 0), rounded half to even."""
    if state.dim() != 2 or state.dtype != torch.uint8:
        raise ValueError("hll_finalize: state must be (groups, m) uint8")
    log2m = log2_of(state.shape[1])
    if state.device.type == "cpu":
        return _hll_finalize_plain(state)
    if state.device.type != "cuda":
        raise RuntimeError(f"hll_finalize: no kernel for {state.device}")
    return _hll_finalize_cuda(state, log2m)


def _hll_finalize_plain(state: torch.Tensor) -> torch.Tensor:
    """hll_finalize in plain torch, summing as the reference does: for
    each byte k of a limb, the sum over the limbs in float32, added in
    order k = 0..7."""
    g, m = state.shape
    b = state.view(g, m // 8, 8).to(torch.int32)
    z = torch.zeros(g, dtype=torch.float32, device=state.device)
    v = torch.zeros(g, dtype=torch.int32, device=state.device)
    for k in range(8):
        bk = b[:, :, k]
        z = z + torch.sum(torch.exp2(-bk.to(torch.float32)), dim=1)
        v = v + torch.sum((bk == 0).to(torch.int32), dim=1)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    f32 = {"dtype": torch.float32, "device": state.device}
    e = torch.tensor(alpha * m * m, **f32) / torch.clamp(z, min=1e-9)
    lc = m * torch.log(torch.tensor(m, **f32)
                       / torch.clamp(v, min=1).to(torch.float32))
    e = torch.where((e <= 2.5 * m) & (v > 0), lc, e)
    return torch.round(e).to(torch.int64)


def _hll_finalize_cuda(state: torch.Tensor, log2m: int) -> torch.Tensor:
    dev = state.device
    g = state.shape[0]
    out = torch.empty(g, dtype=torch.int64, device=dev)
    if g == 0:
        return out
    state = _native.aligned16(state.contiguous())
    lanes = min(32, (1 << log2m) // 16)
    rc = _native.library().chtt_hll_finalize(
        state.data_ptr(), g, log2m, out.data_ptr(),
        _native.grid_blocks(dev, g * lanes, per_sm=8),
        _native.stream_ptr(dev))
    _native.check(rc, "hll_finalize")
    _native.count_launch("hll_finalize", g)
    return out


def hll_finalize_bytes(groups: int, m: int) -> int:
    """Bytes K16's finalize moves: the state read once, an int64 a group
    written."""
    return groups * m + 8 * groups
