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
(group, register) byte in place.

Each entry takes its plain version for CPU tensors and launches its kernel
for CUDA tensors (or raises).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from . import _native
from .hash_ops import (MAX_HASH_COLS, HashArg, _check_args, _fold, _n_rows,
                       fold_args, hash_cols, plain_values)

__all__ = ["hll_update", "hll_merge", "hll_finalize", "hll_update_bytes",
           "hll_merge_bytes", "hll_finalize_bytes", "log2_of"]


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
    return _hll_update_cuda(fold_args(args, MAX_HASH_COLS), log2m, cap_g, n,
                            perm, gid, mask)


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


def _hll_update_cuda(args, log2m, cap_g, n, perm, gid, mask):
    dev = _device(args)
    state = torch.zeros((cap_g, 1 << log2m), dtype=torch.uint8, device=dev)
    if n == 0:
        return state
    cols, keep = hash_cols(args)
    a = _native.K16Args()
    for i in range(len(args)):
        a.cols[i] = cols[i]
    a.n_cols, a.log2m, a.n, a.cap_g = len(args), log2m, n, cap_g
    if perm is not None:
        perm, gid = perm.contiguous(), gid.contiguous()
        if perm.dtype != torch.int32 or gid.dtype != torch.int32:
            raise ValueError("hll_update: perm and gid must be int32")
        a.perm, a.gid = perm.data_ptr(), gid.data_ptr()
    if mask is not None:
        mask = mask.contiguous()
        a.mask = mask.data_ptr()
    a.state = state.data_ptr()
    # the shared-memory update flushes m registers a block: fewer blocks
    per_sm = 4 if perm is None else 16
    rc = _native.library().chtt_hll_update(
        ctypes.byref(a), _native.grid_blocks(dev, n, per_sm=per_sm),
        _native.stream_ptr(dev))
    _native.check(rc, "hll_update")
    _native.count_launch("hll_update", n)
    del keep
    return state


def hll_update_bytes(args: Sequence[HashArg], n: int, cap_g: int, m: int,
                     sorted_rows: bool) -> int:
    """Bytes K16's update moves: each column as stored read once a row,
    under the sort grouping perm and gid (4 bytes each a row), the state
    written once."""
    cols = sum(n * a.tensor().element_size() for a in args
               if a.tensor().dim() == 1)
    return cols + (8 * n if sorted_rows else 0) + cap_g * m


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
