"""Filter helpers (reference: clickhouse_tpu/ops/filter_ops.py).

Filters stay masked (a predicate ANDs into the block's row mask), so the
slice needs only the count of selected rows, which K1 computes.
"""
from __future__ import annotations

import torch

from .agg_ops import masked_reduce

__all__ = ["count_mask"]


def count_mask(mask: torch.Tensor) -> torch.Tensor:
    """Number of selected rows (0-d int64 tensor on the mask's device)."""
    return masked_reduce("sum", mask.to(torch.bool), None)
