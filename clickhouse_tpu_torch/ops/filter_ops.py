"""Filter helpers (reference: clickhouse_tpu/ops/filter_ops.py).

Filters stay masked (a predicate ANDs into the block's row mask), so the
slice needs only the count of selected rows, which K1 computes.
"""
from __future__ import annotations

from typing import Union

import torch

from .agg_ops import RowMask, masked_reduce

__all__ = ["count_mask"]


def count_mask(mask: Union[torch.Tensor, RowMask]) -> torch.Tensor:
    """Number of selected rows (0-d int64 tensor on the mask's device).  A
    RowMask hands its parts (row bound, terms, mask) to K1 as they are."""
    if isinstance(mask, RowMask):
        return mask.count()
    return masked_reduce("sum", None, mask.to(torch.bool))
