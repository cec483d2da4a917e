"""Block: a set of equal-capacity columns (reference:
clickhouse_tpu/core/block.py).

``num_rows`` is the number of valid leading rows; rows [num_rows,
capacity) are padding and must be masked by consumers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable

from .column import Column

__all__ = ["Block"]


@dataclasses.dataclass
class Block:
    columns: Dict[str, Column]
    num_rows: int

    @property
    def capacity(self) -> int:
        for c in self.columns.values():
            return c.capacity
        return 0

    def __getitem__(self, name: str) -> Column:
        return self.columns[name]

    def select(self, names: Iterable[str]) -> "Block":
        return Block({n: self.columns[n] for n in names}, self.num_rows)
