"""Query result: host-side materialized columns + pretty rendering."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Result"]


@dataclasses.dataclass
class Result:
    columns: Dict[str, np.ndarray]
    types: List[Tuple[str, str]]             # (name, type string)
    rows_read: int = 0
    elapsed_s: float = 0.0
    totals: Optional[Dict[str, np.ndarray]] = None

    @property
    def row_count(self) -> int:
        for v in self.columns.values():
            return len(v)
        return 0

    @property
    def column_names(self) -> List[str]:
        return list(self.columns.keys())

    def column(self, name: str) -> np.ndarray:
        return self.columns[name]

    def rows(self) -> List[tuple]:
        cols = [self._pylist(v) for v in self.columns.values()]
        return list(zip(*cols)) if cols else []

    def scalar(self) -> Any:
        r = self.rows()
        if len(r) != 1 or len(r[0]) != 1:
            raise ValueError("Result is not a single scalar")
        return r[0][0]

    def pydict(self) -> Dict[str, np.ndarray]:
        return self.columns

    def to_pandas(self):
        import pandas as pd
        return pd.DataFrame({k: self._pylist(v)
                             for k, v in self.columns.items()})

    @staticmethod
    def _pylist(v: np.ndarray) -> list:
        if v.ndim == 2:           # AggregateFunction states: a row's bytes
            return [row.tobytes() for row in v]
        out = []
        for x in v:
            if isinstance(x, np.integer):
                out.append(int(x))
            elif isinstance(x, np.floating):
                out.append(float(x))
            elif isinstance(x, np.str_):
                out.append(str(x))
            else:
                out.append(x)
        return out

    # -- text rendering (PrettyCompact-style) --------------------------------
    def __repr__(self) -> str:
        names = self.column_names
        if not names:
            return "(empty result)"
        rows = self.rows()
        cells = [[_fmt(x) for x in row] for row in rows[:50]]
        widths = [max([len(n)] + [len(r[i]) for r in cells])
                  for i, n in enumerate(names)]
        sep = "─"
        header = "  ".join(n.ljust(w) for n, w in zip(names, widths))
        line = "  ".join(sep * w for w in widths)
        body = "\n".join("  ".join(c.ljust(w) for c, w in zip(row, widths))
                         for row in cells)
        suffix = "" if len(rows) <= 50 else f"\n... ({len(rows)} rows total)"
        return f"{header}\n{line}\n{body}{suffix}"


def _fmt(x) -> str:
    if x is None:
        return "ᴺᵁᴸᴸ"
    if isinstance(x, float):
        return repr(round(x, 10))
    from ..core.typed import format_value
    return format_value(x)
