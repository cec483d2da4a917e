"""Load table data given as numpy arrays into a session of this engine.

Host arrays are the one format both engines share: a test reads the rows
of a reference (JAX) session's table into numpy and hands them here, so
both sessions answer over the same rows in the same order.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .core import dtypes as dt
from .storage.table import Table

__all__ = ["table_from_numpy"]


def table_from_numpy(session, name: str, columns: Dict[str, np.ndarray],
                     types: Dict[str, "dt.DType | str"],
                     database: str = None) -> Table:
    """Create table `name` in `session` with `types` (DType or type name
    per column, in the order of `columns`) and insert `columns` as one
    part.  Object arrays may hold None for NULL in Nullable columns."""
    db = database or session.catalog.current_database
    schema = []
    for col in columns:
        t = types[col]
        schema.append((col, dt.parse_type_name(t) if isinstance(t, str)
                       else t))
    table = Table(name, schema, device=session.device)
    session.catalog.create_table(db, table)
    table.insert_pydict({k: np.asarray(v) for k, v in columns.items()})
    return table
