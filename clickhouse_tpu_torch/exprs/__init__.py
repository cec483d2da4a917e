from .expr import (BoundCall, BoundColumn, BoundExpr, BoundLiteral, ColVal,
                   colval_from_column, evaluate)
from . import functions, aggregates
