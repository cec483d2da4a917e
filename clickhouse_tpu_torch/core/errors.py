"""Engine exception hierarchy (reference: src/Common/Exception.h + ErrorCodes)."""
from __future__ import annotations

__all__ = [
    "EngineError", "ParseError", "AnalysisError", "UnknownIdentifier",
    "UnknownFunction", "UnknownTable", "TypeError_", "ExecutionError",
    "CapacityError", "MemoryLimitExceeded", "NotImplementedError_",
]


class EngineError(Exception):
    code = 1000


class ParseError(EngineError):
    code = 62        # SYNTAX_ERROR


class AnalysisError(EngineError):
    code = 47


class UnknownIdentifier(AnalysisError):
    code = 47        # UNKNOWN_IDENTIFIER


class UnknownFunction(AnalysisError):
    code = 46        # UNKNOWN_FUNCTION


class UnknownTable(AnalysisError):
    code = 60        # UNKNOWN_TABLE


class TypeError_(AnalysisError):
    code = 43        # ILLEGAL_TYPE_OF_ARGUMENT


class ExecutionError(EngineError):
    code = 1001


class CapacityError(ExecutionError):
    """Static capacity exceeded (groups/join matches beyond planned bound).

    Carries the setting that bounds the capacity and the observed need so the
    session can re-plan at a higher capacity tier (the TPU analog of the
    reference's single-level -> two-level hash table conversion,
    src/Interpreters/Aggregator.cpp:91) instead of failing the query.
    """
    code = 241       # MEMORY_LIMIT_EXCEEDED analog

    def __init__(self, message: str, setting: str = None, needed: int = None):
        super().__init__(message)
        self.setting = setting
        self.needed = needed


class MemoryLimitExceeded(ExecutionError):
    """The plan's estimated device footprint exceeds the budget and no
    streaming rewrite applies — raised BEFORE dispatch so the process never
    hits an uncatchable XLA allocation abort (reference: MemoryTracker hard
    limits, src/Common/MemoryTracker.cpp)."""
    code = 241       # MEMORY_LIMIT_EXCEEDED


class DecimalOverflow(ExecutionError):
    """A decimal value exceeds the engine's int64 scaled representation
    (reference: DECIMAL_OVERFLOW, src/Core/DecimalFunctions.h — the
    reference widens to Int128/256 limbs instead)."""
    code = 407       # DECIMAL_OVERFLOW


class TimeoutExceeded(ExecutionError):
    """max_execution_time elapsed (reference: TIMEOUT_EXCEEDED,
    src/QueryPipeline/ExecutionSpeedLimits.cpp)."""


class QueryCancelled(ExecutionError):
    """Query killed via KILL QUERY (reference: QUERY_WAS_CANCELLED)."""


class NotImplementedError_(EngineError):
    code = 48        # NOT_IMPLEMENTED


class RequiresMaterialization(NotImplementedError_):
    """Raised while TRACING an op whose result needs concrete values
    (per-row stringification).  The session retries the query eagerly,
    where the same op sees concrete arrays and succeeds."""
