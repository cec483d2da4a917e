"""Typed query-settings registry.

Analog of the reference's single settings registry (src/Core/Settings.cpp,
917 ``DECLARE(...)`` entries) with per-session/per-query overrides via the SQL
``SETTINGS`` clause and simple min/max constraints
(src/Access/SettingsConstraints.cpp).  We keep one dataclass; every field is a
setting, overridable per query, discoverable through ``system.settings``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

__all__ = ["Settings", "SettingsConstraintError", "SETTING_DOCS"]


class SettingsConstraintError(ValueError):
    pass


# Reference settings recognized-but-inert here: perf/IO/compat knobs whose
# concern does not exist in this engine's execution model (XLA owns
# scheduling and fusion; there are no mark caches or async IO tiers), or
# whose behavior is this engine's only mode.  SET accepts them, they show
# in system.settings flagged "accepted; no engine effect", getSetting()
# reads them — mirroring how the reference keeps obsolete settings alive
# (src/Core/Settings.cpp MAKE_OBSOLETE).
ACCEPTED_INERT: Dict[str, Any] = {
    # analyzer/compat switches (this engine has one analyzer)
    "allow_experimental_analyzer": 1, "enable_analyzer": 1,
    "allow_deprecated_syntax_for_merge_tree": 0,
    "allow_experimental_object_type": 1,
    "allow_experimental_json_type": 1,
    "allow_experimental_dynamic_type": 0,
    "allow_experimental_variant_type": 0,
    "allow_suspicious_low_cardinality_types": 0,
    "allow_suspicious_codecs": 0, "allow_nondeterministic_mutations": 0,
    "compatibility": "", "joined_subquery_requires_alias": 0,
    "transform_null_in": 0, "legacy_column_name_of_tuple_literal": 0,
    "enable_positional_arguments": 1,
    # threading / pipeline shape (XLA schedules compute here)
    "max_insert_threads": 0, "max_final_threads": 0,
    "max_parsing_threads": 0, "max_download_threads": 4,
    "min_insert_block_size_rows": 1048449,
    "min_insert_block_size_bytes": 268402944,
    "max_insert_block_size": 1048449, "max_compress_block_size": 1048576,
    "min_compress_block_size": 65536, "preferred_block_size_bytes": 1000000,
    "max_read_buffer_size": 1048576, "interactive_delay": 100000,
    "idle_connection_timeout": 3600, "connect_timeout": 10,
    "receive_timeout": 300, "send_timeout": 300,
    "http_send_timeout": 30, "http_receive_timeout": 30,
    # memory/cache knobs folded into this engine's single governor
    "max_bytes_before_external_sort": 0,
    "max_bytes_before_remerge_sort": 1000000000,
    "max_memory_usage_for_user": 0, "memory_overcommit_ratio_denominator": 1073741824,
    "max_untracked_memory": 4194304, "memory_profiler_step": 4194304,
    "use_uncompressed_cache": 0, "merge_tree_max_rows_to_use_cache": 128,
    "merge_tree_max_bytes_to_use_cache": 192,
    "mark_cache_min_lifetime": 0,
    # reads / IO tiers that do not exist here
    "merge_tree_min_rows_for_concurrent_read": 163840,
    "merge_tree_min_bytes_for_concurrent_read": 251658240,
    "merge_tree_min_rows_for_seek": 0, "merge_tree_min_bytes_for_seek": 0,
    "merge_tree_coarse_index_granularity": 8,
    "remote_fs_read_method": "threadpool", "local_filesystem_read_method":
    "pread_threadpool", "read_in_order_two_level_merge_threshold": 100,
    "optimize_read_in_order": 1, "optimize_read_in_window_order": 1,
    "read_overflow_mode": "throw", "allow_asynchronous_read_from_io_pool_for_merge_tree": 0,
    # insert/mutation coordination
    "mutations_sync": 0, "insert_quorum": 0, "insert_quorum_timeout": 600000,
    "insert_quorum_parallel": 1, "select_sequential_consistency": 0,
    "alter_sync": 1, "replication_alter_partitions_sync": 1,
    "insert_keeper_max_retries": 20, "insert_keeper_fault_injection_probability": 0,
    "distributed_ddl_task_timeout": 180, "database_atomic_wait_for_drop_and_detach_synchronously": 0,
    "parallel_distributed_insert_select": 0,
    # optimizer switches whose transform is always-on or absent here
    "optimize_trivial_count_query": 1, "optimize_move_to_prewhere_if_final": 0,
    "optimize_skip_unused_shards": 0, "optimize_distributed_group_by_sharding_key": 0,
    "optimize_aggregation_in_order": 0, "optimize_arithmetic_operations_in_aggregate_functions": 1,
    "optimize_injective_functions_inside_uniq": 1, "optimize_if_chain_to_multiif": 0,
    "optimize_rewrite_sum_if_to_count_if": 1, "optimize_normalize_count_variants": 1,
    "optimize_syntax_fuse_functions": 0, "optimize_redundant_functions_in_order_by": 1,
    "optimize_functions_to_subcolumns": 1, "query_plan_remove_redundant_sorting": 1,
    "query_plan_remove_redundant_distinct": 1, "query_plan_join_swap_table": "auto",
    "query_plan_enable_optimizations": 1, "convert_query_to_cnf": 0,
    "enable_optimize_predicate_expression": 1, "short_circuit_function_evaluation": "enable",
    # formats / output cosmetics (TSV layer handles these today)
    "output_format_pretty_color": 1, "output_format_pretty_max_rows": 10000,
    "output_format_pretty_row_numbers": 1, "output_format_json_quote_64bit_integers": 1,
    "output_format_json_named_tuples_as_objects": 1,
    "output_format_write_statistics": 1, "output_format_decimal_trailing_zeros": 0,
    "input_format_null_as_default": 1, "input_format_skip_unknown_fields": 1,
    "input_format_import_nested_json": 0, "input_format_defaults_for_omitted_fields": 1,
    "input_format_values_interpret_expressions": 1,
    "input_format_parallel_parsing": 1, "output_format_parallel_formatting": 1,
    "date_time_input_format": "basic", "date_time_output_format": "simple",
    "format_csv_delimiter": ",", "format_display_secrets_in_show_and_select": 0,
    # session / protocol / logging
    "session_timezone": "", "distributed_product_mode": "deny",
    "prefer_localhost_replica": 1, "load_balancing": "random",
    "log_query_threads": 0, "log_processors_profiles": 1,
    "log_profile_events": 1, "query_cache_ttl": 60,
    "query_cache_max_entries": 0, "wait_for_async_insert": 1,
    "wait_for_async_insert_timeout": 120, "async_insert_max_data_size": 10485760,
    "async_insert_busy_timeout_ms": 200, "calculate_text_stack_trace": 1,
    "allow_ddl": 1, "force_index_by_date": 0, "force_primary_key": 0,
    "force_optimize_projection": 0, "cast_keep_nullable": 0,
    "mutations_execute_nondeterministic_on_initiator": 0,
    "max_ast_depth": 1000, "max_ast_elements": 50000,
    "max_expanded_ast_elements": 500000, "max_query_size": 262144,
    "max_temporary_columns": 0, "max_temporary_non_const_columns": 0,
    "max_subquery_depth": 100, "max_pipeline_depth": 0,
    "max_rows_to_group_by": 0, "group_by_overflow_mode": "throw",
    "max_rows_to_sort": 0, "max_bytes_to_sort": 0,
    "sort_overflow_mode": "throw", "max_rows_in_join": 0,
    "max_bytes_in_join": 0, "join_overflow_mode": "throw",
    "max_rows_in_set": 0, "max_bytes_in_set": 0, "set_overflow_mode": "throw",
    "max_rows_in_distinct": 0, "max_bytes_in_distinct": 0,
    "distinct_overflow_mode": "throw", "max_bytes_to_read": 0,
    "timeout_overflow_mode": "throw", "max_execution_speed": 0,
    "min_execution_speed": 0, "priority": 0,
    "max_network_bandwidth": 0, "max_network_bytes": 0,
    "count_distinct_implementation": "uniqExact",
    "aggregate_functions_null_for_empty": 0,
    "union_default_mode": "", "intersect_default_mode": "ALL",
    "except_default_mode": "ALL", "any_join_distinct_right_table_keys": 0,
    "final": 0, "lightweight_deletes_sync": 2,
    "use_skip_indexes": 1, "use_skip_indexes_if_final": 0,
    "allow_experimental_parallel_reading_from_replicas": 0,
    "max_parallel_replicas_custom_key": "",
    "http_max_multipart_form_data_size": 1073741824,
}


SETTING_DOCS: Dict[str, str] = {}


def _doc(name: str, text: str) -> None:
    SETTING_DOCS[name] = text


@dataclasses.dataclass
class Settings:
    # -- execution shape -----------------------------------------------------
    max_block_size: int = 1 << 20
    max_threads: int = 0               # 0 = auto (XLA owns intra-chip parallelism)
    max_rows_to_read: int = 0          # 0 = unlimited
    # implicit LIMIT/OFFSET applied outside the query's own LIMIT clause
    limit: int = 0                     # 0 = none
    offset: int = 0
    max_result_rows: int = 0

    # -- aggregation ---------------------------------------------------------
    max_groups: int = 1 << 22          # capacity of group-by output
    group_by_two_level_threshold: int = 1 << 17
    group_by_algorithm: str = "auto"   # auto | sort | hash
    max_bytes_before_external_group_by: int = 0  # spill threshold (0 = off)
    totals_mode: str = "after_having_exclusive"
    group_array_max_size: int = 256    # unbounded groupArray width (autotuned)

    # -- joins ---------------------------------------------------------------
    join_algorithm: str = "hash"       # hash | broadcast | shuffle | sort_merge
    join_dense_gather: bool = True     # direct-address join for proven-dense keys
    join_dense_table_entries: int = 8 << 20   # max dense join table slots
    join_dense_gather_max_words: int = 1      # widest payload for gather path
    # (each word = one ~8ns/row gather; at >=2 the sort-merge path wins)
    max_join_build_rows: int = 1 << 26
    join_use_nulls: bool = False
    max_probe_iterations: int = 64     # linear-probe bound in hash kernels
    max_joined_rows: int = 0           # join output capacity (0 = auto)
    max_array_join_rows: int = 0       # arrayJoin output capacity (0 = auto)
    capacity_autotune: bool = True     # re-plan at higher tier on overflow
    capacity_autotune_max_retries: int = 4

    # -- sorting -------------------------------------------------------------
    max_bytes_before_external_sort: int = 0
    limit_pushdown_threshold: int = 1 << 16  # use top-k kernel for LIMIT <= this

    # -- distributed ---------------------------------------------------------
    num_exchange_buckets: int = 256    # two-level bucket fan-out (reference: 256)
    distributed_group_by_no_merge: bool = False
    # shuffle elision when GROUP BY keys cover the sharding key (reference:
    # optimize_distributed_group_by_sharding_key + useDataParallelAggregation)
    optimize_distributed_group_by_sharding_key: bool = True
    prefer_global_in_and_join: bool = False
    fill_max_rows: int = 8192          # WITH FILL generated-row capacity
    skew_salt_factor: int = 4          # salted-key splitting for heavy hitters

    # -- precision / determinism --------------------------------------------
    deterministic_float_aggregation: bool = True
    cast_to_float32_for_speed: bool = False

    # -- out-of-core streaming (external aggregation analog) -----------------
    # scans larger than this stream through the engine chunk by chunk with
    # mergeable aggregation states carried across chunks (the TPU translation
    # of the reference's external aggregation, Aggregator.h writeToTemporaryFile)
    max_device_block_bytes: int = 2 << 30
    # hard per-query device budget (memory governor): plans estimated over
    # this and not streamable raise MEMORY_LIMIT_EXCEEDED before dispatch
    # instead of hard-aborting in the XLA allocator
    max_device_memory_bytes: int = 12 << 30
    # reference-compatible per-query memory cap (0 = unlimited); caps the
    # governor budget when set (src/Core/Settings.cpp max_memory_usage)
    max_memory_usage: int = 0
    # grouping() per SQL standard: 1 = bit set when the key is aggregated
    # away (reference default); 0 = legacy inverted bits
    force_grouping_standard_compatibility: int = 1
    stream_chunk_bytes: int = 512 << 20  # target chunk size when
    # streaming (device-side bit-unpack of packed transport keeps
    # ~2.5x the chunk in flight; 1 GiB chunks brushed the HBM limit)
    # expanding joins (cross / inflating inner) emit blocks of at most this
    # many output rows; a block this size over the memory budget fails the
    # query (src/Core/Settings.cpp max_joined_block_size_rows)
    max_joined_block_size_rows: int = 65536
    # streamed ORDER BY ... LIMIT k carries top-k rows across chunks when
    # k+offset is at most this; larger limits fall back to collect/host-sort
    stream_topk_max: int = 1 << 20
    # grace partitioned join: both-sides-huge joins hash-partition both
    # sides into host buckets and stream bucket by bucket (reference:
    # src/Interpreters/GraceHashJoin.cpp)
    grace_join_buckets: int = 0        # 0 = auto (sized from build bytes)
    stream_chunk_rows: int = 0         # explicit chunk row count (0 = auto)
    # parallel host readers pulling chunk tasks from a work-stealing
    # coordinator (MergeTreeReadPool analog); overlaps host chunk prep with
    # device compute.  Opt-in (default 1): each buffered chunk costs
    # ~stream_chunk_bytes of host RAM, and streaming exists precisely for
    # data that doesn't fit.
    stream_readers: int = 1
    # host-RAM budget for buffered chunks when stream_readers > 1
    stream_buffer_bytes: int = 4 << 30
    # distributed-semantics setting (parallel replicas of one shard); kept
    # distinct from stream_readers (reference: max_parallel_replicas)
    max_parallel_replicas: int = 1
    # hedged requests against remote() failover replicas: when the primary
    # has not answered within the timeout, a duplicate request starts on
    # the next replica and the first answer wins (reference:
    # use_hedged_requests + hedged_connection_timeout_ms,
    # src/Client/HedgedConnections.h:29)
    use_hedged_requests: bool = True
    hedged_connection_timeout_ms: int = 100
    # cross-process distributed query execution (RemoteQueryExecutor
    # analog): ship the rewritten per-shard query over the native TCP wire
    # — aggregations as WithMergeableState (-State spellings, initiator
    # merges partial states), other queries as column pruning + WHERE
    # pushdown — instead of pulling whole tables with SELECT *
    # (reference: src/Interpreters/ClusterProxy/executeQuery.cpp,
    # src/Core/QueryProcessingStage.h)
    distributed_pushdown: bool = True

    # -- query management --------------------------------------------------
    # hard wall-clock limit (seconds; 0 = unlimited).  Checked at host
    # sync points: streamed chunk boundaries, plan retries, pre-dispatch
    # (reference: max_execution_time / ExecutionSpeedLimits)
    max_execution_time: float = 0.0

    # -- profiling ---------------------------------------------------------
    # wall-clock stack sampler period (QueryProfiler analog, ref
    # src/Common/QueryProfiler.h:54); 0 disables.  Samples land in
    # system.trace_log as frame strings.
    query_profiler_real_time_period_ns: int = 0

    # -- background operations -------------------------------------------
    # inserts leaving at least this many parts schedule a background merge
    # (MergeTreeBackgroundExecutor analog); 0 disables background merging
    background_merge_min_parts: int = 64

    # -- storage / scan ------------------------------------------------------
    system_numbers_limit: int = 1 << 21   # cap for the virtual system.numbers
    index_granularity: int = 8192
    use_minmax_pruning: bool = True
    use_partition_pruning: bool = True
    optimize_move_to_prewhere: bool = True
    optimize_use_projections: bool = True   # aggregate-projection rewrite
    optimize_move_conditions: bool = True   # predicate pushdown through joins

    # -- compilation ---------------------------------------------------------
    compile_queries: bool = True       # jit the whole plan into one XLA program
    query_compile_cache_size: int = 256
    use_query_cache: bool = False      # materialized-result cache

    # -- observability -------------------------------------------------------
    log_queries: bool = True
    collect_profile_events: bool = True

    # -- misc ----------------------------------------------------------------
    # async INSERT batching (AsynchronousInsertQueue analog)
    async_insert: bool = False
    wait_for_async_insert: bool = True
    async_insert_busy_timeout_ms: int = 200
    async_insert_max_data_size: int = 10 << 20

    # coordination service for Replicated* engines: "" = in-process keeper
    # (TestKeeper strategy); "host:port" = networked KeeperServer
    keeper_address: str = ""

    # quorum inserts (ref: src/Storages/MergeTree/ReplicatedMergeTreeSink.cpp)
    insert_quorum: int = 0                  # 0/1 = no quorum
    insert_quorum_parallel: bool = True
    insert_quorum_timeout: int = 600000     # ms; 0 = fail immediately
    select_sequential_consistency: bool = False

    readonly: int = 0
    ignore_unknown_settings: bool = False   # tolerate foreign settings names
                                            # (reference-test compat mode)
    user_files_path: str = ""          # confinement root for file()/INFILE/
                                       # OUTFILE/BACKUP ("" = unrestricted)
    empty_result_for_aggregation_by_empty_set: bool = False

    # reference settings this engine recognizes but does not act on
    # (SET works, system.settings lists them flagged "accepted; no engine
    # effect" — the reference keeps obsolete settings the same way).
    # Stored per-instance so getSetting()/system.settings see overrides.
    extra: Optional[Dict[str, Any]] = None

    # -- API -----------------------------------------------------------------
    def copy_with(self, overrides: Optional[Dict[str, Any]] = None) -> "Settings":
        if not overrides:
            return dataclasses.replace(self)
        fields = {f.name: f for f in dataclasses.fields(self)}
        kwargs = {}
        extra = dict(self.extra or {})
        lenient = self.ignore_unknown_settings \
            or bool(overrides.get("ignore_unknown_settings"))
        for key, value in overrides.items():
            if key not in fields:
                if key in ACCEPTED_INERT:
                    extra[key] = value
                    continue
                if lenient:
                    continue
                raise SettingsConstraintError(f"Unknown setting '{key}'")
            ftype = fields[key].type
            current = getattr(self, key)
            kwargs[key] = _coerce(key, value, type(current))
        if extra:
            kwargs["extra"] = extra
        return dataclasses.replace(self, **kwargs)

    def as_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.pop("extra", None)
        for k, default in ACCEPTED_INERT.items():
            d[k] = (self.extra or {}).get(k, default)
        return d


def _coerce(name: str, value: Any, target: type) -> Any:
    if target is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, (int, float)):
            return bool(value)
        if isinstance(value, str):
            v = value.strip().lower()
            if v in ("1", "true", "yes", "on"):
                return True
            if v in ("0", "false", "no", "off"):
                return False
        raise SettingsConstraintError(f"Setting '{name}' expects bool, got {value!r}")
    if target is int:
        try:
            return int(value)
        except (TypeError, ValueError):
            raise SettingsConstraintError(f"Setting '{name}' expects int, got {value!r}")
    if target is float:
        return float(value)
    if target is str:
        return str(value)
    return value


_doc("max_block_size", "Padded capacity of streaming blocks moved through operators.")
_doc("max_groups", "Static capacity of GROUP BY output; queries exceeding it error.")
_doc("group_by_algorithm", "auto: hash for few expected groups, sort otherwise.")
_doc("num_exchange_buckets", "Bucket fan-out for two-level aggregation state exchange "
     "(matches the reference's 256-bucket convention, TwoLevelHashTable.h:32).")
_doc("skew_salt_factor", "Heavy-hitter keys are split across this many salted "
     "sub-keys before repartitioning shuffles.")
_doc("max_device_block_bytes", "Tables above this physical size stream through "
     "the engine chunk by chunk instead of as one device block.")
_doc("stream_chunk_bytes", "Target physical bytes per chunk when streaming.")
_doc("max_joined_block_size_rows", "Maximum output rows per block emitted by "
     "an expanding join; bounds the streamed cross-join chunk size.")
_doc("stream_readers", "Parallel host readers pulling streamed-scan chunk "
     "tasks from a work-stealing coordinator; 1 disables read parallelism.")
_doc("stream_buffer_bytes", "Host-RAM budget for in-flight buffered chunks "
     "when stream_readers > 1.")
_doc("max_bytes_before_external_group_by", "When > 0, aggregation queries over "
     "tables above this size run in streaming (out-of-core) mode.")
_doc("max_device_memory_bytes", "Per-query device memory budget; non-streamable "
     "plans estimated above it raise MEMORY_LIMIT_EXCEEDED before dispatch.")
_doc("stream_topk_max", "Largest ORDER BY LIMIT k carried as a device top-k "
     "across streamed chunks.")
_doc("grace_join_buckets", "Bucket count for grace partitioned joins "
     "(0 = sized automatically from the build side's bytes).")
