"""Device operators and the engine's hand-written CUDA kernels.

Nineteen kernels carry the main path, each beside its plain PyTorch version
in the module that uses it:

  K1 agg_ops.masked_reduce             (csrc/masked_reduce.cu)
  K2 mxu_segsum.dense_group_reduce     (csrc/dense_group_reduce.cu)
  K3 sort_ops.topk_smallest            (csrc/topk_smallest.cu)
  K4 sort_ops.radix_sort_pairs         (csrc/radix_sort.cu)
  K5 scan_ops.segment_bounds           (csrc/segment_bounds.cu)
  K6 scan_ops.segment_reduce_many      (csrc/segment_reduce.cu)
  K7 join_ops.dense_gather_join        (csrc/dense_join.cu)
  K8 join_ops.propagate_join, build/probe_join_table (csrc/hash_join.cu)
  K9 join_ops.expand_matches           (csrc/expand_matches.cu)
  K10 string_ops.prefix_match          (csrc/prefix_match.cu)
  K11 vector_ops.vector_distance       (csrc/vector_distance.cu)
  K12 calendar_ops.calendar_part       (csrc/calendar_part.cu)
  K13 chunk_ops.unpack_pairs           (csrc/unpack_pairs.cu)
  K14 filter_ops.compact_rows          (csrc/compact_rows.cu)
  K15 hash_ops.row_hash                (csrc/row_hash.cu)
  K16 sketch_ops.hll_update, hll_merge, hll_finalize (csrc/hll.cu)
  K17 scan_ops.segmented_scan          (csrc/segmented_scan.cu)
  K18 search.segmented_search          (csrc/segmented_search.cu)
  K19 state_ops.pack_state_rows, unpack_state_rows (csrc/state_rows.cu)

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises.  ``_native`` builds the kernels at the first
launch.
"""
from . import (hash_ops, agg_ops, calendar_ops, filter_ops, join_ops,
               mxu_segsum, scan_ops, sketch_ops, sort_ops, state_ops,
               string_ops, vector_ops)
