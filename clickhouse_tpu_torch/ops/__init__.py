"""Device operators and the engine's hand-written CUDA kernels.

Three kernels carry the slice's main path, each beside its plain PyTorch
version in the module that uses it:

  K1 agg_ops.masked_reduce          (csrc/masked_reduce.cu)
  K2 mxu_segsum.dense_group_reduce  (csrc/dense_group_reduce.cu)
  K3 sort_ops.topk_smallest         (csrc/topk_smallest.cu)

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises.  ``_native`` builds the kernels at the first
launch.
"""
from . import hash_ops, agg_ops, filter_ops, mxu_segsum, sort_ops
