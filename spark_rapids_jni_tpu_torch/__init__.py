"""PyTorch/CUDA port of spark_rapids_jni_tpu for NVIDIA Hopper.

A package of its own beside the JAX package, which stays the reference.
It imports torch and numpy only. Kernels are hand-written CUDA C++ under
``csrc/``, built with nvcc on first use on a card (``_build.py``); on
CPU tensors every kernel wrapper runs its plain PyTorch version.

Slices in this package: the ColumnarBatch handles (``columnar``), the
JCUDF row <-> column transcode (``ops.row_conversion`` over
``ops.ragged_bytes``), the bounded GROUP BY SUM
(``ops.aggregate.groupby_sum_bounded``), and the shuffle write and
equi-join tier (``parallel.shuffle.hash_partition`` over
``ops.hashing``; ``ops.join`` over ``ops.paged_join``, ``ops.sort`` and
``ops.copying``).
"""
