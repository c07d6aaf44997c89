"""PyTorch/CUDA port of spark_rapids_jni_tpu for NVIDIA Hopper.

A package of its own beside the JAX package, which stays the reference.
It imports torch and numpy only. Kernels are hand-written CUDA C++ under
``csrc/``, built with nvcc on first use on a card (``_build.py``); on
CPU tensors every kernel wrapper runs its plain PyTorch version.

Slice in this package: fixed-width ColumnarBatch handles
(``columnar``), the JCUDF row <-> column transcode
(``ops.row_conversion`` over ``ops.ragged_bytes``) and the bounded
GROUP BY SUM (``ops.aggregate.groupby_sum_bounded``).
"""
