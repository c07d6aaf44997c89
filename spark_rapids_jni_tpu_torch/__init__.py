"""PyTorch/CUDA port of spark_rapids_jni_tpu for NVIDIA Hopper.

A package of its own beside the JAX package, which stays the reference.
It imports torch and numpy only. Kernels are hand-written CUDA C++ under
``csrc/``, built with nvcc on first use on a card (``_build.py``); on
CPU tensors every kernel wrapper runs its plain PyTorch version.

Slices in this package: the ColumnarBatch handles (``columnar``), the
JCUDF row <-> column transcode (``ops.row_conversion`` over
``ops.ragged_bytes``), the bounded GROUP BY SUM
(``ops.aggregate.groupby_sum_bounded``; the one-hot kernel B2 as
``ops.hopper_kernels.groupby_sum_bounded``), the shuffle write and
equi-join tier (``parallel.shuffle.hash_partition`` over
``ops.hashing``; ``ops.join`` over ``ops.paged_join``, ``ops.sort`` and
``ops.copying``), and TPC-H q1/q6: the expression tier
(``ops.expressions``), the exact FLOAT64 accumulator (``ops.f64acc``),
the sort-based GROUP BY (``ops.aggregate.groupby_aggregate``), the
compiled-plan mechanism (``pipeline``) and the models (``models.datagen``,
``models.tpch``, ``models.compiled``). All ten TPU kernels of the
reference have a hand-written counterpart (``ops.hopper_kernels``,
``ops.ragged_bytes``). The plan tier (``plan``: logical plans, rewrites,
statistics, the cost-based optimizer and the compiler onto ``pipeline``
and the operators) runs the TPC-DS plan queries (``models.tpcds_plans``).
The serving tier is the device worker the native client reaches
(``sidecar``), its supervised pool (``sidecar_pool``), the native
runtime's bindings (``runtime``) and the query scheduler with its durable
journal (``serve``). The correctness tooling (``analysis``: the lint,
the static race pass, lockdep with its dynamic race layer, the span-log
merge, the plan checker and the plan fuzzer) runs over the package's own
tree.
"""

import os as _os

if (
    _os.environ.get("SRJTORCH_LOCKDEP", "").lower() in ("1", "true", "yes")  # srjt-lint: allow-environ(bootstrap: lockdep must patch threading before ANY package module creates a lock, so the arming is read before any package import)
    or _os.environ.get("SRJTORCH_RACE", "").lower() in ("1", "true", "yes")  # srjt-lint: allow-environ(bootstrap: the race detector rides the lockdep shim and has the same patch-before-any-lock constraint)
):
    from .analysis import lockdep as _lockdep

    _lockdep.install()

