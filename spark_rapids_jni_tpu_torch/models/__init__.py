"""Benchmark models of the port: deterministic data generation
(``datagen``), the BASELINE.json TPC-H q1/q6 pipelines on the operator
tier (``tpch``) and through the compiled-plan mechanism (``compiled``),
and the single-chip TPC-DS queries (``tpcds``)."""

from . import compiled, datagen, tpch, tpcds  # noqa: F401
