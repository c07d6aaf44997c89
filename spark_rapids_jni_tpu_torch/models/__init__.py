"""Benchmark models of the port: deterministic data generation
(``datagen``), the BASELINE.json TPC-H q1/q6 pipelines on the operator
tier (``tpch``) and through the compiled-plan mechanism (``compiled``),
the single-chip TPC-DS queries (``tpcds``) and the TPC-DS queries
expressed as logical plans (``tpcds_plans``)."""

from . import compiled, datagen, tpch, tpcds, tpcds_plans  # noqa: F401
