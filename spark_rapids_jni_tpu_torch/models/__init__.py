"""Benchmark models of the port: deterministic data generation
(``datagen``) and the BASELINE.json TPC-H q1/q6 pipelines on the operator
tier (``tpch``) and through the compiled-plan mechanism (``compiled``)."""

from . import compiled, datagen, tpch  # noqa: F401
