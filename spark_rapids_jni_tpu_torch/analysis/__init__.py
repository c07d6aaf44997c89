"""Correctness tooling for the port's concurrent substrate and plan tier.

The tools:

- ``lint.py`` — ``srjt-lint``, an AST static pass (stdlib ``ast``)
  enforcing the package's conventions (SRJT000-007, SRJT011): the
  central knob registry (utils/knobs.py, scanned across the package
  PLUS tests/ and benchmarks/), the error-taxonomy raise/except
  discipline, the metrics/spill hot-path stub pattern, deadline
  cooperation for blocking calls, registry<->README drift, and the
  rewrite rules' verifier coverage. Run as
  ``python -m spark_rapids_jni_tpu_torch.analysis.lint``.
- ``races.py`` — ``srjt-race`` layer 1 (SRJT008-010): static
  guarded-by inference over the concurrent modules — per class, which
  ``self._*`` attributes are accessed under ``with self._lock:`` vs
  bare — flagging mixed-guard access, check-then-act splits, and bare
  mutable-global mutation. Run as
  ``python -m spark_rapids_jni_tpu_torch.analysis.races``.
- ``plancheck.py`` / ``planfuzz.py`` — ``srjt-plancheck``: plancheck
  runs the ``plan/verifier.py`` rules (PLAN001-006) over every
  checked-in plan in ``models/tpcds_plans.py``; planfuzz generates
  seeded typed plans over the TPC-DS generator schemas, executes them
  through rewrite->compile->run against a direct-plan-interpretation
  oracle, and bisects any mismatch (PLAN007) to the first
  semantics-breaking rewrite in the chain.
- ``lockdep.py`` — opt-in runtime instrumentation over ``threading``:
  ``SRJTORCH_LOCKDEP=1`` records per-thread acquisition stacks, the
  lock-order graph, cycles, and blocking-while-locked events;
  ``SRJTORCH_RACE=1`` additionally arms srjt-race layer 2 — per-thread
  vector clocks advanced on every sync edge with a ``track(obj)``
  registration API over the scheduler/pool/memgov/metrics/cache shared
  state. Merge/gate everything with
  ``python -m spark_rapids_jni_tpu_torch.analysis.lockdep``.
- ``tracemerge.py`` — joins the per-process span logs
  (``SRJTORCH_TRACE_LOG``) into per-trace trees, Chrome JSON export and
  the zero-orphan gate.

The static CLIs emit ``--format=json|sarif`` with text-mode exit-code
parity. This package stays import-light (the standard library and the
knob registry only at import time): the package ``__init__`` installs
lockdep BEFORE any other module — and so before any package lock
exists — when either runtime knob is armed.
"""
