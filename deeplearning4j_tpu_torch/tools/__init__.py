"""The fleet smoke tools of the port, run as modules:

- ``python -m deeplearning4j_tpu_torch.tools.serving_smoke`` — the
  serving load generator (HTTP stack, prefix cache, SLOs, the router,
  fleet federation, the autoscaler, the disaggregated tier, the online
  loop);
- ``python -m deeplearning4j_tpu_torch.tools.chaos_smoke`` — randomized
  fault plans against the supervised trainer (ZeRO stages 0-3 over
  ``--world`` ranks), serving, the disaggregated tier, elasticity, the
  online loop and the control plane.

Both run on the card unless ``--platform cpu`` is passed, and print one
JSON line in the reference tools' keys, so ``tools/trace_report.py``,
``tools/metrics_dump.py`` and ``tools/perf_gate.py --record`` read them.
"""
