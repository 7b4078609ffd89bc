"""Train-phase metric recording and the `cli train` timing report.

The port of `predictionio_tpu/obs/report.py`: `CoreWorkflow.run_train`
records each phase's wall seconds into the process-default metrics
registry, and `cli train` prints a per-phase report read back from that
registry (the numbers a scraper would see on /metrics) to stderr. The
JAX report's XLA compile line has no counterpart: the port compiles
nothing per shape.
"""

from __future__ import annotations

from typing import Mapping, Optional

from predictionio_tpu_torch.obs.metrics import MetricsRegistry, get_registry

TRAIN_BUCKETS = (0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0,
                 1800.0, 7200.0)


def record_train_phases(phase_timings: Mapping[str, float],
                        registry: Optional[MetricsRegistry] = None) -> None:
    """Record a train run's per-phase wall seconds (keys like 'read_s',
    'pack_s', 'solve_s') into the registry."""
    reg = registry or get_registry()
    hist = reg.histogram(
        "pio_train_phase_seconds", "Training phase wall time per run",
        labels=("phase",), buckets=TRAIN_BUCKETS)
    for key, secs in phase_timings.items():
        phase = key[:-2] if key.endswith("_s") else key
        hist.labels(phase=phase).observe(float(secs))


def train_report(registry: Optional[MetricsRegistry] = None) -> str:
    """Per-phase timing report rendered from the metrics registry."""
    reg = registry or get_registry()
    snap = reg.snapshot()
    lines = ["Training phase report (from the metrics registry):"]
    fam = snap.get("pio_train_phase_seconds")
    if fam and fam["series"]:
        for s in fam["series"]:
            phase = s["labels"].get("phase", "?")
            lines.append(f"  {phase:<20} {s['sum']:9.3f}s"
                         f"  (runs: {s['count']})")
    else:
        lines.append("  (no training phases recorded)")
    return "\n".join(lines)
