"""Unified run telemetry (doc/observability.md).

The reference framework's only observability was ``REGISTER_TIMER`` /
``StatSet`` log dumps and the BarrierStat straggler line — metrics lived
as unstructured log text, scraped back out with regexes. This package is
the structured replacement: every subsystem (trainer step loop, data
pipeline, checkpoint I/O, retry layer, fault injection, barrier skew)
emits into one per-host, schema-versioned ``metrics.jsonl`` stream, and
``spans.py`` upgrades ``stat_timer`` scopes into Chrome trace-event
spans. ``paddle metrics <run_dir>`` (analyze.py) reads it all back.
``compile_log.py`` adds per-launch-group compile telemetry and the
persistent compilation cache; ``costs.py`` turns XLA cost analysis into
``paddle roofline`` reports; ``compare.py`` diffs two runs with a
regression verdict (``paddle compare``); ``serving.py`` gives
generation the same treatment — request-lifecycle records, the
deterministic offered-load serve driver behind ``bench.py serve``, and
``paddle serve-report``.

Deliberately jax-free at import time: the supervisor and the analyzer
must work when the accelerator runtime is exactly what keeps crashing.
"""

from paddle_tpu_torch.observability.metrics import (  # noqa: F401
    SCHEMA_VERSION,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    MetricsWriter,
    configure,
    configure_from_flags,
    emit,
    enabled,
    flush,
    metrics_files,
    read_records,
    read_tail,
    registry,
    validate_record,
)
from paddle_tpu_torch.observability import spans  # noqa: F401
