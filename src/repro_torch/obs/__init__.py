"""Observability spine: metrics, flight recorder, timeline, drift.

Port of ``repro.obs``, one telemetry layer shared by the planning stack
(``repro_torch.core``) and the real training loop (``repro_torch.train``):

* :mod:`repro_torch.obs.metrics` — labeled Counters/Gauges/Histograms with
  exact snapshot/delta/merge algebra (fixed exponential buckets);
* :mod:`repro_torch.obs.timeline` — the shared :class:`Span` type and
  Chrome/Perfetto trace I/O, plus counter tracks;
* :mod:`repro_torch.obs.recorder` — bounded flight-recorder ring of
  per-iteration / event records with lossless JSONL round-trip;
* :mod:`repro_torch.obs.drift` — EWMA predicted-vs-observed residuals with
  threshold alerts that drive refit + replan.

Every module is stdlib-only at import.  Import order below matters:
``metrics`` and ``timeline`` are leaves, ``recorder`` uses ``timeline``,
``drift`` uses both.
"""


from repro_torch.obs.metrics import (
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    Registry,
    Snapshot,
    bucket_index,
    bucket_upper_edge,
    counter,
    gauge,
    histogram,
    merge_all,
)
from repro_torch.obs.timeline import (
    CounterSample,
    Span,
    chrome_counters,
    counter_samples_from,
    from_chrome_trace,
    read_chrome_trace,
    to_chrome_trace,
    write_chrome_trace,
)
from repro_torch.obs.recorder import (
    BucketRecord,
    EventRecord,
    FlightRecorder,
    IterationRecord,
    from_iteration_result,
    plan_fingerprint,
    read_jsonl,
    record_spans,
    write_jsonl,
)
from repro_torch.obs.drift import (
    DriftAlert,
    DriftMonitor,
    fit_link_models,
)

__all__ = [
    "REGISTRY", "Counter", "Gauge", "Histogram", "Registry", "Snapshot",
    "bucket_index", "bucket_upper_edge", "counter", "gauge", "histogram",
    "merge_all",
    "CounterSample", "Span", "chrome_counters", "counter_samples_from",
    "from_chrome_trace", "read_chrome_trace", "to_chrome_trace",
    "write_chrome_trace",
    "BucketRecord", "EventRecord", "FlightRecorder", "IterationRecord",
    "from_iteration_result", "plan_fingerprint", "read_jsonl",
    "record_spans", "write_jsonl",
    "DriftAlert", "DriftMonitor", "fit_link_models",
]
