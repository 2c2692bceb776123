"""Process-local labeled counters: the part of ``repro.obs.metrics`` that
the planner uses (``REGISTRY.counter(name).inc()``).

Each distinct label set is its own series (``counter.inc(job="a")`` and
``counter.inc(job="b")`` never mix).  Gauges, histograms and snapshots
come with the port's observability slice.
"""

from __future__ import annotations

from typing import Mapping


def _label_key(labels: Mapping[str, object]) -> str:
    """Canonical series key: sorted ``k=v`` pairs joined by ``|``."""
    if not labels:
        return ""
    for k, v in labels.items():
        if "=" in k or "|" in k or "=" in str(v) or "|" in str(v):
            raise ValueError(f"label {k}={v!r} contains a reserved char")
    return "|".join(f"{k}={v}" for k, v in sorted(labels.items()))


class Counter:
    """Monotonically increasing per-series float."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._series: dict[str, float] = {}

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {value})")
        key = _label_key(labels)
        self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels) -> float:
        return float(self._series.get(_label_key(labels), 0.0))


class Registry:
    """Named counters with get-or-create semantics."""

    def __init__(self):
        self._metrics: dict[str, Counter] = {}

    def counter(self, name: str, help: str = "") -> Counter:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Counter(name, help)
        return m

    def names(self) -> list[str]:
        return sorted(self._metrics)


#: The process-wide default registry every instrumented site shares.
REGISTRY = Registry()
