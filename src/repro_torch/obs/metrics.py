"""Process-local metrics: labeled counters, gauges, histograms.

Port of ``repro.obs.metrics``, stdlib only: the producers (the planner's
inner loop, the train step's host side) must not grow a dependency for
the privilege of counting things.

* **Labels** are keyword arguments at observation time; each distinct
  label set is its own series (``counter.inc(job="a")`` and
  ``counter.inc(job="b")`` never mix).
* **Histograms use fixed exponential buckets**: a value ``v > 0`` lands
  in bucket ``e`` where ``v ∈ [2^(e-1), 2^e)`` — the binary exponent
  from ``math.frexp``.  Every histogram shares the same bucket edges, so
  merging two histograms is an *exact* per-bucket integer sum.
  Non-positive values land in a reserved underflow bucket.
* **Snapshots** (:meth:`Registry.snapshot`) are immutable copies with
  three exact operations: ``delta`` (counters and histogram buckets
  subtract), ``merge`` (counters/histograms sum exactly, gauges are
  last-write-wins from the right operand), and a lossless
  ``to_dict``/``from_dict`` JSON round-trip.

A module-level default :data:`REGISTRY` is the spine the instrumented
call sites share; tests diff snapshots instead of assuming absolute
values.
"""


from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Mapping

# Reserved exponential-bucket index for values <= 0.  Every float's
# frexp exponent is > -1075 (the subnormal floor), so this never
# collides with a real bucket.
UNDERFLOW_BUCKET = -1100


def bucket_index(value: float) -> int:
    """Fixed exponential bucket of ``value``: ``v ∈ [2^(e-1), 2^e) -> e``."""
    if value <= 0 or math.isnan(value):
        return UNDERFLOW_BUCKET
    if math.isinf(value):
        return 1025                       # above every finite exponent
    return math.frexp(value)[1]


def bucket_upper_edge(index: int) -> float:
    """Upper edge ``2^index`` of a bucket (0.0 for the underflow bucket)."""
    if index == UNDERFLOW_BUCKET:
        return 0.0
    try:
        return math.ldexp(1.0, index)
    except OverflowError:
        return math.inf


def _label_key(labels: Mapping[str, object]) -> str:
    """Canonical series key: sorted ``k=v`` pairs joined by ``|``."""
    if not labels:
        return ""
    for k, v in labels.items():
        if "=" in k or "|" in k or "=" in str(v) or "|" in str(v):
            raise ValueError(f"label {k}={v!r} contains a reserved char")
    return "|".join(f"{k}={v}" for k, v in sorted(labels.items()))


def parse_label_key(key: str) -> dict[str, str]:
    """Inverse of the canonical series key (string-valued)."""
    if not key:
        return {}
    return dict(part.split("=", 1) for part in key.split("|"))


# ---------------------------------------------------------------------------
# Live metrics.
# ---------------------------------------------------------------------------

class _Metric:
    kind = "?"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._series: dict[str, object] = {}

    def label_keys(self) -> list[str]:
        return sorted(self._series)


class Counter(_Metric):
    """Monotonically increasing per-series float."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {value})")
        key = _label_key(labels)
        self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels) -> float:
        return float(self._series.get(_label_key(labels), 0.0))


class Gauge(_Metric):
    """Last-written per-series float (set / add)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._series[_label_key(labels)] = float(value)

    def add(self, value: float, **labels) -> None:
        key = _label_key(labels)
        self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels) -> float:
        return float(self._series.get(_label_key(labels), 0.0))


@dataclasses.dataclass
class _HistState:
    counts: dict[int, int] = dataclasses.field(default_factory=dict)
    sum: float = 0.0
    count: int = 0
    min: float = math.inf
    max: float = -math.inf


class Histogram(_Metric):
    """Fixed-exponential-bucket histogram (exact merges; see module doc)."""

    kind = "histogram"

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        st = self._series.get(key)
        if st is None:
            st = self._series[key] = _HistState()
        b = bucket_index(value)
        st.counts[b] = st.counts.get(b, 0) + 1
        st.sum += value
        st.count += 1
        st.min = min(st.min, value)
        st.max = max(st.max, value)

    def count(self, **labels) -> int:
        st = self._series.get(_label_key(labels))
        return st.count if st is not None else 0

    def quantile(self, q: float, **labels) -> float:
        st = self._series.get(_label_key(labels))
        if st is None or st.count == 0:
            return 0.0
        return _hist_quantile(st.counts, st.count, st.min, st.max, q)


def _hist_quantile(counts: Mapping[int, int], total: int, vmin: float,
                   vmax: float, q: float) -> float:
    """Upper-edge quantile estimate from exponential buckets, clamped to
    the observed [min, max] so single-value series are exact."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile {q} outside [0, 1]")
    rank = q * total
    seen = 0.0
    for b in sorted(counts):
        seen += counts[b]
        if seen >= rank:
            return min(max(bucket_upper_edge(b), vmin), vmax)
    return vmax


# ---------------------------------------------------------------------------
# Snapshots: immutable, exact delta/merge, JSON round-trip.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Snapshot:
    """Frozen copy of a registry.

    ``metrics`` maps name -> {"kind", "help", "series": {label_key:
    payload}} where payload is a float (counter/gauge) or a histogram
    dict {"counts": {bucket: n}, "sum", "count", "min", "max"}.
    """

    metrics: dict

    def value(self, name: str, **labels) -> float:
        payload = self._payload(name, labels)
        if isinstance(payload, dict):
            raise TypeError(f"{name} is a histogram; use hist()/quantile()")
        return float(payload) if payload is not None else 0.0

    def hist(self, name: str, **labels) -> dict | None:
        payload = self._payload(name, labels)
        if payload is not None and not isinstance(payload, dict):
            raise TypeError(f"{name} is not a histogram")
        return payload

    def quantile(self, name: str, q: float, **labels) -> float:
        h = self.hist(name, **labels)
        if not h or not h["count"]:
            return 0.0
        return _hist_quantile(h["counts"], h["count"], h["min"], h["max"], q)

    def _payload(self, name: str, labels: Mapping[str, object]):
        m = self.metrics.get(name)
        if m is None:
            return None
        return m["series"].get(_label_key(labels))

    def delta(self, earlier: "Snapshot") -> "Snapshot":
        """What happened between ``earlier`` and ``self``.

        Counters and histogram buckets subtract (exact: integer bucket
        counts, and counter floats that only ever accumulated the same
        addends); gauges keep their current value.  Metrics/series
        absent from ``earlier`` pass through whole.
        """
        out = {}
        for name, m in self.metrics.items():
            prev = earlier.metrics.get(name)
            series = {}
            for key, payload in m["series"].items():
                base = prev["series"].get(key) if prev else None
                series[key] = _sub_payload(m["kind"], payload, base)
            out[name] = {"kind": m["kind"], "help": m["help"],
                         "series": series}
        return Snapshot(out)

    def merge(self, other: "Snapshot") -> "Snapshot":
        """Combine two snapshots: counters and histograms sum exactly
        (shared fixed bucket edges), gauges take ``other``'s value where
        both define a series (right-biased last-write-wins)."""
        out = {name: {"kind": m["kind"], "help": m["help"],
                      "series": dict(m["series"])}
               for name, m in self.metrics.items()}
        for name, m in other.metrics.items():
            if name not in out:
                out[name] = {"kind": m["kind"], "help": m["help"],
                             "series": dict(m["series"])}
                continue
            mine = out[name]
            if mine["kind"] != m["kind"]:
                raise TypeError(f"cannot merge {name}: {mine['kind']} vs "
                                f"{m['kind']}")
            for key, payload in m["series"].items():
                base = mine["series"].get(key)
                mine["series"][key] = _add_payload(m["kind"], base, payload)
        return Snapshot(out)

    def to_dict(self) -> dict:
        """JSON-ready form (histogram bucket keys become strings)."""
        out = {}
        for name, m in self.metrics.items():
            series = {}
            for key, payload in m["series"].items():
                if isinstance(payload, dict):
                    payload = dict(payload, counts={
                        str(b): n for b, n in sorted(payload["counts"].items())})
                series[key] = payload
            out[name] = {"kind": m["kind"], "help": m["help"],
                         "series": series}
        return out

    @staticmethod
    def from_dict(obj: Mapping) -> "Snapshot":
        out = {}
        for name, m in obj.items():
            series = {}
            for key, payload in m["series"].items():
                if isinstance(payload, dict):
                    payload = dict(payload, counts={
                        int(b): n for b, n in payload["counts"].items()})
                series[key] = payload
            out[name] = {"kind": m["kind"], "help": m.get("help", ""),
                         "series": series}
        return Snapshot(out)


def _hist_payload(st: _HistState) -> dict:
    return {"counts": dict(st.counts), "sum": st.sum, "count": st.count,
            "min": st.min, "max": st.max}


def _sub_payload(kind: str, payload, base):
    if base is None:
        return dict(payload, counts=dict(payload["counts"])) \
            if isinstance(payload, dict) else payload
    if kind == "gauge":
        return payload
    if kind == "counter":
        return payload - base
    counts = {}
    for b, n in payload["counts"].items():
        d = n - base["counts"].get(b, 0)
        if d:
            counts[b] = d
    # min/max are not delta-able; report the later window's observed range
    return {"counts": counts, "sum": payload["sum"] - base["sum"],
            "count": payload["count"] - base["count"],
            "min": payload["min"], "max": payload["max"]}


def _add_payload(kind: str, base, payload):
    if base is None:
        return dict(payload, counts=dict(payload["counts"])) \
            if isinstance(payload, dict) else payload
    if kind == "gauge":
        return payload                      # right-biased
    if kind == "counter":
        return base + payload
    counts = dict(base["counts"])
    for b, n in payload["counts"].items():
        counts[b] = counts.get(b, 0) + n
    return {"counts": counts, "sum": base["sum"] + payload["sum"],
            "count": base["count"] + payload["count"],
            "min": min(base["min"], payload["min"]),
            "max": max(base["max"], payload["max"])}


# ---------------------------------------------------------------------------
# Registry.
# ---------------------------------------------------------------------------

class Registry:
    """Named metrics with get-or-create semantics (kind-checked)."""

    _KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, requested {cls.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(Histogram, name, help)

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def reset(self) -> None:
        """Drop every series (metric definitions survive)."""
        for m in self._metrics.values():
            m._series.clear()

    def snapshot(self) -> Snapshot:
        out = {}
        for name, m in self._metrics.items():
            series = {}
            for key, payload in m._series.items():
                series[key] = _hist_payload(payload) \
                    if isinstance(payload, _HistState) else payload
            out[name] = {"kind": m.kind, "help": m.help, "series": series}
        return Snapshot(out)


#: The process-wide default registry every instrumented site shares.
REGISTRY = Registry()


def counter(name: str, help: str = "") -> Counter:
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "") -> Histogram:
    return REGISTRY.histogram(name, help)


def merge_all(snapshots: Iterable[Snapshot]) -> Snapshot:
    """Fold :meth:`Snapshot.merge` over many snapshots (exact for
    counters/histograms regardless of grouping — the associativity the
    property tests pin)."""
    out = Snapshot({})
    for s in snapshots:
        out = out.merge(s)
    return out
