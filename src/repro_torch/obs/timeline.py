"""Unified timeline: the shared span type + Chrome-trace I/O.

Port of ``repro.obs.timeline``.  Two event families:

* **complete spans** (``ph: "X"``) — one box per (pid, tid) lane;
  ``ts``/``dur`` are spec-standard microseconds while the ``ts_s`` /
  ``end_s`` sidecar fields (ignored by viewers) keep the exact float
  seconds, so :func:`from_chrome_trace` round-trips losslessly;
* **counter tracks** (``ph: "C"``) — numeric series rendered as stacked
  area charts in Perfetto.  :func:`counter_samples_from` turns
  per-iteration ``staleness`` and per-worker frontier drift into counter
  tracks next to a job's span lanes.  The ``ts_s`` sidecar keeps
  counters lossless too (:func:`chrome_counters`).

Stdlib only, so that the planner and the train loop can import it
without dragging either one in.
"""


from __future__ import annotations

import dataclasses
import json
from typing import Sequence

_US = 1e6   # chrome trace timestamps are microseconds


@dataclasses.dataclass(frozen=True)
class Span:
    """One complete ("ph": "X") trace event."""

    name: str
    cat: str          # "compute" | "comm" | "network" | "step" | ...
    pid: str          # job name (or "background")
    tid: str          # worker name or "link:<name>"
    start: float      # seconds
    end: float        # seconds
    args: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.end < self.start:
            raise ValueError(f"span ends before it starts: {self}")


@dataclasses.dataclass(frozen=True)
class CounterSample:
    """One counter ("ph": "C") trace event: a numeric multi-series sample.

    ``values`` maps series name -> value; Perfetto stacks the series of
    one counter track.  Counter tracks group by (pid, name) — one sample
    per observation time.
    """

    name: str
    pid: str
    time: float                 # seconds
    values: dict = dataclasses.field(default_factory=dict)


# ---------------------------------------------------------------------------
# Chrome trace export / import (round-trips exactly).
# ---------------------------------------------------------------------------

def to_chrome_trace(spans: Sequence[Span],
                    counters: Sequence[CounterSample] = ()) -> dict:
    """Chrome/Perfetto "X" events; ``ts``/``dur`` are microseconds per the
    trace-event spec, while ``ts_s``/``end_s`` (ignored by viewers) keep
    the exact float seconds so a round-trip is lossless.  ``counters``
    append as "C" events after the spans (with a ``ts_s`` sidecar of
    their own); with no counters the output is byte-identical to the
    spans-only format, and to the reference's on the same spans."""
    events = []
    for s in spans:
        events.append({
            "name": s.name, "cat": s.cat, "ph": "X",
            "pid": s.pid, "tid": s.tid,
            "ts": s.start * _US, "dur": (s.end - s.start) * _US,
            "ts_s": s.start, "end_s": s.end,
            "args": dict(s.args),
        })
    for c in counters:
        events.append({
            "name": c.name, "cat": "counter", "ph": "C",
            "pid": c.pid, "ts": c.time * _US, "ts_s": c.time,
            "args": dict(c.values),
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def from_chrome_trace(obj: dict) -> list[Span]:
    spans = []
    for ev in obj.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        if "ts_s" in ev:                      # our lossless sidecar fields
            start, end = ev["ts_s"], ev["end_s"]
        else:                                 # foreign chrome trace
            start = ev["ts"] / _US
            end = start + ev["dur"] / _US
        spans.append(Span(name=ev["name"], cat=ev.get("cat", ""),
                          pid=str(ev["pid"]), tid=str(ev["tid"]),
                          start=start, end=end,
                          args=dict(ev.get("args", {}))))
    return spans


def chrome_counters(obj: dict) -> list[CounterSample]:
    """The counter ("C") events of a trace, losslessly (via ``ts_s``)."""
    out = []
    for ev in obj.get("traceEvents", []):
        if ev.get("ph") != "C":
            continue
        t = ev["ts_s"] if "ts_s" in ev else ev["ts"] / _US
        out.append(CounterSample(name=ev["name"], pid=str(ev["pid"]),
                                 time=t, values=dict(ev.get("args", {}))))
    return out


def write_chrome_trace(path: str, spans: Sequence[Span],
                       counters: Sequence[CounterSample] = ()) -> None:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(spans, counters), f)


def read_chrome_trace(path: str) -> list[Span]:
    with open(path) as f:
        return from_chrome_trace(json.load(f))


# ---------------------------------------------------------------------------
# Counter tracks from job results: staleness + frontier drift.
# ---------------------------------------------------------------------------

def counter_samples_from(job_result, pid: str | None = None
                         ) -> list[CounterSample]:
    """Per-iteration counter tracks for one job result (duck-typed:
    anything with ``.iterations`` carrying ``index`` / ``end`` /
    ``staleness`` / ``worker_end``).

    Two tracks, sampled at each iteration's end:

    * ``staleness`` — local steps since the last global sync
      (``IterationResult.staleness`` of the reference's engine): flat 0 for
      synchronous schedules, a sawtooth for LocalSGD(H);
    * ``frontier_drift`` — per-worker series of each worker's frontier
      lag ``max_w(worker_end) - worker_end[w]``: all-zero under BSP's
      barrier, visibly fanning out for drifting schedules.

    The tracks live in their own ``pid`` group (default
    ``"<job>/counters"``) so they sit next to, not inside, the span
    lanes in Perfetto.
    """
    name = getattr(job_result, "name", "job")
    group = pid if pid is not None else f"{name}/counters"
    out = []
    for it in job_result.iterations:
        out.append(CounterSample(name="staleness", pid=group, time=it.end,
                                 values={"staleness": it.staleness}))
        ends = dict(it.worker_end)
        if ends:
            frontier = max(ends.values())
            out.append(CounterSample(
                name="frontier_drift", pid=group, time=it.end,
                values={w: frontier - e for w, e in sorted(ends.items())}))
    return out
