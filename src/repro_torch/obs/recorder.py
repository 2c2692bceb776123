"""Flight recorder: a bounded ring of structured per-iteration records.

Port of ``repro.obs.recorder``, one record schema for simulated and real
iterations.  The real training loop emits an :class:`IterationRecord`
per step from its host-side timing hook
(``repro_torch.train.step.instrument_step``); planner decisions and drift
alerts ride along as :class:`EventRecord` entries in the same ring.

* the ring is **bounded** (``capacity``): evictions are counted, never
  silent;
* JSONL round-trips are **lossless**: ``json`` serializes Python floats
  via ``repr``, so :func:`read_jsonl` reproduces every record bit for
  bit.

Stdlib only; it may import siblings in ``repro_torch.obs`` but nothing
from ``repro_torch.core`` / ``repro_torch.train`` (they import *us*).
"""


from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
from typing import Iterable, Sequence

from repro_torch.obs.timeline import Span


@dataclasses.dataclass(frozen=True)
class BucketRecord:
    """One bucket's gradient synchronization inside one iteration (the
    iteration index lives on the parent record)."""

    bucket: int
    nbytes: int
    ready: float        # bucket's last gradient produced
    start: float        # collective issued
    end: float          # collective completed
    comm_s: float = -1.0   # fabric occupancy; < 0 means "use end - start"

    @property
    def duration(self) -> float:
        return self.comm_s if self.comm_s >= 0 else self.end - self.start


@dataclasses.dataclass(frozen=True)
class IterationRecord:
    """One training iteration, simulator- or real-run-sourced.

    ``source`` distinguishes provenance (``"sim"`` | ``"train"``), not
    schema: both producers fill the same fields, with real runs leaving
    the engine-only telemetry (worker frontiers, link accounting) empty
    and flagging estimated bucket timings in ``args``.
    """

    source: str
    job: str
    iteration: int
    start: float
    end: float
    backward_end: float
    staleness: int = 0
    buckets: tuple[BucketRecord, ...] = ()
    worker_compute: tuple[tuple[str, float], ...] = ()
    worker_start: tuple[tuple[str, float], ...] = ()
    worker_end: tuple[tuple[str, float], ...] = ()
    link_bytes: tuple[tuple[str, float], ...] = ()
    link_busy: tuple[tuple[str, float], ...] = ()
    args: dict = dataclasses.field(default_factory=dict)

    @property
    def t_iter(self) -> float:
        return self.end - self.start

    @property
    def comm_total(self) -> float:
        return sum(b.duration for b in self.buckets)


@dataclasses.dataclass(frozen=True)
class EventRecord:
    """A point decision/alert: planner replans, co-plan rounds, drift
    alerts.  ``time`` is in the emitter's own clock (sim seconds, host
    wall seconds, or a round counter — recorded in ``args`` by
    convention when ambiguous)."""

    kind: str
    time: float
    source: str = "sim"
    job: str = ""
    args: dict = dataclasses.field(default_factory=dict)


Record = IterationRecord | EventRecord


class FlightRecorder:
    """Bounded in-memory ring of :class:`IterationRecord` /
    :class:`EventRecord`, in arrival order."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self.evicted = 0
        self.recorded = 0

    def __len__(self) -> int:
        return len(self._ring)

    def record(self, rec: Record) -> None:
        if not isinstance(rec, (IterationRecord, EventRecord)):
            raise TypeError(f"not a record: {rec!r}")
        if len(self._ring) == self.capacity:
            self.evicted += 1
        self._ring.append(rec)
        self.recorded += 1

    @property
    def records(self) -> tuple[Record, ...]:
        return tuple(self._ring)

    def iterations(self, job: str | None = None) -> list[IterationRecord]:
        return [r for r in self._ring if isinstance(r, IterationRecord)
                and (job is None or r.job == job)]

    def events(self, kind: str | None = None) -> list[EventRecord]:
        return [r for r in self._ring if isinstance(r, EventRecord)
                and (kind is None or r.kind == kind)]

    def clear(self) -> None:
        self._ring.clear()
        self.evicted = 0
        self.recorded = 0

    def write(self, path: str) -> None:
        write_jsonl(path, self._ring)


# ---------------------------------------------------------------------------
# JSONL round-trip (lossless).
# ---------------------------------------------------------------------------

def record_to_obj(rec: Record) -> dict:
    if isinstance(rec, IterationRecord):
        obj = dataclasses.asdict(rec)
        obj["type"] = "iteration"
        return obj
    obj = dataclasses.asdict(rec)
    obj["type"] = "event"
    return obj


def _pairs(raw) -> tuple[tuple[str, float], ...]:
    return tuple((str(k), v) for k, v in raw)


def record_from_obj(obj: dict) -> Record:
    kind = obj.get("type")
    if kind == "iteration":
        return IterationRecord(
            source=obj["source"], job=obj["job"],
            iteration=obj["iteration"], start=obj["start"], end=obj["end"],
            backward_end=obj["backward_end"],
            staleness=obj.get("staleness", 0),
            buckets=tuple(BucketRecord(**b) for b in obj.get("buckets", ())),
            worker_compute=_pairs(obj.get("worker_compute", ())),
            worker_start=_pairs(obj.get("worker_start", ())),
            worker_end=_pairs(obj.get("worker_end", ())),
            link_bytes=_pairs(obj.get("link_bytes", ())),
            link_busy=_pairs(obj.get("link_busy", ())),
            args=dict(obj.get("args", {})))
    if kind == "event":
        return EventRecord(kind=obj["kind"], time=obj["time"],
                           source=obj.get("source", "sim"),
                           job=obj.get("job", ""),
                           args=dict(obj.get("args", {})))
    raise ValueError(f"unknown record type {kind!r}")


def write_jsonl(path: str, records: Iterable[Record]) -> None:
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(record_to_obj(rec)) + "\n")


def read_jsonl(path: str) -> list[Record]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(record_from_obj(json.loads(line)))
    return out


# ---------------------------------------------------------------------------
# Producers' helpers.
# ---------------------------------------------------------------------------

def plan_fingerprint(plan) -> str:
    """Deterministic short id of a merge plan's bucket structure — the
    "which plan was live" tag on decision events and iteration records.
    Accepts a ``MergePlan`` or a bare buckets tuple."""
    buckets = getattr(plan, "buckets", plan)
    payload = ";".join(",".join(str(i) for i in b) for b in buckets)
    return hashlib.sha1(payload.encode()).hexdigest()[:12]


def from_iteration_result(result, *, job: str, source: str = "sim",
                          args: dict | None = None) -> IterationRecord:
    """Convert an engine ``IterationResult`` (duck-typed) into the
    shared record schema."""
    return IterationRecord(
        source=source, job=job, iteration=result.index,
        start=result.start, end=result.end,
        backward_end=result.backward_end,
        staleness=result.staleness,
        buckets=tuple(BucketRecord(bucket=b.bucket, nbytes=b.nbytes,
                                   ready=b.ready, start=b.start, end=b.end,
                                   comm_s=b.comm_s)
                      for b in result.buckets),
        worker_compute=tuple(result.worker_compute),
        worker_start=tuple(result.worker_start),
        worker_end=tuple(result.worker_end),
        link_bytes=tuple(result.link_bytes),
        link_busy=tuple(result.link_busy),
        args=dict(args or {}))


def record_spans(records: Sequence[Record], *, pid: str | None = None
                 ) -> list[Span]:
    """Render iteration records as timeline spans — one ``step`` lane
    plus a ``comm`` lane of per-bucket collectives per job.

    For simulator runs the engine already exports richer per-worker /
    per-link spans; this renderer exists so *real-run* records (which
    have no engine spans) land in the same Chrome trace, and the two
    sources line up lane for lane."""
    spans = []
    for rec in records:
        if not isinstance(rec, IterationRecord):
            continue
        group = pid if pid is not None else f"{rec.source}:{rec.job}"
        spans.append(Span(
            name=f"iter{rec.iteration}", cat="step", pid=group, tid="step",
            start=rec.start, end=rec.end,
            args={"iter": rec.iteration, "staleness": rec.staleness,
                  **rec.args}))
        for b in rec.buckets:
            spans.append(Span(
                name=f"allreduce:b{b.bucket}", cat="comm", pid=group,
                tid="comm", start=b.start, end=max(b.end, b.start),
                args={"iter": rec.iteration, "bucket": b.bucket,
                      "bytes": b.nbytes}))
    return spans
