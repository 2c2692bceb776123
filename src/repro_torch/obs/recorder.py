"""Decision records: the part of ``repro.obs.recorder`` that the planner
uses (:class:`EventRecord` and :func:`plan_fingerprint`).  The flight
recorder ring and the JSONL round trip come with the port's observability
slice."""

from __future__ import annotations

import dataclasses
import hashlib


@dataclasses.dataclass(frozen=True)
class EventRecord:
    """A point decision/alert (planner replans and the like).  ``time`` is
    in the emitter's own clock."""

    kind: str
    time: float
    source: str = "sim"
    job: str = ""
    args: dict = dataclasses.field(default_factory=dict)


def plan_fingerprint(plan) -> str:
    """Deterministic short id of a merge plan's bucket structure.
    Accepts a ``MergePlan`` or a bare buckets tuple."""
    buckets = getattr(plan, "buckets", plan)
    payload = ";".join(",".join(str(i) for i in b) for b in buckets)
    return hashlib.sha1(payload.encode()).hexdigest()[:12]
