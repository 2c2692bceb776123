"""Closed-form pipeline simulator for bucketed WFBP communication (Eqs. 6-8).

Port of ``repro.core.simulator.simulate``.  Given per-tensor backward times,
a merge plan, and an all-reduce cost model, replay the timeline:

  * gradients become ready in backward order at prefix sums of ``t_b``;
  * bucket k's all-reduce starts at ``max(ready(last tensor of k),
    end of bucket k-1's all-reduce)``                        (paper Eq. 7)
  * iteration time = t_f + final all-reduce end              (paper Eq. 8)
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.cost_model import AllReduceModel
from repro_torch.core.planner import MergePlan, TensorSpec


@dataclasses.dataclass(frozen=True)
class BucketEvent:
    bucket: int
    nbytes: int
    ready: float        # when the bucket's last gradient is produced
    start: float        # when its all-reduce starts
    end: float          # when its all-reduce completes


@dataclasses.dataclass(frozen=True)
class SimResult:
    t_f: float                 # forward time (input)
    t_b_total: float           # total backward compute
    comm_total: float          # sum of bucket all-reduce times
    comm_end: float            # timestamp (backward origin) of last comm end
    t_iter: float              # t_f + comm_end  (== paper Eq. 8)
    t_c_no: float              # non-overlapped communication (bottleneck)
    events: tuple[BucketEvent, ...]

    @property
    def overlap_ratio(self) -> float:
        """Fraction of communication hidden under computation."""
        if self.comm_total <= 0:
            return 1.0
        return max(0.0, 1.0 - self.t_c_no / self.comm_total)


def simulate(specs: Sequence[TensorSpec], plan: MergePlan,
             model: AllReduceModel, t_f: float = 0.0) -> SimResult:
    if plan.num_tensors != len(specs):
        raise ValueError(
            f"plan covers {plan.num_tensors} tensors, specs has {len(specs)}")
    ready, acc = [], 0.0
    for s in specs:
        acc += s.t_b
        ready.append(acc)
    t_b_total = acc

    events: list[BucketEvent] = []
    prev_end = 0.0
    comm_total = 0.0
    for k, bucket in enumerate(plan.buckets):
        nbytes = sum(specs[i].nbytes for i in bucket)
        r = ready[bucket[-1]]
        start = max(r, prev_end)
        dur = model.time(nbytes)
        end = start + dur
        comm_total += dur
        events.append(BucketEvent(k, nbytes, r, start, end))
        prev_end = end
    comm_end = prev_end if events else t_b_total
    comm_end = max(comm_end, t_b_total)
    return SimResult(
        t_f=t_f,
        t_b_total=t_b_total,
        comm_total=comm_total,
        comm_end=comm_end,
        t_iter=t_f + comm_end,
        t_c_no=comm_end - t_b_total,
        events=tuple(events),
    )
