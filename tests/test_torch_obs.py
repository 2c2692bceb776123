"""The port's observability modules against the reference's, on the CPU.

``repro_torch.obs`` is a stdlib-only copy of ``repro.obs``.  The same
inputs go through both packages and must give *equal* results, compared
with ``==`` (tolerance: exact): histogram buckets and quantiles, snapshot
delta, merge and dict round trip, the flight recorder's ring and eviction
count, its JSONL round trip (byte for byte), the Chrome trace dicts and
counter tracks, and the drift monitor's alert sequences.

The JSONL property test binds its strategy by keyword: a positional
``@given`` strategy binds to the rightmost parameter, which in the
reference's ``test_obs_props.py::test_recorder_round_trip_identity`` is the
``tmp_path_factory`` fixture, so pytest looks for a fixture named
``records`` and the setup errors.
"""

import dataclasses
import json
import math
import os
import tempfile
import types

import pytest

pytest.importorskip("torch")
pytest.importorskip("hypothesis", reason="the JSONL test needs hypothesis")

from hypothesis import given, settings, strategies as st  # noqa: E402

import repro.obs as r_obs  # noqa: E402
from repro.core import cost_model as r_cost  # noqa: E402
from repro.obs import drift as r_drift  # noqa: E402
from repro.obs import metrics as r_metrics  # noqa: E402
from repro.obs import recorder as r_recorder  # noqa: E402
from repro.obs import timeline as r_timeline  # noqa: E402
import repro_torch.obs as obs  # noqa: E402
from repro_torch.core import cost_model  # noqa: E402
from repro_torch.obs import drift, metrics, recorder, timeline  # noqa: E402

VALUES = [0.0, -1.0, float("nan"), float("inf"), 5e-324, 1e-300, 0.75, 1.0,
          1.5, 2.0, 3.0e8, 1.7976931348623157e308]


def test_exports_match_reference():
    assert obs.__all__ == r_obs.__all__
    for name in obs.__all__:
        assert hasattr(obs, name), name


@pytest.mark.parametrize("value", VALUES, ids=repr)
def test_bucket_index_and_edge_match_reference(value):
    idx = metrics.bucket_index(value)
    assert idx == r_metrics.bucket_index(value)
    assert metrics.bucket_upper_edge(idx) == r_metrics.bucket_upper_edge(idx)


def _fill(pkg, values, **labels):
    reg = pkg.Registry()
    h = reg.histogram("step_s", "wall")
    for v in values:
        h.observe(v, **labels)
    return reg, h


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_buckets_and_quantiles_match_reference(seed):
    import random
    rng = random.Random(seed)
    values = [rng.lognormvariate(-3, 2) for _ in range(200)] + [0.0, 2.0]
    reg, h = _fill(metrics, values, job="a")
    r_reg, r_h = _fill(r_metrics, values, job="a")
    assert reg.snapshot().to_dict() == r_reg.snapshot().to_dict()
    assert h.count(job="a") == r_h.count(job="a") == len(values)
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert h.quantile(q, job="a") == r_h.quantile(q, job="a")
        assert reg.snapshot().quantile("step_s", q, job="a") == \
            r_reg.snapshot().quantile("step_s", q, job="a")
    with pytest.raises(ValueError):
        h.quantile(1.5, job="a")


def _drive(pkg, phase):
    """Counters, gauges and histograms over two label sets; ``phase`` 0 is
    the earlier window, 1 adds to it."""
    reg = pkg.Registry()
    c = reg.counter("buckets_total", "issued")
    g = reg.gauge("plan_buckets", "in force")
    h = reg.histogram("step_s", "wall")
    for i in range(5 + 3 * phase):
        c.inc(1.0 + i, job="a")
        c.inc(0.5, job="b")
        g.set(142 - i, job="a")
        g.add(0.25, job="b")
        h.observe(0.3 + 0.01 * i, job="a")
        h.observe(2.0 ** -i, job="b")
    return reg


def test_snapshot_algebra_matches_reference():
    early, late = _drive(metrics, 0), _drive(metrics, 1)
    r_early, r_late = _drive(r_metrics, 0), _drive(r_metrics, 1)
    s0, s1 = early.snapshot(), late.snapshot()
    r0, r1 = r_early.snapshot(), r_late.snapshot()
    assert s1.delta(s0).to_dict() == r1.delta(r0).to_dict()
    assert s0.merge(s1).to_dict() == r0.merge(r1).to_dict()
    assert metrics.merge_all([s0, s1, s0]).to_dict() == \
        r_metrics.merge_all([r0, r1, r0]).to_dict()
    # the dict form survives JSON, and each package reads the other's
    wire = json.loads(json.dumps(s1.to_dict()))
    assert metrics.Snapshot.from_dict(wire) == s1
    assert r_metrics.Snapshot.from_dict(wire).to_dict() == s1.to_dict()
    for name, labels in (("buckets_total", {"job": "a"}),
                         ("plan_buckets", {"job": "b"})):
        assert s1.value(name, **labels) == r1.value(name, **labels)
    assert s1.hist("step_s", job="b") == r1.hist("step_s", job="b")
    with pytest.raises(TypeError):
        s1.value("step_s", job="a")
    with pytest.raises(TypeError):
        late.counter("plan_buckets")
    late.reset()
    r_late.reset()
    assert late.snapshot().to_dict() == r_late.snapshot().to_dict()
    assert late.names() == r_late.names()


def _iteration(pkg, i):
    buckets = tuple(pkg.BucketRecord(bucket=k, nbytes=1000 * (k + 1),
                                     ready=i + 0.1 * k, start=i + 0.1 * k,
                                     end=i + 0.1 * k + 0.05,
                                     comm_s=-1.0 if k else 0.04)
                    for k in range(3))
    return pkg.IterationRecord(
        source="train", job="replan", iteration=i, start=float(i),
        end=i + 0.7, backward_end=i + 0.5, buckets=buckets,
        worker_end=(("w0", i + 0.7),), args={"plan": "abc", "k": i})


def _event(pkg, i):
    return pkg.EventRecord(kind="planner_update", time=float(i),
                           source="planner", args={"num_buckets": 10 - i})


@pytest.mark.parametrize("capacity", [1, 3, 16])
def test_ring_eviction_matches_reference(capacity):
    rings = []
    for pkg in (recorder, r_recorder):
        ring = pkg.FlightRecorder(capacity)
        for i in range(7):
            ring.record(_iteration(pkg, i))
            ring.record(_event(pkg, i))
        rings.append(ring)
    ring, r_ring = rings
    assert (len(ring), ring.evicted, ring.recorded) == \
        (len(r_ring), r_ring.evicted, r_ring.recorded)
    assert [recorder.record_to_obj(r) for r in ring.records] == \
        [r_recorder.record_to_obj(r) for r in r_ring.records]
    assert len(ring.iterations("replan")) == len(r_ring.iterations("replan"))
    assert len(ring.events("planner_update")) == \
        len(r_ring.events("planner_update"))
    with pytest.raises(TypeError):
        ring.record("not a record")
    ring.clear()
    assert (len(ring), ring.evicted, ring.recorded) == (0, 0, 0)


times = st.floats(min_value=0.0, max_value=1e6, allow_nan=False,
                  allow_infinity=False)
pairs = st.lists(st.tuples(st.text(alphabet="abcxyz", min_size=1,
                                   max_size=4), times),
                 max_size=3).map(tuple)
bucket_records = st.builds(
    recorder.BucketRecord,
    bucket=st.integers(min_value=0, max_value=99),
    nbytes=st.integers(min_value=0, max_value=1 << 40),
    ready=times, start=times, end=times, comm_s=times)
iteration_records = st.builds(
    recorder.IterationRecord,
    source=st.sampled_from(["sim", "train"]),
    job=st.text(alphabet="abcdef", min_size=1, max_size=6),
    iteration=st.integers(min_value=0, max_value=10**6),
    start=times, end=times, backward_end=times,
    staleness=st.integers(min_value=0, max_value=64),
    buckets=st.lists(bucket_records, max_size=4).map(tuple),
    worker_compute=pairs, worker_start=pairs, worker_end=pairs,
    link_bytes=pairs, link_busy=pairs,
    args=st.dictionaries(st.text(alphabet="abc", min_size=1, max_size=3),
                         st.one_of(times, st.text(max_size=8)),
                         max_size=3))
event_records = st.builds(
    recorder.EventRecord,
    kind=st.sampled_from(["planner_update", "drift_alert"]),
    time=times,
    source=st.sampled_from(["planner", "train"]),
    job=st.text(alphabet="abcdef", max_size=6),
    args=st.dictionaries(st.text(alphabet="xyz", min_size=1, max_size=3),
                         times, max_size=3))


@given(records=st.lists(st.one_of(iteration_records, event_records),
                        max_size=20))
@settings(max_examples=40, deadline=None)
def test_jsonl_round_trip_identity_and_reference_bytes(records):
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "port.jsonl")
        recorder.write_jsonl(path, records)
        assert recorder.read_jsonl(path) == records
        # the same records written by the reference give the same bytes
        r_records = [r_recorder.record_from_obj(recorder.record_to_obj(r))
                     for r in records]
        r_path = os.path.join(tmp, "ref.jsonl")
        r_recorder.write_jsonl(r_path, r_records)
        with open(path) as f, open(r_path) as g:
            assert f.read() == g.read()
        assert [r_recorder.record_to_obj(r)
                for r in r_recorder.read_jsonl(path)] == \
            [recorder.record_to_obj(r) for r in records]


def _spans(pkg):
    return [pkg.Span(name=f"s{i}", cat="comm" if i % 2 else "step",
                     pid="train:replan", tid="comm" if i % 2 else "step",
                     start=0.1 * i, end=0.1 * i + 0.0375,
                     args={"bucket": i}) for i in range(5)]


def _counters(pkg):
    return [pkg.CounterSample(name="staleness", pid="train/counters",
                              time=0.5 * i, values={"staleness": i % 3})
            for i in range(4)]


def test_chrome_trace_matches_reference(tmp_path):
    trace = timeline.to_chrome_trace(_spans(timeline), _counters(timeline))
    r_trace = r_timeline.to_chrome_trace(_spans(r_timeline),
                                         _counters(r_timeline))
    assert trace == r_trace
    assert timeline.to_chrome_trace(_spans(timeline)) == \
        r_timeline.to_chrome_trace(_spans(r_timeline))
    assert timeline.from_chrome_trace(trace) == _spans(timeline)
    assert timeline.chrome_counters(trace) == _counters(timeline)
    # a foreign trace without the sidecar fields reads the same in both
    foreign = {"traceEvents": [{k: v for k, v in ev.items()
                                if k not in ("ts_s", "end_s")}
                               for ev in trace["traceEvents"]]}
    assert [dataclasses.astuple(s) for s in
            timeline.from_chrome_trace(foreign)] == \
        [dataclasses.astuple(s) for s in
         r_timeline.from_chrome_trace(foreign)]
    path = str(tmp_path / "t.json")
    timeline.write_chrome_trace(path, _spans(timeline), _counters(timeline))
    assert timeline.read_chrome_trace(path) == _spans(timeline)
    assert r_timeline.read_chrome_trace(path) == _spans(r_timeline)
    with pytest.raises(ValueError):
        timeline.Span("x", "step", "p", "t", start=1.0, end=0.5)


def _job_result():
    its = [types.SimpleNamespace(
        index=i, start=float(i), end=i + 0.9, backward_end=i + 0.6,
        staleness=i % 2,
        buckets=[types.SimpleNamespace(bucket=k, nbytes=64 << k,
                                       ready=i + 0.2 * k, start=i + 0.2 * k,
                                       end=i + 0.2 * k + 0.1, comm_s=-1.0)
                 for k in range(2)],
        worker_compute=[("w0", 0.5), ("w1", 0.6)],
        worker_start=[("w0", float(i)), ("w1", float(i))],
        worker_end=[("w0", i + 0.9), ("w1", i + 0.8)],
        link_bytes=[("ici", 128.0)], link_busy=[("ici", 0.3)])
        for i in range(3)]
    return types.SimpleNamespace(name="job0", iterations=its)


def test_counter_tracks_records_and_spans_match_reference():
    job = _job_result()
    assert [dataclasses.astuple(c) for c in
            timeline.counter_samples_from(job)] == \
        [dataclasses.astuple(c) for c in
         r_timeline.counter_samples_from(job)]
    recs = [recorder.from_iteration_result(it, job="j", args={"x": 1})
            for it in job.iterations]
    r_recs = [r_recorder.from_iteration_result(it, job="j", args={"x": 1})
              for it in job.iterations]
    assert [recorder.record_to_obj(r) for r in recs] == \
        [r_recorder.record_to_obj(r) for r in r_recs]
    recs.append(_event(recorder, 0))
    r_recs.append(_event(r_recorder, 0))
    assert [dataclasses.astuple(s) for s in recorder.record_spans(recs)] == \
        [dataclasses.astuple(s) for s in r_recorder.record_spans(r_recs)]
    assert recorder.plan_fingerprint(((0, 1), (2,))) == \
        r_recorder.plan_fingerprint(((0, 1), (2,)))


STREAMS = {
    "calibrated": [(1.0, 1.0 + 0.01 * (i % 3)) for i in range(12)],
    "sustained": [(1.0, 1.0)] * 3 + [(1.0, 1.6)] * 6 + [(1.0, 1.0)] * 6,
    "spike": [(1.0, 1.0)] * 4 + [(1.0, 5.0)] + [(1.0, 1.0)] * 4,
    "zero_prediction": [(0.0, 1.0), (2.0, 3.0), (2.0, 3.0)],
}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_drift_alert_sequence_matches_reference(stream):
    outs = []
    for d, rec_mod, reg in ((drift, recorder, metrics.REGISTRY),
                            (r_drift, r_recorder, r_metrics.REGISTRY)):
        ring = rec_mod.FlightRecorder()
        mon = d.DriftMonitor(threshold=0.2, alpha=0.5, warmup=2,
                             recorder=ring, source="train", job="replan")
        before = reg.snapshot()
        alerts, residuals = [], []
        for i, (pred, obs_t) in enumerate(STREAMS[stream]):
            a = mon.observe(i, pred, obs_t)
            alerts.append(None if a is None else dataclasses.astuple(a))
            residuals.append(mon.residual())
            if i == 8:
                mon.reset()
        delta = reg.snapshot().delta(before)
        outs.append((alerts, residuals,
                     [rec_mod.record_to_obj(e) for e in ring.events()],
                     delta.value("obs_drift_alerts_total", kind="iteration")))
    assert outs[0] == outs[1]
    with pytest.raises(ValueError):
        drift.DriftMonitor(alpha=0.0)


def test_link_drift_and_refit_match_reference():
    samples = {"nvlink": [(1 << 20, 3.0e-5), (1 << 24, 2.1e-4),
                          (1 << 26, 8.0e-4)],
               "pcie": [(1 << 20, 9.0e-5)],
               "idle": []}
    path = types.SimpleNamespace(paths=[
        types.SimpleNamespace(link="nvlink", a=1e-5, b=1e-11),
        types.SimpleNamespace(link="nvlink", a=2e-6, b=1e-12),
        types.SimpleNamespace(link="pcie", a=5e-5, b=3e-11)])
    outs = []
    for d, cm in ((drift, cost_model), (r_drift, r_cost)):
        flat = {"nvlink": cm.AllReduceModel(1e-5, 1e-11),
                "pcie": cm.AllReduceModel(5e-5, 3e-11),
                "idle": cm.AllReduceModel(1e-5, 0.0)}
        mon = d.DriftMonitor(threshold=0.1, warmup=1)
        alerts = [dataclasses.astuple(a) for model in (flat, path)
                  for a in mon.observe_links(3, model, samples)]
        fitted = {k: (m.a, m.b, m.name)
                  for k, m in d.fit_link_models(samples).items()}
        outs.append((alerts, fitted, mon.residual("link:nvlink")))
    assert outs[0] == outs[1]
    assert set(outs[0][1]) == {"nvlink"}         # one-size links skipped
    assert all(math.isfinite(x) for x in outs[0][1]["nvlink"][:2])
