"""Drift monitor: EWMA residuals of predicted vs observed timings.

Port of ``repro.obs.drift``.  MG-WFBP's bucketing is only optimal for
the (a, b) model and t_b profile it was planned against; when the fabric
or the compute drifts, the plan silently degrades.  Two residual
families are watched:

* **iteration drift** — the closed-form prediction of the live plan
  (``core.simulator.simulate(...).t_iter``) vs the observed iteration
  time;
* **link drift** — each link's modeled occupancy ``a_l + b_l * nbytes``
  vs measured occupancies.

Residuals are *relative* (``|obs - pred| / pred``) and smoothed with an
EWMA so a single jittered iteration does not page anyone; a sustained
residual above ``threshold`` raises a :class:`DriftAlert`, which callers
wire to a refit and ``Planner.update`` (``repro_torch.train.replan``).
Alerts also feed the metrics registry (``obs_drift_alerts_total``) and,
when a :class:`~repro_torch.obs.recorder.FlightRecorder` is attached,
land as ``drift_alert`` events in its ring.

Only ``repro_torch.obs`` siblings at import time; the least-squares
refit helper imports ``repro_torch.core.cost_model`` lazily.
"""


from __future__ import annotations

import dataclasses

from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.recorder import EventRecord, FlightRecorder


@dataclasses.dataclass(frozen=True)
class DriftAlert:
    """One threshold crossing.  ``kind`` is ``"iteration"`` or
    ``"link"``; ``ewma`` is the smoothed relative residual that
    crossed ``threshold``."""

    kind: str
    iteration: int
    ewma: float
    threshold: float
    predicted: float
    observed: float
    link: str = ""

    @property
    def key(self) -> str:
        return f"link:{self.link}" if self.kind == "link" else "iteration"


@dataclasses.dataclass
class _Ewma:
    alpha: float
    value: float = 0.0
    n: int = 0

    def update(self, x: float) -> float:
        self.value = x if self.n == 0 else \
            self.alpha * x + (1.0 - self.alpha) * self.value
        self.n += 1
        return self.value


class DriftMonitor:
    """EWMA drift detection over prediction/observation pairs.

    ``observe`` returns a :class:`DriftAlert` when the smoothed relative
    residual for that key exceeds ``threshold`` (after ``warmup``
    samples), else ``None``.  After the caller reacts (refit + replan),
    call :meth:`reset` so the monitor re-learns against the new model
    instead of alerting on stale residual history.
    """

    def __init__(self, threshold: float = 0.15, alpha: float = 0.5,
                 warmup: int = 1, *,
                 recorder: FlightRecorder | None = None,
                 source: str = "sim", job: str = ""):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if threshold <= 0.0:
            raise ValueError(f"threshold must be > 0, got {threshold}")
        self.threshold = threshold
        self.alpha = alpha
        self.warmup = warmup
        self.recorder = recorder
        self.source = source
        self.job = job
        self._ewma: dict[str, _Ewma] = {}
        self.alerts: list[DriftAlert] = []

    def residual(self, key: str = "iteration") -> float:
        st = self._ewma.get(key)
        return st.value if st is not None else 0.0

    def observe(self, iteration: int, predicted: float, observed: float,
                *, link: str = "") -> DriftAlert | None:
        """Feed one prediction/observation pair; returns the alert it
        raised, if any."""
        if predicted <= 0.0:
            return None
        kind = "link" if link else "iteration"
        key = f"link:{link}" if link else "iteration"
        st = self._ewma.setdefault(key, _Ewma(self.alpha))
        ewma = st.update(abs(observed - predicted) / predicted)
        if st.n < self.warmup or ewma <= self.threshold:
            return None
        alert = DriftAlert(kind=kind, iteration=iteration, ewma=ewma,
                           threshold=self.threshold, predicted=predicted,
                           observed=observed, link=link)
        self.alerts.append(alert)
        REGISTRY.counter(
            "obs_drift_alerts_total",
            "drift alerts raised, by kind").inc(kind=kind)
        if self.recorder is not None:
            self.recorder.record(EventRecord(
                kind="drift_alert", time=float(iteration),
                source=self.source, job=self.job,
                args={"drift_kind": kind, "link": link, "ewma": ewma,
                      "threshold": self.threshold, "predicted": predicted,
                      "observed": observed}))
        return alert

    def observe_links(self, iteration: int, model,
                      link_samples: dict) -> list[DriftAlert]:
        """Compare a per-link path model against measured occupancies.

        ``model`` is duck-typed as either a mapping ``link -> object
        with .a/.b`` or an object with ``.paths`` (a sequence of phases
        carrying ``.link``/``.a``/``.b`` — the simulator's path models,
        where a link's affine cost is the sum over its phases).
        ``link_samples`` maps ``link -> [(nbytes, occupancy_s), ...]``
        (the engine's ``JobResult.link_samples``).
        """
        coeffs = _link_coefficients(model)
        out = []
        for link, samples in sorted(link_samples.items()):
            ab = coeffs.get(link)
            if ab is None or not samples:
                continue
            a, b = ab
            for nbytes, occ in samples:
                alert = self.observe(iteration, a + b * nbytes, occ,
                                     link=link)
                if alert is not None:
                    out.append(alert)
        return out

    def reset(self, key: str | None = None) -> None:
        """Forget residual history — for one key, or all of them
        (after a refit+replan)."""
        if key is None:
            self._ewma.clear()
        else:
            self._ewma.pop(key, None)


def _link_coefficients(model) -> dict[str, tuple[float, float]]:
    paths = getattr(model, "paths", None)
    if paths is not None:
        coeffs: dict[str, list[float]] = {}
        for phase in paths:
            cur = coeffs.setdefault(phase.link, [0.0, 0.0])
            cur[0] += phase.a
            cur[1] += phase.b
        return {k: (a, b) for k, (a, b) in coeffs.items()}
    out = {}
    for link, m in dict(model).items():
        out[link] = (m.a, m.b)
    return out


def fit_link_models(link_samples: dict) -> dict:
    """Least-squares refit of each link's affine occupancy model from
    engine samples; links with fewer than two distinct sizes (the fit
    would be degenerate) are skipped.  Returns ``link ->
    AllReduceModel``-like fitted models."""
    from repro_torch.core.cost_model import fit   # lazy: keep obs zero-dep

    out = {}
    for link, samples in sorted(link_samples.items()):
        sizes = [n for n, _ in samples]
        if len(set(sizes)) < 2:
            continue
        out[link] = fit(sizes, [t for _, t in samples], name=f"fit:{link}")
    return out
