"""SLO tracking (a copy of analytics_zoo_tpu/observability/slo.py): are
we meeting the latency targets?

Iteration-level schedulers (the continuous-batching engine) are
judged on TTFT/TPOT percentiles *under an SLO*: the operator declares
targets, and the system reports attainment and counts violations per
dimension.  Targets live on `OrcaContext.slo_targets` as a dict over
the four request-latency dimensions the request log derives:

    OrcaContext.slo_targets = {"ttft_s": 0.5, "tpot_s": 0.05}

Every finished request (observability/request_log.py calls
`get_slo_tracker().observe(...)`) is judged against the configured
dimensions:

* `slo_violation_total` counts requests that missed >= 1 target, and
  the `slo_violation_<dim>_total` family counts per dimension — the
  alerting-rule inputs;
* `slo_attainment_ratio` is a rolling-window gauge: the fraction of
  the last `window` judged requests that met EVERY configured target
  (nan before the first judged request);
* `GET /slo` on `ServingServer` serves the full snapshot (targets,
  window attainment overall and per dimension, violation counts).

Targets are read at observe time, so they can be changed on a live
process; requests finished while no targets were set are not judged
(they do not dilute attainment).  A dimension whose measure is
unavailable for a request (e.g. TPOT on a 1-token response) does not
count as a violation of that dimension.

Keyed targets (the control plane's dimensions): alongside the
plain dimensions, `OrcaContext.slo_targets` accepts ``"model:<name>"``
and ``"tenant:<name>"`` keys mapping to per-model / per-tenant
dimension overrides.  A request finished with a model label or tenant
attribution is judged against base targets overlaid with its model's
overrides, then its tenant's (tenant wins); its verdict also lands in
a per-key rolling window, surfaced by `attainment_for()` and the
/slo + /stats payloads.

Shadow traffic is judged by a SEPARATE tracker
(`get_shadow_slo_tracker()`): the same machinery under the
``shadow_`` metric prefix — `shadow_slo_violation_total`,
`shadow_slo_attainment_ratio` and the per-dimension
`shadow_slo_violation_<dim>_total` family (literal prefix
``shadow_slo_violation_``) — so a slow shadow candidate can never
tick the primary `slo_violation_total` or drag the attainment the
admission shedder reads.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, Optional

from analytics_zoo_tpu_torch.observability.registry import (
    MetricsRegistry,
    get_registry,
)

#: the request-latency dimensions targets may be set over (the derived
#: measures of observability/request_log.py)
SLO_DIMENSIONS = ("ttft_s", "tpot_s", "queue_wait_s", "e2e_s")

#: rolling attainment window (judged requests)
DEFAULT_WINDOW = 512


class SLOTracker:
    """Rolling-window SLO judge over per-request latency measures."""

    def __init__(self, window: int = DEFAULT_WINDOW,
                 registry: Optional[MetricsRegistry] = None,
                 prefix: str = ""):
        self.window = window
        #: metric-name prefix: "" for the primary tracker, "shadow_"
        #: for the shadow tracker — two disjoint metric families
        self.prefix = str(prefix)
        self._lock = threading.Lock()
        #: per judged request: {dim: bool met} over the dims that were
        #: both targeted and measurable at judge time
        self._judged: "deque[Dict[str, bool]]" = deque(maxlen=window)
        #: per "model:<name>" / "tenant:<name>" key: rolling all-met
        #: verdicts of requests attributed to that key
        self._keyed: Dict[str, "deque[bool]"] = {}
        self._violations_by_dim: Dict[str, int] = {}
        self._n_judged = 0
        reg = registry if registry is not None else get_registry()
        self._reg = reg
        self._c_violations = reg.counter(
            self.prefix + "slo_violation_total",
            help="requests that missed at least one configured SLO "
                 "target")
        reg.gauge(
            self.prefix + "slo_attainment_ratio", fn=self.attainment,
            help="rolling-window fraction of judged requests meeting "
                 "every configured SLO target (nan before the first)")

    # ------------------------------------------------------------------

    @staticmethod
    def _targets() -> Optional[Dict[str, float]]:
        from analytics_zoo_tpu_torch.common.context import OrcaContext
        return OrcaContext.slo_targets

    @staticmethod
    def _overlay(targets: Dict[str, Any], kind: str,
                 name: Optional[str]) -> Optional[Dict[str, float]]:
        """The ``model:<name>`` / ``tenant:<name>`` override for
        `name`, falling back from a full ``name@version`` label to the
        bare model name."""
        if name is None:
            return None
        over = targets.get(f"{kind}:{name}")
        if over is None and "@" in str(name):
            over = targets.get(f"{kind}:{str(name).split('@', 1)[0]}")
        return over

    def effective_targets(self, model: Optional[str] = None,
                          tenant: Optional[str] = None) \
            -> Dict[str, float]:
        """Base dimension targets overlaid with the model's overrides,
        then the tenant's (tenant wins) — empty when unconfigured."""
        targets = self._targets() or {}
        eff = {d: t for d, t in targets.items() if d in SLO_DIMENSIONS}
        for kind, name in (("model", model), ("tenant", tenant)):
            over = self._overlay(targets, kind, name)
            if over:
                eff.update(over)
        return eff

    def observe(self, measures: Dict[str, Optional[float]],
                model: Optional[str] = None,
                tenant: Optional[str] = None) -> None:
        """Judge one finished request's derived latencies against the
        targets effective for its model/tenant attribution.  No-op
        when no targets are set."""
        targets = self.effective_targets(model=model, tenant=tenant)
        if not targets:
            return
        verdict: Dict[str, bool] = {}
        for dim, target in targets.items():
            value = measures.get(dim)
            if value is None:
                continue
            verdict[dim] = value <= target
        if not verdict:
            return
        missed = [d for d, ok in verdict.items() if not ok]
        all_met = not missed
        with self._lock:
            self._judged.append(verdict)
            self._n_judged += 1
            for d in missed:
                self._violations_by_dim[d] = (
                    self._violations_by_dim.get(d, 0) + 1)
            for kind, name in (("model", model), ("tenant", tenant)):
                if name is None:
                    continue
                dq = self._keyed.setdefault(
                    f"{kind}:{name}", deque(maxlen=self.window))
                dq.append(all_met)
        if missed:
            self._c_violations.inc()
            for d in missed:
                # the per-dimension family (literal prefix
                # slo_violation_)
                self._reg.counter(
                    f"{self.prefix}slo_violation_{d}_total",
                    help=f"requests missing the {d} SLO target").inc()

    # ------------------------------------------------------------------

    def attainment(self) -> float:
        """Window fraction meeting every judged dimension (nan before
        any judged request)."""
        with self._lock:
            if not self._judged:
                return float("nan")
            ok = sum(1 for v in self._judged if all(v.values()))
            return ok / len(self._judged)

    def attainment_for(self, key: str) -> float:
        """Window attainment of one ``model:<name>`` /
        ``tenant:<name>`` key (nan when nothing was attributed)."""
        with self._lock:
            dq = self._keyed.get(key)
            if not dq:
                return float("nan")
            return sum(1 for ok in dq if ok) / len(dq)

    def attainment_by_key(self) -> Dict[str, float]:
        """Window attainment per model/tenant key (control-plane
        /stats: which model version or tenant is missing its SLO)."""
        with self._lock:
            return {k: (sum(1 for ok in dq if ok) / len(dq))
                    for k, dq in sorted(self._keyed.items()) if dq}

    def attainment_by_dim(self) -> Dict[str, float]:
        with self._lock:
            counts: Dict[str, int] = {}
            met: Dict[str, int] = {}
            for v in self._judged:
                for d, ok in v.items():
                    counts[d] = counts.get(d, 0) + 1
                    met[d] = met.get(d, 0) + (1 if ok else 0)
        return {d: met[d] / counts[d] for d in sorted(counts)}

    def snapshot(self) -> Dict[str, Any]:
        """The GET /slo payload."""
        targets = self._targets()
        with self._lock:
            n_window = len(self._judged)
            n_judged = self._n_judged
            by_dim_viol = dict(self._violations_by_dim)
        att = self.attainment()
        by_dim = self.attainment_by_dim()
        by_key = self.attainment_by_key()
        out: Dict[str, Any] = {
            "targets": dict(targets) if targets else None,
            "window": self.window,
            "requests_judged": n_judged,
            "requests_in_window": n_window,
            "attainment": (round(att, 4) if att == att else None),
            "attainment_by_dim": {d: round(v, 4)
                                  for d, v in by_dim.items()},
            "attainment_by_model": {
                k.split(":", 1)[1]: round(v, 4)
                for k, v in by_key.items() if k.startswith("model:")},
            "attainment_by_tenant": {
                k.split(":", 1)[1]: round(v, 4)
                for k, v in by_key.items() if k.startswith("tenant:")},
            "violations_total": self._c_violations.value,
            "violations_by_dim": by_dim_viol,
        }
        return out

    def reset(self) -> None:
        with self._lock:
            self._judged.clear()
            self._keyed.clear()
            self._violations_by_dim.clear()
            self._n_judged = 0


# ----------------------------------------------------------------------

_global_lock = threading.Lock()
_global: Optional[SLOTracker] = None
_global_shadow: Optional[SLOTracker] = None


def get_slo_tracker() -> SLOTracker:
    global _global
    with _global_lock:
        if _global is None:
            _global = SLOTracker()
        return _global


def get_shadow_slo_tracker() -> SLOTracker:
    """The shadow-traffic judge: same machinery, ``shadow_`` metric
    prefix, fed only by requests finished with
    ``request_class="shadow"`` — shadow outcomes never touch the
    primary tracker the admission shedder reads."""
    global _global_shadow
    with _global_lock:
        if _global_shadow is None:
            _global_shadow = SLOTracker(prefix="shadow_")
        return _global_shadow


def reset_slo_tracker() -> SLOTracker:
    """Drop and re-create the global trackers (tests) against the
    CURRENT global registry."""
    global _global, _global_shadow
    with _global_lock:
        _global = None
        _global_shadow = None
    return get_slo_tracker()
