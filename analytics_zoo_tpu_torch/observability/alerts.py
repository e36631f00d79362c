"""Declarative alerting over recorded metric history (a copy of
analytics_zoo_tpu/observability/alerts.py).

The `AlertEngine` consumes the sample lists the metrics history plane
records (observability/history.py) and evaluates a fixed set of
declarative rules — multi-window SLO burn rate, queue-growth slope,
floor collapses, dominant-blame-phase shifts — with hysteresis and
cooldown.  Two-layer design:

* `evaluate(samples)` is a PURE function of the samples: every
  timestamp in the state machine comes from the samples themselves
  (no ``time.time()`` anywhere in the evaluation path), so replaying
  a recorded trace reproduces a byte-identical alert sequence.  This
  is the interface an autoscaling controller consumes.

* `step(samples)` is the thin LIVE wrapper: it diffs `evaluate`'s
  event list against what was already emitted and fires the side
  effects — `alert_fired_total` / `alert_resolved_total` /
  `alert_active` metrics, a flight-ring instant (so alerts land on
  the fleet timeline) and a structured `log_event` record.

Rule state machine (all per rule, driven by sample timestamps)::

    inactive --cond true for >= for_s, past cooldown--> firing
    firing   --clear-cond true for >= clear_s--------> resolved
                                                      (cooldown_s)

Built-in rules are registered in `BUILTIN_ALERTS`, the JAX package's
names.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

#: Registry of built-in rule names (the check_alert_rules.py lint
#: anchors on this tuple; keep it in sync with builtin_rules()).
BUILTIN_ALERTS = (
    "slo_burn_rate",
    "queue_depth_growth",
    "goodput_floor",
    "prefix_cache_collapse",
    "speculation_collapse",
    "recompile_storm",
    "blame_shift",
)

_KINDS = ("burn_rate", "slope", "floor", "shift")


@dataclass
class AlertRule:
    """One declarative rule.  `params` are kind-specific:

    * ``burn_rate`` — over an attainment-ratio gauge: ``target`` (SLO
      objective), ``threshold`` (burn multiple), ``short_s``/``long_s``
      (the two windows; fires only when BOTH burn above threshold —
      the classic multi-window guard against blips), ``clear_ratio``
      (hysteresis: clears once short-window burn < threshold*ratio).
    * ``slope`` — least-squares slope (/s) of a gauge over
      ``window_s``; fires above ``min_slope`` (needs >= 3 points);
      clears below ``min_slope * clear_ratio``.
    * ``floor`` — windowed mean of a gauge below ``floor``; optional
      ``guard_counters`` + ``guard_min_rate`` require the listed
      counters' combined rate over the window to exceed the guard
      (a cache with no traffic is not "collapsed"); clears once the
      mean >= ``floor * clear_ratio``.
    * ``shift`` — a categorical gauge (e.g. the blame plane's
      ``blame_tail_phase_code``) whose latest value differs from the
      modal value of the older points in ``window_s`` (needs >=
      ``min_points`` points; negative values are the no-data
      sentinel).  Clears — resolving naturally — once the new value
      has persisted long enough to BECOME the window's mode.
    """
    name: str
    metric: str
    kind: str
    params: Dict[str, float] = field(default_factory=dict)
    for_s: float = 0.0
    clear_s: float = 0.0
    cooldown_s: float = 0.0
    severity: str = "warn"

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"rule {self.name!r}: unknown kind {self.kind!r}")


def builtin_rules() -> Tuple[AlertRule, ...]:
    """The default rule set (names == BUILTIN_ALERTS, asserted)."""
    rules = (
        AlertRule(
            "slo_burn_rate", metric="slo_attainment_ratio",
            kind="burn_rate",
            params={"target": 0.9, "threshold": 2.0,
                    "short_s": 15.0, "long_s": 60.0,
                    "clear_ratio": 0.5},
            for_s=0.0, clear_s=5.0, cooldown_s=30.0, severity="page"),
        AlertRule(
            "queue_depth_growth", metric="generation_queue_depth",
            kind="slope",
            params={"min_slope": 0.5, "window_s": 30.0,
                    "clear_ratio": 0.5},
            for_s=5.0, clear_s=10.0, cooldown_s=30.0),
        AlertRule(
            "goodput_floor", metric="goodput_ratio", kind="floor",
            params={"floor": 0.5, "window_s": 30.0,
                    "clear_ratio": 1.2},
            for_s=5.0, clear_s=10.0, cooldown_s=60.0),
        AlertRule(
            "prefix_cache_collapse", metric="prefix_cache_hit_rate",
            kind="floor",
            params={"floor": 0.2, "window_s": 30.0,
                    "clear_ratio": 1.5, "guard_min_rate": 1.0},
            for_s=5.0, clear_s=10.0, cooldown_s=60.0),
        AlertRule(
            "speculation_collapse",
            metric="speculation_acceptance_rate", kind="floor",
            params={"floor": 0.1, "window_s": 30.0,
                    "clear_ratio": 1.5, "guard_min_rate": 0.5},
            for_s=5.0, clear_s=10.0, cooldown_s=60.0),
        AlertRule(
            # slope over the cumulative compile-event counter (the
            # counter fallback in `_metric_points`) = compiles/sec.
            # Steady state is ZERO new programs after warmup, so a
            # sustained rate above one compile per ~5s means a
            # signature keeps forking — the profiling plane's
            # compile-event diffs name the leaf
            "recompile_storm", metric="compile_events_total",
            kind="slope",
            params={"min_slope": 0.2, "window_s": 30.0,
                    "clear_ratio": 0.25},
            for_s=5.0, clear_s=10.0, cooldown_s=60.0,
            severity="page"),
        AlertRule(
            # the dominant p99-tail blame phase changed (queue-
            # dominated ↔ compute-dominated ↔ ...): exactly the
            # distinction the SLO autoscaler keys scale-out vs
            # scale-up decisions on, so a shift is worth a page-less
            # heads-up even before any SLO burns
            "blame_shift", metric="blame_tail_phase_code",
            kind="shift",
            params={"window_s": 60.0, "min_points": 3.0},
            for_s=5.0, clear_s=10.0, cooldown_s=60.0),
    )
    rules[3].params["guard_counters"] = (
        "prefix_cache_hits_total", "prefix_cache_misses_total")
    rules[4].params["guard_counters"] = ("speculation_rounds_total",)
    assert tuple(r.name for r in rules) == BUILTIN_ALERTS
    return rules


# -- pure evaluation helpers ------------------------------------------


def _metric_points(samples: List[Dict[str, Any]], name: str
                   ) -> List[Tuple[float, float]]:
    """(ts, value) for a gauge (falling back to counter level),
    merged across procs on the shared wall clock."""
    out = []
    for s in samples:
        v = s.get("gauges", {}).get(name)
        if v is None:
            v = s.get("counters", {}).get(name)
        if v is not None:
            out.append((s["ts"], float(v)))
    return out


def _window(points: List[Tuple[float, float]], ts: float,
            window_s: float) -> List[Tuple[float, float]]:
    return [(t, v) for t, v in points if ts - window_s < t <= ts]


def _counter_rate_over(samples: List[Dict[str, Any]], names, ts: float,
                       window_s: float) -> Optional[float]:
    """Summed per-proc increase of `names` over the trailing window,
    divided by the window span actually covered.  None when fewer
    than two in-window points exist for every (proc, name)."""
    total, t_min, t_max = 0.0, None, None
    seen_pair = False
    per: Dict[Tuple[str, str], List[Tuple[float, float]]] = {}
    for s in samples:
        t = s["ts"]
        if not (ts - window_s < t <= ts):
            continue
        for name in names:
            v = s.get("counters", {}).get(name)
            if v is not None:
                per.setdefault((s.get("proc", ""), name), []).append(
                    (t, float(v)))
    for pts in per.values():
        if len(pts) < 2:
            continue
        seen_pair = True
        delta = pts[-1][1] - pts[0][1]
        if delta < 0:       # counter reset
            delta = pts[-1][1]
        total += delta
        t_min = pts[0][0] if t_min is None else min(t_min, pts[0][0])
        t_max = pts[-1][0] if t_max is None else max(t_max, pts[-1][0])
    if not seen_pair or t_max is None or t_max <= t_min:
        return None
    return total / (t_max - t_min)


def _lsq_slope(points: List[Tuple[float, float]]) -> Optional[float]:
    n = len(points)
    if n < 3:
        return None
    t0 = points[0][0]
    xs = [t - t0 for t, _v in points]
    ys = [v for _t, v in points]
    mx = sum(xs) / n
    my = sum(ys) / n
    den = sum((x - mx) ** 2 for x in xs)
    if den == 0:
        return None
    return sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / den


class AlertEngine:
    """Evaluates rules over a sample list.  Stateless between calls —
    `evaluate` recomputes the full state machine from the samples it
    is given, which is what makes replay exact."""

    def __init__(self, rules: Tuple[AlertRule, ...] = ()):
        self.rules = tuple(rules) if rules else builtin_rules()
        self._emitted: set = set()

    # -- pure ----------------------------------------------------------

    def _conditions(self, rule: AlertRule,
                    samples: List[Dict[str, Any]], ts: float
                    ) -> Tuple[Optional[float], bool, bool]:
        """(reported value, fire-condition, clear-condition) at one
        sample timestamp.  Value None = metric absent at ts."""
        p = rule.params
        if rule.kind == "burn_rate":
            target = p["target"]
            budget = max(1e-9, 1.0 - target)
            pts = _metric_points(samples, rule.metric)
            short = _window(pts, ts, p["short_s"])
            long_ = _window(pts, ts, p["long_s"])
            if not short or not long_:
                return None, False, False
            burn_s = (1.0 - sum(v for _t, v in short) / len(short)) \
                / budget
            burn_l = (1.0 - sum(v for _t, v in long_) / len(long_)) \
                / budget
            thr = p["threshold"]
            fire = burn_s > thr and burn_l > thr
            clear = burn_s < thr * p.get("clear_ratio", 0.5)
            return round(burn_s, 9), fire, clear
        if rule.kind == "slope":
            pts = _window(_metric_points(samples, rule.metric), ts,
                          p["window_s"])
            slope = _lsq_slope(pts)
            if slope is None:
                return None, False, False
            thr = p["min_slope"]
            return (round(slope, 9), slope > thr,
                    slope < thr * p.get("clear_ratio", 0.5))
        if rule.kind == "shift":
            pts = _window(_metric_points(samples, rule.metric), ts,
                          p["window_s"])
            if len(pts) < int(p.get("min_points", 3)):
                return None, False, False
            latest = pts[-1][1]
            older = [v for _t, v in pts[:-1] if v >= 0]
            if latest < 0 or not older:
                return None, False, False   # no-data sentinel
            counts: Dict[float, int] = {}
            for v in older:
                counts[v] = counts.get(v, 0) + 1
            peak = max(counts.values())
            # ties broken by smallest value — deterministic under
            # replay regardless of dict iteration history
            baseline = min(v for v, c in counts.items() if c == peak)
            changed = latest != baseline
            return round(latest, 9), changed, not changed
        # floor
        pts = _window(_metric_points(samples, rule.metric), ts,
                      p["window_s"])
        if not pts:
            return None, False, False
        guard_names = p.get("guard_counters")
        if guard_names:
            rate = _counter_rate_over(samples, guard_names, ts,
                                      p["window_s"])
            if rate is None or rate < p.get("guard_min_rate", 0.0):
                return None, False, False
        mean = sum(v for _t, v in pts) / len(pts)
        floor = p["floor"]
        return (round(mean, 9), mean < floor,
                mean >= floor * p.get("clear_ratio", 1.0))

    def evaluate(self, samples: List[Dict[str, Any]]
                 ) -> Dict[str, Any]:
        """Run the full state machine over the samples.  PURE: no
        clock reads, no registry access; same samples → byte-identical
        result (round-tripped through json.dumps)."""
        samples = sorted(samples,
                         key=lambda s: (s.get("ts", 0.0),
                                        str(s.get("proc")),
                                        s.get("seq", 0)))
        ts_list = sorted({s["ts"] for s in samples})
        events: List[Dict[str, Any]] = []
        active: Dict[str, Dict[str, Any]] = {}
        for rule in self.rules:
            firing = False
            cond_since: Optional[float] = None
            clear_since: Optional[float] = None
            cooldown_until = -float("inf")
            fired_at = 0.0
            last_value: Optional[float] = None
            for ts in ts_list:
                value, cond, clear = self._conditions(rule, samples,
                                                      ts)
                if value is not None:
                    last_value = value
                if not firing:
                    if cond and ts >= cooldown_until:
                        if cond_since is None:
                            cond_since = ts
                        if ts - cond_since >= rule.for_s:
                            firing, fired_at = True, ts
                            clear_since = None
                            events.append({
                                "ts": ts, "rule": rule.name,
                                "state": "firing",
                                "severity": rule.severity,
                                "metric": rule.metric,
                                "value": value})
                    else:
                        cond_since = None
                else:
                    if clear:
                        if clear_since is None:
                            clear_since = ts
                        if ts - clear_since >= rule.clear_s:
                            firing = False
                            cond_since = None
                            cooldown_until = ts + rule.cooldown_s
                            events.append({
                                "ts": ts, "rule": rule.name,
                                "state": "resolved",
                                "severity": rule.severity,
                                "metric": rule.metric,
                                "value": value})
                    else:
                        clear_since = None
            if firing:
                active[rule.name] = {"since": fired_at,
                                     "severity": rule.severity,
                                     "metric": rule.metric,
                                     "value": last_value}
        events.sort(key=lambda e: (e["ts"], e["rule"], e["state"]))
        return {"events": events, "active": active,
                "rules": [r.name for r in self.rules]}

    # -- live wrapper --------------------------------------------------

    def step(self, samples: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Evaluate, then emit side effects for events not yet seen.
        The emitted-set is keyed (rule, state, ts) so a re-evaluation
        over an overlapping window never double-fires."""
        from analytics_zoo_tpu_torch.observability import flight_recorder
        from analytics_zoo_tpu_torch.observability.events import log_event
        from analytics_zoo_tpu_torch.observability.registry import (
            get_registry, sanitize_metric_name)
        result = self.evaluate(samples)
        reg = get_registry()
        for ev in result["events"]:
            key = (ev["rule"], ev["state"], ev["ts"])
            if key in self._emitted:
                continue
            self._emitted.add(key)
            if ev["state"] == "firing":
                reg.counter("alert_fired_total",
                            help="alerts fired").inc()
                reg.counter(
                    "alert_fired_"
                    + sanitize_metric_name(ev["rule"]) + "_total",
                    help=f"{ev['rule']} alerts fired").inc()
            else:
                reg.counter("alert_resolved_total",
                            help="alerts resolved").inc()
            flight_recorder.record("alert", rule=ev["rule"],
                                   state=ev["state"],
                                   severity=ev["severity"],
                                   value=ev["value"])
            log_event("alert", rule=ev["rule"], state=ev["state"],
                      severity=ev["severity"], metric=ev["metric"],
                      value=ev["value"], sample_ts=ev["ts"])
        reg.gauge("alert_active",
                  help="currently firing alerts").set(
                      len(result["active"]))
        # bound the emitted-set: drop keys older than the window start
        if samples:
            horizon = min(s["ts"] for s in samples)
            self._emitted = {k for k in self._emitted
                             if k[2] >= horizon}
        return result
