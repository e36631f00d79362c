"""Routing policies over the ModelRegistry (a port of
analytics_zoo_tpu/serving/control_plane/routing.py): weighted A/B
between versions, and shadow traffic to a candidate.

* `WeightedAB`: seeded weighted choice over version names; the split is
  a function of the seed and the draw index.
* `ShadowSampler` + `run_shadow`: a sampled fraction of the primary
  traffic is duplicated to a candidate version, admitted with
  ``request_class="shadow"`` (lowest priority, no tenant charge), its
  output discarded by a background drain and its latency and SLO
  verdicts recorded on the shadow side only (`shadow_*` metrics, the
  shadow SLO tracker), so a slow candidate never touches the primary's
  `slo_violation_total`.

Both draw from numpy's generator, so for the same seed they make the
JAX package's picks.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np

from analytics_zoo_tpu_torch.observability import get_registry


class WeightedAB:
    """Seeded weighted choice over model versions."""

    __slots__ = ("weights", "_versions", "_probs", "_rng", "_lock")

    def __init__(self, weights: Dict[str, float], seed: int = 0):
        if not weights:
            raise ValueError("A/B weights must name at least one "
                             "version")
        total = float(sum(float(w) for w in weights.values()))
        if total <= 0:
            raise ValueError("A/B weights must sum to > 0")
        for v, w in weights.items():
            if float(w) < 0:
                raise ValueError(f"A/B weight for {v!r} is negative")
        self.weights = {str(v): float(w) for v, w in weights.items()}
        self._versions = sorted(self.weights)
        self._probs = np.array(
            [self.weights[v] / total for v in self._versions])
        self._rng = np.random.default_rng(int(seed))
        self._lock = threading.Lock()

    def choose(self) -> str:
        with self._lock:
            return str(self._rng.choice(self._versions, p=self._probs))


class ShadowSampler:
    """Seeded Bernoulli sampler: `sample()` is True for roughly
    `fraction` of draws, deterministically per seed."""

    __slots__ = ("version", "fraction", "_rng", "_lock")

    def __init__(self, version: str, fraction: float, seed: int = 0):
        if not 0.0 <= float(fraction) <= 1.0:
            raise ValueError("shadow fraction must be in [0, 1]")
        self.version = str(version)
        self.fraction = float(fraction)
        self._rng = np.random.default_rng(int(seed))
        self._lock = threading.Lock()

    def sample(self) -> bool:
        if self.fraction <= 0.0:
            return False
        if self.fraction >= 1.0:
            return True
        with self._lock:
            return bool(self._rng.random() < self.fraction)


def run_shadow(target, prompt, kw: dict,
               primary_request_id: Optional[str] = None) -> None:
    """Duplicate one request onto the shadow `target`: submit with
    ``request_class="shadow"`` and drain the stream on a daemon
    thread, discarding every token.  Any failure (queue shed, quota,
    engine stop) is swallowed into `shadow_dropped_total` — shadow
    traffic must never surface an error to the primary caller."""
    reg = get_registry()
    c_requests = reg.counter(
        "shadow_requests_total",
        help="requests duplicated to a shadow model version")
    c_dropped = reg.counter(
        "shadow_dropped_total",
        help="shadow duplicates that shed or failed (primary "
             "traffic is never affected)")
    h_e2e = reg.histogram(
        "shadow_e2e_seconds",
        help="end-to-end latency of shadow duplicates (recorded "
             "separately from primary request_e2e_seconds)")
    skw = dict(kw)
    skw["request_class"] = "shadow"
    skw.pop("stream", None)
    if primary_request_id is not None:
        skw["request_id"] = f"shadow-{primary_request_id}"
    c_requests.inc()
    import time as _time
    t0 = _time.monotonic()
    try:
        stream = target.submit(prompt, **skw)
    except Exception:
        c_dropped.inc()
        return

    def _drain():
        try:
            for _tok in stream:
                pass                       # output discarded
            h_e2e.record(_time.monotonic() - t0)
        except Exception:
            c_dropped.inc()

    threading.Thread(target=_drain, daemon=True,
                     name="shadow-drain").start()


__all__ = ["WeightedAB", "ShadowSampler", "run_shadow"]
