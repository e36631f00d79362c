"""Open-loop overload harness: seeded arrival-process load (a port of
analytics_zoo_tpu/serving/streaming/open_loop.py).

A closed-loop bench (N clients, each waiting for its answer) never
overloads a server: offered load throttles itself to capacity.
Independent users do not wait for each other, so arrivals here are an
external, seeded process:

* ``poisson_trace(rate, duration, seed)``: exponential gaps;
* ``bursty_trace(rate, duration, seed, burstiness)``: a Gamma-modulated
  Poisson process, each window's rate drawn from a Gamma of mean
  `rate` and shape ``1/burstiness``.

Both draw from numpy's generator, so for the same arguments they are
the JAX package's traces, element for element.

``run_open_loop(submit, arrivals, slo_s=...)`` fires `submit(i)` at each
arrival offset whatever the completions, and reports goodput, SLO
attainment of the admitted requests, the shed rate, time-to-shed, and
p50/p99/p99.9 of admitted latency.  `submit` returns a dict
``{"status": "ok"|"shed"|"error", "retry_after": bool}`` (other keys
reach the caller in ``results``)."""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Sequence

import numpy as np


def poisson_trace(rate_hz: float, duration_s: float,
                  seed: int = 0) -> List[float]:
    """Arrival offsets (seconds from t0) of a Poisson process."""
    if rate_hz <= 0 or duration_s <= 0:
        return []
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    while True:
        t += float(rng.exponential(1.0 / rate_hz))
        if t >= duration_s:
            return out
        out.append(t)


def bursty_trace(rate_hz: float, duration_s: float, seed: int = 0,
                 burstiness: float = 4.0,
                 window_s: float = 0.5) -> List[float]:
    """Gamma-modulated Poisson arrivals: each `window_s` window draws
    its own rate from Gamma(shape=1/burstiness, scale=rate*burstiness)
    — mean `rate_hz`, variance growing with `burstiness` — then fills
    the window with Poisson arrivals at that rate."""
    if rate_hz <= 0 or duration_s <= 0:
        return []
    if burstiness <= 0:
        raise ValueError("burstiness must be > 0")
    rng = np.random.default_rng(seed)
    out: List[float] = []
    t0 = 0.0
    while t0 < duration_s:
        w = min(window_s, duration_s - t0)
        r = float(rng.gamma(1.0 / burstiness, rate_hz * burstiness))
        t = t0
        while r > 0:
            t += float(rng.exponential(1.0 / r))
            if t >= t0 + w:
                break
            out.append(t)
        t0 += window_s
    return out


def _percentile(xs: Sequence[float], q: float) -> float:
    if not xs:
        return 0.0
    return float(np.percentile(np.asarray(xs, np.float64), q))


def run_open_loop(submit: Callable[[int], Dict[str, Any]],
                  arrivals: Sequence[float], *, slo_s: float,
                  max_workers: int = 256) -> Dict[str, Any]:
    """Replay `arrivals` open-loop against `submit` and report.

    Each arrival gets a worker that sleeps until its offset and fires
    — completions never gate later arrivals (the open-loop property).
    `start_lag_p99_s` reports scheduling fidelity: if the worker pool
    saturated, late fires show up there instead of silently converting
    the run back to closed-loop."""
    from analytics_zoo_tpu_torch.observability import get_registry
    reg = get_registry()
    c_offered = reg.counter(
        "harness_offered_total",
        help="open-loop arrivals fired at a serving stack")
    c_admitted = reg.counter(
        "harness_admitted_total",
        help="open-loop requests admitted (not shed)")
    c_shed = reg.counter(
        "harness_shed_total",
        help="open-loop requests promptly shed (429/503)")
    c_errors = reg.counter(
        "harness_errors_total",
        help="open-loop requests that failed outside the shed path")

    results: List[Dict[str, Any]] = [None] * len(arrivals)
    lags: List[float] = [0.0] * len(arrivals)
    lock = threading.Lock()
    t0 = time.monotonic() + 0.05        # small runway for scheduling

    def fire(i: int, offset: float) -> None:
        lateness = time.monotonic() - (t0 + offset)
        if lateness < 0:
            time.sleep(-lateness)
            lateness = 0.0
        c_offered.inc()
        t_fire = time.monotonic()
        try:
            r = dict(submit(i))
        except Exception as e:
            r = {"status": "error",
                 "error": f"{type(e).__name__}: {e}"}
        r.setdefault("e2e_s", time.monotonic() - t_fire)
        status = r.get("status")
        if status == "shed":
            c_shed.inc()
        elif status == "ok":
            c_admitted.inc()
        else:
            c_admitted.inc()            # admitted, then failed
            c_errors.inc()
        with lock:
            results[i] = r
            lags[i] = lateness

    with ThreadPoolExecutor(
            max_workers=min(max(1, max_workers),
                            max(1, len(arrivals)))) as ex:
        for i, off in enumerate(arrivals):
            ex.submit(fire, i, off)
    duration = max(arrivals) if arrivals else 0.0

    admitted = [r for r in results if r and r["status"] != "shed"]
    ok = [r for r in admitted if r["status"] == "ok"]
    shed = [r for r in results if r and r["status"] == "shed"]
    ok_in_slo = [r for r in ok if r["e2e_s"] <= slo_s]
    adm_lat = sorted(r["e2e_s"] for r in admitted)
    return {
        "offered": len(arrivals),
        "offered_rate_hz": (len(arrivals) / duration
                            if duration > 0 else 0.0),
        "admitted": len(admitted),
        "completed_ok": len(ok),
        "shed": len(shed),
        "shed_rate": (len(shed) / len(arrivals) if arrivals else 0.0),
        "shed_with_retry_after": sum(
            1 for r in shed if r.get("retry_after")),
        "time_to_shed_p50_s": _percentile(
            [r["e2e_s"] for r in shed], 50),
        "attainment_admitted": (len(ok_in_slo) / len(admitted)
                                if admitted else 1.0),
        "goodput_rps": (len(ok_in_slo) / duration
                        if duration > 0 else 0.0),
        "p50_s": _percentile(adm_lat, 50),
        "p99_s": _percentile(adm_lat, 99),
        "p999_s": _percentile(adm_lat, 99.9),
        "start_lag_p99_s": _percentile(lags, 99),
        "slo_s": slo_s,
        "results": results,
    }
