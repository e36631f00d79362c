"""Goodput accounting (a copy of analytics_zoo_tpu/observability/
goodput.py): where did a step's wall time go?

One `StepClock` per hot loop (`spmd_train`, `spmd_eval`,
`generation_prefill`, `generation_decode`, `generation_spec_verify`)
splits each step into buckets:

* ``compile``            — the first dispatch of a step signature: on
                           the card that is where the kernels' first
                           launch builds them (JAX's bucket holds XLA's
                           compile of a jitted entry point's cold call)
* ``host_input``         — host-side batch assembly and staging to the
                           card
* ``device_compute``     — the host's wait at a fence after the step's
                           dispatch returned (`torch.cuda.synchronize`,
                           or a host read the step already does, as the
                           engine's token fetch).  A jitted JAX step
                           dispatches in microseconds, so there this is
                           the device's time; the port's step is eager,
                           and the card runs its kernels while the host
                           is still launching them, so what the card
                           did during the dispatch lands in
                           ``overhead``.  A low ratio then says the host
                           sets the pace (the card finished soon after
                           the last launch), not how busy the card was:
                           that needs a device trace (torch.profiler).
                           Timing the step with CUDA events would not
                           give it either: their span also counts the
                           card's gaps between the host's launches.
* ``blocked_collective`` — host-visible waits on other processes,
                           attributed by their call sites (0 on one
                           card)
* ``checkpoint``         — save cost paid on the loop's critical path
* ``overhead``           — everything else: Python dispatch,
                           scheduling, metric accumulation

Fencing every step would defeat asynchronous dispatch, so the clock
fences at a sampled cadence (`OrcaContext.goodput_sample_every`,
default every 16th step; 1 fences every step).  Only FENCED steps are
fully decomposed, and the table reports bucket totals over fenced
steps, whose sum equals the fenced wall by construction (``overhead``
is the residual).  Unfenced steps still count in `steps` / `wall_s`,
and their host staging is kept apart as ``unfenced_host_input_s``.  On
the CPU the step's work is done when the call returns, so no fence is
needed there.

The process-wide ``goodput_ratio`` gauge is ``device_compute /
fenced_wall`` over every clock, and the per-bucket totals ride
`/metrics` as ``goodput_<clock>_<bucket>_seconds_total`` counters.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from analytics_zoo_tpu_torch.observability.registry import (
    get_registry,
    now,
    sanitize_metric_name,
)

BUCKETS = ("compile", "host_input", "device_compute",
           "blocked_collective", "checkpoint", "overhead")

#: bounded ring of FENCED step slices ({clock, ts (wall), dur_s,
#: buckets, cold}) — what the timeline export (timeline.py) draws as goodput
#: tracks.  Fenced-only keeps entries meaningful (fully decomposed)
#: and the decode loop, which fences every iteration, fully covered.
_TIMELINE_SIZE = 1024
_timeline_lock = threading.Lock()
_timeline: "deque[Dict[str, Any]]" = deque(maxlen=_TIMELINE_SIZE)

#: productive buckets for the goodput ratio: device compute only —
#: compile time is startup cost, not goodput (a retried job that spends
#: half its wall recompiling has low goodput, which is the point)
_PRODUCTIVE = ("device_compute",)

_clocks_lock = threading.Lock()
_clocks: Dict[str, "StepClock"] = {}


def _sample_every() -> int:
    from analytics_zoo_tpu_torch.common.context import OrcaContext
    return max(1, int(OrcaContext.goodput_sample_every))


class _StepRecord:
    """One in-flight step.  `lap(bucket)` attributes the time since the
    previous lap (or `begin`) to `bucket` (None discards it into the
    residual); `end()` closes the step and folds the residual into
    ``overhead`` when the step was fenced."""

    __slots__ = ("_clock", "_t0", "_t_last", "_laps", "fenced", "cold",
                 "_wall0")

    def __init__(self, clock: "StepClock", fenced: bool):
        self._clock = clock
        self._t0 = now()
        self._t_last = self._t0
        #: wall anchor for the timeline exporter (durations still come
        #: from the monotonic clock)
        self._wall0 = time.time()
        self._laps: Dict[str, float] = {}
        self.fenced = fenced
        #: set by the caller on a step signature's first dispatch: its
        #: dispatch and wait laps land in ``compile``
        self.cold = False

    def lap(self, bucket: Optional[str]) -> float:
        t = now()
        dt = t - self._t_last
        self._t_last = t
        if bucket is not None:
            self._laps[bucket] = self._laps.get(bucket, 0.0) + dt
        return dt

    def end(self) -> None:
        wall = now() - self._t0
        laps = dict(self._laps)
        if self.cold:
            # a first dispatch's device wait is mostly the kernels'
            # build: fold it into the compile bucket so warm goodput is
            # not polluted by one giant first step
            laps["compile"] = (laps.get("compile", 0.0)
                               + laps.pop("device_compute", 0.0))
        self._clock._commit(wall, laps, self.fenced, self.cold,
                            self._wall0)


class StepClock:
    """Per-hot-loop goodput decomposition (get one via `step_clock`)."""

    def __init__(self, name: str, registry=None):
        self.name = sanitize_metric_name(name)
        self._reg = registry if registry is not None else get_registry()
        self._lock = threading.Lock()
        self.steps = 0
        self.fenced_steps = 0
        self.wall_s = 0.0
        self.fenced_wall_s = 0.0
        self.buckets = {b: 0.0 for b in BUCKETS}
        #: host staging observed on UNFENCED steps — kept out of
        #: `buckets` so the fenced bucket sums equal `fenced_wall_s`
        self.unfenced_host_input_s = 0.0
        self._counters = {
            b: self._reg.counter(
                f"goodput_{self.name}_{b}_seconds_total",
                help=f"goodput bucket {b} of the {name} loop "
                     "(fenced steps)")
            for b in BUCKETS}
        self._reg.gauge(
            f"goodput_{self.name}_ratio",
            fn=self.goodput_ratio,
            help=f"device_compute / fenced wall of the {name} loop")
        #: last step wall time; the Gauge's min/max tracking gives the
        #: breakdown table its best/worst step for free
        self._g_step = self._reg.gauge(
            f"goodput_{self.name}_step_seconds",
            help=f"wall time of the last {name} step (gauge min/max = "
                 "best/worst step)")

    # ------------------------------------------------------------------

    def begin(self, force_fence: bool = False) -> _StepRecord:
        """Open a step record.  The step is fenced (fully decomposable)
        every `OrcaContext.goodput_sample_every`-th step or when
        `force_fence`; callers check `.fenced` to decide whether to
        fence before `lap("device_compute")`."""
        with self._lock:
            fenced = force_fence or (self.steps % _sample_every() == 0)
        return _StepRecord(self, fenced)

    def attribute(self, bucket: str, seconds: float) -> None:
        """Out-of-step attribution (e.g. a multi-host barrier wait that
        happens between steps) — lands in the bucket totals and the
        exported counters, outside any step's wall."""
        if bucket not in self.buckets:
            raise ValueError(f"unknown goodput bucket {bucket!r}")
        with self._lock:
            self.buckets[bucket] += seconds
        self._counters[bucket].inc(seconds)

    def _commit(self, wall: float, laps: Dict[str, float], fenced: bool,
                cold: bool, wall0: Optional[float] = None) -> None:
        with self._lock:
            self.steps += 1
            self.wall_s += wall
            if fenced:
                self.fenced_steps += 1
                self.fenced_wall_s += wall
                attributed = sum(laps.values())
                # the residual (Python dispatch, bookkeeping) is
                # overhead; measured laps can only under-cover the wall
                laps["overhead"] = (laps.get("overhead", 0.0)
                                    + max(0.0, wall - attributed))
                for b, dt in laps.items():
                    self.buckets[b] += dt
            else:
                # host staging is host-observable without a fence; the
                # async device time is not.  Tracked separately so the
                # fenced bucket sums keep their partition invariant.
                self.unfenced_host_input_s += laps.get("host_input",
                                                       0.0)
                laps = {}
        self._g_step.set(wall)
        for b, dt in laps.items():
            if dt:
                self._counters[b].inc(dt)
        if fenced:
            with _timeline_lock:
                _timeline.append({
                    "clock": self.name,
                    "ts": (wall0 if wall0 is not None
                           else time.time() - wall),
                    "dur_s": wall,
                    "buckets": {b: round(v, 9)
                                for b, v in laps.items() if v},
                    "cold": cold,
                })
            # opportunistic memory telemetry rides the fenced cadence:
            # every hot loop feeds the sampler without its own wiring,
            # and the time gate bounds its cost
            from analytics_zoo_tpu_torch.observability import memory
            memory.maybe_sample()

    # ------------------------------------------------------------------

    def goodput_ratio(self) -> float:
        """device_compute / fenced wall (0.0 before any fenced step)."""
        with self._lock:
            if self.fenced_wall_s <= 0:
                return 0.0
            prod = sum(self.buckets[b] for b in _PRODUCTIVE)
            return prod / self.fenced_wall_s

    def table(self) -> Dict[str, object]:
        """The step-time-breakdown row: bucket totals (fenced steps),
        fenced/total step counts and wall, and the goodput ratio.
        Fenced bucket sums equal `fenced_wall_s` up to out-of-step
        `attribute()` contributions."""
        with self._lock:
            # ratio computed inline: goodput_ratio() takes this
            # (non-reentrant) lock
            prod = sum(self.buckets[b] for b in _PRODUCTIVE)
            ratio = (prod / self.fenced_wall_s
                     if self.fenced_wall_s > 0 else 0.0)
            table = {
                "steps": self.steps,
                "fenced_steps": self.fenced_steps,
                "wall_s": round(self.wall_s, 6),
                "fenced_wall_s": round(self.fenced_wall_s, 6),
                "buckets_s": {b: round(v, 6)
                              for b, v in self.buckets.items()},
                "unfenced_host_input_s": round(
                    self.unfenced_host_input_s, 6),
                "goodput_ratio": round(ratio, 4),
            }
        if self.steps:
            table["step_min_s"] = round(self._g_step.min, 6)
            table["step_max_s"] = round(self._g_step.max, 6)
        return table

    def reset(self) -> None:
        with self._lock:
            self.steps = self.fenced_steps = 0
            self.wall_s = self.fenced_wall_s = 0.0
            self.buckets = {b: 0.0 for b in BUCKETS}
            self.unfenced_host_input_s = 0.0


# ----------------------------------------------------------------------

def step_clock(name: str) -> StepClock:
    """Get-or-create the named process-global StepClock."""
    with _clocks_lock:
        c = _clocks.get(name)
        if c is None:
            c = _clocks[name] = StepClock(name)
            _ensure_global_gauge()
        return c


def goodput_tables() -> Dict[str, Dict[str, object]]:
    """{clock_name: breakdown table} for every live clock, stable name
    order (the server's GET /goodput)."""
    with _clocks_lock:
        items = sorted(_clocks.items())
    return {name: c.table() for name, c in items}


def process_goodput_ratio() -> float:
    """Aggregate device_compute / fenced wall over all clocks."""
    with _clocks_lock:
        clocks = list(_clocks.values())
    prod = wall = 0.0
    for c in clocks:
        with c._lock:
            prod += sum(c.buckets[b] for b in _PRODUCTIVE)
            wall += c.fenced_wall_s
    return prod / wall if wall > 0 else 0.0


_global_gauge_done = False


def _ensure_global_gauge() -> None:
    global _global_gauge_done
    if not _global_gauge_done:
        get_registry().gauge(
            "goodput_ratio", fn=process_goodput_ratio,
            help="process goodput: device_compute / fenced step wall "
                 "across all step clocks")
        _global_gauge_done = True


def recent_steps(n: Optional[int] = None) -> List[Dict[str, Any]]:
    """Fenced step slices from the timeline ring, oldest first (the
    goodput tracks of the timeline export)."""
    with _timeline_lock:
        items = list(_timeline)
    if n is not None:
        items = items[-int(n):]
    return items


def reset_clocks() -> None:
    """Drop every clock and the step timeline ring (tests).  The next
    `step_clock` call re-creates clocks against the CURRENT global
    registry."""
    global _global_gauge_done
    with _clocks_lock:
        _clocks.clear()
        _global_gauge_done = False
    with _timeline_lock:
        _timeline.clear()
