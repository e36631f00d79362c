"""What the port's observability tests share
(tests/test_torch_observability.py, test_torch_profiling.py,
test_torch_request_lifecycle.py, test_torch_fit_observability.py and
the serving planes' test_torch_slo_blame.py,
test_torch_history_alerts.py, test_torch_fleet_timeline.py,
test_torch_serving_planes.py): one
reset of both packages' planes, and a fake clock patched into every
module of both packages that reads the instrumentation clock `now`.

Both packages keep their planes in process globals (the span ring, the
event sink, the ledger, the request log, the step clocks, the memory
ring, the flight ring and excepthook, the metrics registry).  A test
file resets them when it starts and when it ends, so neither a JAX test
nor another port test in the same worker sees what it left; the SLO,
blame and exemplar planes fed by each request log, the metrics history
recorders and the telemetry spools are reset too."""

import contextlib
import importlib

from analytics_zoo_tpu import observability as jobs
from analytics_zoo_tpu_torch import observability as obs

#: the modules that bind `now` at import, in each package
_CLOCK_MODULES = ("registry", "tracing", "goodput", "memory", "watchdog",
                  "request_log", "profiling", "history", "telemetry_spool")


class FakeClock:
    """A monotonic clock that moves only when told to."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def tick(self, dt: float) -> None:
        self.t += dt


@contextlib.contextmanager
def patch_clock(clock):
    """`clock` as `now` in both packages' planes for the block."""
    saved = []
    for pkg in (jobs, obs):
        for name in _CLOCK_MODULES:
            mod = importlib.import_module(f"{pkg.__name__}.{name}")
            saved.append((mod, mod.now))
            mod.now = clock
    try:
        yield clock
    finally:
        for mod, fn in saved:
            mod.now = fn


def reset_planes():
    """Drop every plane's state in both packages."""
    for o in (jobs, obs):
        o.flight_recorder.uninstall()
        o.flight_recorder.clear_ring()
        o.close_sink()
        o.clear_spans()
        o.reset_registry()
        o.reset_profiling()
        o.reset_request_log()
        o.goodput.reset_clocks()
        o.memory.reset()
        o.reset_slo_tracker()
        o.reset_blame_tracker()
        o.reset_exemplar_store()
        o.reset_recorder()
        o.telemetry_spool.reset_spools()
