"""Elastic restart driver: kill-and-resume as a tested scenario (a copy
of analytics_zoo_tpu/resilience/elastic.py).

A gang of workers is all-or-nothing: when a member dies the survivors
block in their next collective, so recovery needs a supervisor that (1)
detects the death, (2) tears the whole gang down, and (3) restarts the
job from the latest committed checkpoint.  `ElasticTrainingDriver` is
that supervisor, over two kinds of member:

* in-process members (callables): threads that beat a heartbeat through
  their `WorkerContext`; death is an escaped exception, a stall a stale
  heartbeat;
* process members (`spawn=`): whatever `spawn(worker_id,
  resume_checkpoint, attempt)` starts, a `subprocess.Popen`, alive while
  `poll()` is None, with optional heartbeat files (`touch_heartbeat`,
  JAX's paths and names); on a failure the survivors are SIGKILLed, as a
  preempted job's are.  A member that trains on the card is a fresh
  interpreter: never fork a process that has touched CUDA.

Every wait goes through the driver's `clock` (anything with
`monotonic()` and `sleep(seconds)`; the `time` module by default), so a
test can drive staleness and backoff without racing the wall clock.
Restarts consume a `RetryPolicy` budget with deterministic backoff;
each leaves a flight-recorder bundle, ticks `resilience_restarts_total`
/ `resilience_worker_deaths_total`, and resumes from the newest
committed checkpoint (`find_latest_checkpoint` skips one whose commit
marker never landed), so a kill mid-save costs at most the work since
the previous commit.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from analytics_zoo_tpu_torch.resilience.retry import RetryPolicy


class WorkerCancelled(RuntimeError):
    """Raised out of `WorkerContext.heartbeat()` once the driver has
    fenced this attempt — cooperative teardown of in-process members
    (the thread analog of the supervisor's SIGKILL)."""


class ElasticRestartExceeded(RuntimeError):
    """The restart budget drained without a clean run."""


class WorkerContext:
    """What a worker function receives: identity, the resume source,
    and the heartbeat it must feed."""

    def __init__(self, worker_id: int, n_workers: int, attempt: int,
                 resume_checkpoint: Optional[str], clock=time):
        self.worker_id = worker_id
        self.n_workers = n_workers
        self.attempt = attempt
        #: newest COMMITTED checkpoint path, or None on a fresh start
        self.resume_checkpoint = resume_checkpoint
        self._clock = clock
        self._cancel = threading.Event()
        self._last_beat = clock.monotonic()

    def heartbeat(self) -> None:
        """Call once per unit of progress (step / scheduling round).
        Raises `WorkerCancelled` after the driver fenced the attempt,
        so a zombie member exits instead of racing the restarted job."""
        if self._cancel.is_set():
            raise WorkerCancelled(
                f"worker {self.worker_id} cancelled by the elastic "
                f"driver (attempt {self.attempt})")
        self._last_beat = self._clock.monotonic()

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()


class _ThreadMember:
    def __init__(self, fn: Callable, ctx: WorkerContext):
        self.ctx = ctx
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self._done = threading.Event()

        def run():
            try:
                self.result = fn(ctx)
            except BaseException as e:
                self.error = e
            finally:
                self._done.set()

        self._thread = threading.Thread(
            target=run, daemon=True,
            name=f"elastic-worker-{ctx.worker_id}")
        self._thread.start()

    def finished(self) -> bool:
        return self._done.is_set()

    def last_beat(self) -> float:
        return self.ctx._last_beat

    def cancel(self) -> None:
        self.ctx._cancel.set()

    def join(self, timeout: float) -> bool:
        self._thread.join(timeout)
        return not self._thread.is_alive()


class _ProcessMember:
    """Subprocess gang member: liveness from poll(), heartbeats from
    the mtime of its `touch_heartbeat` file when one is configured."""

    def __init__(self, proc, heartbeat_file: Optional[str], clock=time):
        self.proc = proc
        self.heartbeat_file = heartbeat_file
        self.result = None
        self.error: Optional[BaseException] = None
        self._clock = clock
        self._t0 = clock.monotonic()

    def finished(self) -> bool:
        rc = self.proc.poll()
        if rc is None:
            return False
        if rc != 0 and self.error is None:
            self.error = RuntimeError(
                f"gang member pid {self.proc.pid} exited rc={rc}")
        return True

    def last_beat(self) -> float:
        """The member's newest heartbeat, never before its spawn: a file
        a previous attempt's member left behind is not this member's
        beat (JAX's driver reads it as one, and fences a restarted
        member before its first beat)."""
        if self.heartbeat_file:
            try:
                mtime = os.path.getmtime(self.heartbeat_file)
                # map the file's wall mtime onto the monotonic axis the
                # staleness check uses
                return max(self._t0, self._clock.monotonic()
                           - max(0.0, time.time() - mtime))
            except OSError:
                pass
        return self._t0

    def cancel(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.kill()        # SIGKILL: a preempted member
            except OSError:             # gets no goodbye either
                pass

    def join(self, timeout: float) -> bool:
        deadline = self._clock.monotonic() + timeout
        while self.proc.poll() is None:
            if self._clock.monotonic() >= deadline:
                return False
            self._clock.sleep(0.01)
        return True


def touch_heartbeat(directory: str, worker_id: int) -> str:
    """Subprocess-member heartbeat: touch (and return) the per-worker
    beat file the driver watches."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"heartbeat-{worker_id}")
    with open(path, "a"):
        os.utime(path, None)
    return path


class ElasticTrainingDriver:
    """Run a gang, watch its heartbeats, restart from the latest
    committed checkpoint until the job finishes or the restart budget
    drains."""

    def __init__(self, workers, *,
                 checkpoint_dir: Optional[str] = None,
                 restart: Optional[RetryPolicy] = None,
                 heartbeat_timeout_s: float = 30.0,
                 poll_interval_s: float = 0.02,
                 drain_timeout_s: float = 10.0,
                 spawn: Optional[Callable] = None,
                 heartbeat_dir: Optional[str] = None,
                 registry=None, clock=time):
        """`workers`: a callable (single member), a sequence of
        callables (in-process gang), or — with `spawn` — an int member
        count; `spawn(worker_id, resume_checkpoint, attempt)` must
        return a started `subprocess.Popen`.  `heartbeat_dir` arms
        file-mtime heartbeats for subprocess members (workers call
        `touch_heartbeat(dir, worker_id)` per step); without it only
        process death is detected for them.  `clock` (module docstring)
        times every wait."""
        if callable(workers):
            workers = [workers]
        self._spawn = spawn
        if spawn is not None:
            self.n_workers = int(workers) if isinstance(workers, int) \
                else len(list(workers))
            self._worker_fns: Sequence[Callable] = ()
        else:
            self._worker_fns = list(workers)
            self.n_workers = len(self._worker_fns)
            if not self.n_workers:
                raise ValueError("need at least one worker")
        self.checkpoint_dir = checkpoint_dir
        self.restart = restart if restart is not None else RetryPolicy(
            max_attempts=3, backoff_s=0.2, name="elastic_restart")
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.poll_interval_s = float(poll_interval_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.heartbeat_dir = heartbeat_dir
        self.clock = clock
        #: attempt ledger: one entry per gang launch with its outcome
        self.history: List[Dict[str, Any]] = []
        self.restarts = 0
        from analytics_zoo_tpu_torch.observability import get_registry
        reg = registry if registry is not None else get_registry()
        self._c_restarts = reg.counter(
            "resilience_restarts_total",
            help="elastic-driver gang restarts")
        self._c_deaths = reg.counter(
            "resilience_worker_deaths_total",
            help="gang members observed dead or stalled by the "
                 "elastic driver")

    # ------------------------------------------------------------------

    def latest_committed(self) -> Optional[str]:
        """Newest committed checkpoint under `checkpoint_dir` (None
        before the first commit) — the only state a restart trusts."""
        if not self.checkpoint_dir:
            return None
        from analytics_zoo_tpu_torch.orca.learn.checkpoint import (
            find_latest_checkpoint,
        )
        try:
            return find_latest_checkpoint(self.checkpoint_dir)
        except (FileNotFoundError, OSError):
            return None

    def _launch(self, attempt: int, resume: Optional[str]):
        from analytics_zoo_tpu_torch.observability import trace_context
        members = []
        if self._spawn is not None:
            # export the driver's trace context to os.environ for the
            # duration of the spawns: user spawn factories build child
            # envs from os.environ, so gang members inherit
            # TRACEPARENT and their spans join the driver's trace
            # (observability/trace_context.py install_from_env)
            with trace_context.env_bound():
                for wid in range(self.n_workers):
                    hb = (os.path.join(self.heartbeat_dir,
                                       f"heartbeat-{wid}")
                          if self.heartbeat_dir else None)
                    members.append(_ProcessMember(
                        self._spawn(wid, resume, attempt), hb, self.clock))
        else:
            for wid, fn in enumerate(self._worker_fns):
                ctx = WorkerContext(wid, self.n_workers, attempt,
                                    resume, self.clock)
                members.append(_ThreadMember(fn, ctx))
        return members

    def _monitor(self, members) -> Dict[str, Any]:
        """Poll liveness + heartbeat staleness until the gang finishes
        or a member dies/stalls.  Returns the attempt verdict."""
        from analytics_zoo_tpu_torch.observability import (
            maybe_record,
            maybe_spool,
        )
        while True:
            # the driver (and its in-process thread members) spool
            # telemetry each poll tick — a driver SIGKILL leaves its
            # last restart ledger/metrics behind for the fleet view
            maybe_spool("elastic-driver")
            maybe_record()
            dead, stalled, running = [], [], 0
            now = self.clock.monotonic()
            for i, m in enumerate(members):
                if m.finished():
                    if m.error is not None:
                        dead.append(i)
                    continue
                running += 1
                if now - m.last_beat() > self.heartbeat_timeout_s:
                    stalled.append(i)
            if dead or stalled:
                return {"ok": False, "dead": dead, "stalled": stalled,
                        "errors": [
                            f"{type(m.error).__name__}: {m.error}"
                            for m in members if m.error is not None]}
            if running == 0:
                return {"ok": True}
            self.clock.sleep(self.poll_interval_s)

    def _teardown(self, members) -> None:
        """Gang semantics: one death fences everyone.  Cancel, then
        drain with a deadline so a zombie can't race the restart."""
        for m in members:
            m.cancel()
        deadline = self.clock.monotonic() + self.drain_timeout_s
        for m in members:
            m.join(max(0.0, deadline - self.clock.monotonic()))
        # a cancelled member may have a save mid-flight: quiesce the
        # background writer so the restart's find_latest sees a stable
        # directory (its possibly-failed write is fine to drop)
        from analytics_zoo_tpu_torch.resilience.checkpointing import (
            drain_background,
        )
        drain_background(raise_on_error=False)

    # ------------------------------------------------------------------

    def run(self) -> List[Any]:
        """Drive the job to completion.  Returns per-worker results
        (in-process members; subprocess members return None).  Raises
        `ElasticRestartExceeded` when the restart budget drains."""
        from analytics_zoo_tpu_torch.observability import (
            flight_recorder,
            log_event,
        )
        last_errors: List[str] = []
        for attempt in range(1, self.restart.max_attempts + 1):
            resume = self.latest_committed()
            log_event("elastic_attempt", attempt=attempt,
                      resume=resume or "")
            members = self._launch(attempt, resume)
            verdict = self._monitor(members)
            if verdict["ok"]:
                self.history.append({"attempt": attempt,
                                     "resume": resume, "ok": True})
                return [m.result for m in members]
            self._teardown(members)
            last_errors = verdict.get("errors") or [
                f"stalled members {verdict['stalled']} (no heartbeat "
                f"for {self.heartbeat_timeout_s}s)"]
            n_bad = len(verdict["dead"]) + len(verdict["stalled"])
            self._c_deaths.inc(n_bad)
            self.history.append({"attempt": attempt, "resume": resume,
                                 "ok": False, **verdict})
            flight_recorder.dump(
                "elastic_restart",
                extra={"attempt": attempt, "dead": verdict["dead"],
                       "stalled": verdict["stalled"],
                       "errors": last_errors})
            if attempt >= self.restart.max_attempts:
                break
            self.restarts += 1
            self._c_restarts.inc()
            self.restart.record_retry(RuntimeError(
                "; ".join(last_errors)))
            delay = self.restart.backoff(attempt)
            if delay > 0:
                self.clock.sleep(delay)
        raise ElasticRestartExceeded(
            f"gang failed {self.restart.max_attempts} attempt(s); "
            f"last errors: {last_errors}")


# re-exported for subprocess worker scripts that only need the signal
# name without importing the whole driver
SIGKILL = getattr(signal, "SIGKILL", signal.SIGTERM)
