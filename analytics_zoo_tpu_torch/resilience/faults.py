"""Deterministic, seeded fault injection (a trimmed copy of
analytics_zoo_tpu/resilience/faults.py, for the sites the training path,
the generation engine and the serving scale-out fire).

Usage::

    OrcaContext.fault_plan = {"faults": [
        {"site": "train.step", "at": 15, "action": "raise"}]}

Sites (each a no-op when no plan is armed):

=========================== =============================================
site                        threaded into
=========================== =============================================
``train.step``              `TrainEngine`'s per-step loops (host batches
                            and the DEVICE store)
``eval.step``               the same loops, evaluating
``train.epoch``             the top of `TrainEngine.run_epoch_device`
``eval.epoch``              the same, evaluating
``checkpoint.before_write`` commit protocol, before any byte is written
``checkpoint.mid_write``    after the temp-dir write, before rename
``checkpoint.before_rename`` temp dir complete, rename not yet executed
``checkpoint.before_commit`` renamed into place, commit marker missing
``checkpoint.after_commit`` marker durable (a crash loses nothing)
``checkpoint.load``         restore path (a broken load consumes retry
                            budget)
``generation.decode``       the generation engine's decode step, before
                            dispatch
``generation.prefix_lookup`` `PrefixCache.lookup` (a failed admission)
``generation.spec_verify``  the speculative verify round, before
                            dispatch (the lanes decode instead)
``generation.host_spill``   `HostKVTier.put` (the spill is dropped)
``generation.host_restore`` `HostKVTier.fetch` (a raise or "nan" drops
                            the entry as corrupt; the lane recomputes)
``serving.admission``       `AdmissionCore.admit`'s queue check (every
                            door: the engine, the worker pool, /predict)
``admission.quota``         the tenant quota gate ("refuse" sheds 429)
``registry.swap``           `ModelRegistry.hot_swap`, before the pointer
                            moves (a raise leaves it unmoved)
``router.dispatch``         `ReplicaRouter.submit` ("refuse" sheds 503)
``stream.append``           `StreamLog.append`, before the frame is
                            written (``path`` = the segment directory)
``stream.fsync``            `StreamLog.sync`, before the fsync
``stream.lease``            `DurableStream.dequeue`, before any lease
``stream.ack``              `DurableStream.ack`, before any cursor moves
=========================== =============================================

Actions: ``raise`` (SimulatedWorkerFailure), ``crash`` (SimulatedCrash,
the checkpoint matrix's kill), ``torn_write`` (truncate the largest
file under the site's path, then SimulatedCrash), ``stall`` (sleep the
fault's ``delay_s``, default 0.5 s, and go on), ``poison_request``
(PoisonedRequestError carrying the victim's request id: the engine
evicts that request alone), and two that `fault_point` returns to its
caller: ``nan`` (the train loop poisons the batch's float leaves, so
the step is non-finite and skipped) and ``refuse`` (submit then raises
QueueFull, as an organic overload would).

Determinism: a fault fires when its site's hit counter reaches ``at``
(1-based), for ``times`` firings (default 1); ``prob`` instead draws
from a PRNG seeded by ``(plan seed, site)``: the firing pattern is a
function of the plan, never of wall time.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import zlib
from typing import Any, Dict, List, Optional

from analytics_zoo_tpu_torch.common.context import OrcaContext

logger = logging.getLogger("analytics_zoo_tpu_torch")

ACTIONS = ("raise", "crash", "torn_write", "stall", "poison_request",
           "nan", "refuse")

KNOWN_SITES = (
    "train.step", "eval.step", "train.epoch", "eval.epoch",
    "checkpoint.before_write", "checkpoint.mid_write",
    "checkpoint.before_rename", "checkpoint.before_commit",
    "checkpoint.after_commit", "checkpoint.load",
    "generation.decode", "generation.prefix_lookup",
    "generation.spec_verify",
    "generation.host_spill", "generation.host_restore",
    "serving.admission", "admission.quota", "registry.swap",
    "router.dispatch",
    "stream.append", "stream.fsync", "stream.lease", "stream.ack",
)


class FaultInjected(RuntimeError):
    """Base of every injected failure."""


class SimulatedWorkerFailure(FaultInjected):
    """An injected worker death (the killed worker of the retry-restore
    scenario, in-process)."""


class SimulatedCrash(FaultInjected):
    """An injected process kill inside a checkpoint phase."""


class PoisonedRequestError(FaultInjected):
    """An injected decode-step failure attributable to ONE request;
    the engine evicts that request and keeps serving the rest."""

    def __init__(self, message: str, request_id: Optional[str] = None):
        super().__init__(message)
        self.request_id = request_id


class Fault:
    """One armed fault: a site, an action, and a deterministic firing
    rule (`at`/`times`, or seeded `prob`); `request_id` names the victim
    of ``poison_request``, `delay_s` the sleep of ``stall``."""

    __slots__ = ("site", "action", "at", "times", "delay_s", "request_id",
                 "prob", "fired")

    def __init__(self, site: str, action: str, at: int = 1,
                 times: int = 1, delay_s: float = 0.5,
                 request_id: Optional[str] = None,
                 prob: Optional[float] = None):
        if action not in ACTIONS:
            raise ValueError(
                f"unknown fault action {action!r}; valid: {ACTIONS}")
        if site not in KNOWN_SITES:
            raise ValueError(
                f"unknown fault site {site!r}; valid: {KNOWN_SITES}")
        if at < 1:
            raise ValueError("fault 'at' is a 1-based hit index")
        self.site = str(site)
        self.action = action
        self.at = int(at)
        self.times = int(times)
        self.delay_s = float(delay_s)
        self.request_id = request_id
        self.prob = None if prob is None else float(prob)
        self.fired = 0

    def describe(self) -> Dict[str, Any]:
        return {"site": self.site, "action": self.action, "at": self.at,
                "times": self.times, "fired": self.fired}


class FaultPlan:
    """A seeded set of faults plus per-site hit counters.  Built from a
    dict/list (the ``OrcaContext.fault_plan`` setter) or directly."""

    def __init__(self, faults, seed: int = 0):
        self.seed = int(seed)
        self.faults: List[Fault] = [
            f if isinstance(f, Fault) else Fault(**dict(f))
            for f in faults]
        self.hits: Dict[str, int] = {}
        self._rngs: Dict[str, Any] = {}
        self._lock = threading.Lock()

    @classmethod
    def from_config(cls, cfg) -> "FaultPlan":
        if isinstance(cfg, FaultPlan):
            return cfg
        if isinstance(cfg, dict):
            return cls(cfg.get("faults", []), seed=cfg.get("seed", 0))
        return cls(list(cfg))

    def _rng(self, site: str):
        import numpy as np
        rng = self._rngs.get(site)
        if rng is None:
            rng = self._rngs[site] = np.random.default_rng(
                (self.seed, zlib.crc32(site.encode())))
        return rng

    def hit(self, site: str) -> Optional[Fault]:
        """Count one hit of `site`; return the fault to fire, if any."""
        with self._lock:
            n = self.hits[site] = self.hits.get(site, 0) + 1
            for f in self.faults:
                if f.site != site or f.fired >= f.times:
                    continue
                if f.prob is not None:
                    if float(self._rng(site).random()) >= f.prob:
                        continue
                elif n < f.at + f.fired:
                    # fire at the at-th hit, then (times > 1) every
                    # later hit until the budget drains
                    continue
                f.fired += 1
                return f
        return None

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [f.describe() for f in self.faults]


def _torn_write(path: str) -> None:
    """Truncate the largest regular file under `path` to half: a torn
    write frozen mid-flush, before the simulated kill."""
    victim, size = None, -1
    for dirpath, _dirs, files in os.walk(path):
        for fn in files:
            p = os.path.join(dirpath, fn)
            try:
                s = os.path.getsize(p)
            except OSError:
                continue
            if s > size:
                victim, size = p, s
    if victim is not None:
        with open(victim, "r+b") as f:
            f.truncate(max(0, size // 2))


def _record_fire(fault: Fault, ctx: Dict[str, Any]) -> None:
    """Count a fired fault and leave it in the flight ring and the
    event log (JAX faults.py:222-235).  Imported here, at the first
    fire, so an unarmed process never loads the planes for it."""
    from analytics_zoo_tpu_torch.observability import (
        flight_recorder,
        get_registry,
        log_event,
    )
    get_registry().counter(
        "resilience_faults_injected_total",
        help="faults fired by the armed fault plan "
             "(resilience/faults.py)").inc()
    fields = {k: v for k, v in ctx.items()
              if isinstance(v, (int, float, str, bool, list))}
    flight_recorder.record("fault_injected", site=fault.site,
                           action=fault.action, **fields)
    log_event("fault_injected", site=fault.site, action=fault.action,
              **fields)


def fault_point(site: str, **ctx) -> Optional[str]:
    """The injection site hook.  Unarmed (no plan): one attribute read,
    returning None.  Armed: counts the hit and, when a fault fires,
    raises, sleeps (``stall``), or returns the action for the caller to
    interpret (``nan``, ``refuse``)."""
    plan = OrcaContext.fault_plan
    if plan is None:
        return None
    fault = plan.hit(site)
    if fault is None:
        return None
    logger.warning("fault injected at %s: %s %s", site, fault.action,
                   {k: v for k, v in ctx.items()
                    if isinstance(v, (int, float, str, bool))})
    _record_fire(fault, ctx)
    if fault.action == "raise":
        raise SimulatedWorkerFailure(
            f"injected worker failure at {site} "
            f"(hit {plan.hits.get(site)})")
    if fault.action == "crash":
        raise SimulatedCrash(f"injected crash at {site}")
    if fault.action == "stall":
        time.sleep(fault.delay_s)
        return fault.action
    if fault.action == "poison_request":
        # the named victim when it is among this hit's requests, else
        # the first of them
        rid = fault.request_id
        ids = ctx.get("request_ids") or []
        if rid is None or (ids and rid not in ids):
            rid = ids[0] if ids else rid
        raise PoisonedRequestError(
            f"injected decode failure poisoning request {rid!r}",
            request_id=rid)
    if fault.action in ("nan", "refuse"):
        return fault.action
    path = ctx.get("path")
    if path and os.path.isdir(path):
        _torn_write(path)
    raise SimulatedCrash(f"injected torn write at {site}")
