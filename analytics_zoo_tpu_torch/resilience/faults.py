"""Deterministic, seeded fault injection (a trimmed copy of
analytics_zoo_tpu/resilience/faults.py, for the sites the training path
fires).

Usage::

    OrcaContext.fault_plan = {"faults": [
        {"site": "train.step", "at": 15, "action": "raise"}]}

Sites (each a no-op when no plan is armed):

=========================== =============================================
site                        threaded into
=========================== =============================================
``train.step``              `TrainEngine`'s per-step loops (host batches
                            and the DEVICE store)
``train.epoch``             the top of `TrainEngine.run_epoch_device`
``checkpoint.before_write`` commit protocol, before any byte is written
``checkpoint.mid_write``    after the temp-dir write, before rename
``checkpoint.before_rename`` temp dir complete, rename not yet executed
``checkpoint.before_commit`` renamed into place, commit marker missing
``checkpoint.after_commit`` marker durable (a crash loses nothing)
``checkpoint.load``         restore path (a broken load consumes retry
                            budget)
=========================== =============================================

Actions: ``raise`` (SimulatedWorkerFailure), ``crash`` (SimulatedCrash,
the checkpoint matrix's kill) and ``torn_write`` (truncate the largest
file under the site's path, then SimulatedCrash).

Determinism: a fault fires when its site's hit counter reaches ``at``
(1-based), for ``times`` firings (default 1); ``prob`` instead draws
from a PRNG seeded by ``(plan seed, site)``: the firing pattern is a
function of the plan, never of wall time.
"""

from __future__ import annotations

import logging
import os
import threading
import zlib
from typing import Any, Dict, List, Optional

from analytics_zoo_tpu_torch.common.context import OrcaContext

logger = logging.getLogger("analytics_zoo_tpu_torch")

ACTIONS = ("raise", "crash", "torn_write")

KNOWN_SITES = (
    "train.step", "train.epoch",
    "checkpoint.before_write", "checkpoint.mid_write",
    "checkpoint.before_rename", "checkpoint.before_commit",
    "checkpoint.after_commit", "checkpoint.load",
)


class FaultInjected(RuntimeError):
    """Base of every injected failure."""


class SimulatedWorkerFailure(FaultInjected):
    """An injected worker death (the killed worker of the retry-restore
    scenario, in-process)."""


class SimulatedCrash(FaultInjected):
    """An injected process kill inside a checkpoint phase."""


class Fault:
    """One armed fault: a site, an action, and a deterministic firing
    rule (`at`/`times`, or seeded `prob`)."""

    __slots__ = ("site", "action", "at", "times", "prob", "fired")

    def __init__(self, site: str, action: str, at: int = 1,
                 times: int = 1, prob: Optional[float] = None):
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
        self.prob = None if prob is None else float(prob)
        self.fired = 0


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


def fault_point(site: str, **ctx) -> None:
    """The injection site hook.  Unarmed (no plan): one attribute read.
    Armed: counts the hit and, when a fault fires, raises."""
    plan = OrcaContext.fault_plan
    if plan is None:
        return
    fault = plan.hit(site)
    if fault is None:
        return
    logger.warning("fault injected at %s: %s %s", site, fault.action,
                   {k: v for k, v in ctx.items()
                    if isinstance(v, (int, float, str, bool))})
    if fault.action == "raise":
        raise SimulatedWorkerFailure(
            f"injected worker failure at {site} "
            f"(hit {plan.hits.get(site)})")
    if fault.action == "crash":
        raise SimulatedCrash(f"injected crash at {site}")
    path = ctx.get("path")
    if path and os.path.isdir(path):
        _torn_write(path)
    raise SimulatedCrash(f"injected torn write at {site}")
