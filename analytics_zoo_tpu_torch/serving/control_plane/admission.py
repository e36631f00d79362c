"""The unified AdmissionCore: one admission decision for every serving
door (a port of analytics_zoo_tpu/serving/control_plane/admission.py).
The generation engine, the worker pool's checkout and the /predict
batcher all ask the same core, which layers three gates in order:

1. **Queue bound and SLO shedder**: past `max_queue` waiting requests,
   or, with `OrcaContext.slo_targets` and `slo_shed_attainment` set,
   attainment below the threshold with at least `slo_shed_min_queue`
   waiting, the request sheds with `QueueFull` (HTTP 503 and
   Retry-After).
2. **Fault injection** at the ``serving.admission`` site ("refuse"
   sheds exactly as an organic overload does).
3. **Per-tenant quota**: a token bucket per tenant from
   `OrcaContext.tenant_quotas`; an over-quota request sheds with
   `TenantQuotaExceeded` (HTTP 429, Retry-After the bucket's refill
   time).  The ledger is process-global, so every replica charges the
   same bucket (the router shopping a request around cannot launder a
   tenant past its quota, which is also why `TenantQuotaExceeded` is not
   a `QueueFull`).  The ``admission.quota`` site makes the 429 testable.
   The quota gate runs last, so a request the queue sheds anyway burns
   no tokens.

Request classes type the admission: "interactive" (default), "batch"
and "shadow" map to scheduler priorities 0/1/2; shadow traffic (a
routing duplicate, never a paying request) skips the tenant charge.

`TokenBucket` reads its clock through a callable (default
`time.monotonic`) that a test can replace.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.observability import (
    get_registry,
    get_slo_tracker,
)
from analytics_zoo_tpu_torch.resilience.faults import fault_point
from analytics_zoo_tpu_torch.serving.errors import (
    QueueFull,
    TenantQuotaExceeded,
)

#: typed request classes, in priority order (index = scheduler
#: priority: lower admits first and preempts last)
REQUEST_CLASSES = ("interactive", "batch", "shadow")
CLASS_PRIORITY = {c: i for i, c in enumerate(REQUEST_CLASSES)}


class TokenBucket:
    """Classic token bucket: `rate` tokens/s refill up to `burst`
    capacity; `take()` is non-blocking and `eta()` reports the refill
    wait a shed response should hint (thread-safe; `clock`, default
    `time.monotonic`, is the time source)."""

    __slots__ = ("rate", "burst", "tokens", "_t_last", "_lock", "_clock")

    def __init__(self, rate: float, burst: float,
                 clock: Optional[Callable[[], float]] = None):
        if rate <= 0 or burst <= 0:
            raise ValueError("rate and burst must be > 0")
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._clock = clock or time.monotonic
        self._t_last = self._clock()
        self._lock = threading.Lock()

    def _refill(self) -> None:
        now = self._clock()
        self.tokens = min(self.burst,
                          self.tokens + (now - self._t_last) * self.rate)
        self._t_last = now

    def take(self, n: float = 1.0) -> bool:
        with self._lock:
            self._refill()
            if self.tokens >= n:
                self.tokens -= n
                return True
            return False

    def eta(self, n: float = 1.0) -> float:
        """Seconds until `n` tokens will be available (0 if now)."""
        with self._lock:
            self._refill()
            short = n - self.tokens
            return max(0.0, short / self.rate)


class TenantLedger:
    """Process-global tenant -> TokenBucket map configured live from
    `OrcaContext.tenant_quotas` (re-read on every charge, so a quota
    change applies to the next request; a bucket is rebuilt when its
    configured rate/burst changed).  Tenants absent from the config
    are unlimited; a None config disables charging entirely.  `clock`
    is handed to every bucket."""

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self._clock = clock
        self._buckets: Dict[str, TokenBucket] = {}
        self._lock = threading.Lock()
        self.admitted: Dict[str, int] = {}
        self.shed: Dict[str, int] = {}

    def charge(self, tenant: str) -> Optional[float]:
        """Charge one request to `tenant`.  Returns None when
        admitted, else the bucket's refill ETA in seconds (shed)."""
        quotas = OrcaContext.tenant_quotas
        if quotas is None:
            return None
        q = quotas.get(str(tenant))
        if q is None:
            return None
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None or b.rate != q["rate"] or b.burst != q["burst"]:
                b = self._buckets[tenant] = TokenBucket(
                    q["rate"], q["burst"], clock=self._clock)
        if b.take(1.0):
            with self._lock:
                self.admitted[tenant] = self.admitted.get(tenant, 0) + 1
            return None
        with self._lock:
            self.shed[tenant] = self.shed.get(tenant, 0) + 1
        # never hint 0: the client would hammer the empty bucket
        return max(0.05, b.eta(1.0))

    def stats(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant admission ledger for /stats: configured quota,
        tokens left in the bucket, admitted/shed counts."""
        quotas = OrcaContext.tenant_quotas or {}
        with self._lock:
            tenants = (set(self._buckets) | set(quotas)
                       | set(self.admitted) | set(self.shed))
            out = {}
            for t in sorted(tenants):
                b = self._buckets.get(t)
                q = quotas.get(t)
                out[t] = {
                    "rate": q["rate"] if q else None,
                    "burst": q["burst"] if q else None,
                    "tokens": round(b.tokens, 3) if b else None,
                    "admitted": self.admitted.get(t, 0),
                    "shed": self.shed.get(t, 0),
                }
            return out


_ledger = TenantLedger()
_ledger_lock = threading.Lock()


def get_tenant_ledger() -> TenantLedger:
    return _ledger


def reset_tenant_ledger(clock: Optional[Callable[[], float]] = None
                        ) -> TenantLedger:
    """Fresh ledger (tests): forgets every bucket and count; its buckets
    read `clock` (default `time.monotonic`)."""
    global _ledger
    with _ledger_lock:
        _ledger = TenantLedger(clock)
    return _ledger


class AdmissionCore:
    """One door's admission policy over the shared tenant ledger.

    `max_queue` / `slo_shed_min_queue` bound the door's own waiting
    queue (the caller reports its current depth — the core holds no
    queue itself, so one class fronts the generation scheduler, the
    worker-pool checkout and the /predict batcher alike).
    `retry_after` is the door's backoff-hint callable (e.g. the
    engine's measured queue-drain estimate); sheds carry its value."""

    def __init__(self, *, max_queue: Optional[int] = None,
                 slo_shed_min_queue: int = 0,
                 retry_after: Optional[Callable[[], float]] = None,
                 ledger: Optional[TenantLedger] = None):
        self.max_queue = max_queue
        self.slo_shed_min_queue = int(slo_shed_min_queue)
        self._retry_after = retry_after or (lambda: 0.5)
        self._ledger = ledger
        reg = get_registry()
        self._c_tenant_admitted = reg.counter(
            "tenant_admitted_total",
            help="tenant-attributed requests admitted past the quota "
                 "gate (unattributed requests are not counted)")
        self._c_tenant_shed = reg.counter(
            "tenant_quota_shed_total",
            help="requests shed 429 by a tenant token bucket "
                 "(docs/control-plane.md)")

    @property
    def ledger(self) -> TenantLedger:
        return self._ledger if self._ledger is not None \
            else get_tenant_ledger()

    def shed_reason(self, depth: int) -> Optional[str]:
        """Why a new request should be turned away right now (None =
        admit).  Two gates: the hard `max_queue` bound, and — when
        `OrcaContext.slo_targets` + `slo_shed_attainment` are set —
        the SLO-aware shedder: attainment below target with at least
        `slo_shed_min_queue` requests already waiting means admitting
        more load would spend latency the objective does not have."""
        if self.max_queue is not None and depth >= self.max_queue:
            return (f"{depth} requests already waiting "
                    f"(max_queue={self.max_queue})")
        thr = OrcaContext.slo_shed_attainment
        if thr is not None and OrcaContext.slo_targets:
            att = get_slo_tracker().attainment()
            if att == att and att < thr and \
                    depth >= self.slo_shed_min_queue:
                return (f"shedding under SLO pressure: attainment "
                        f"{att:.3f} < {thr} with {depth} waiting")
        return None

    def admit(self, depth: int, tenant: Optional[str] = None,
              request_class: str = "interactive") -> int:
        """Admit one request or raise: `QueueFull` (503) from the
        queue/SLO gates, `TenantQuotaExceeded` (429) from the tenant
        bucket.  Returns the request class's scheduler priority."""
        if request_class not in REQUEST_CLASSES:
            raise ValueError(
                f"unknown request class {request_class!r}; valid: "
                f"{REQUEST_CLASSES}")
        reason = self.shed_reason(depth)
        if reason is not None:
            raise QueueFull(reason, retry_after_s=self._retry_after())
        # fault-injection site (resilience/faults.py): "refuse" sheds
        # this request exactly like an organic overload — the client's
        # RetryPolicy + Retry-After path is testable on demand
        act = fault_point("serving.admission", queue_depth=depth)
        if act == "refuse":
            raise QueueFull("injected admission refusal (fault plan)",
                            retry_after_s=self._retry_after())
        if tenant is not None and request_class != "shadow":
            # "refuse" here exercises the 429 path: a quota shed with
            # the standard backoff hint, indistinguishable from an
            # organically empty bucket
            act = fault_point("admission.quota", tenant=str(tenant))
            if act == "refuse":
                self._c_tenant_shed.inc()
                raise TenantQuotaExceeded(
                    f"injected quota refusal for tenant {tenant!r} "
                    "(fault plan)", retry_after_s=self._retry_after())
            eta = self.ledger.charge(str(tenant))
            if eta is not None:
                self._c_tenant_shed.inc()
                raise TenantQuotaExceeded(
                    f"tenant {tenant!r} over quota; retry in "
                    f"{eta:.2f}s", retry_after_s=eta)
            if OrcaContext.tenant_quotas is not None:
                self._c_tenant_admitted.inc()
        return CLASS_PRIORITY[request_class]
