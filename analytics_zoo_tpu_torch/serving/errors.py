"""Error taxonomy — the single table mapping every typed exception of
the serving and resilience layers to an HTTP status (a copy of
analytics_zoo_tpu/serving/errors.py).

Keyed by CLASS NAME (not class object) so this table imports with zero
dependencies: a client-only process and the HTTP layer read the same
dict, and both packages answer the same status for the same name.
"""

from __future__ import annotations

#: exception class name -> HTTP status the serving layer answers with.
#: 4xx = the request's fault (do not retry unchanged); 503 = back off
#: and retry (responses carry Retry-After); 500 = server-side fault.
ERROR_HTTP_STATUS = {
    # serving/generation admission + geometry
    "RequestTooLarge": 413,
    # replica health — the shared vocabulary of the image-serving
    # WorkerPool and the generation ReplicaRouter (both 503: the
    # replica set is degraded, the request itself is fine to retry)
    "ReplicaStopped": 503,
    "ReplicaDiedMidPredict": 503,
    "QueueFull": 503,
    # control plane (serving/control_plane/): per-tenant quota sheds
    # are 429 — the SERVICE has capacity, this tenant's token bucket
    # is empty, and retrying another replica cannot help (the ledger
    # is process-global), so this is deliberately NOT a QueueFull
    # subclass (the router's shed-retry loop must not spin on it)
    "TenantQuotaExceeded": 429,
    # registry lifecycle misuse: registering/swapping onto a
    # checkpoint without a durable commit marker, or naming a model
    # the registry does not hold (4xx — the caller's config is wrong,
    # the serving fleet is healthy)
    "UncommittedCheckpointError": 409,
    "ModelNotFound": 404,
    # streaming data plane: bounded-buffer backpressure at enqueue —
    # 429 (the stream exists and is healthy, the CALLER is outrunning
    # the consumer groups' drain rate; responses carry Retry-After
    # derived from that rate — docs/streaming.md)
    "StreamBacklogFull": 429,
    # resilience: injected faults (chaos is a server-side 5xx; a
    # poisoned request's eviction is shed-shaped, hence 503)
    "FaultInjected": 500,
    "SimulatedWorkerFailure": 500,
    "SimulatedCrash": 500,
    "PoisonedRequestError": 503,
    # resilience: recovery machinery
    "WorkerCancelled": 503,
    "ElasticRestartExceeded": 500,
    "CheckpointWriteError": 500,
}


class ReplicaStopped(RuntimeError):
    """A predict/submit raced a deliberate shutdown: the pool or
    router was stopping, so the failure is lifecycle, not fault.  Both
    replica pools (`serving/worker_pool.py`, the generation
    `ReplicaRouter`) raise this one name so callers and dashboards see
    a single taxonomy (HTTP 503 — retry elsewhere or later)."""


class ReplicaDiedMidPredict(RuntimeError):
    """A replica died while holding a request.  The WorkerPool
    respawns the worker and surfaces this to the caller whose request
    was lost; the ReplicaRouter records it and re-queues the request
    once on a healthy replica (HTTP 503 when it does escape)."""


class QueueFull(RuntimeError):
    """Admission shed: the waiting queue is at its bound or the SLO
    shedder judged the backlog unserveable (HTTP 503).  Raised by the
    unified AdmissionCore (serving/control_plane/admission.py) on
    behalf of every front door — GenerationEngine.submit, the
    WorkerPool checkout, ServingServer's /predict batcher and the
    ReplicaRouter (when EVERY replica shed).  Carries the server's
    backoff hint: ``retry_after_s`` (seconds), surfaced as the HTTP
    Retry-After header."""

    def __init__(self, message: str,
                 retry_after_s: "float | None" = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class RequestTooLarge(ValueError):
    """The request can NEVER fit this engine's compiled geometry
    (prompt + max_new_tokens vs max_context) — a client error (HTTP
    413), not a load condition; retrying unchanged cannot succeed."""


class TenantQuotaExceeded(RuntimeError):
    """Per-tenant token-bucket quota exhausted (HTTP 429 — the caller
    should back off for ``retry_after_s``, the bucket's refill ETA).
    Deliberately not a QueueFull subclass: the quota ledger is shared
    by every replica in the process, so shopping the request around
    the fleet cannot admit it (docs/control-plane.md)."""

    def __init__(self, message: str,
                 retry_after_s: "float | None" = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class UncommittedCheckpointError(RuntimeError):
    """The ModelRegistry refused to register or hot-swap a version
    whose source checkpoint lacks a durable commit marker (the commit
    protocol's ``<path>.commit``, written after fsync) — a torn or
    in-flight write must never take traffic.  HTTP 409: the conflict
    is between the caller's intent and the checkpoint's state; finish
    (or re-run) the commit, then retry."""


class ModelNotFound(KeyError):
    """The request named a model (or model version) the registry does
    not hold — HTTP 404.  Carries the registered names so a typo is
    diagnosable from the error body alone."""


def http_status_for(exc: BaseException, default: int = 500) -> int:
    """Resolve an exception (walking its MRO, so subclasses inherit
    their base's mapping) to an HTTP status."""
    for klass in type(exc).__mro__:
        status = ERROR_HTTP_STATUS.get(klass.__name__)
        if status is not None:
            return status
    return default


__all__ = ["ERROR_HTTP_STATUS", "http_status_for", "ReplicaStopped",
           "ReplicaDiedMidPredict", "QueueFull", "RequestTooLarge",
           "TenantQuotaExceeded", "UncommittedCheckpointError",
           "ModelNotFound"]
