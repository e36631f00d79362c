"""Replica router: least-loaded admission over N generation engines (a
port of analytics_zoo_tpu/serving/distributed/router.py; reference:
Cluster Serving's scale-out, Flink `modelParallelism` replicas behind
one queue).

A `ReplicaRouter` owns N `GenerationEngine` replicas, which share one
card, and places each request on the active replica with the lowest load
score: queue depth, plus weighted KV-pool occupancy, plus the occupied
share of the lanes, read from the `generation_queue_depth` /
`generation_cache_occupancy` / `generation_active_slots` gauges each
engine exports.  Each replica has its own `MetricsRegistry` (a shared
one would bind every engine's gauges to the last engine built); the
router's `router_*` / `replica_*` families live in the process
registry, so the server's /metrics carries them, and each replica's loop
spools under the replica's name.

States: ``active`` (admits), ``draining`` (finishes its in-flight work,
admits nothing: `drain()` / `undrain()`), ``dead`` (its loop stopped;
found by the heartbeat sweep, a flight bundle dumped, never admits
again).  When no replica admits, `submit` raises `QueueFull` with the
smallest per-replica `retry_after_s`, which the server answers as a 503
with Retry-After.

A request is sticky: its stream consumes from the replica that admitted
it.  The one exception is a replica that dies mid-stream: `RouterStream`
re-queues the request once on a healthy replica, continuing from the
tokens already delivered (greedy decoding makes the continuation exact),
under the same request id, with `resilience_retries_total` counted.

Replicas built by `build` share one host KV tier of
`OrcaContext.kv_host_tier_bytes` (JAX router.py:284-293): the tier is
keyed by tokens, so a block one replica spilled restores on another.

Phase-aware routing (`OrcaContext.router_phase_aware`, off by default):
with two or more replicas, replica-0 is tagged ``prefill`` and the rest
``decode``; each submit is classified by how much of its prompt any
replica's radix tree or the shared tier already holds.  A prefill-heavy
request (long prompt, little cached) prefers the prefill replica, whose
prefix cache writes its committed blocks through to the shared tier,
and a decode-heavy one prefers the decode replicas, which adopt those
blocks on lookup.  The preference is a load-score penalty
(`PHASE_PENALTY`), not a pin: a saturated preferred replica sheds to
the other phase.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from analytics_zoo_tpu_torch.observability import (
    flight_recorder,
    get_registry,
    log_event,
    now,
    request_log,
    trace,
)
from analytics_zoo_tpu_torch.observability.registry import MetricsRegistry
from analytics_zoo_tpu_torch.resilience.faults import fault_point
from analytics_zoo_tpu_torch.serving.errors import (
    QueueFull,
    ReplicaDiedMidPredict,
    ReplicaStopped,
)
from analytics_zoo_tpu_torch.serving.generation.engine import (
    GenerationEngine,
    GenerationStream,
)

REPLICA_STATES = ("active", "draining", "dead")


class _Replica:
    """One engine plus its router-side state."""

    __slots__ = ("name", "engine", "state", "served", "pending", "phase")

    def __init__(self, name: str, engine: GenerationEngine):
        self.name = name
        self.engine = engine
        self.state = "active"
        self.served = 0
        #: submits placed here that the engine has not taken yet
        self.pending = 0
        #: "prefill" / "decode" under phase-aware routing, else None
        self.phase: Optional[str] = None
        # each replica loop spools under its own name, so the fleet
        # aggregator can tell replica-0's last snapshot from replica-1's
        engine.spool_name = name

    def load_score(self, occupancy_weight: float) -> float:
        """Least-loaded admission score off the engine's live gauges:
        waiting requests dominate, KV-pool occupancy breaks ties
        toward the replica with cache headroom, occupied lanes break
        the remaining ties toward the idler replica.  Submits placed
        here and not yet in the engine's queue count as waiting: without
        them, requests that arrive together all read the same gauges and
        pile onto one replica."""
        reg = self.engine.registry
        depth = float(reg.gauge("generation_queue_depth").value) \
            + self.pending
        occ = float(reg.gauge("generation_cache_occupancy").value)
        slots = float(reg.gauge("generation_active_slots").value)
        return depth + occupancy_weight * occ \
            + slots / max(1, self.engine.max_slots)


class RouterStream:
    """Drop-in `GenerationStream` facade bound to the router.

    Iterating yields token ids exactly like the engine stream it
    wraps; `.request_id` stays pinned to the id the router admitted
    (sticky for the stream's lifetime, across a re-queue).  When the
    serving replica dies mid-stream (its loop finished the request
    with an ``error:`` reason, or the stream's queue timed out), the
    router re-submits ``prompt + tokens-so-far`` once on a healthy
    replica and the iteration continues seamlessly."""

    def __init__(self, router: "ReplicaRouter", replica: _Replica,
                 stream: GenerationStream, prompt: List[int],
                 kwargs: dict):
        self._router = router
        self._replica = replica
        self._stream = stream
        self._prompt = list(prompt)
        self._kwargs = dict(kwargs)
        self._budget = int(kwargs.get("max_new_tokens", 32))
        self._got: List[int] = []
        self._requeues_left = router.max_requeues
        #: span ids of every dispatch attempt (submit + requeues) —
        #: each requeue span links to the dead attempt's span, so the
        #: retry chain is walkable inside ONE trace
        self._dispatch_spans: List[str] = []
        self._finish_reason: Optional[str] = None
        #: sticky id — survives the re-queue (the lifecycle log keeps
        #: one trail: the failed leg's record is finished before the
        #: healthy replica restarts the same id)
        self.request_id = stream.request_id

    @property
    def finish_reason(self) -> Optional[str]:
        if self._finish_reason is not None:
            return self._finish_reason
        return self._stream.finish_reason

    @property
    def replica_name(self) -> str:
        """The replica currently serving this stream."""
        return self._replica.name

    def __iter__(self):
        while True:
            broken = None
            try:
                for token in self._stream:
                    self._got.append(int(token))
                    yield int(token)
            except Exception as e:   # wedged replica: queue timeout
                broken = (f"error: replica stream broke "
                          f"({type(e).__name__}: {e})")
            reason = broken or self._stream.finish_reason
            if (reason is not None and reason.startswith("error")
                    and self._requeues_left > 0
                    and len(self._got) < self._budget):
                self._requeues_left -= 1
                moved = self._router._requeue(self, reason)
                if moved is not None:
                    self._replica, self._stream = moved
                    continue
            self._finish_reason = reason
            self._router._released(self.request_id)
            return

    def tokens(self) -> List[int]:
        return list(self)


class ReplicaRouter:
    """N generation-engine replicas behind one submit() door.

    API-compatible with `GenerationEngine` where `ServingServer`
    touches it: `submit()` (returns a stream), `ensure_started()`,
    `stop()`, `retry_after_s()`, plus `stats()` for the per-replica
    /stats rows."""

    #: load-score penalty of a phase-mismatched replica under phase-aware
    #: routing: more than any occupancy or lane term, about a few queued
    #: requests, so load still wins over a saturated preferred replica
    PHASE_PENALTY = 8.0

    def __init__(self, engines: List[GenerationEngine], *,
                 registry=None, occupancy_weight: float = 4.0,
                 max_requeues: int = 1, phase_aware="auto"):
        if not engines:
            raise ValueError("ReplicaRouter needs at least one engine")
        regs = {id(e.registry) for e in engines}
        if len(regs) != len(engines):
            raise ValueError(
                "every router replica needs its own MetricsRegistry "
                "(a shared registry rebinds the per-engine gauge "
                "callbacks to one engine — build each with "
                "GenerationEngine(..., registry=MetricsRegistry()) or "
                "use ReplicaRouter.build)")
        self.replicas = [_Replica(f"replica-{i}", e)
                         for i, e in enumerate(engines)]
        self.occupancy_weight = float(occupancy_weight)
        self.max_requeues = int(max_requeues)
        self._lock = threading.RLock()
        self._rr = 0
        self._stopped = False
        #: request_id -> replica currently serving it (sticky)
        self._assignment: Dict[str, _Replica] = {}

        reg = registry if registry is not None else get_registry()
        self.registry = reg
        self._c_requests = reg.counter(
            "router_requests_total",
            help="requests admitted through the replica router")
        self._c_sheds = reg.counter(
            "router_sheds_total",
            help="requests shed by the router (no admitting replica)")
        self._c_requeues = reg.counter(
            "router_requeues_total",
            help="requests re-queued on a healthy replica after their "
                 "serving replica died mid-stream")
        reg.gauge("router_replicas", fn=lambda: len(self.replicas),
                  help="replicas owned by the router")
        reg.gauge("router_healthy_replicas",
                  fn=lambda: sum(1 for r in self.replicas
                                 if r.state == "active"
                                 and self._alive(r)),
                  help="replicas currently admitting requests")
        reg.gauge("router_draining_replicas",
                  fn=lambda: sum(1 for r in self.replicas
                                 if r.state == "draining"),
                  help="replicas draining (finishing in-flight work)")
        reg.gauge("router_queue_depth",
                  fn=lambda: sum(len(r.engine.scheduler.waiting)
                                 for r in self.replicas),
                  help="waiting requests summed over all replicas")
        for r in self.replicas:
            # one counter per replica: the served-skew bench gate and
            # the /stats rows read these (family documented as
            # replica_<name>_served_total)
            reg.counter("replica_" + r.name.replace("-", "_")
                        + "_served_total",
                        help=f"requests dispatched to {r.name}")
        # "auto" reads OrcaContext.router_phase_aware; it arms only with
        # two or more replicas
        if phase_aware == "auto":
            from analytics_zoo_tpu_torch.common.context import OrcaContext
            phase_aware = OrcaContext.router_phase_aware
        self.phase_aware = bool(phase_aware) and len(self.replicas) >= 2
        self._c_phase_prefill = reg.counter(
            "router_phase_prefill_total",
            help="submits classified prefill-heavy (phase-aware "
                 "routing; 0 while router_phase_aware is off)")
        self._c_phase_decode = reg.counter(
            "router_phase_decode_total",
            help="submits classified decode-heavy (phase-aware "
                 "routing; 0 while router_phase_aware is off)")
        if self.phase_aware:
            self.replicas[0].phase = "prefill"
            for r in self.replicas[1:]:
                r.phase = "decode"
            pc = self.replicas[0].engine.prefix_cache
            if pc is not None and pc.host_tier is not None:
                # the prefill replica publishes its committed blocks to
                # the shared tier at once, for the decode replicas
                pc.host_write_through = True

    # -- construction --------------------------------------------------

    @classmethod
    def build(cls, model, *, n_replicas="auto", registry=None,
              occupancy_weight: float = 4.0, max_requeues: int = 1,
              warmup: bool = True, **engine_kwargs) -> "ReplicaRouter":
        """N engines over one `CausalLM` (its weights shared, each engine
        with its own KV pool and a fresh `MetricsRegistry`).
        ``n_replicas="auto"`` reads `OrcaContext.serving_replicas`;
        `engine_kwargs` go to every `GenerationEngine` (`device` among
        them: None = the CUDA card).  Without a `kv_host_tier` among
        them and with `OrcaContext.kv_host_tier_bytes` above 0, every
        replica gets one shared `HostKVTier` of that capacity."""
        from analytics_zoo_tpu_torch.common.context import OrcaContext
        if n_replicas == "auto":
            n_replicas = OrcaContext.serving_replicas
        n = int(n_replicas)
        if n < 1:
            raise ValueError(
                f"n_replicas must be >= 1, got {n} (set "
                "OrcaContext.serving_replicas or pass n_replicas)")
        if "kv_host_tier" not in engine_kwargs \
                and OrcaContext.kv_host_tier_bytes > 0:
            # one tier for every replica: a tier each would hold the
            # bytes N times, and no replica could restore another's
            # spills
            from analytics_zoo_tpu_torch.serving.generation.host_tier \
                import HostKVTier
            engine_kwargs["kv_host_tier"] = HostKVTier(
                OrcaContext.kv_host_tier_bytes)
        engines = []
        for _ in range(n):
            eng = GenerationEngine(model, registry=MetricsRegistry(),
                                   **engine_kwargs)
            if warmup:
                eng.warmup()
            engines.append(eng)
        return cls(engines, registry=registry,
                   occupancy_weight=occupancy_weight,
                   max_requeues=max_requeues)

    # -- health --------------------------------------------------------

    @staticmethod
    def _alive(replica: _Replica) -> bool:
        eng = replica.engine
        if eng._stop.is_set():
            return False
        thread = eng._thread
        return thread is None or thread.is_alive()

    def heartbeat(self) -> None:
        """Sweep replica health: a started loop thread that died (or
        an engine stopped behind the router's back) flips its replica
        to ``dead`` with a flight bundle — the admission path never
        places work on it again."""
        with self._lock:
            for r in self.replicas:
                if r.state != "dead" and not self._alive(r):
                    r.state = "dead"
                    log_event("replica_death", replica=r.name)
                    flight_recorder.dump(
                        "replica_death", extra={"replica": r.name})

    def drain(self, replica: Optional[str] = None) -> None:
        """Stop admitting to one replica (by name) or to all of them.
        In-flight streams finish; `undrain` re-opens the door."""
        with self._lock:
            for r in self.replicas:
                if replica in (None, r.name) and r.state == "active":
                    r.state = "draining"
                    log_event("replica_drain", replica=r.name)

    def undrain(self, replica: Optional[str] = None) -> None:
        with self._lock:
            for r in self.replicas:
                if replica in (None, r.name) and r.state == "draining":
                    r.state = "active"
                    log_event("replica_undrain", replica=r.name)

    # -- admission -----------------------------------------------------

    def retry_after_s(self) -> float:
        """Comeback hint for shed responses: the smallest per-replica
        queue-drain estimate among replicas that could come back."""
        hints = [r.engine.retry_after_s() for r in self.replicas
                 if r.state != "dead"]
        return min(hints) if hints else 1.0

    def _candidates(self) -> List[_Replica]:
        return [r for r in self.replicas
                if r.state == "active" and self._alive(r)]

    def _classify(self, prompt) -> str:
        """A request's phase: "decode" when the prompt is short or most
        of it is cached somewhere (a replica's radix tree or the shared
        tier), else "prefill".  Read-only probes: nothing pinned, no
        counter ticked."""
        tokens = list(prompt)
        best = 0
        for r in self.replicas:
            pc = r.engine.prefix_cache
            if pc is None:
                continue
            best = max(best, pc.peek(tokens))
            if pc.host_tier is not None:
                best = max(best, pc.host_tier.match_tokens(tokens))
        bs = self.replicas[0].engine.cache.block_size
        if len(tokens) < 2 * bs or 2 * best >= len(tokens):
            return "decode"
        return "prefill"

    def _ordered(self, candidates: List[_Replica],
                 phase: Optional[str] = None) -> List[_Replica]:
        """Ascending load score; equal scores rotate round-robin, so an
        idle fleet does not pile onto replica-0.  Under phase-aware
        routing a replica of the other phase pays `PHASE_PENALTY`."""
        n = len(self.replicas)
        rr = self._rr
        self._rr += 1
        idx = {id(r): i for i, r in enumerate(self.replicas)}

        def score(r: _Replica) -> float:
            s = r.load_score(self.occupancy_weight)
            if phase is not None and r.phase is not None \
                    and r.phase != phase:
                s += self.PHASE_PENALTY
            return s

        return sorted(candidates,
                      key=lambda r: (score(r), (idx[id(r)] - rr) % n))

    def _dispatched(self, replica: _Replica, request_id: str) -> None:
        replica.served += 1
        self.registry.counter(
            "replica_" + replica.name.replace("-", "_")
            + "_served_total").inc()
        self._assignment[request_id] = replica
        request_log.event(request_id, "replica_dispatch",
                          replica=replica.name)

    def _released(self, request_id: str) -> None:
        with self._lock:
            self._assignment.pop(request_id, None)

    def submit(self, prompt, max_new_tokens: int = 32,
               temperature: float = 0.0, top_k: int = 0,
               eos_id: Optional[int] = None,
               stream_timeout: float = 120.0,
               request_id: Optional[str] = None,
               tenant: Optional[str] = None,
               request_class: str = "interactive") -> RouterStream:
        """Admit one request on the least-loaded active replica.

        Raises exactly what `GenerationEngine.submit` raises —
        ValueError / `RequestTooLarge` propagate from the first
        replica tried (geometry is identical across replicas), and
        `QueueFull` (with the smallest Retry-After hint) when EVERY
        replica sheds or none is admitting.  `TenantQuotaExceeded`
        (429) propagates from the FIRST replica that reached its
        quota gate: the tenant ledger is process-global, so shopping
        the request to another replica would charge the same empty
        bucket — deliberately NOT part of the shed-retry loop below."""
        if self._stopped:
            raise ReplicaStopped("replica router stopped")
        act = fault_point("router.dispatch",
                          replicas=len(self.replicas),
                          request_id=request_id)
        if act == "refuse":
            self._c_sheds.inc()
            raise QueueFull(
                "injected dispatch refusal (fault plan)",
                retry_after_s=self.retry_after_s())
        self.heartbeat()
        kwargs = dict(max_new_tokens=int(max_new_tokens),
                      temperature=temperature, top_k=top_k,
                      eos_id=eos_id, stream_timeout=stream_timeout,
                      tenant=tenant, request_class=request_class)
        phase = None
        if self.phase_aware:
            phase = self._classify(prompt)
            (self._c_phase_prefill if phase == "prefill"
             else self._c_phase_decode).inc()
        with self._lock:
            candidates = self._ordered(self._candidates(), phase=phase)
            if candidates:
                # reserved in the same critical section as the choice
                candidates[0].pending += 1
        if not candidates:
            self._c_sheds.inc()
            raise QueueFull(
                "no active replica (all draining or dead)",
                retry_after_s=self.retry_after_s())
        sheds: List[QueueFull] = []
        for k, r in enumerate(candidates):
            if k:
                with self._lock:
                    r.pending += 1
            try:
                # the dispatch span nests under whatever is open on
                # this thread (serving.generate, stream.consume) — or
                # under an ambient remote trace context — so the
                # placement decision is part of the request's trace
                with trace("router.dispatch", replica=r.name,
                           request_id=request_id, attempt=1) as dsp:
                    stream = r.engine.submit(prompt,
                                             request_id=request_id,
                                             **kwargs)
                    dsp.attrs["request_id"] = stream.request_id
            except QueueFull as e:
                sheds.append(e)
                continue
            finally:
                # the engine's gauges show the request from here on
                with self._lock:
                    r.pending -= 1
            with self._lock:
                self._dispatched(r, stream.request_id)
            self._c_requests.inc()
            rs = RouterStream(self, r, stream, prompt, kwargs)
            rs._dispatch_spans.append(dsp.span_id)
            return rs
        self._c_sheds.inc()
        hints = [e.retry_after_s for e in sheds
                 if e.retry_after_s is not None]
        raise QueueFull(
            f"every replica shed ({sheds[-1]})",
            retry_after_s=min(hints) if hints
            else self.retry_after_s())

    def _requeue(self, rs: RouterStream,
                 reason: str) -> Optional[Tuple[_Replica,
                                                GenerationStream]]:
        """Place a mid-stream casualty on a healthy replica (at most
        once per request, budgeted by the RouterStream).  Continues
        from the tokens already streamed — greedy decode makes the
        continuation exactly the sequence the dead replica would have
        produced — under the SAME request_id."""
        t_detect = now()
        self.heartbeat()
        failed = rs._replica
        death = ReplicaDiedMidPredict(
            f"replica {failed.name} failed request {rs.request_id} "
            f"mid-stream ({reason})")
        log_event("router_requeue", replica=failed.name,
                  request_id=rs.request_id, error=str(death))
        with self._lock:
            candidates = [r for r in self._candidates()
                          if r is not failed]
            if not candidates:
                return None
            target = self._ordered(candidates)[0]
        kwargs = dict(rs._kwargs)
        kwargs["max_new_tokens"] = rs._budget - len(rs._got)
        # the requeue is a NEW span in the SAME trace (it runs on the
        # thread consuming the stream, under the request's open span /
        # remote context), linked to the dead attempt's dispatch span
        # and numbered — so "one request, two replicas, one trace" is
        # literal in the fleet timeline
        attempt_n = len(rs._dispatch_spans) + 1
        try:
            with trace("router.requeue", replica=target.name,
                       failed_replica=failed.name,
                       request_id=rs.request_id, attempt=attempt_n,
                       link_span_id=(rs._dispatch_spans[-1]
                                     if rs._dispatch_spans
                                     else None)) as qsp:
                # the new record's blame ledger charges the death-
                # detection + re-placement gap to the "requeue" phase
                # (the dying engine's error finish closed the old
                # record; the seed keeps the client's wait additive)
                stream = target.engine.submit(
                    rs._prompt + rs._got,
                    request_id=rs.request_id,
                    blame_seed={"requeue": now() - t_detect},
                    **kwargs)
        except Exception:
            return None
        rs._dispatch_spans.append(qsp.span_id)
        self._c_requeues.inc()
        # the shared retry ledger (resilience/retry.py registers it;
        # the router is one more adopter — docs/observability.md)
        get_registry().counter("resilience_retries_total").inc()
        with self._lock:
            self._dispatched(target, stream.request_id)
        return target, stream

    # -- lifecycle -----------------------------------------------------

    def warmup(self) -> "ReplicaRouter":
        for r in self.replicas:
            r.engine.warmup()
        return self

    def ensure_started(self) -> "ReplicaRouter":
        for r in self.replicas:
            if r.state != "dead":
                r.engine.ensure_started()
        return self

    def run_until_idle(self) -> None:
        """Drive every replica's loop inline (tests/bench)."""
        for r in self.replicas:
            r.engine.run_until_idle()

    def consume_stream(self, stream, out_stream=None, **kw):
        """Attach the ROUTER to a durable stream as a consumer-group
        member: leased prompts go through `submit`'s least-loaded
        admission (and its died-mid-decode requeue), so a replica
        death mid-record composes with the stream's lease replay —
        the record either finishes on a survivor via the router's own
        requeue, or the consumer dies with it and the lease expiry
        replays the same record id (docs/streaming.md)."""
        from analytics_zoo_tpu_torch.serving.streaming.consumer import (
            generation_consumer,
        )
        return generation_consumer(stream, self,
                                   out_stream=out_stream, **kw)

    def stop(self) -> None:
        self._stopped = True
        for r in self.replicas:
            r.engine.stop()

    # -- introspection -------------------------------------------------

    def stats(self) -> dict:
        """Per-replica rows for /stats plus router totals."""
        self.heartbeat()
        rows = []
        for r in self.replicas:
            eng = r.engine
            rows.append({
                "replica": r.name,
                "state": r.state,
                "queue_depth": len(eng.scheduler.waiting),
                "active_slots": len(eng.scheduler.running()),
                "cache_occupancy": round(
                    float(eng.cache.allocator.occupancy()), 4),
                "served": r.served,
                "tokens_total": int(eng._c_tokens.value),
                "tensor_parallel": 0,
                "phase": r.phase,
            })
        return {
            "replicas": rows,
            "requests": int(self._c_requests.value),
            "sheds": int(self._c_sheds.value),
            "requeues": int(self._c_requeues.value),
        }
