"""ModelRegistry: named models x versions with lifecycle states and a
hot swap that drops nothing (a port of analytics_zoo_tpu/serving/
control_plane/registry.py).

A version is an in-process serving target, a `GenerationEngine` or a
`ReplicaRouter` (anything with ``submit``), registered as
``name@version``.  A version built from a checkpoint registers only
when the port's commit marker (`orca.learn.checkpoint.
has_commit_marker`) proves the write committed, and the marker is
checked again at swap time.

Lifecycle: ``loading`` (registered, warming) -> ``ready`` (warm;
serving when it is the model's current version) -> ``draining`` (just
swapped away; its in-flight streams finish on it, since each stream
holds its engine and the registry repoints only new submissions) ->
``ready`` again once idle, or ``retired`` (removed, its target stopped).
`hot_swap()` is atomic under the registry lock and `rollback()` is a
swap back.  A per-model A/B split and shadow duplication (routing.py)
ride on top.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from analytics_zoo_tpu_torch.observability import get_registry, log_event
from analytics_zoo_tpu_torch.orca.learn.checkpoint import has_commit_marker
from analytics_zoo_tpu_torch.resilience.faults import fault_point
from analytics_zoo_tpu_torch.serving.errors import (
    ModelNotFound,
    UncommittedCheckpointError,
)
from analytics_zoo_tpu_torch.serving.control_plane.routing import (
    ShadowSampler,
    WeightedAB,
    run_shadow,
)

MODEL_STATES = ("loading", "ready", "draining", "retired")


class ModelVersion:
    """One registered version: a serving target plus its lifecycle
    state and (optional) source checkpoint path."""

    __slots__ = ("model", "version", "target", "checkpoint", "state",
                 "t_registered")

    def __init__(self, model: str, version: str, target,
                 checkpoint: Optional[str] = None):
        self.model = model
        self.version = version
        self.target = target
        self.checkpoint = checkpoint
        self.state = "loading"
        self.t_registered = time.time()

    @property
    def label(self) -> str:
        return f"{self.model}@{self.version}"

    def _engines(self):
        reps = getattr(self.target, "replicas", None)
        if reps is not None:
            return [r.engine for r in reps]
        return [self.target]

    def idle(self) -> bool:
        """No queued or slotted work on any engine of this target."""
        for eng in self._engines():
            sched = getattr(eng, "scheduler", None)
            if sched is not None and sched.has_work():
                return False
        return True

    def snapshot(self) -> Dict[str, Any]:
        return {"model": self.model, "version": self.version,
                "state": self.state, "checkpoint": self.checkpoint}


class ModelRegistry:
    """The control plane's model table.  Thread-safe; one per serving
    process (ServingServer accepts it as its generation target —
    `submit()` routes by model name through the per-model A/B and
    shadow policies)."""

    def __init__(self, metrics_registry=None):
        self._models: Dict[str, Dict[str, ModelVersion]] = {}
        self._serving: Dict[str, str] = {}
        self._previous: Dict[str, str] = {}
        self._ab: Dict[str, WeightedAB] = {}
        self._shadow: Dict[str, ShadowSampler] = {}
        self._lock = threading.RLock()
        reg = metrics_registry if metrics_registry is not None \
            else get_registry()
        self._c_swaps = reg.counter(
            "registry_swaps_total",
            help="hot swaps completed (rollbacks included)")
        self._c_rollbacks = reg.counter(
            "registry_rollbacks_total",
            help="hot swaps that were rollbacks to the previous "
                 "serving version")
        self._c_swap_refused = reg.counter(
            "registry_swap_refused_total",
            help="hot swaps refused (unknown/unready version, or the "
                 "commit marker vanished since registration)")
        reg.gauge("registry_models", fn=lambda: len(self._models),
                  help="models registered in the control plane")
        reg.gauge("registry_versions",
                  fn=lambda: sum(len(v) for v in self._models.values()),
                  help="model versions registered (all states)")

    # ------------------------------------------------------------------
    # registration + lifecycle
    # ------------------------------------------------------------------

    def register(self, model: str, version: str, target, *,
                 checkpoint: Optional[str] = None,
                 warm: bool = True) -> ModelVersion:
        """Register `target` as ``model@version``.  With `checkpoint`
        set, the path must carry the port's durable commit marker
        (`orca.learn.checkpoint.has_commit_marker`) or registration
        refuses with `UncommittedCheckpointError`: a torn write never
        becomes a servable version.  `warm=True` (default) runs the
        target's warmup up front, so a later swap takes traffic without
        a cold first dispatch.  The first version registered for a
        model starts serving it."""
        if not str(model) or not str(version):
            raise ValueError("model and version must be non-empty")
        if checkpoint is not None:
            if not has_commit_marker(str(checkpoint)):
                raise UncommittedCheckpointError(
                    f"checkpoint {checkpoint!r} has no durable commit "
                    f"marker — refusing to register {model}@{version} "
                    "from an uncommitted/torn write")
        mv = ModelVersion(str(model), str(version), target,
                          checkpoint=None if checkpoint is None
                          else str(checkpoint))
        with self._lock:
            versions = self._models.setdefault(mv.model, {})
            if mv.version in versions:
                raise ValueError(f"{mv.label} already registered")
            versions[mv.version] = mv
        # label every engine so its request-log records carry the
        # model dimension (observability/request_log.py)
        for eng in mv._engines():
            if hasattr(eng, "model_label"):
                eng.model_label = mv.label
        if warm and hasattr(target, "warmup"):
            target.warmup()
        with self._lock:
            mv.state = "ready"
            if mv.model not in self._serving:
                self._serving[mv.model] = mv.version
        log_event("registry_registered", model=mv.model,
                  version=mv.version, checkpoint=mv.checkpoint)
        return mv

    def get(self, model: str, version: Optional[str] = None) \
            -> ModelVersion:
        with self._lock:
            versions = self._models.get(str(model))
            if not versions:
                raise ModelNotFound(
                    f"model {model!r} is not registered; have: "
                    f"{sorted(self._models)}")
            if version is None:
                version = self._serving[str(model)]
            mv = versions.get(str(version))
            if mv is None:
                raise ModelNotFound(
                    f"{model}@{version} is not registered; have: "
                    f"{sorted(versions)}")
            return mv

    def serving_version(self, model: str) -> str:
        return self.get(str(model)).version

    def models(self):
        with self._lock:
            return sorted(self._models)

    def _default_model(self) -> str:
        with self._lock:
            if len(self._models) == 1:
                return next(iter(self._models))
        raise ModelNotFound(
            "request names no model and the registry holds "
            f"{len(self._models)} — send X-Model / model=")

    # ------------------------------------------------------------------
    # hot swap + rollback
    # ------------------------------------------------------------------

    def hot_swap(self, model: str, version: str) -> ModelVersion:
        """Atomically repoint `model`'s serving version.  The target
        must be registered and warm (state ``ready``), and its source
        checkpoint's commit marker must still exist.  In-flight
        requests are untouched: their streams hold the old engine, so
        they finish there under their original request ids — the
        registry only redirects submissions made after the swap.  The
        old version drains (``draining`` until idle, then ``ready``
        again), which is what makes `rollback()` just a swap back."""
        model, version = str(model), str(version)
        try:
            mv = self.get(model, version)
        except ModelNotFound:
            self._c_swap_refused.inc()
            raise
        if mv.state not in ("ready", "draining"):
            self._c_swap_refused.inc()
            raise UncommittedCheckpointError(
                f"{mv.label} is {mv.state}, not ready — warm it "
                "before swapping traffic onto it")
        if mv.checkpoint is not None:
            if not has_commit_marker(mv.checkpoint):
                self._c_swap_refused.inc()
                raise UncommittedCheckpointError(
                    f"checkpoint {mv.checkpoint!r} lost its commit "
                    f"marker since registration — refusing to swap "
                    f"{mv.label} into service")
        # fault-injection site: a raise here must leave the serving
        # pointer UNMOVED (the swap is all-or-nothing)
        fault_point("registry.swap", model=model, version=version)
        with self._lock:
            old_version = self._serving[model]
            if old_version == version:
                return mv
            old = self._models[model][old_version]
            self._previous[model] = old_version
            self._serving[model] = version
            old.state = "draining"
            mv.state = "ready"
            self._c_swaps.inc()
        log_event("registry_swapped", model=model,
                  version=version, previous=old_version)
        return mv

    def rollback(self, model: str) -> ModelVersion:
        """Swap back to the version serving before the last
        `hot_swap` of `model`."""
        model = str(model)
        with self._lock:
            prev = self._previous.get(model)
        if prev is None:
            raise ValueError(f"model {model!r} has no previous "
                             "version to roll back to")
        mv = self.hot_swap(model, prev)
        self._c_rollbacks.inc()
        return mv

    def retire(self, model: str, version: str) -> None:
        """Remove a non-serving version and stop its target."""
        mv = self.get(str(model), str(version))
        with self._lock:
            if self._serving.get(mv.model) == mv.version:
                raise ValueError(
                    f"{mv.label} is the serving version — swap away "
                    "before retiring it")
            mv.state = "retired"
        if hasattr(mv.target, "stop"):
            mv.target.stop()
        log_event("registry_retired", model=mv.model,
                  version=mv.version)

    def _settle_draining(self) -> None:
        """Flip idle draining versions back to ready (called lazily
        from stats()/submit() — drain completion needs no thread)."""
        with self._lock:
            draining = [mv for versions in self._models.values()
                        for mv in versions.values()
                        if mv.state == "draining"]
        for mv in draining:
            if mv.idle():
                with self._lock:
                    if mv.state == "draining":
                        mv.state = "ready"

    # ------------------------------------------------------------------
    # routing policy
    # ------------------------------------------------------------------

    def set_ab(self, model: str, weights: Optional[Dict[str, float]],
               seed: int = 0) -> None:
        """Weighted A/B split over two (or more) READY versions of
        `model`; None clears the policy (all traffic to the serving
        version)."""
        model = str(model)
        if weights is None:
            with self._lock:
                self._ab.pop(model, None)
            return
        for v in weights:
            self.get(model, v)      # must exist (ModelNotFound)
        with self._lock:
            self._ab[model] = WeightedAB(weights, seed=seed)

    def set_shadow(self, model: str, version: Optional[str],
                   fraction: float = 0.0, seed: int = 0) -> None:
        """Duplicate a `fraction` of `model`'s traffic to candidate
        `version` (output discarded, latency/SLO recorded on the
        shadow side only — routing.py).  None clears it."""
        model = str(model)
        if version is None:
            with self._lock:
                self._shadow.pop(model, None)
            return
        self.get(model, version)
        with self._lock:
            self._shadow[model] = ShadowSampler(str(version),
                                                float(fraction),
                                                seed=seed)

    # ------------------------------------------------------------------
    # the serving front
    # ------------------------------------------------------------------

    def submit(self, prompt, model: Optional[str] = None, **kw):
        """Route one generation request: resolve the model (the single
        registered one when unnamed), pick a version through the A/B
        policy (else the serving version), duplicate to the shadow
        candidate when the sampler fires, and submit to the chosen
        target.  Admission (queue/SLO/tenant) happens in the target's
        own engine — the registry adds routing, not a second queue."""
        model = str(model) if model else self._default_model()
        with self._lock:
            ab = self._ab.get(model)
            shadow = self._shadow.get(model)
            version = ab.choose() if ab is not None else None
        mv = self.get(model, version)
        shadow_version = (shadow.version
                          if shadow is not None and shadow.sample()
                          else None)
        stream = mv.target.submit(prompt, **kw)
        try:
            # the frontend echoes the resolved version back (X-Model)
            # so an A/B-routed client learns which arm served it
            stream.model_label = mv.label
        except AttributeError:
            pass
        if shadow_version is not None and shadow_version != mv.version:
            smv = self.get(model, shadow_version)
            run_shadow(smv.target, prompt, kw,
                       primary_request_id=getattr(stream, "request_id",
                                                  None))
        self._settle_draining()
        return stream

    def stats(self) -> Dict[str, Any]:
        self._settle_draining()
        with self._lock:
            out: Dict[str, Any] = {"models": {}}
            for model, versions in sorted(self._models.items()):
                ab = self._ab.get(model)
                shadow = self._shadow.get(model)
                out["models"][model] = {
                    "serving": self._serving.get(model),
                    "previous": self._previous.get(model),
                    "versions": {v: mv.snapshot()
                                 for v, mv in sorted(versions.items())},
                    "ab_weights": ab.weights if ab is not None else None,
                    "shadow": ({"version": shadow.version,
                                "fraction": shadow.fraction}
                               if shadow is not None else None),
                }
            out["swaps"] = self._c_swaps.value
            out["rollbacks"] = self._c_rollbacks.value
            out["swap_refused"] = self._c_swap_refused.value
            return out

    # ------------------------------------------------------------------
    # lifecycle passthroughs (ServingServer calls these on its target)
    # ------------------------------------------------------------------

    def ensure_started(self) -> "ModelRegistry":
        with self._lock:
            targets = [mv.target for versions in self._models.values()
                       for mv in versions.values()
                       if mv.state != "retired"]
        for t in targets:
            if hasattr(t, "ensure_started"):
                t.ensure_started()
        return self

    def stop(self) -> None:
        with self._lock:
            targets = [mv.target for versions in self._models.values()
                       for mv in versions.values()
                       if mv.state != "retired"]
        for t in targets:
            if hasattr(t, "stop"):
                t.stop()
