"""The runtime entry points and `OrcaContext` (counterpart of
analytics_zoo_tpu/common/context.py).

`init_orca_context(cluster_mode="local")` (and its alias
`init_nncontext`) starts the runtime and `stop_orca_context` stops it,
with JAX's rules (context.py:906-1004): a second call with the same
mode returns what the first returned; another mode raises RuntimeError
until `stop_orca_context`; an explicit call replaces the implicit local
start made by reading `OrcaContext.device`; an unknown mode raises
JAX's ValueError; `cores` sets `OMP_NUM_THREADS` unless it is set; an
atexit hook stops the runtime.  JAX returns the global device `Mesh`;
the port returns this process's device, the `torch.device` that
`resolve_device(device)` gives (None: the CUDA card, or a raise), and
keeps its `ProcessMesh` as `OrcaContext.mesh`.

"distributed" (and JAX's alias "tpu_pod") starts a
`torch.distributed` process group, one process a rank: the rendezvous
is `coordinator_address` ("host:port"), `num_processes` and
`process_id`, each read from the usual torch environment variables
(`MASTER_ADDR` / `MASTER_PORT`, `WORLD_SIZE`, `RANK`) where not given.
A rank on the card takes card `LOCAL_RANK` (else its rank) modulo the
cards it sees.  The backend is "nccl" when every rank has a card of its
own, and "gloo" on the CPU or where ranks share a card (NCCL runs one
rank a device); `stop_orca_context` destroys the group.  `mesh_shape`
may hold "sp" (sequence parallelism, `parallel/ring_attention.py`)
beside "dp": 1; every other axis, and dp > 1, raises
NotImplementedError (ROADMAP Queue 1 item 8b).  `OrcaContext.initialized`,
`cluster_mode`, `device`, `mesh`, `num_devices` and `devices` read the
runtime's state.

The settings user code reads and writes as `OrcaContext.<setting>` are
the part of JAX's that the ported paths read:

  * `train_data_store`: "DRAM" (the default: host batches, copied to
    the card step by step), "DEVICE" (the dataset uploaded to the card
    once, every epoch indexing it in place) or "DISK_n" (new XShards
    pickle their shards to a temp dir and stream them back one at a
    time; as in the JAX package, n is never read);
  * `shard_size` (None): target rows per shard of `XShards.partition`;
  * `host_input_prefetch` (2): how many host batches the train engine
    keeps staged on the card ahead of the step that takes them (0
    stages each inside its own step);
  * `device_cache_bytes`: the most the DEVICE store holds on the card
    across cached datasets, 256 MiB by default;
  * `failure_retry_times` (5) and `failure_retry_interval_s` (1.0): how
    often `Estimator.fit` restores its newest checkpoint and resumes
    after a failure, and the backoff between tries;
  * `background_checkpointing` (False): trigger saves leave the
    critical path after one device-to-host snapshot;
  * `fault_plan` (None): the armed fault-injection plan
    (`resilience/faults.py`);
  * the observability planes' settings (`observability/`), with JAX's
    defaults and checks (context.py:57-87): `observability_dir` (None),
    `goodput_sample_every` (16), `watchdog_deadline_s` (None),
    `nonfinite_watchdog` (False), `memory_sample_interval_s` (1.0),
    `hardware_peak_flops` (None) and `request_log_size` (256); the
    serving side's (context.py:64-86, :231-294, :410-591): `slo_targets`
    (None), `blame_tolerance` (0.05), `exemplar_count` (16),
    `exemplar_max_bytes` (64 KiB), `metrics_history_interval_s` (None),
    `metrics_history_max_bytes` (8 MiB), `telemetry_spool_interval_s`
    (1.0), `telemetry_spool_max_bytes` (1 MiB) and `slo_shed_attainment`
    (None);
  * the generation engine's defaults, read where its arguments are
    "auto": `kv_cache_quantization` (None or "int8"), `prefix_caching`
    (False), `chunked_prefill` (False), `speculative_decoding` (False),
    `speculative_k` (4) and `kv_host_tier_bytes` (0, no host tier).
"""

from __future__ import annotations

import atexit
import logging
import os
import threading
from typing import Any, Dict, List, Optional

logger = logging.getLogger("analytics_zoo_tpu_torch")

#: where the other parallel axes are queued
_LATER = ("only the 'sp' axis (with 'dp': 1) is ported; the other "
          "parallel axes come with ROADMAP Queue 1 item 8b")

#: JAX's mesh axes, in its order (context.py:38), and the data axes
MESH_AXES = ("dp", "fsdp", "pp", "ep", "sp", "tp")
DATA_AXES = ("dp", "fsdp")
#: the axes a torch.distributed mesh may hold, and dp's one size
_PORTED_AXES = ("dp", "sp")


class ProcessMesh:
    """The port's counterpart of JAX's `jax.sharding.Mesh`: the ranks of
    a `torch.distributed` job laid out over named axes (JAX's order),
    with this process's coordinate on each axis and a process group for
    each (none in local mode, where the axes hold one process).

    `axis_names`, `shape` (axis -> size) and `size` read as JAX's do;
    `rank`, `coords` (axis -> index), `groups` (axis -> group) and
    `backend` say where this process sits."""

    def __init__(self, shape: Dict[str, int], device, rank: int = 0,
                 groups: Optional[Dict[str, Any]] = None,
                 backend: Optional[str] = None):
        self.axis_names = tuple(a for a in MESH_AXES if a in shape)
        self.shape = {a: int(shape[a]) for a in self.axis_names}
        self.size = 1
        for a in self.axis_names:
            self.size *= self.shape[a]
        self.device = device
        self.rank = int(rank)
        self.backend = backend
        self.groups = dict(groups or {})
        self.coords = {}
        rest = self.rank
        for a in reversed(self.axis_names):
            self.coords[a] = rest % self.shape[a]
            rest //= self.shape[a]

    def group_ranks(self, axis: str) -> List[int]:
        """The global ranks of this process's group along `axis`, in
        axis order."""
        names = self.axis_names
        stride = 1
        for a in names[names.index(axis) + 1:]:
            stride *= self.shape[a]
        base = self.rank - self.coords[axis] * stride
        return [base + i * stride for i in range(self.shape[axis])]

    def __repr__(self):
        return (f"ProcessMesh({self.shape}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")


class OrcaContextMeta(type):
    _train_data_store = "DRAM"
    _shard_size = None
    _host_input_prefetch = 2
    _device_cache_bytes = 256 * 1024 * 1024
    _failure_retry_times = 5
    _failure_retry_interval_s = 1.0
    _background_checkpointing = False
    _fault_plan = None
    _kv_cache_quantization = None
    _prefix_caching = False
    _chunked_prefill = False
    _speculative_decoding = False
    _speculative_k = 4
    _kv_host_tier_bytes = 0
    _observability_dir = None
    _goodput_sample_every = 16
    _watchdog_deadline_s = None
    _nonfinite_watchdog = False
    _memory_sample_interval_s = 1.0
    _hardware_peak_flops = None
    _request_log_size = 256
    _slo_targets = None
    _blame_tolerance = 0.05
    _exemplar_count = 16
    _exemplar_max_bytes = 64 * 1024
    _metrics_history_interval_s = None
    _metrics_history_max_bytes = 8 * 1024 * 1024
    _telemetry_spool_interval_s = 1.0
    _telemetry_spool_max_bytes = 1024 * 1024
    _slo_shed_attainment = None
    _tenant_quotas = None
    _serving_replicas = 0
    _router_phase_aware = False

    # --- runtime state ---
    _device = None
    _mesh = None
    _cluster_mode = None
    _initialized = False
    _auto_initialized = False
    _lock = threading.Lock()

    @property
    def device(cls):
        """The `torch.device` the runtime runs on (JAX's `mesh`).
        Reading it before `init_orca_context` starts local mode on the
        default device; a later explicit `init_orca_context` call
        replaces that start."""
        if cls._device is None:
            init_orca_context(cluster_mode="local")
            # on the metaclass, where init_orca_context reads it (JAX's
            # `mesh` sets it on OrcaContext, so JAX never replaces its
            # implicit start)
            OrcaContextMeta._auto_initialized = True
        return cls._device

    @property
    def cluster_mode(cls):
        return cls._cluster_mode

    @property
    def initialized(cls):
        return cls._initialized

    @property
    def mesh(cls):
        """The runtime's `ProcessMesh` (JAX's `mesh`); reading it, as
        reading `device`, starts local mode when nothing has started."""
        cls.device
        return cls._mesh

    @property
    def num_devices(cls):
        """The devices the runtime spans (the mesh's size, as JAX's)."""
        return cls.mesh.size

    @property
    def devices(cls):
        return [cls.device]

    @property
    def train_data_store(cls):
        """"DRAM", "DEVICE" or "DISK_n": where training data lives
        between epochs.  Sources mutated after a DEVICE fit has cached
        them are seen only where a sampled row changed (the Estimator's
        content fingerprint)."""
        return cls._train_data_store

    @train_data_store.setter
    def train_data_store(cls, value):
        value = str(value).upper()
        if value not in ("DRAM", "DEVICE") and not value.startswith("DISK"):
            raise ValueError(
                "train_data_store must be 'DRAM', 'DEVICE' or 'DISK_n'")
        cls._train_data_store = value

    @property
    def shard_size(cls):
        """Target rows per `XShards.partition` shard, or None (one shard
        per pool thread)."""
        return cls._shard_size

    @shard_size.setter
    def shard_size(cls, value):
        if value is not None and int(value) <= 0:
            raise ValueError("shard_size must be positive or None")
        cls._shard_size = None if value is None else int(value)

    @property
    def host_input_prefetch(cls):
        """Host-input double-buffering depth of the train engine's
        host-streaming loops (`orca/learn/spmd.py`): with depth d >= 1
        the loop keeps d batches staged and stages the next one right
        after it queues the current step, so the host builds and copies
        batch k+1 while step k runs on the card.  0 stages each batch
        synchronously inside its own step.  Default 2."""
        return cls._host_input_prefetch

    @host_input_prefetch.setter
    def host_input_prefetch(cls, value):
        if int(value) < 0:
            raise ValueError("host_input_prefetch must be >= 0")
        cls._host_input_prefetch = int(value)

    @property
    def device_cache_bytes(cls):
        """The most bytes the DEVICE store holds on the card across
        cached datasets (an Estimator evicts its older entries before
        passing it); a single dataset over it streams from the host,
        with a warning."""
        return cls._device_cache_bytes

    @device_cache_bytes.setter
    def device_cache_bytes(cls, value):
        cls._device_cache_bytes = int(value)

    @property
    def failure_retry_times(cls):
        """How many times `Estimator.fit` restores the newest checkpoint
        and resumes after a training failure."""
        return cls._failure_retry_times

    @failure_retry_times.setter
    def failure_retry_times(cls, value):
        if int(value) < 0:
            raise ValueError("failure_retry_times must be >= 0")
        cls._failure_retry_times = int(value)

    @property
    def failure_retry_interval_s(cls):
        """Seconds before the first retry (doubling with each further
        one, `RetryPolicy`)."""
        return cls._failure_retry_interval_s

    @failure_retry_interval_s.setter
    def failure_retry_interval_s(cls, value):
        if float(value) < 0:
            raise ValueError("failure_retry_interval_s must be >= 0")
        cls._failure_retry_interval_s = float(value)

    @property
    def background_checkpointing(cls):
        """True routes `Estimator` trigger saves through the
        `BackgroundCheckpointer`: the caller pays one snapshot of the
        state to host tensors, the commit protocol runs on a writer
        thread.  False (the default) leaves the choice to
        `checkpoint.async_save_enabled` (background on the card,
        synchronous on the CPU)."""
        return cls._background_checkpointing

    @background_checkpointing.setter
    def background_checkpointing(cls, value):
        cls._background_checkpointing = bool(value)

    @property
    def fault_plan(cls):
        """The armed `FaultPlan`, or None (every injection site a no-op).
        Accepts a `FaultPlan` or its dict form, ``{"seed": 0, "faults":
        [{"site": ..., "action": ..., "at": N, "times": 1}, ...]}``."""
        return cls._fault_plan

    @fault_plan.setter
    def fault_plan(cls, value):
        if value is None:
            cls._fault_plan = None
            return
        from analytics_zoo_tpu_torch.resilience.faults import FaultPlan
        cls._fault_plan = FaultPlan.from_config(value)


    @property
    def kv_cache_quantization(cls):
        """The generation engine's KV pool residency: None (default)
        keeps the pool at the engine's `cache_dtype`; "int8" stores
        int8 values with per-token-slot scales, dequantized on read."""
        return cls._kv_cache_quantization

    @kv_cache_quantization.setter
    def kv_cache_quantization(cls, value):
        if value is not None:
            value = str(value).lower()
            if value in ("none", "off"):
                value = None
            elif value != "int8":
                raise ValueError(
                    f"kv_cache_quantization must be None or 'int8', "
                    f"got {value!r}")
        cls._kv_cache_quantization = value

    @property
    def prefix_caching(cls):
        """Radix-tree prompt-prefix reuse in the generation engine
        (`serving/generation/prefix_cache.py`).  False (default): every
        request prefills its whole prompt into blocks of its own.  True:
        admission shares the longest cached whole-block prefix and
        prefills only the tail; full prompt blocks are committed back,
        and unreferenced cached blocks are evicted LRU under pool
        pressure before a running lane is preempted."""
        return cls._prefix_caching

    @prefix_caching.setter
    def prefix_caching(cls, value):
        cls._prefix_caching = bool(value)

    @property
    def chunked_prefill(cls):
        """Chunked prefill in the generation engine (default False):
        a long prompt prefills in chunks bounded by the engine's
        `prefill_token_budget`, with a decode step for the running lanes
        between chunks."""
        return cls._chunked_prefill

    @chunked_prefill.setter
    def chunked_prefill(cls, value):
        cls._chunked_prefill = bool(value)

    @property
    def speculative_decoding(cls):
        """Draft-free speculative decoding (`serving/generation/
        speculation.py`, default False): greedy lanes draft up to
        `speculative_k` tokens from their own history and one verify
        step scores them; the accepted tokens are those single-step
        greedy decoding gives."""
        return cls._speculative_decoding

    @speculative_decoding.setter
    def speculative_decoding(cls, value):
        cls._speculative_decoding = bool(value)

    @property
    def speculative_k(cls):
        """The most tokens a lane drafts a round (default 4)."""
        return cls._speculative_k

    @speculative_k.setter
    def speculative_k(cls, value):
        value = int(value)
        if value < 1:
            raise ValueError(f"speculative_k must be >= 1, got {value}")
        cls._speculative_k = value

    @property
    def kv_host_tier_bytes(cls):
        """Bytes of host memory the prefix cache may spill evicted KV
        blocks into (`serving/generation/host_tier.py`); 0 (default) =
        no tier, evicted blocks are dropped.  Used only with
        `prefix_caching` on."""
        return cls._kv_host_tier_bytes

    @kv_host_tier_bytes.setter
    def kv_host_tier_bytes(cls, value):
        value = int(value)
        if value < 0:
            raise ValueError("kv_host_tier_bytes must be >= 0 (0 = off)")
        cls._kv_host_tier_bytes = value

    @property
    def observability_dir(cls):
        """Directory of the structured-event sink: `log_event` and
        completed spans append to `<dir>/events.jsonl`, and flight
        bundles land here.  None (default) disables the sink; the
        in-memory metrics, spans and rings work regardless."""
        return cls._observability_dir

    @observability_dir.setter
    def observability_dir(cls, value):
        cls._observability_dir = None if value is None else str(value)

    @property
    def goodput_sample_every(cls):
        """Fence cadence of the goodput `StepClock`s
        (`observability/goodput.py`): every Nth step is closed with a
        fence (`torch.cuda.synchronize` on the card) so its wall time
        splits exactly into compile / host-input / device-compute /
        blocked-collective / checkpoint / overhead.  Default 16; 1
        fences every step."""
        return cls._goodput_sample_every

    @goodput_sample_every.setter
    def goodput_sample_every(cls, value):
        if int(value) < 1:
            raise ValueError("goodput_sample_every must be >= 1")
        cls._goodput_sample_every = int(value)

    @property
    def watchdog_deadline_s(cls):
        """Stall-watchdog deadline in seconds (None = off, the
        default).  When set, `Estimator.fit` and the generation engine
        arm a `Watchdog`: no step or round for this long increments
        `watchdog_stall_total` and writes a flight bundle to
        `observability_dir`.  Size it above the slowest step, the
        kernels' first build included."""
        return cls._watchdog_deadline_s

    @watchdog_deadline_s.setter
    def watchdog_deadline_s(cls, value):
        if value is not None and float(value) <= 0:
            raise ValueError("watchdog_deadline_s must be > 0 or None")
        cls._watchdog_deadline_s = (None if value is None
                                    else float(value))

    @property
    def nonfinite_watchdog(cls):
        """Opt-in nonfinite sentinel (default False).  The train step
        always computes its `_nan_steps` stat on the device; with the
        sentinel on the host reads it every step (a sync with the card:
        that is its cost) and, on a non-finite step, recomputes the
        batch from the kept pre-step state, names the first nonfinite
        tensors (`observability.localize_nonfinite`) and writes a
        flight bundle.  Off, the step's launches are unchanged."""
        return cls._nonfinite_watchdog

    @nonfinite_watchdog.setter
    def nonfinite_watchdog(cls, value):
        cls._nonfinite_watchdog = bool(value)

    @property
    def memory_sample_interval_s(cls):
        """Least seconds between memory samples (`observability/
        memory.py`: host RSS, the card's allocated and reserved bytes,
        the registered pools), taken from fenced goodput steps.  None
        disables those samples (forced ones still work)."""
        return cls._memory_sample_interval_s

    @memory_sample_interval_s.setter
    def memory_sample_interval_s(cls, value):
        if value is not None and float(value) < 0:
            raise ValueError(
                "memory_sample_interval_s must be >= 0 or None")
        cls._memory_sample_interval_s = (None if value is None
                                         else float(value))

    @property
    def hardware_peak_flops(cls):
        """The peak FLOP/s the dispatch ledger's MFU divides by
        (`observability/profiling.py`).  None (default) falls back to
        `profiling.DEFAULT_PEAK_FLOPS` (1 TFLOP/s, a placeholder that
        keeps CPU numbers comparable); set the card's dense peak (an
        H100 SXM: 989e12 in bf16) for a meaningful ratio."""
        return cls._hardware_peak_flops

    @hardware_peak_flops.setter
    def hardware_peak_flops(cls, value):
        if value is not None and float(value) <= 0:
            raise ValueError("hardware_peak_flops must be > 0 or None")
        cls._hardware_peak_flops = (None if value is None
                                    else float(value))

    @property
    def request_log_size(cls):
        """Capacity of the request lifecycle log's ring of finished
        records (`observability/request_log.py`), read when the process
        log is made (`reset_request_log()` reads it again)."""
        return cls._request_log_size

    @request_log_size.setter
    def request_log_size(cls, value):
        if int(value) < 1:
            raise ValueError("request_log_size must be >= 1")
        cls._request_log_size = int(value)

    @property
    def slo_targets(cls):
        """Per-request latency SLO targets (`observability/slo.py`): a
        dict over {"ttft_s", "tpot_s", "queue_wait_s", "e2e_s"}, seconds
        each, any subset.  Every finished generation request is judged
        against them: misses count in ``slo_violation_total`` (and the
        ``slo_violation_<dim>_total`` family), the rolling attainment is
        the ``slo_attainment_ratio`` gauge and GET /slo.  A
        ``"model:<name>"`` / ``"tenant:<name>"`` key maps to its own
        sub-dict over the same dimensions, laid over the base for that
        model's / tenant's requests (the tenant's wins).  None (default)
        judges nothing."""
        return cls._slo_targets

    @slo_targets.setter
    def slo_targets(cls, value):
        if value is None:
            cls._slo_targets = None
            return
        from analytics_zoo_tpu_torch.observability.slo import (
            SLO_DIMENSIONS,
        )

        def _dims(d, who):
            out = {}
            for k, v in dict(d).items():
                if k not in SLO_DIMENSIONS:
                    raise ValueError(
                        f"unknown SLO dimension {k!r}{who}; valid: "
                        f"{SLO_DIMENSIONS}")
                if float(v) <= 0:
                    raise ValueError(f"SLO target {k} must be > 0")
                out[k] = float(v)
            return out

        targets = {}
        for k, v in dict(value).items():
            if isinstance(k, str) and (k.startswith("model:")
                                       or k.startswith("tenant:")):
                if not k.split(":", 1)[1]:
                    raise ValueError(
                        f"keyed SLO target {k!r} names no model/tenant")
                targets[k] = _dims(v, f" under {k!r}")
            else:
                targets.update(_dims({k: v}, ""))
        cls._slo_targets = targets

    @property
    def blame_tolerance(cls):
        """Relative slack of the phase ledger's additivity
        (`observability/blame.py`): a finished request's phases sum to
        its e2e within this fraction (an absolute 0.1 ms floor covers
        sub-millisecond e2e); a miss flips the ledger's `additive_ok`
        and ticks `blame_additivity_violations_total`."""
        return cls._blame_tolerance

    @blame_tolerance.setter
    def blame_tolerance(cls, value):
        if not (0.0 < float(value) <= 1.0):
            raise ValueError("blame_tolerance must be in (0, 1]")
        cls._blame_tolerance = float(value)

    @property
    def exemplar_count(cls):
        """The most tail exemplars the process store holds
        (`observability/exemplars.py`): SLO violators displace the
        others, else the top-k slowest; 0 captures none."""
        return cls._exemplar_count

    @exemplar_count.setter
    def exemplar_count(cls, value):
        if int(value) < 0:
            raise ValueError("exemplar_count must be >= 0")
        cls._exemplar_count = int(value)

    @property
    def exemplar_max_bytes(cls):
        """JSON bytes an exemplar may take: its span, dispatch,
        scheduler and event tails are halved (newest kept) until it
        fits."""
        return cls._exemplar_max_bytes

    @exemplar_max_bytes.setter
    def exemplar_max_bytes(cls, value):
        if int(value) < 2048:
            raise ValueError("exemplar_max_bytes must be >= 2048")
        cls._exemplar_max_bytes = int(value)

    @property
    def metrics_history_interval_s(cls):
        """The metrics history recorder's cadence in seconds
        (`observability/history.py`); None (default) leaves it disarmed.
        When set, the generation engine's loop samples every registered
        registry into a bounded ring and, with `observability_dir`, a
        CRC32C-framed log under `observability_dir/history/<proc>/`;
        each sample steps the built-in AlertEngine.  GET
        /metrics/history takes a sample on demand either way."""
        return cls._metrics_history_interval_s

    @metrics_history_interval_s.setter
    def metrics_history_interval_s(cls, value):
        if value is not None and float(value) <= 0:
            raise ValueError(
                "metrics_history_interval_s must be > 0 or None")
        cls._metrics_history_interval_s = (None if value is None
                                           else float(value))

    @property
    def metrics_history_max_bytes(cls):
        """On-disk budget of one process's history log (8 MiB): whole
        oldest segments are dropped past it, never the append path."""
        return cls._metrics_history_max_bytes

    @metrics_history_max_bytes.setter
    def metrics_history_max_bytes(cls, value):
        if int(value) < 4096:
            raise ValueError("metrics_history_max_bytes must be >= 4096")
        cls._metrics_history_max_bytes = int(value)

    @property
    def telemetry_spool_interval_s(cls):
        """The least seconds between telemetry spool snapshots
        (`observability/telemetry_spool.py`): the generation engine's
        loop rewrites `<observability_dir>/telemetry/<proc>/
        snapshot.json` at most this often, so its last metrics and spans
        survive a SIGKILL.  Armed only with `observability_dir`."""
        return cls._telemetry_spool_interval_s

    @telemetry_spool_interval_s.setter
    def telemetry_spool_interval_s(cls, value):
        if float(value) < 0:
            raise ValueError("telemetry_spool_interval_s must be >= 0")
        cls._telemetry_spool_interval_s = float(value)

    @property
    def telemetry_spool_max_bytes(cls):
        """Byte cap of one spooled snapshot: the span, request and
        exemplar tails are halved until it fits; the metric exposition
        is kept whole."""
        return cls._telemetry_spool_max_bytes

    @telemetry_spool_max_bytes.setter
    def telemetry_spool_max_bytes(cls, value):
        if int(value) < 4096:
            raise ValueError("telemetry_spool_max_bytes must be >= 4096")
        cls._telemetry_spool_max_bytes = int(value)

    @property
    def slo_shed_attainment(cls):
        """The generation engine's SLO shedder (None = off, the
        default).  With it set (0 < x <= 1) and `slo_targets` set,
        `GenerationEngine.submit` sheds a new request (QueueFull, HTTP
        503 with Retry-After) while the rolling attainment is below it
        and at least `slo_shed_min_queue` requests wait."""
        return cls._slo_shed_attainment

    @slo_shed_attainment.setter
    def slo_shed_attainment(cls, value):
        if value is not None:
            value = float(value)
            if not 0.0 < value <= 1.0:
                raise ValueError(
                    "slo_shed_attainment must be in (0, 1] or None")
        cls._slo_shed_attainment = value

    @property
    def tenant_quotas(cls):
        """Per-tenant admission quotas of the `AdmissionCore`
        (serving/control_plane/admission.py): tenant name -> sustained
        requests/s, or ``{"rate": r, "burst": b}`` (a token bucket of
        depth `burst`, default max(rate, 1), refilled at `rate`).  An
        over-quota request sheds with `TenantQuotaExceeded` (HTTP 429,
        Retry-After the bucket's refill time); tenants not named are
        unlimited, and None (the default) charges nothing.  Read at each
        admission."""
        return cls._tenant_quotas

    @tenant_quotas.setter
    def tenant_quotas(cls, value):
        if value is None:
            cls._tenant_quotas = None
            return
        quotas = {}
        for tenant, q in dict(value).items():
            if not str(tenant):
                raise ValueError("tenant_quotas key must be non-empty")
            if isinstance(q, dict):
                rate = float(q.get("rate", 0.0))
                burst = float(q.get("burst", max(rate, 1.0)))
            else:
                rate = float(q)
                burst = max(rate, 1.0)
            if rate <= 0 or burst <= 0:
                raise ValueError(
                    f"tenant_quotas[{tenant!r}]: rate and burst must "
                    "be > 0")
            quotas[str(tenant)] = {"rate": rate, "burst": burst}
        cls._tenant_quotas = quotas

    @property
    def router_phase_aware(cls):
        """Prefill/decode phase-aware routing in the `ReplicaRouter`
        (serving/distributed/router.py), JAX's setting (context.py:701).
        False (the default) keeps least-loaded admission.  True, with
        two or more replicas: the first replica is tagged "prefill" and
        the rest "decode"; each submit is classified by how much of its
        prompt is cached on any replica or in the shared host tier
        (`kv_host_tier_bytes`), a prefill-heavy request prefers the
        prefill replica, whose prefix cache writes its blocks through
        to the shared tier, and a decode-heavy one the decode replicas,
        which adopt those blocks on lookup.  A phase mismatch is a
        penalty on the load score, not a pin.  Read when a router is
        built."""
        return cls._router_phase_aware

    @router_phase_aware.setter
    def router_phase_aware(cls, value):
        cls._router_phase_aware = bool(value)

    @property
    def serving_replicas(cls):
        """Engine replicas `ReplicaRouter.build` makes when its
        `n_replicas` is "auto" (serving/distributed/router.py); 0 (the
        default) = no router."""
        return cls._serving_replicas

    @serving_replicas.setter
    def serving_replicas(cls, value):
        value = int(value)
        if value < 0:
            raise ValueError("serving_replicas must be >= 0 (0 = off)")
        cls._serving_replicas = value


class OrcaContext(metaclass=OrcaContextMeta):
    pass


def _check_mesh_shape(mesh_shape, world: int) -> Dict[str, int]:
    """The mesh's axis sizes: None is all "dp"; JAX's checks (context.py
    :870-903) for unknown axes and a product that misses the process
    count, then the port's for what is not ported yet (dp > 1 too, so
    several ranks never train unsynchronised on the default shape)."""
    sizes = ({"dp": world} if not mesh_shape
             else {a: int(n) for a, n in dict(mesh_shape).items()})
    unknown = set(sizes) - set(MESH_AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}; valid: {MESH_AXES}")
    if any(a not in _PORTED_AXES for a in sizes) \
            or sizes.get("dp", 1) != 1:
        raise NotImplementedError(f"mesh_shape {mesh_shape}: {_LATER}")
    prod = 1
    for n in sizes.values():
        prod *= n
    if prod != world:
        raise ValueError(
            f"mesh_shape {mesh_shape} covers {prod} of {world} "
            "process(es); make the axis sizes multiply to the process "
            "count")
    return sizes


def _start_process_group(coordinator_address, num_processes, process_id,
                         device):
    """Start `torch.distributed` (module docstring's rules); returns
    (world size, rank, this rank's device, backend)."""
    import torch
    import torch.distributed as dist

    from analytics_zoo_tpu_torch.device import resolve_device

    env = os.environ
    world = int(num_processes if num_processes is not None
                else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None
               else env.get("RANK", 0))
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} not in [0, {world})")
    if coordinator_address is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError(
                "cluster_mode 'distributed' needs coordinator_address "
                "('host:port') or MASTER_ADDR and MASTER_PORT")
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(env.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    own_card = (dev.type == "cuda"
                and world <= torch.cuda.device_count())
    backend = "nccl" if own_card else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=world, rank=rank)
    return world, rank, dev, backend


def init_orca_context(cluster_mode: str = "local",
                      cores: Optional[int] = None,
                      num_nodes: int = 1,
                      mesh_shape: Optional[Dict[str, int]] = None,
                      coordinator_address: Optional[str] = None,
                      num_processes: Optional[int] = None,
                      process_id: Optional[int] = None,
                      device=None, **kwargs):
    """Start the runtime (JAX context.py:906): `cluster_mode` "local"
    runs on `device` (None: the CUDA card; without one this raises);
    "distributed" / "tpu_pod" starts a process group of
    `num_processes` ranks meeting at `coordinator_address`, this one
    rank `process_id` (the module docstring's rules).  `mesh_shape`
    lays the ranks out over named axes.  `cores` caps the host's OpenMP
    threads.  Returns this process's device."""
    from analytics_zoo_tpu_torch.device import resolve_device

    cluster_mode = cluster_mode.lower()
    with OrcaContextMeta._lock:
        if OrcaContextMeta._initialized:
            if OrcaContextMeta._auto_initialized:
                # an implicit local start never masks an explicit one
                _stop_locked()
            elif (cluster_mode == OrcaContextMeta._cluster_mode
                    and mesh_shape is None):
                logger.warning("init_orca_context called twice; returning "
                               "the existing device")
                return OrcaContextMeta._device
            else:
                raise RuntimeError(
                    "runtime already initialized with cluster_mode="
                    f"'{OrcaContextMeta._cluster_mode}'; call "
                    "stop_orca_context() before re-initializing with a "
                    "different configuration")

        distributed = cluster_mode in ("tpu_pod", "distributed")
        if not distributed and cluster_mode != "local":
            raise ValueError(
                f"unsupported cluster_mode '{cluster_mode}'; the TPU build "
                "supports 'local' and 'tpu_pod' (Spark modes like "
                "'yarn'/'k8s' do not apply — hosts are provisioned by the "
                "TPU platform)")
        if distributed:
            # the axes are checked before any rendezvous starts
            world = int(num_processes if num_processes is not None
                        else os.environ.get("WORLD_SIZE", 1))
            shape = _check_mesh_shape(mesh_shape, world)
            world, rank, dev, backend = _start_process_group(
                coordinator_address, num_processes, process_id, device)
            mesh = ProcessMesh(shape, dev, rank, backend=backend)
            mesh.groups = _axis_groups(mesh)
        else:
            shape = _check_mesh_shape(mesh_shape, 1)
            dev = resolve_device(device)
            mesh = ProcessMesh(shape, dev)
        if cores is not None:
            os.environ.setdefault("OMP_NUM_THREADS", str(cores))
        OrcaContextMeta._device = dev
        OrcaContextMeta._mesh = mesh
        OrcaContextMeta._cluster_mode = cluster_mode
        OrcaContextMeta._initialized = True
        atexit.register(stop_orca_context)
        logger.info("init_orca_context: %s", mesh)
        return dev


def _axis_groups(mesh: ProcessMesh) -> Dict[str, Any]:
    """One process group for each axis: the ranks that differ from this
    one on that axis alone.  Every rank makes every group (the
    collective rule of `new_group`), in the same order; an axis that
    spans every rank takes the default group."""
    import torch.distributed as dist

    groups = {}
    for axis in mesh.axis_names:
        if mesh.shape[axis] == mesh.size:
            groups[axis] = dist.group.WORLD
            continue
        mine = mesh.group_ranks(axis)
        seen = set()
        for r in range(mesh.size):
            ranks = tuple(ProcessMesh(mesh.shape, None, r).group_ranks(axis))
            if ranks in seen:
                continue
            seen.add(ranks)
            g = dist.new_group(list(ranks))
            if list(ranks) == mine:
                groups[axis] = g
    return groups


def current_mesh() -> Optional[ProcessMesh]:
    """The started runtime's mesh, or None; unlike `OrcaContext.mesh`,
    never starts one."""
    return OrcaContextMeta._mesh


def init_nncontext(*args, **kwargs):
    """Alias of `init_orca_context` (JAX context.py:977)."""
    return init_orca_context(*args, **kwargs)


def _stop_locked():
    if not OrcaContextMeta._initialized:
        return
    if OrcaContextMeta._cluster_mode in ("tpu_pod", "distributed"):
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    OrcaContextMeta._device = None
    OrcaContextMeta._mesh = None
    OrcaContextMeta._cluster_mode = None
    OrcaContextMeta._initialized = False
    OrcaContextMeta._auto_initialized = False
    logger.info("stop_orca_context: runtime stopped")


def stop_orca_context():
    """Stop the runtime (JAX context.py:999)."""
    with OrcaContextMeta._lock:
        _stop_locked()
