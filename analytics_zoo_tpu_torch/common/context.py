"""`OrcaContext`: the class-level settings the port reads (counterpart
of analytics_zoo_tpu/common/context.py's `OrcaContextMeta`, the part of
it the training path reads; the mesh, the cluster modes and the other
settings of the JAX class are not ported).

User code reads and writes them as `OrcaContext.<setting>`:

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
    (`resilience/faults.py`).
"""

from __future__ import annotations


class OrcaContextMeta(type):
    _train_data_store = "DRAM"
    _shard_size = None
    _host_input_prefetch = 2
    _device_cache_bytes = 256 * 1024 * 1024
    _failure_retry_times = 5
    _failure_retry_interval_s = 1.0
    _background_checkpointing = False
    _fault_plan = None

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


class OrcaContext(metaclass=OrcaContextMeta):
    pass
