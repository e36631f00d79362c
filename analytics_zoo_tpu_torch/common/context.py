"""`OrcaContext`: the class-level settings the port reads (counterpart
of analytics_zoo_tpu/common/context.py's `OrcaContextMeta`, the part of
it the training path reads; the mesh, the cluster modes and the other
settings of the JAX class are not ported).

User code reads and writes them as `OrcaContext.<setting>`:

  * `train_data_store`: "DRAM" (the default: host batches, copied to
    the card step by step), "DEVICE" (the dataset uploaded to the card
    once, every epoch indexing it in place) or "DISK_n" (accepted as the
    JAX package accepts it; its Estimator never reads n, so it streams
    from the host like "DRAM");
  * `device_cache_bytes`: the most the DEVICE store holds on the card
    across cached datasets, 256 MiB by default.
"""

from __future__ import annotations


class OrcaContextMeta(type):
    _train_data_store = "DRAM"
    _device_cache_bytes = 256 * 1024 * 1024

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
    def device_cache_bytes(cls):
        """The most bytes the DEVICE store holds on the card across
        cached datasets (an Estimator evicts its older entries before
        passing it); a single dataset over it streams from the host,
        with a warning."""
        return cls._device_cache_bytes

    @device_cache_bytes.setter
    def device_cache_bytes(cls, value):
        cls._device_cache_bytes = int(value)


class OrcaContext(metaclass=OrcaContextMeta):
    pass
