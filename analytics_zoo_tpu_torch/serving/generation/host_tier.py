"""Host-memory KV offload tier: the layer below the device block pool
(counterpart of analytics_zoo_tpu/serving/generation/host_tier.py).

When the prefix cache evicts a block only its tree holds, the block's KV
rows (and their int8 dequant scales) are copied into a bounded-bytes
host LRU instead of being dropped, and a later radix miss that extends
into a host-resident prefix restores the block with one host-to-card
copy instead of a prefill chunk.

Contract — advisory, never authoritative: the device pool and the radix
tree stay the only source of truth.  A full tier, a refused spill, an
evicted entry or an injected fault costs speed (the lane recomputes the
prefix as it would without the tier), never correctness.  Both
directions are fault sites (``generation.host_spill`` /
``generation.host_restore``).

Keys are full token-id prefixes (each block keyed by the whole prompt
prefix it ends), so an entry is independent of the engine that spilled
it.

Slabs are host tensors: pinned when the engine's pool is on the card
(the prefix cache allocates them), plain otherwise, since pinning needs
a CUDA driver.  `stage_prefix` starts the copies of a waiting request's
next entries to the card ahead of admission, on a side stream, each
with an event the compute stream waits on before it reads the copy.  A
staged entry that the tier evicts before its restore is a miss (the lane
recomputes); its pinned source is kept alive until the copy's event has
completed.

`record_dma` / `dma_events` keep the latest tier copies (spills and
restores, with their bytes and host seconds) for a caller to read.
"""

from __future__ import annotations

import functools
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from analytics_zoo_tpu_torch.resilience.faults import (
    FaultInjected,
    fault_point,
)

#: the most recent host<->card tier copies, oldest dropped
_DMA_RING: deque = deque(maxlen=512)


def record_dma(kind: str, dur_s: float, nbytes: int, **extra) -> None:
    """Record one tier copy (`kind` = "host_spill" / "host_restore"):
    its host seconds and bytes, and any `extra` fields."""
    _DMA_RING.append(dict(ts=time.time(), dur_s=float(dur_s),
                          kind=str(kind), nbytes=int(nbytes), **extra))


def dma_events(n: Optional[int] = None) -> List[Dict[str, Any]]:
    """The most recent `n` copies (all when None), oldest first."""
    entries = list(_DMA_RING)
    return entries[-int(n):] if n is not None else entries


def reset_dma() -> None:
    _DMA_RING.clear()


def _locked(method):
    """Run a `HostKVTier` method under the tier's lock."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with self._lock:
            return method(self, *args, **kwargs)
    return run


class _HostEntry:
    """One spilled block: the token-id prefix it ends, its KV rows
    [L, 2, block_size, heads, head_dim] at the pool's dtype (int8 when
    the pool is quantized), the scales [L, 2, block_size] (None
    unquantized), and while a restore is staged its copies on the card
    and the event that marks them complete."""

    __slots__ = ("key", "kv", "scale", "nbytes", "staged_kv",
                 "staged_scale", "staged_event")

    def __init__(self, key: Tuple[int, ...], kv: torch.Tensor,
                 scale: Optional[torch.Tensor]):
        self.key = key
        self.kv = kv
        self.scale = scale
        self.nbytes = int(kv.numel() * kv.element_size()
                          + (0 if scale is None
                             else scale.numel() * scale.element_size()))
        self.staged_kv = None
        self.staged_scale = None
        self.staged_event = None


class HostKVTier:
    """Bounded-bytes host LRU of spilled KV blocks, keyed by full
    token-id prefixes.  One tier may serve several engines (a router's
    replicas, `ReplicaRouter.build`), each from its own loop thread: its
    lock makes each put, fetch, staging and clear whole, so a lost race
    is a miss (a recompute), never a torn entry.

    Counters (plain integers): `n_spilled`, `n_restored`,
    `n_restore_failed`, `n_evictions`, `n_staged`."""

    def __init__(self, capacity_bytes: int):
        self.capacity_bytes = int(capacity_bytes)
        self._entries: "OrderedDict[Tuple[int, ...], _HostEntry]" = \
            OrderedDict()
        self._bytes = 0
        #: (n_layers, block_size, heads, head_dim, dtype, quantized),
        #: bound by the first engine; a mismatched slab is refused
        self._geometry: Optional[tuple] = None
        #: (event, source tensors) of staged copies still in flight:
        #: the pinned sources live at least as long as their copies
        self._inflight: List[tuple] = []
        self._side_stream = None
        self._lock = threading.RLock()
        self.n_spilled = 0
        self.n_restored = 0
        self.n_restore_failed = 0
        self.n_evictions = 0
        self.n_staged = 0

    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def bytes_used(self) -> int:
        return self._bytes

    def bind_geometry(self, cache) -> None:
        """Pin the slab geometry to `cache`'s pool.  A tier re-bound to
        an incompatible pool drops its entries (losing them only costs
        recomputes)."""
        geo = (int(cache.kv.shape[0]), int(cache.block_size),
               int(cache.kv.shape[3]), int(cache.kv.shape[4]),
               cache.kv.dtype, cache.kv_scale is not None)
        if self._geometry is not None and self._geometry != geo:
            self.clear()
        self._geometry = geo

    def _fits(self, kv: torch.Tensor, scale: Optional[torch.Tensor]
              ) -> bool:
        if self._geometry is None:
            return True
        L, bs, h, d, dt, quant = self._geometry
        if tuple(kv.shape) != (L, 2, bs, h, d) or kv.dtype != dt:
            return False
        if quant != (scale is not None):
            return False
        return scale is None or tuple(scale.shape) == (L, 2, bs)

    # ------------------------------------------------------------------

    @_locked
    def put(self, key: Sequence[int], kv: torch.Tensor,
            scale: Optional[torch.Tensor], dur_s: float = 0.0) -> bool:
        """Admit one spilled block (host tensors) under the bounded-bytes
        LRU, evicting least-recently-used entries to fit.  A refused or
        injected-fault spill returns False and the caller goes on as if
        the tier were absent."""
        key = tuple(int(t) for t in key)
        try:
            fault_point("generation.host_spill", key_blocks=len(key),
                        nbytes=int(kv.numel() * kv.element_size()))
        except FaultInjected:
            return False
        if self.capacity_bytes <= 0 or not self._fits(kv, scale):
            return False
        if key in self._entries:
            self._entries.move_to_end(key)
            return True
        entry = _HostEntry(key, kv, scale)
        if entry.nbytes > self.capacity_bytes:
            return False
        while self._bytes + entry.nbytes > self.capacity_bytes \
                and self._entries:
            _k, old = self._entries.popitem(last=False)
            self._bytes -= old.nbytes
            self.n_evictions += 1
        self._entries[key] = entry
        self._bytes += entry.nbytes
        self.n_spilled += 1
        record_dma("host_spill", dur_s, entry.nbytes)
        return True

    @_locked
    def fetch(self, key: Sequence[int]) -> Optional[_HostEntry]:
        """The entry for `key`, None on a miss.  The restore fault site
        fires here: an injected fault (or a "nan" corruption action)
        counts `n_restore_failed`, drops the entry (it is suspect) and
        reports a miss."""
        key = tuple(int(t) for t in key)
        try:
            action = fault_point("generation.host_restore",
                                 key_blocks=len(key))
        except FaultInjected:
            action = "nan"
        if action == "nan":
            self.n_restore_failed += 1
            entry = self._entries.pop(key, None)
            if entry is not None:
                self._bytes -= entry.nbytes
            return None
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
        return entry

    def count_restored(self) -> None:
        """One host block landed in the device pool."""
        self.n_restored += 1

    def match_tokens(self, tokens: Sequence[int]) -> int:
        """Longest host-resident prefix of `tokens` in tokens (whole
        blocks, capped one short of the query like the radix tree).
        Read-only: no LRU touch, no counters."""
        if self._geometry is None or not self._entries:
            return 0
        bs = self._geometry[1]
        usable = (len(tokens) - 1) // bs
        j = 0
        while j < usable:
            key = tuple(int(t) for t in tokens[:(j + 1) * bs])
            if key not in self._entries:
                break
            j += 1
        return j * bs

    def _retire_copies(self) -> None:
        self._inflight = [c for c in self._inflight if not c[0].query()]

    @_locked
    def stage_prefix(self, tokens: Sequence[int], n_matched: int,
                     depth: int = 2, device=None) -> int:
        """Start the copies to `device` of up to `depth` entries
        extending the device-matched prefix, ahead of admission: on the
        card, non-blocking copies from the pinned slabs on a side stream,
        with an event recorded after them; on the CPU the slab itself
        stands in.  Returns how many entries are staged (those staged
        before count)."""
        if self._geometry is None or not self._entries:
            return 0
        device = torch.device("cpu" if device is None else device)
        cuda = device.type == "cuda"
        if cuda:
            self._retire_copies()
            if self._side_stream is None:
                self._side_stream = torch.cuda.Stream(device)
        bs = self._geometry[1]
        usable = (len(tokens) - 1) // bs
        staged = 0
        j = n_matched // bs
        while j < usable and staged < depth:
            key = tuple(int(t) for t in tokens[:(j + 1) * bs])
            entry = self._entries.get(key)
            if entry is None:
                break
            if entry.staged_kv is None:
                if cuda:
                    side = self._side_stream
                    # the copies allocate from the side stream's own
                    # pool and read immutable pinned slabs: they need
                    # not wait for the compute stream
                    with torch.cuda.stream(side):
                        entry.staged_kv = entry.kv.to(device,
                                                      non_blocking=True)
                        if entry.scale is not None:
                            entry.staged_scale = entry.scale.to(
                                device, non_blocking=True)
                        ev = torch.cuda.Event()
                        ev.record(side)
                    entry.staged_event = ev
                    self._inflight.append((ev, entry.kv, entry.scale))
                else:
                    entry.staged_kv = entry.kv
                    entry.staged_scale = entry.scale
                self.n_staged += 1
            staged += 1
            j += 1
        return staged

    @_locked
    def clear(self) -> int:
        """Drop every entry (only future restores are lost).  Returns
        how many were dropped."""
        n = len(self._entries)
        self._entries.clear()
        self._bytes = 0
        return n
