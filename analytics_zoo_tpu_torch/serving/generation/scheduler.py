"""Iteration-level scheduling (Orca-style) over a fixed slot grid
(counterpart of analytics_zoo_tpu/serving/generation/scheduler.py).

The decode step runs over `max_slots` lanes; sequences join and leave
BETWEEN steps by claiming/releasing a lane.  Admission is FCFS within a
priority class, with a prefill token budget per round (the first
admission always proceeds, so nothing starves).  When the block pool
runs dry the scheduler first evicts unreferenced prefix-cache blocks
(LRU; cold cache entries are cheaper to lose than live work), then
preempts the newest-admitted sequence: its blocks return to the pool
and it re-queues at the FRONT of the waiting line with its generated
tokens intact, to be re-prefilled (recompute-on-resume) when pressure
clears.

Prefix caching (prefix_cache.py): with a `PrefixCache` attached,
admission looks up the longest cached whole-block prefix of the known
context, pins those blocks, allocates fresh blocks only for the tail,
and (chunk mode) starts the sequence "prefilling" at `prefill_pos` =
the matched tokens; the engine prefills the tail (in chunks when chunked
prefill is on) and flips it to "running" when its first token is
sampled.  Releasing or preempting a lane frees its table through the
refcounts, so blocks other lanes or the tree still hold survive.

Copy-on-write: `resolve_write_conflicts` un-shares a block the next
decode write would land in while it has more than one reference; the
engine copies the block's rows (and int8 scales) on the device.

Speculation: `grow_for_speculation` extends a lane's table for its
draft straight from the free list; `rollback_speculation` returns the
blocks past the lane's next write position.

Every lane decision leaves a flight record (`sched_admit`,
`sched_preempt`, `sched_cow`, `sched_release`) and a lifecycle event on
the request's record (`admit` or `resume`, `prefix_hit`,
`host_restore`, `preempt`); `release` finishes the record with the
stream's reason (JAX scheduler.py:224-446).

Invariant the engine relies on: a RUNNING sequence has KV written for
exactly `context_len - 1` tokens — the newest sampled token is pending,
and the next decode step feeds it, writes its KV, and samples its
successor.  A resume-prefill re-writes KV for all `context_len` known
tokens (minus any re-matched cached prefix) and samples the next,
restoring the same invariant.
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Deque, List, Optional, Tuple

from analytics_zoo_tpu_torch.observability import (
    flight_recorder,
    request_log,
)
from analytics_zoo_tpu_torch.serving.generation.kv_cache import (
    PagedKVCache,
)

_UIDS = itertools.count()


class Sequence:
    """One generation request's host-side state."""

    __slots__ = ("uid", "prompt", "generated", "max_new_tokens",
                 "temperature", "top_k", "eos_id", "stream",
                 "block_table", "slot", "status", "finish_reason",
                 "n_preempted", "_admit_order", "request_id", "priority",
                 "logits", "prefill_pos", "prefix_tokens", "spec")

    def __init__(self, prompt, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0,
                 eos_id: Optional[int] = None, stream=None,
                 request_id: Optional[str] = None, priority: int = 0):
        self.uid = next(_UIDS)
        self.request_id = request_id
        self.prompt = [int(t) for t in prompt]
        self.generated: List[int] = []
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.eos_id = eos_id
        self.stream = stream
        self.block_table: List[int] = []
        self.slot: Optional[int] = None
        self.status = "waiting"
        self.finish_reason: Optional[str] = None
        self.n_preempted = 0
        self._admit_order = -1
        #: 0 admits first and preempts last; ties stay FCFS /
        #: newest-preempted-first
        self.priority = int(priority)
        #: the logits each generated token was sampled from, when the
        #: engine keeps them (`GenerationEngine(keep_logits=True)`)
        self.logits: Optional[list] = None
        #: context tokens whose KV is already written (chunk-prefill
        #: progress; starts at the prefix-cache match length)
        self.prefill_pos = 0
        #: tokens skipped through the prefix cache at the LAST admission
        self.prefix_tokens = 0
        #: the lane's draft state (a `speculation.SpecState`, attached
        #: by the engine's Speculator on first use; it survives
        #: preemption, since drafting reads only the token history)
        self.spec = None

    @property
    def context_len(self) -> int:
        return len(self.prompt) + len(self.generated)

    def should_finish(self) -> Optional[str]:
        if self.eos_id is not None and self.generated and \
                self.generated[-1] == self.eos_id:
            return "eos"
        if len(self.generated) >= self.max_new_tokens:
            return "length"
        return None


class SlotScheduler:
    """Admission, capacity and preemption over `max_slots` decode lanes
    backed by `cache`'s block allocator.  Host-side only; the engine
    serializes access.

    `prefix_cache` (optional) enables prefix reuse on admission;
    `chunk_mode` makes admission claim lane + blocks only (status
    "prefilling") and leaves the prefill work, chunked under the token
    budget, to the engine's prefill round.  Both off keeps the
    admit-and-prefill-whole-prompt path."""

    def __init__(self, cache: PagedKVCache, max_slots: int,
                 max_context: int, prefill_buckets,
                 prefill_token_budget: int, prefix_cache=None,
                 chunk_mode: bool = False):
        self.cache = cache
        self.prefix_cache = prefix_cache
        self.chunk_mode = chunk_mode
        self.max_slots = max_slots
        self.max_context = max_context
        self.prefill_buckets = sorted(prefill_buckets)
        self.prefill_token_budget = prefill_token_budget
        self.max_blocks_per_seq = cache.blocks_for(max_context)
        self.slots: List[Optional[Sequence]] = [None] * max_slots
        self.waiting: Deque[Sequence] = deque()
        self.n_preemptions = 0
        self._admit_counter = 0

    def submit(self, seq: Sequence) -> None:
        if seq.context_len + seq.max_new_tokens > self.max_context:
            raise ValueError(
                f"prompt ({seq.context_len}) + max_new_tokens "
                f"({seq.max_new_tokens}) exceeds max_context "
                f"{self.max_context}")
        # queue ahead of the first strictly lower-priority waiter
        # (higher number = less important), behind every peer
        for i, other in enumerate(self.waiting):
            if other.priority > seq.priority:
                self.waiting.insert(i, seq)
                return
        self.waiting.append(seq)

    def has_work(self) -> bool:
        return bool(self.waiting) or any(
            s is not None for s in self.slots)

    def slotted(self) -> List[Sequence]:
        """Every sequence holding a lane (running or prefilling)."""
        return [s for s in self.slots if s is not None]

    def running(self) -> List[Sequence]:
        """Lanes participating in the decode step."""
        return [s for s in self.slots
                if s is not None and s.status == "running"]

    def prefilling(self) -> List[Sequence]:
        """Lanes whose (tail) prefill is still in progress, in admit
        order: the engine's chunk-prefill work list."""
        return sorted((s for s in self.slots
                       if s is not None and s.status == "prefilling"),
                      key=lambda s: s._admit_order)

    def bucket_for(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds the largest "
                         f"prefill bucket {self.prefill_buckets[-1]}")

    def expected_prefill_variants(self) -> int:
        """The prefill shapes the bucket geometry implies: any prompt
        length maps onto exactly one of them."""
        return len(self.prefill_buckets)

    def _alloc_with_evict(self, n: int) -> Optional[List[int]]:
        """Allocate `n` blocks, evicting unreferenced prefix-cache
        blocks (LRU) first when the free list cannot cover the request:
        cache entries are recomputable, running lanes' work is not."""
        got = self.cache.allocator.alloc(n)
        if got is None and self.prefix_cache is not None:
            self.prefix_cache.evict(n - self.cache.allocator.available())
            got = self.cache.allocator.alloc(n)
        return got

    def _preempt_newest(self) -> Optional[Sequence]:
        """Free the newest-admitted slotted sequence's blocks and
        re-queue it at the front of the waiting line."""
        victims = self.slotted()
        if not victims:
            return None
        # lowest class first, newest-admitted within a class
        victim = max(victims, key=lambda s: (s.priority, s._admit_order))
        # the per-lane decision trail: a post-mortem shows why lanes
        # emptied under cache pressure
        flight_recorder.record("sched_preempt", uid=victim.uid,
                               slot=victim.slot,
                               blocks_freed=len(victim.block_table),
                               context_len=victim.context_len)
        request_log.event(victim.request_id, "preempt",
                          slot=victim.slot,
                          context_len=victim.context_len)
        self.cache.allocator.free(victim.block_table)
        victim.block_table = []
        self.slots[victim.slot] = None
        victim.slot = None
        victim.status = "waiting"
        victim.prefill_pos = 0
        victim.prefix_tokens = 0
        victim.n_preempted += 1
        self.n_preemptions += 1
        self.waiting.appendleft(victim)
        return victim

    def ensure_decode_capacity(self) -> None:
        """Before a decode step: every running sequence writes one KV
        entry at position context_len - 1; grow its block table (or
        evict cold cache blocks, then preempt, newest first, under cache
        pressure — possibly the needy sequence itself)."""
        # highest class then oldest first: the newest and least
        # important lanes yield to the oldest interactive ones
        for seq in sorted(self.running(),
                          key=lambda s: (s.priority, s._admit_order)):
            if seq.slot is None:      # already preempted this round
                continue
            need = seq.context_len - 1  # position being written
            while len(seq.block_table) <= need // self.cache.block_size:
                got = self._alloc_with_evict(1)
                if got is not None:
                    seq.block_table.extend(got)
                    continue
                victim = self._preempt_newest()
                if victim is None or victim is seq:
                    break             # seq itself yielded its lane

    def grow_for_speculation(self, seq: Sequence,
                             last_pos: int) -> bool:
        """Extend `seq`'s block table to cover a verify step's writes
        through position `last_pos`.  Speculation is opportunistic: the
        blocks come straight off the free list (no eviction, no
        preemption), and False means the lane decodes normally this
        round.  The new blocks are fresh (refcount 1), so
        `rollback_speculation` returns them without touching a shared
        prefix block."""
        need = last_pos // self.cache.block_size + 1
        added: List[int] = []
        while len(seq.block_table) < need:
            got = self.cache.allocator.alloc(1)
            if got is None:
                if added:
                    self.cache.allocator.free(added)
                    del seq.block_table[-len(added):]
                return False
            added.extend(got)
            seq.block_table.extend(got)
        return True

    def rollback_speculation(self, seq: Sequence) -> None:
        """After the accepted prefix advanced `context_len`, drop every
        table block past the one the lane's next write (position
        context_len - 1) lands in.  Rejected tokens' KV left in a kept
        block lies past ctx_len, where every read masks it and the next
        writes overwrite it."""
        if not seq.block_table:
            return
        keep = (seq.context_len - 1) // self.cache.block_size + 1
        if len(seq.block_table) > keep:
            extra = seq.block_table[keep:]
            del seq.block_table[keep:]
            self.cache.allocator.free(extra)

    def resolve_write_conflicts(self) \
            -> List[Tuple[Sequence, int, int, int]]:
        """Copy-on-write, after `ensure_decode_capacity`: the block each
        running lane's next decode write lands in must be exclusively
        owned.  A shared target (refcount > 1) gets a fresh block here,
        the table entry is swapped and the lane's reference on the
        source dropped; the ENGINE copies the rows on the device.
        Returns [(seq, block_index, src_block, dst_block)].  Empty in
        normal operation (prompt sharing is whole-block and decode
        writes land past it)."""
        work: List[Tuple[Sequence, int, int, int]] = []
        for seq in sorted(self.running(), key=lambda s: s._admit_order):
            if seq.slot is None:
                continue
            idx = (seq.context_len - 1) // self.cache.block_size
            if idx >= len(seq.block_table):
                continue              # capacity growth failed; the
            src = seq.block_table[idx]  # lane yields next round
            if self.cache.allocator.ref_count(src) <= 1:
                continue
            got = self._alloc_with_evict(1)
            if got is None:
                victim = self._preempt_newest()
                if victim is seq or victim is None:
                    continue
                got = self._alloc_with_evict(1)
                if got is None:
                    continue
            dst = got[0]
            seq.block_table[idx] = dst
            self.cache.allocator.free([src])
            flight_recorder.record("sched_cow", uid=seq.uid,
                                   slot=seq.slot, src=src, dst=dst)
            work.append((seq, idx, src, dst))
        return work

    def admit(self) -> List[Sequence]:
        """FCFS admission into free slots.  Each admitted sequence gets
        blocks for its full known context, minus the cached prefix
        blocks the prefix cache shares with it (extended from the host
        tier when one is attached).

        Without chunk mode, bucketed prefill sizes are capped by the
        per-round token budget (the first admission always goes
        through) and the sequence comes out "running": the engine
        prefills it whole this round.  In chunk mode admission only
        claims the lane and blocks (status "prefilling", `prefill_pos`
        = cached tokens); the engine's prefill round spends the budget
        on chunks."""
        admitted: List[Sequence] = []
        budget = self.prefill_token_budget
        while self.waiting:
            free_slots = [i for i, s in enumerate(self.slots) if s is None]
            if not free_slots:
                break
            seq = self.waiting[0]
            cached_blocks: List[int] = []
            n_cached = 0
            if self.prefix_cache is not None:
                ctx = seq.prompt + seq.generated
                cached_blocks, n_cached = self.prefix_cache.lookup(ctx)
                if self.prefix_cache.host_tier is not None:
                    # `restoring_for` names the beneficiary to the
                    # engine's restore writer, which charges the copy to
                    # this request's blame accumulators
                    dev_cached = n_cached
                    self.prefix_cache.restoring_for = seq.request_id
                    try:
                        cached_blocks, n_cached = \
                            self.prefix_cache.restore(ctx, cached_blocks,
                                                      n_cached)
                    finally:
                        self.prefix_cache.restoring_for = None
                    if n_cached > dev_cached:
                        request_log.event(
                            seq.request_id, "host_restore",
                            tokens=n_cached - dev_cached)
            if not self.chunk_mode:
                bucket = self.bucket_for(seq.context_len - n_cached)
                if admitted and bucket > budget:
                    if cached_blocks:
                        self.cache.allocator.free(cached_blocks)
                    break
            blocks = self._alloc_with_evict(
                self.cache.blocks_for(seq.context_len)
                - len(cached_blocks))
            if blocks is None:
                if cached_blocks:
                    self.cache.allocator.free(cached_blocks)
                break                 # pressure: wait for releases
            self.waiting.popleft()
            seq.block_table = cached_blocks + blocks
            seq.prefill_pos = n_cached
            seq.prefix_tokens = n_cached
            seq.slot = free_slots[0]
            seq.status = "prefilling" if self.chunk_mode else "running"
            seq._admit_order = self._admit_counter
            self._admit_counter += 1
            self.slots[seq.slot] = seq
            if not self.chunk_mode:
                budget -= bucket
            admitted.append(seq)
            flight_recorder.record("sched_admit", uid=seq.uid,
                                   slot=seq.slot,
                                   blocks=len(seq.block_table),
                                   prefix_tokens=n_cached,
                                   resumed=seq.n_preempted > 0)
            request_log.event(
                seq.request_id,
                "resume" if seq.n_preempted > 0 else "admit",
                slot=seq.slot)
            if n_cached:
                # how much prefill the prefix cache skipped
                request_log.event(seq.request_id, "prefix_hit",
                                  tokens=n_cached,
                                  blocks=len(cached_blocks))
        return admitted

    def release(self, seq: Sequence, reason: str) -> None:
        """Finish: blocks back to the pool, lane freed for the next
        admission, the lifecycle record closed with `reason`."""
        if seq.block_table:
            self.cache.allocator.free(seq.block_table)
            seq.block_table = []
        if seq.slot is not None:
            self.slots[seq.slot] = None
            seq.slot = None
        seq.status = "finished"
        seq.finish_reason = reason
        flight_recorder.record("sched_release", uid=seq.uid,
                               reason=reason,
                               generated=len(seq.generated))
        request_log.finish(seq.request_id, reason)
