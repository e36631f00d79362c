"""Iteration-level scheduling (Orca-style) over a fixed slot grid
(counterpart of analytics_zoo_tpu/serving/generation/scheduler.py,
without the prefix cache, chunked prefill and speculation branches).

The decode step runs over `max_slots` lanes; sequences join and leave
BETWEEN steps by claiming/releasing a lane.  Admission is FCFS within a
priority class, with a prefill token budget per round (the first
admission always proceeds, so nothing starves).  When the block pool
runs dry mid-decode the scheduler preempts the newest-admitted
sequence: its blocks return to the pool and it re-queues at the FRONT
of the waiting line with its generated tokens intact, to be re-prefilled
(recompute-on-resume) when pressure clears.

Invariant the engine relies on: a RUNNING sequence has KV written for
exactly `context_len - 1` tokens — the newest sampled token is pending,
and the next decode step feeds it, writes its KV, and samples its
successor.  A resume-prefill re-writes KV for all `context_len` known
tokens and samples the next, restoring the same invariant.
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Deque, List, Optional

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
                 "logits")

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
    serializes access."""

    def __init__(self, cache: PagedKVCache, max_slots: int,
                 max_context: int, prefill_buckets,
                 prefill_token_budget: int):
        self.cache = cache
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
        """Every sequence holding a lane."""
        return [s for s in self.slots if s is not None]

    def running(self) -> List[Sequence]:
        """Lanes participating in the decode step."""
        return [s for s in self.slots
                if s is not None and s.status == "running"]

    def bucket_for(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds the largest "
                         f"prefill bucket {self.prefill_buckets[-1]}")

    def _preempt_newest(self) -> Optional[Sequence]:
        """Free the newest-admitted slotted sequence's blocks and
        re-queue it at the front of the waiting line."""
        victims = self.slotted()
        if not victims:
            return None
        # lowest class first, newest-admitted within a class
        victim = max(victims, key=lambda s: (s.priority, s._admit_order))
        self.cache.allocator.free(victim.block_table)
        victim.block_table = []
        self.slots[victim.slot] = None
        victim.slot = None
        victim.status = "waiting"
        victim.n_preempted += 1
        self.n_preemptions += 1
        self.waiting.appendleft(victim)
        return victim

    def ensure_decode_capacity(self) -> None:
        """Before a decode step: every running sequence writes one KV
        entry at position context_len - 1; grow its block table, or
        preempt (newest first) under cache pressure — possibly the
        needy sequence itself."""
        # highest class then oldest first: the newest and least
        # important lanes yield to the oldest interactive ones
        for seq in sorted(self.running(),
                          key=lambda s: (s.priority, s._admit_order)):
            if seq.slot is None:      # already preempted this round
                continue
            need = seq.context_len - 1  # position being written
            while len(seq.block_table) <= need // self.cache.block_size:
                got = self.cache.allocator.alloc(1)
                if got is not None:
                    seq.block_table.extend(got)
                    continue
                victim = self._preempt_newest()
                if victim is None or victim is seq:
                    break             # seq itself yielded its lane

    def admit(self) -> List[Sequence]:
        """FCFS admission into free slots.  Each admitted sequence gets
        blocks for its full known context; bucketed prefill sizes are
        capped by the per-round token budget (the first admission always
        goes through) and the sequence comes out "running" — the engine
        prefills it whole this round."""
        admitted: List[Sequence] = []
        budget = self.prefill_token_budget
        while self.waiting:
            free_slots = [i for i, s in enumerate(self.slots) if s is None]
            if not free_slots:
                break
            seq = self.waiting[0]
            bucket = self.bucket_for(seq.context_len)
            if admitted and bucket > budget:
                break
            blocks = self.cache.allocator.alloc(
                self.cache.blocks_for(seq.context_len))
            if blocks is None:
                break                 # pressure: wait for releases
            self.waiting.popleft()
            seq.block_table = blocks
            seq.slot = free_slots[0]
            seq.status = "running"
            seq._admit_order = self._admit_counter
            self._admit_counter += 1
            self.slots[seq.slot] = seq
            budget -= bucket
            admitted.append(seq)
        return admitted

    def release(self, seq: Sequence, reason: str) -> None:
        """Finish: blocks back to the pool, lane freed for the next
        admission."""
        if seq.block_table:
            self.cache.allocator.free(seq.block_table)
            seq.block_table = []
        if seq.slot is not None:
            self.slots[seq.slot] = None
            seq.slot = None
        seq.status = "finished"
        seq.finish_reason = reason
