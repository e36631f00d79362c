"""Prefix cache: radix-tree prompt reuse over the paged KV block pool
(counterpart of analytics_zoo_tpu/serving/generation/prefix_cache.py).

The pool stores KV in fixed-size indexed blocks, so a prompt prefix that
is a whole number of blocks can be SHARED between requests by pointing
their block tables at the same committed blocks.

Structure: a radix tree whose edges are `block_size`-token chunks of
prompt token ids.  Each node owns one committed pool block (the KV of
exactly that chunk, at the absolute positions the path from the root
spells) and holds its own reference on it (`BlockAllocator.share`).  On
admission the scheduler walks the tree for the longest cached prefix
(`lookup`, pinning one reference per matched block for the sequence),
prefills only the uncovered tail, and once the prompt is written
`commit` inserts its full blocks, deduplicating against identical
prefixes committed meanwhile by adopting the cached block and dropping
the duplicate.

Committed blocks are never written again: only blocks fully covered by
prompt tokens are committed, matches are whole blocks capped one token
short of the query, and decode writes land past the prompt.  The
scheduler still un-shares a block before any write that would hit a
refcount above 1 (copy-on-write), so a fork cannot corrupt a shared
block either.

Eviction: unreferenced cached blocks (refcount 1, the tree the only
holder) are evicted leaves first in LRU order when the allocator runs
dry, before the scheduler preempts a running lane.

`lookup` is a fault site (``generation.prefix_lookup``): a raise there
fails the admission and leaves the tree intact.

Host tier (host_tier.py, `OrcaContext.kv_host_tier_bytes`): with a
`HostKVTier` attached, `evict` copies each victim's KV rows to host
memory before freeing the block (a pinned slab on the card, then a wait
for the copy: one host sync per spilled block, counted in
`n_spill_syncs`), and `restore` extends a device match with
host-resident blocks, allocating a pool block per entry and handing the
write to the engine's `restore_writer`.

Counters (plain integers): `n_lookups`, `n_hits`, `n_misses`,
`n_hit_tokens`, `n_evictions`, `n_spill_syncs`.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from analytics_zoo_tpu_torch.resilience.faults import fault_point
from analytics_zoo_tpu_torch.serving.generation.kv_cache import (
    PagedKVCache,
)


class _Node:
    """One cached chunk: `chunk` (the block_size token ids of its
    edge), the pool block holding their KV, and an LRU stamp."""

    __slots__ = ("chunk", "block", "children", "parent", "last_use")

    def __init__(self, chunk: Tuple[int, ...], block: int,
                 parent: Optional["_Node"]):
        self.chunk = chunk
        self.block = block
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.last_use = 0


class PrefixCache:
    """Radix tree over token-id block chunks mapping prompt prefixes to
    committed KV pool blocks.  Host-side only, serialized by the
    engine's lock like the scheduler."""

    def __init__(self, cache: PagedKVCache, host_tier=None):
        self.cache = cache
        self.allocator = cache.allocator
        self.block_size = cache.block_size
        #: host spill tier (host_tier.HostKVTier), or None
        self.host_tier = host_tier
        if host_tier is not None:
            host_tier.bind_geometry(cache)
        #: device-write callback for restores, set by the engine:
        #: ``restore_writer(block, entry) -> bool`` lands a host entry's
        #: rows in pool block `block` (False = recompute instead)
        self.restore_writer = None
        #: the router's prefill replica: `commit` also copies each newly
        #: inserted block to the host tier, so replicas sharing the tier
        #: adopt it without waiting for an eviction
        self.host_write_through = False
        self._root = _Node((), -1, None)
        self._n_blocks = 0
        #: monotonic use counter: LRU recency without wall time
        self._clock = 0
        self.n_lookups = 0
        self.n_hits = 0
        self.n_misses = 0
        self.n_hit_tokens = 0
        self.n_evictions = 0
        self.n_spill_syncs = 0

    # ------------------------------------------------------------------

    @property
    def n_blocks(self) -> int:
        """Blocks currently held by the tree."""
        return self._n_blocks

    def hit_rate(self) -> float:
        """hits / lookups (nan before the first lookup)."""
        looked = self.n_hits + self.n_misses
        return (self.n_hits / looked) if looked else float("nan")

    def lookup(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached prefix of `tokens` in whole blocks, capped one
        token short of the query so that at least one tail token is
        prefilled (the last position's logits are sampled from).  Pins
        one reference per matched block for the caller (released with
        the rest of its block table).  Returns (matched block ids,
        matched token count)."""
        fault_point("generation.prefix_lookup", n_tokens=len(tokens))
        bs = self.block_size
        usable = (len(tokens) - 1) // bs
        self._clock += 1
        self.n_lookups += 1
        node = self._root
        blocks: List[int] = []
        for j in range(usable):
            child = node.children.get(
                tuple(int(t) for t in tokens[j * bs:(j + 1) * bs]))
            if child is None:
                break
            child.last_use = self._clock
            blocks.append(child.block)
            node = child
        if blocks:
            self.allocator.share(blocks)
            self.n_hits += 1
            self.n_hit_tokens += len(blocks) * bs
        else:
            self.n_misses += 1
        return blocks, len(blocks) * bs

    def commit(self, tokens: Sequence[int],
               block_table: Sequence[int]) -> List[int]:
        """Insert the blocks fully covered by `tokens` (whose KV is
        written in `block_table`'s blocks) into the tree, taking one
        tree reference on each newly inserted block.  A chunk already
        cached under another block is adopted: the caller's duplicate is
        freed and the returned table points at the shared block.
        Idempotent for prefixes already committed.  Returns the
        (possibly deduplicated) block table."""
        bs = self.block_size
        full = len(tokens) // bs
        table = list(block_table)
        self._clock += 1
        node = self._root
        for j in range(full):
            chunk = tuple(int(t) for t in tokens[j * bs:(j + 1) * bs])
            child = node.children.get(chunk)
            if child is None:
                child = _Node(chunk, int(table[j]), node)
                node.children[chunk] = child
                self.allocator.share([child.block])
                self._n_blocks += 1
                if self.host_write_through and self.host_tier is not None:
                    self._spill_block(child)
            elif child.block != table[j]:
                # a duplicate prefill of a cached chunk: adopt the
                # cached block (the KV of the same token prefix)
                self.allocator.share([child.block])
                self.allocator.free([int(table[j])])
                table[j] = child.block
            child.last_use = self._clock
            node = child
        return table

    def peek(self, tokens: Sequence[int]) -> int:
        """Length in tokens of the longest cached prefix of `tokens`,
        capped like `lookup`, read-only: no reference pinned, no
        counter, no LRU touch."""
        bs = self.block_size
        usable = (len(tokens) - 1) // bs
        node = self._root
        matched = 0
        for j in range(usable):
            child = node.children.get(
                tuple(int(t) for t in tokens[j * bs:(j + 1) * bs]))
            if child is None:
                break
            matched += 1
            node = child
        return matched * bs

    # ------------------------------------------------------------------
    # host tier (spill on evict, restore on miss)
    # ------------------------------------------------------------------

    def _key_for(self, node: _Node) -> Tuple[int, ...]:
        """The full token-id prefix `node` ends (the host-tier key)."""
        chunks: List[Tuple[int, ...]] = []
        while node is not self._root:
            chunks.append(node.chunk)
            node = node.parent
        out: List[int] = []
        for chunk in reversed(chunks):
            out.extend(chunk)
        return tuple(out)

    def _spill_block(self, victim: _Node) -> None:
        """Copy one tree block's KV rows (and int8 scales) to the host
        tier: into pinned slabs when the pool is on the card, then a
        wait for the copy (the block is freed right after)."""
        tier = self.host_tier
        if tier is None or tier.capacity_bytes <= 0:
            return
        bs = self.block_size
        blk = victim.block
        kv = self.cache.kv[:, :, blk * bs:(blk + 1) * bs]
        scale = (None if self.cache.kv_scale is None
                 else self.cache.kv_scale[:, :, blk * bs:(blk + 1) * bs])
        t0 = time.perf_counter()
        pin = kv.is_cuda
        kv_h = torch.empty(kv.shape, dtype=kv.dtype, pin_memory=pin)
        kv_h.copy_(kv, non_blocking=pin)
        scale_h = None
        if scale is not None:
            scale_h = torch.empty(scale.shape, dtype=scale.dtype,
                                  pin_memory=pin)
            scale_h.copy_(scale, non_blocking=pin)
        if pin:
            torch.cuda.current_stream(kv.device).synchronize()
            self.n_spill_syncs += 1
        tier.put(self._key_for(victim), kv_h, scale_h,
                 dur_s=time.perf_counter() - t0)

    def restore(self, tokens: Sequence[int], blocks: List[int],
                n_matched: int) -> Tuple[List[int], int]:
        """Extend a device match with host-resident blocks: for each
        tier entry continuing the matched prefix, allocate a pool block,
        let the engine's `restore_writer` land the rows, and insert the
        node as a commit would: the caller ends with one reference per
        block (alloc) and the tree with its own (share), as on a device
        hit.  Stops at the first miss or refused write, freeing that
        block; the lane prefills the rest.  Returns the extended
        (blocks, matched token count)."""
        tier = self.host_tier
        if tier is None or self.restore_writer is None:
            return blocks, n_matched
        bs = self.block_size
        usable = (len(tokens) - 1) // bs
        blocks = list(blocks)
        j = n_matched // bs
        node = self._root
        for i in range(j):
            node = node.children[
                tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])]
        while j < usable:
            chunk = tuple(int(t) for t in tokens[j * bs:(j + 1) * bs])
            entry = tier.fetch(tokens[:(j + 1) * bs])
            if entry is None:
                break
            got = self.allocator.alloc(1)   # no evict: a restore must
            if got is None:                 # never churn live entries
                break
            blk = got[0]
            ok = False
            try:
                ok = bool(self.restore_writer(blk, entry))
            finally:
                if not ok:
                    self.allocator.free([blk])
            if not ok:
                break
            child = _Node(chunk, blk, node)
            node.children[chunk] = child
            child.last_use = self._clock
            self.allocator.share([blk])     # the tree's reference
            self._n_blocks += 1
            blocks.append(blk)
            self.n_hit_tokens += bs
            tier.count_restored()
            node = child
            j += 1
        return blocks, j * bs

    # ------------------------------------------------------------------

    def _evictable(self) -> List[_Node]:
        """Leaf nodes whose block only the tree holds (refcount 1): the
        only blocks eviction may free."""
        out: List[_Node] = []
        stack = [self._root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if (n is not self._root and not n.children
                    and self.allocator.ref_count(n.block) == 1):
                out.append(n)
        return out

    def evict(self, n_blocks: int) -> int:
        """Free up to `n_blocks` unreferenced cached blocks, least
        recently used leaves first (spilling each to the host tier
        first, when one is attached).  Returns how many were freed."""
        freed = 0
        while freed < n_blocks:
            leaves = self._evictable()
            if not leaves:
                break
            victim = min(leaves, key=lambda n: n.last_use)
            if self.host_tier is not None:
                # spill BEFORE the free: once the block is back in the
                # pool its rows may be overwritten
                self._spill_block(victim)
            del victim.parent.children[victim.chunk]
            self.allocator.free([victim.block])
            self._n_blocks -= 1
            self.n_evictions += 1
            freed += 1
        return freed

    def clear(self) -> int:
        """Drop every tree reference (blocks still pinned by live lanes
        stay allocated until those lanes release them).  Returns the
        number of tree references dropped."""
        dropped = 0
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            self.allocator.free([n.block])
            dropped += 1
        self._root.children.clear()
        self._n_blocks = 0
        return dropped
