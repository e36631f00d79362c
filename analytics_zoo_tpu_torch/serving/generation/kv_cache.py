"""Paged KV cache: fixed-size blocks in one preallocated device buffer
(counterpart of analytics_zoo_tpu/serving/generation/kv_cache.py).

The pool is ONE tensor per cache, [n_layers, 2, num_blocks * block_size,
heads, head_dim] (k=0/v=1 on axis 1), flat in the token dimension, so
writes are plain index copies at `block_id * block_size + offset`.
Block 0 is the NULL block: inactive lanes' table entries and padding
writes all point at it, so dead lanes scribble harmlessly instead of
branching.  Unlike the JAX pool, which the jitted steps take and return
as functional state, this pool is updated in place.

Allocation is host-side: the allocator hands block ids to the
scheduler, which bakes them into the block-table tensors of each step.

Quantized mode (`quantization="int8"`): the pool stores int8 with a
per-token-slot symmetric scale vector `kv_scale`
[n_layers, 2, num_blocks * block_size] f32 (amax/127 per token slot),
so appends never touch already-written slots.  Reads dequantize in the
paged-attention kernel (or its plain version).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from analytics_zoo_tpu_torch.device import resolve_device

#: block id 0 is never allocated; see module docstring
NULL_BLOCK = 0


def quantize_kv_tokens(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-token int8 quantization of K or V slabs
    `x` [..., heads, head_dim]: one amax/127 scale per leading index.
    Returns (int8 values, f32 scales [...])."""
    xf = x.float()
    amax = xf.abs().amax(dim=(-2, -1))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None, None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv_tokens(q, scale):
    """Inverse of `quantize_kv_tokens`."""
    return q.float() * scale[..., None, None]


class BlockAllocator:
    """Free-list allocator over `num_blocks` KV blocks (block 0 reserved
    as the null block), with per-block reference counts.  `alloc` hands
    out blocks at refcount 1; `share` pins an extra reference; `free`
    drops one reference per listed id and returns a block to the free
    list when its count reaches zero.  LIFO reuse.  Not thread-safe —
    the engine loop is the only caller."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is the "
                             "reserved null block)")
        self.num_blocks = num_blocks
        # pop() takes from the tail: ascending init → low ids first
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        #: block id -> live reference count (allocated blocks only)
        self._refs: Dict[int, int] = {}

    @property
    def capacity(self) -> int:
        """Allocatable blocks (excludes the null block)."""
        return self.num_blocks - 1

    def available(self) -> int:
        return len(self._free)

    def occupancy(self) -> float:
        """Fraction of allocatable blocks currently held."""
        return len(self._refs) / self.capacity

    def ref_count(self, block: int) -> int:
        """Live references on `block` (0 = free / never allocated)."""
        return self._refs.get(block, 0)

    def alloc(self, n: int = 1) -> Optional[List[int]]:
        """n blocks, or None when the pool can't cover the request
        (partial allocations are never handed out)."""
        if n > len(self._free):
            return None
        blocks = [self._free.pop() for _ in range(n)]
        for blk in blocks:
            self._refs[blk] = 1
        return blocks

    def share(self, blocks: List[int]) -> None:
        """Pin one extra reference on each (already-allocated) block."""
        for blk in blocks:
            if blk not in self._refs:
                raise ValueError(f"cannot share unallocated block {blk}")
        for blk in blocks:
            self._refs[blk] += 1

    def free(self, blocks: List[int]) -> None:
        """Drop one reference per listed id.  The whole request is
        validated before anything changes: freeing the null block, an
        id out of range, or an id more times than it has references (a
        duplicate inside one call is a double free too) raises instead
        of corrupting the pool."""
        need: Dict[int, int] = {}
        for blk in blocks:
            if blk == NULL_BLOCK:
                raise ValueError("cannot free the null block")
            if not 0 < blk < self.num_blocks:
                raise ValueError(f"block id {blk} out of range")
            need[blk] = need.get(blk, 0) + 1
        for blk, n in need.items():
            if n > self._refs.get(blk, 0):
                raise ValueError(f"double free of block {blk}")
        for blk in blocks:
            self._refs[blk] -= 1
            if self._refs[blk] == 0:
                del self._refs[blk]
                self._free.append(blk)


class PagedKVCache:
    """The device pool + its allocator, on `device`."""

    def __init__(self, n_layers: int, num_blocks: int, block_size: int,
                 n_head: int, head_dim: int, dtype=torch.float32,
                 quantization: Optional[str] = None, device=None):
        if quantization not in (None, "int8"):
            raise ValueError(f"unsupported KV quantization "
                             f"{quantization!r}; use None or 'int8'")
        device = resolve_device(device)
        self.n_layers = n_layers
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.n_head = n_head
        self.head_dim = head_dim
        self.quantization = quantization
        #: the dtype reads dequantize to (and the pool dtype itself
        #: when quantization is off)
        self.logical_dtype = dtype
        store = torch.int8 if quantization == "int8" else dtype
        self.kv = torch.zeros(
            (n_layers, 2, num_blocks * block_size, n_head, head_dim),
            dtype=store, device=device)
        #: per-token-slot dequant scales (int8 mode only)
        self.kv_scale = (
            torch.ones((n_layers, 2, num_blocks * block_size),
                       dtype=torch.float32, device=device)
            if quantization == "int8" else None)
        self.allocator = BlockAllocator(num_blocks)

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold n_tokens."""
        return -(-n_tokens // self.block_size)

    @property
    def physical_nbytes(self) -> int:
        """Bytes the pool occupies on the device (int8 values plus
        their scale vectors in quantized mode)."""
        total = self.kv.numel() * self.kv.element_size()
        if self.kv_scale is not None:
            total += self.kv_scale.numel() * self.kv_scale.element_size()
        return total

    @property
    def logical_nbytes(self) -> int:
        """Bytes the same pool would occupy unquantized at
        `logical_dtype`."""
        itemsize = torch.empty((), dtype=self.logical_dtype).element_size()
        return self.kv.numel() * itemsize
