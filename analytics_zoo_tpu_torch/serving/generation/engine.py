"""Continuous-batching decode engine (counterpart of
analytics_zoo_tpu/serving/generation/engine.py, its whole-prompt
prefill path).

Each scheduling round admits waiting requests, prefills each admitted
prompt over a power-of-two length bucket, grows or preempts for decode
capacity, and runs ONE decode step over a fixed `max_slots`-lane grid —
tokens [S], block tables [S, max_blocks], context lengths [S], an
active-lane mask [S] and per-lane sampling params.  Sequences join and
leave between steps by changing those host arrays.

Paging: with `decode_attention="paged"` (the default) the decode step
hands the pool and each lane's block table to the model's paged path,
whose kernel gathers pool blocks by table index itself; "concat" keeps
the gather + concat-attend path as the parity oracle.  New tokens' K/V
are written into block slots in place — quantized on write when the
pool is int8 (`kv_quantization="int8"`).  Inactive lanes and prefill
padding write into the null block 0.

Streaming: `submit()` returns a `GenerationStream`; the engine pushes
each sampled token as it exists.  Drive the loop with `step()` /
`run_until_idle()`, or serve with `ensure_started()` / `stop()`.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from typing import List, Optional, Sequence as Seq

import numpy as np
import torch

from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.serving.errors import QueueFull, RequestTooLarge
from analytics_zoo_tpu_torch.serving.generation.kv_cache import (
    PagedKVCache,
    dequantize_kv_tokens,
    quantize_kv_tokens,
)
from analytics_zoo_tpu_torch.serving.generation.sampling import (
    sample_tokens,
)
from analytics_zoo_tpu_torch.serving.generation.scheduler import (
    Sequence,
    SlotScheduler,
)

_STREAM_END = object()
_log = logging.getLogger(__name__)


class GenerationStream:
    """Consumer half of one request: iterate to receive token ids as
    they are sampled; `tokens()` drains to completion.  After the
    iterator is exhausted `finish_reason` is set ("length" | "eos" |
    "error: ...")."""

    def __init__(self, seq: Sequence, timeout: float = 120.0):
        self.seq = seq
        self.timeout = timeout
        self._q: "queue.Queue" = queue.Queue()

    def _put(self, token: int) -> None:
        self._q.put(int(token))

    def _close(self) -> None:
        self._q.put(_STREAM_END)

    @property
    def finish_reason(self) -> Optional[str]:
        return self.seq.finish_reason

    def __iter__(self):
        while True:
            item = self._q.get(timeout=self.timeout)
            if item is _STREAM_END:
                return
            yield item

    def tokens(self) -> List[int]:
        return list(self)


class GenerationEngine:
    """Continuous-batching generation over a `CausalLM`, on `device`
    (None = the CUDA card, raising without one).  The model is moved
    there.

    Counters (plain integers): `n_requests`, `n_tokens`, `n_prefills`,
    `n_decode_steps`.  The wall times of the latest rounds are kept in
    `prefill_seconds` ((bucket, seconds) pairs) and `decode_seconds`.
    `keep_logits=True` stores on each sequence the logits every
    generated token was sampled from (`seq.logits`), for checks."""

    def __init__(self, model, *, max_slots: int = 8, block_size: int = 16,
                 max_context: int = 512, num_blocks: Optional[int] = None,
                 prefill_buckets: Optional[Seq[int]] = None,
                 prefill_token_budget: int = 2048,
                 cache_dtype=torch.float32, seed: int = 0,
                 max_queue: Optional[int] = None,
                 kv_quantization: Optional[str] = None,
                 decode_attention: str = "paged",
                 keep_logits: bool = False, device=None):
        if model.max_position_len < max_context:
            raise ValueError(
                f"model.max_position_len {model.max_position_len} < "
                f"max_context {max_context}")
        if decode_attention not in ("paged", "concat"):
            raise ValueError(
                f"decode_attention must be 'paged' or 'concat', got "
                f"{decode_attention!r}")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.max_slots = max_slots
        self.max_context = max_context
        self.decode_attention = decode_attention
        self.kv_quantization = kv_quantization
        self._quantized = kv_quantization == "int8"
        self.max_queue = max_queue
        self.keep_logits = keep_logits
        if num_blocks is None:
            # every lane can hold a full context
            num_blocks = max_slots * (-(-max_context // block_size)) + 1
        self.cache = PagedKVCache(
            model.n_block, num_blocks, block_size, model.n_head,
            model.hidden_size // model.n_head, dtype=cache_dtype,
            quantization=kv_quantization, device=self.device)
        if prefill_buckets is None:
            prefill_buckets = []
            b = min(16, max_context)
            while b < max_context:
                prefill_buckets.append(b)
                b *= 2
            prefill_buckets.append(max_context)
        elif max(prefill_buckets) < max_context:
            # a preempted sequence re-prefills at up to max_context
            # tokens; the top bucket must cover it
            raise ValueError(
                f"largest prefill bucket {max(prefill_buckets)} < "
                f"max_context {max_context}")
        self.scheduler = SlotScheduler(
            self.cache, max_slots, max_context, prefill_buckets,
            prefill_token_budget)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._lock = threading.RLock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

        self.n_requests = 0
        self.n_tokens = 0
        self.n_prefills = 0
        self.n_decode_steps = 0
        self.prefill_seconds: deque = deque(maxlen=4096)
        self.decode_seconds: deque = deque(maxlen=4096)

    # ------------------------------------------------------------------
    # the steps
    # ------------------------------------------------------------------

    def _tensor(self, a) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _write_kv(self, dest, new_k, new_v) -> None:
        # new_k/new_v [L, n, h, d] at token destinations dest [n].  The
        # JAX engine donates the pool to its jitted step; here the pool
        # is updated in place.  int8 mode quantizes on write (per-token
        # scales), so appends never touch already-written slots.
        kv = self.cache.kv
        if self._quantized:
            scl = self.cache.kv_scale
            for j, x in ((0, new_k), (1, new_v)):
                qx, sx = quantize_kv_tokens(x)
                kv[:, j].index_copy_(1, dest, qx)
                scl[:, j].index_copy_(1, dest, sx)
        else:
            kv[:, 0].index_copy_(1, dest, new_k.to(kv.dtype))
            kv[:, 1].index_copy_(1, dest, new_v.to(kv.dtype))

    def _prefill(self, tokens, length: int, block_table, temperature,
                 top_k):
        # tokens [1, B] (bucket-padded), block_table [max_blocks]:
        # writes KV for the `length` real tokens and samples the first
        # new token from the last real position
        B = tokens.shape[1]
        bs = self.cache.block_size
        ar = torch.arange(B, device=self.device)
        pos = torch.clamp_max(ar, self.model.max_position_len - 1)
        token_mask = (ar < length)[None]
        logits, new_k, new_v = self.model(tokens, pos[None],
                                          token_mask=token_mask)
        dest = block_table[ar // bs].long() * bs + ar % bs
        dest = torch.where(ar < length, dest, torch.zeros_like(dest))
        self._write_kv(dest, new_k[:, 0], new_v[:, 0])
        last = logits[0, length - 1]
        nxt = sample_tokens(last[None], self._gen, temperature, top_k)[0]
        return nxt, last

    def _decode(self, tokens, block_tables, ctx_len, active, temperature,
                top_k):
        # one step for all lanes: tokens [S] (each lane's pending
        # token), ctx_len [S] (= its position), block_tables
        # [S, max_blocks], active [S] lane mask
        S = block_tables.shape[0]
        bs = self.cache.block_size
        nb = self.cache.num_blocks
        kv = self.cache.kv
        L = kv.shape[0]
        pos = torch.clamp_max(ctx_len, self.model.max_position_len - 1)
        if self.decode_attention == "paged":
            kvp = kv.view(L, 2, nb, bs, *kv.shape[-2:])
            scl = (self.cache.kv_scale.view(L, 2, nb, bs)
                   if self._quantized else None)
            logits, new_k, new_v = self.model(
                tokens[:, None], pos[:, None], kv_pool=kvp, kv_scale=scl,
                block_tables=block_tables, ctx_len=ctx_len)
        else:
            tok_idx = (block_tables.long()[:, :, None] * bs
                       + torch.arange(bs, device=self.device)[None, None]
                       ).reshape(S, -1)
            ctx_k = kv[:, 0][:, tok_idx]            # [L, S, C, h, d]
            ctx_v = kv[:, 1][:, tok_idx]
            if self._quantized:
                ks = self.cache.kv_scale
                ctx_k = dequantize_kv_tokens(ctx_k, ks[:, 0][:, tok_idx])
                ctx_v = dequantize_kv_tokens(ctx_v, ks[:, 1][:, tok_idx])
            logits, new_k, new_v = self.model(
                tokens[:, None], pos[:, None], ctx_k=ctx_k, ctx_v=ctx_v,
                ctx_len=ctx_len)
        lane = torch.arange(S, device=self.device)
        dest = block_tables[lane, ctx_len.long() // bs].long() * bs \
            + ctx_len.long() % bs
        dest = torch.where(active, dest, torch.zeros_like(dest))
        self._write_kv(dest, new_k[:, :, 0], new_v[:, :, 0])
        last = torch.where(active[:, None], logits[:, 0],
                           torch.zeros_like(logits[:, 0]))
        nxt = sample_tokens(last, self._gen, temperature, top_k)
        return nxt, last

    @torch.no_grad()
    def warmup(self) -> None:
        """Run the decode step and every prefill bucket once on dummy
        inputs (all writes land in the null block), so that kernels are
        built and libraries initialised before live traffic."""
        with self._lock:
            MB = self.scheduler.max_blocks_per_seq
            S = self.max_slots
            one = torch.zeros(1, dtype=torch.float32, device=self.device)
            onek = torch.zeros(1, dtype=torch.int32, device=self.device)
            table = torch.zeros(MB, dtype=torch.int32, device=self.device)
            for b in self.scheduler.prefill_buckets:
                self._prefill(torch.zeros((1, b), dtype=torch.int32,
                                          device=self.device),
                              1, table, one, onek)
            zi = torch.zeros(S, dtype=torch.int32, device=self.device)
            self._decode(zi, torch.zeros((S, MB), dtype=torch.int32,
                                         device=self.device),
                         zi, torch.zeros(S, dtype=torch.bool,
                                         device=self.device),
                         torch.zeros(S, dtype=torch.float32,
                                     device=self.device), zi)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # request intake
    # ------------------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 32,
               temperature: float = 0.0, top_k: int = 0,
               eos_id: Optional[int] = None, stream_timeout: float = 120.0,
               request_id: Optional[str] = None, priority: int = 0
               ) -> GenerationStream:
        """Queue one request; returns its token stream.  Raises up front
        when the request can never run: ValueError for malformed
        prompts, `RequestTooLarge` (a ValueError; HTTP 413) when prompt +
        max_new_tokens exceed max_context or the whole block pool,
        `QueueFull` (HTTP 503) when `max_queue` requests already wait."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if any(not 0 <= t < self.model.vocab for t in prompt):
            raise ValueError("prompt token out of vocab range")
        total = len(prompt) + int(max_new_tokens)
        if total > self.max_context:
            raise RequestTooLarge(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_context "
                f"{self.max_context}")
        if self.cache.blocks_for(total) > self.cache.allocator.capacity:
            raise RequestTooLarge(
                f"request needs {self.cache.blocks_for(total)} KV "
                f"blocks, pool holds {self.cache.allocator.capacity}")
        seq = Sequence(prompt, max_new_tokens=max_new_tokens,
                       temperature=temperature, top_k=top_k,
                       eos_id=eos_id, request_id=request_id,
                       priority=priority)
        seq.stream = GenerationStream(seq, timeout=stream_timeout)
        if self.keep_logits:
            seq.logits = []
        with self._lock:
            if self.max_queue is not None \
                    and len(self.scheduler.waiting) >= self.max_queue:
                raise QueueFull(
                    f"{len(self.scheduler.waiting)} requests waiting "
                    f"(max_queue {self.max_queue})", retry_after_s=0.5)
            self.scheduler.submit(seq)
            self.n_requests += 1
        self._wake.set()
        return seq.stream

    def generate(self, prompt, **kw) -> List[int]:
        """Blocking one-shot convenience: submit and drain.  Drives the
        loop inline when no background thread is running."""
        stream = self.submit(prompt, **kw)
        if self._thread is None:
            self.run_until_idle()
        return stream.tokens()

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------

    def _finish(self, seq: Sequence, reason: str) -> None:
        self.scheduler.release(seq, reason)
        if seq.stream is not None:
            seq.stream._close()

    def _emit(self, seq: Sequence, token: int, logits=None) -> None:
        seq.generated.append(int(token))
        if seq.logits is not None and logits is not None:
            seq.logits.append(logits.clone())
        self.n_tokens += 1
        if seq.stream is not None:
            seq.stream._put(token)
        reason = seq.should_finish()
        if reason:
            self._finish(seq, reason)

    def _prefill_seq(self, seq: Sequence) -> None:
        t0 = time.perf_counter()
        ctx = seq.prompt + seq.generated
        L = len(ctx)
        bucket = self.scheduler.bucket_for(L)
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :L] = ctx
        table = np.zeros(self.scheduler.max_blocks_per_seq, np.int32)
        table[:len(seq.block_table)] = seq.block_table
        nxt, last = self._prefill(
            self._tensor(tokens), L, self._tensor(table),
            self._tensor(np.full(1, seq.temperature, np.float32)),
            self._tensor(np.full(1, seq.top_k, np.int32)))
        nxt = int(nxt)            # token fetch = device fence
        self.prefill_seconds.append((bucket, time.perf_counter() - t0))
        self.n_prefills += 1
        self._emit(seq, nxt, last)

    def _decode_all(self) -> None:
        t0 = time.perf_counter()
        S = self.max_slots
        MB = self.scheduler.max_blocks_per_seq
        tokens = np.zeros(S, np.int32)
        tables = np.zeros((S, MB), np.int32)
        ctx_len = np.zeros(S, np.int32)
        active = np.zeros(S, bool)
        temp = np.zeros(S, np.float32)
        top_k = np.zeros(S, np.int32)
        lanes = {}
        for seq in self.scheduler.running():
            i = seq.slot
            lanes[i] = seq
            tokens[i] = seq.generated[-1] if seq.generated \
                else seq.prompt[-1]
            tables[i, :len(seq.block_table)] = seq.block_table
            ctx_len[i] = seq.context_len - 1    # the pending position
            active[i] = True
            temp[i] = seq.temperature
            top_k[i] = seq.top_k
        nxt, last = self._decode(
            self._tensor(tokens), self._tensor(tables),
            self._tensor(ctx_len), self._tensor(active),
            self._tensor(temp), self._tensor(top_k))
        nxt = nxt.cpu().numpy()   # token fetch = device fence
        self.decode_seconds.append(time.perf_counter() - t0)
        self.n_decode_steps += 1
        for i, seq in lanes.items():
            self._emit(seq, nxt[i], last[i])

    @torch.no_grad()
    def step(self) -> bool:
        """One scheduling round: admit → prefill each admitted prompt
        whole → grow/preempt for decode capacity → one decode step.
        Returns whether any device work ran."""
        with self._lock:
            did = False
            for seq in self.scheduler.admit():
                self._prefill_seq(seq)
                did = True
            self.scheduler.ensure_decode_capacity()
            if self.scheduler.running():
                self._decode_all()
                did = True
            return did

    def run_until_idle(self, max_steps: int = 1_000_000) -> None:
        for _ in range(max_steps):
            if not self.scheduler.has_work():
                return
            if not self.step():
                raise RuntimeError(
                    "generation engine stuck: waiting requests but no "
                    "schedulable work (block pool too small?)")
        raise RuntimeError(f"still busy after {max_steps} steps")

    # ------------------------------------------------------------------
    # background serving
    # ------------------------------------------------------------------

    def ensure_started(self) -> "GenerationEngine":
        """Start the background serving loop (once)."""
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="generation-engine")
            self._thread.start()
        return self

    def _loop(self) -> None:
        stuck_rounds = 0
        while not self._stop.is_set():
            if not self.scheduler.has_work():
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            try:
                did = self.step()
                with self._lock:
                    if did or not self.scheduler.waiting:
                        stuck_rounds = 0
                    else:
                        # waiting requests, nothing admittable or
                        # running: the head can never be scheduled —
                        # reject it instead of spinning forever
                        stuck_rounds += 1
                        if stuck_rounds >= 3:
                            stuck_rounds = 0
                            self._finish(
                                self.scheduler.waiting.popleft(),
                                "error: engine stuck (request cannot be "
                                "scheduled)")
            except Exception as e:   # fail the lanes loudly, keep serving
                _log.exception("generation step failed")
                with self._lock:
                    for seq in list(self.scheduler.slotted()):
                        self._finish(seq, f"error: {e}")

    def stop(self) -> None:
        """Stop the background loop and close every stream still open."""
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            if self._thread.is_alive():
                raise RuntimeError("generation loop did not stop")
            self._thread = None
        with self._lock:
            for seq in list(self.scheduler.slotted()):
                self._finish(seq, "error: engine stopped")
            while self.scheduler.waiting:
                self._finish(self.scheduler.waiting.popleft(),
                             "error: engine stopped")
