"""Continuous-batching decode engine (counterpart of
analytics_zoo_tpu/serving/generation/engine.py).

Each scheduling round admits waiting requests, prefills them, grows or
preempts for decode capacity, and runs ONE decode step over a fixed
`max_slots`-lane grid — tokens [S], block tables [S, max_blocks],
context lengths [S], an active-lane mask [S] and per-lane sampling
params.  Sequences join and leave between steps by changing those host
arrays.

Paging: with `decode_attention="paged"` (the default) the decode step
hands the pool and each lane's block table to the model's paged path,
whose kernel gathers pool blocks by table index itself; "concat" keeps
the gather + concat-attend path as the parity oracle.  New tokens' K/V
are written into block slots in place — quantized on write when the
pool is int8 (`kv_quantization="int8"`).  Inactive lanes and prefill
padding write into the null block 0.

Prefill: with prefix caching and chunked prefill off (the defaults),
each admitted prompt prefills whole over a power-of-two length bucket.
With either on, prefill runs through the chunk step, which attends over
the context already written in the pool (gathered by block table) plus
itself and writes a bucket-sized slab of new positions: a prefix-cache
hit prefills only the uncovered tail (prefix_cache.py), and a chunked
long prompt spreads over rounds under `prefill_token_budget`, with a
decode step for the running lanes between its chunks.  Shared blocks
are copied before a write (copy-on-write, int8 scales included); with a
host tier (host_tier.py) evicted prefix blocks spill to host memory and
come back by copy instead of recompute.

Speculative decoding (speculation.py): greedy lanes draft up to k
tokens from their own history, and ONE verify step scores every drafted
lane at once (`paged_verify_attention`), writing the draft's KV and
taking the argmax at every position; the longest matching prefix plus
one bonus token is emitted, and the blocks past the next write go back
to the pool.  The other greedy lanes ride the same dispatch as
length-1 rows, so a verify round replaces the decode round for them.

Streaming: `submit()` returns a `GenerationStream`; the engine pushes
each sampled token as it exists.  Drive the loop with `step()` /
`run_until_idle()`, or serve with `ensure_started()` / `stop()`.

Intake: `submit` asks the engine's `AdmissionCore` (serving/
control_plane/admission.py, as JAX's engine.py:322-329 does), which sheds
with `QueueFull` when `max_queue` requests wait; when the SLO shedder is
armed (`OrcaContext.slo_targets` and `slo_shed_attainment`) and the
rolling attainment is below it with at least `slo_shed_min_queue`
waiting; or when a fault plan's ``refuse`` fires at the
``serving.admission`` site; and with `TenantQuotaExceeded` (429) when
the request's tenant is over its quota (`OrcaContext.tenant_quotas`).
Each carries a Retry-After hint: `retry_after_s()`, the queue's drain
time estimated from the measured decode steps, or the tenant bucket's
refill time.  The request class ("interactive", "batch", "shadow") is
the scheduler priority.  A
``poison_request`` fault at ``generation.decode`` fails one request
before dispatch: the engine evicts that request alone and the other
lanes decode on the next round (JAX engine.py:1405-1493).

Observability, as JAX's (engine.py:416-430, :689-771, :957-1600): each
request has a record in the lifecycle log (`request_log`, keyed by its
id) with its admission, prefill, token, decode-round and finish events
and its derived TTFT / TPOT / queue wait / e2e.  Prefill and chunk
steps, decode steps and verify steps are split by the
`generation_prefill` / `generation_decode` / `generation_spec_verify`
goodput clocks (each step fenced by its own token fetch; a middle
chunk of a chunked prefill, which fetches nothing, at the clock's
sampled cadence on the card).  The step
families `prefill`, `chunk_prefill`, `decode`, `spec_verify`,
`copy_block` and `host_restore` go through the dispatch ledger, which
counts their signatures against the budgets the geometry implies and
their fenced work in `CausalLMFlops`.  The KV pool's occupancy is the
`kv_pool` memory provider.  With `OrcaContext.watchdog_deadline_s` a
`generation` watchdog is beaten once a round while the engine has work.
An evicted request, a stuck engine and a failed step each log an event
and write a flight bundle.  The engine's `registry` (the process
registry) holds JAX's `generation_*` and `speculation_*` families; each loop round spools that registry
(`maybe_spool`, with `OrcaContext.observability_dir`) and samples it
into the metrics history (`maybe_record`, with
`OrcaContext.metrics_history_interval_s`), as JAX's loop does.
"""

from __future__ import annotations

import logging
import queue
import threading
import weakref
from collections import deque
from typing import Dict, List, Optional, Sequence as Seq, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.observability import (
    flight_recorder,
    get_registry,
    log_event,
    maybe_record,
    maybe_spool,
    maybe_watchdog,
    memory,
    now,
    profiling,
    request_log,
    step_clock,
)
from analytics_zoo_tpu_torch.resilience.faults import (
    FaultInjected,
    PoisonedRequestError,
    fault_point,
)
from analytics_zoo_tpu_torch.serving.control_plane.admission import (
    AdmissionCore,
)
from analytics_zoo_tpu_torch.serving.errors import (  # noqa: F401
    QueueFull,
    RequestTooLarge,
)
from analytics_zoo_tpu_torch.serving.generation.host_tier import (
    HostKVTier,
    record_dma,
)
from analytics_zoo_tpu_torch.serving.generation.kv_cache import (
    PagedKVCache,
    dequantize_kv_tokens,
    quantize_kv_tokens,
)
from analytics_zoo_tpu_torch.serving.generation.prefix_cache import (
    PrefixCache,
)
from analytics_zoo_tpu_torch.serving.generation.sampling import (
    sample_tokens,
)
from analytics_zoo_tpu_torch.serving.generation.scheduler import (
    Sequence,
    SlotScheduler,
)
from analytics_zoo_tpu_torch.serving.generation.speculation import (
    Speculator,
)

_STREAM_END = object()
_log = logging.getLogger(__name__)


class GenerationStream:
    """Consumer half of one request: iterate to receive token ids as
    they are sampled; `tokens()` drains to completion.  After the
    iterator is exhausted `finish_reason` is set ("length" | "eos" |
    "error: ...").  `submitted_at` and `token_times` are the host clock
    (`observability.now`) at submission and at each token's push."""

    def __init__(self, seq: Sequence, timeout: float = 120.0):
        self.seq = seq
        self.timeout = timeout
        self._q: "queue.Queue" = queue.Queue()
        self.submitted_at = now()
        self.token_times: List[float] = []

    def _put(self, token: int) -> None:
        self.token_times.append(now())
        self._q.put(int(token))

    def _close(self) -> None:
        self._q.put(_STREAM_END)

    @property
    def finish_reason(self) -> Optional[str]:
        return self.seq.finish_reason

    @property
    def request_id(self) -> Optional[str]:
        """The request's id: the caller's, sanitized, or a new one."""
        return self.seq.request_id

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

    The "auto" arguments read `OrcaContext` (common/context.py):
    `kv_quantization` its `kv_cache_quantization`, `prefix_caching`,
    `chunked_prefill`, `speculative_decoding`, `speculative_k`, and
    `kv_host_tier` its `kv_host_tier_bytes` (a byte capacity, or a
    `HostKVTier` to share; used only with prefix caching on).
    `slo_shed_min_queue` (default `max_slots`: one waiting request a
    lane) is the queue depth from which the SLO shedder may shed.

    Counters (plain integers): `n_requests`, `n_tokens`, `n_prefills`
    (whole-prompt prefills), `n_chunks` (chunk steps), `n_prefill_tokens`,
    `n_decode_steps`, `n_verify_steps` (verify dispatches),
    `n_cow_copies`, `n_spec_rounds` (lane verify rounds),
    `n_spec_proposed`, `n_spec_accepted`, `n_spec_parked` (lane rounds
    sat out in the cooldown), `n_host_restores` (blocks restored from
    the host tier, `n_host_restores_staged` of them from a staged copy),
    `n_evictions` (poisoned requests evicted alone).
    The host wall times of the latest fenced rounds are kept in
    `prefill_seconds` ((bucket, seconds) pairs: whole prefills and final
    chunks), `decode_seconds` and `verify_seconds`.  `keep_logits=True`
    stores on each sequence the logits every generated token was
    sampled (or accepted) from (`seq.logits`), for checks."""

    def __init__(self, model, *, max_slots: int = 8, block_size: int = 16,
                 max_context: int = 512, num_blocks: Optional[int] = None,
                 prefill_buckets: Optional[Seq[int]] = None,
                 prefill_token_budget: int = 2048,
                 cache_dtype=torch.float32, seed: int = 0,
                 max_queue: Optional[int] = None,
                 slo_shed_min_queue: Optional[int] = None,
                 kv_quantization="auto",
                 decode_attention: str = "paged",
                 prefix_caching="auto", chunked_prefill="auto",
                 speculative_decoding="auto", speculative_k="auto",
                 kv_host_tier="auto",
                 keep_logits: bool = False, registry=None, device=None):
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
        if kv_quantization == "auto":
            kv_quantization = OrcaContext.kv_cache_quantization
        self.kv_quantization = kv_quantization
        self._quantized = kv_quantization == "int8"
        if prefix_caching == "auto":
            prefix_caching = OrcaContext.prefix_caching
        self.prefix_caching = bool(prefix_caching)
        if chunked_prefill == "auto":
            chunked_prefill = OrcaContext.chunked_prefill
        self.chunked_prefill = bool(chunked_prefill)
        #: either feature routes prefill through the chunk step; both
        #: off keeps the whole-prompt prefill path
        self._use_chunks = self.prefix_caching or self.chunked_prefill
        if speculative_decoding == "auto":
            speculative_decoding = OrcaContext.speculative_decoding
        if speculative_k == "auto":
            speculative_k = OrcaContext.speculative_k
        self.speculative_decoding = bool(speculative_decoding)
        self.speculation = (Speculator(int(speculative_k))
                            if self.speculative_decoding else None)
        #: the door policy (serving/control_plane/admission.py): the
        #: queue bound, the SLO shedder and the tenant quota gate;
        #: `max_queue` / `slo_shed_min_queue` read and write it
        self.admission = AdmissionCore(
            max_queue=max_queue,
            slo_shed_min_queue=(max_slots if slo_shed_min_queue is None
                                else int(slo_shed_min_queue)),
            retry_after=self.retry_after_s)
        #: "model@version" on this engine's request records, set by a
        #: ModelRegistry; None outside one
        self.model_label: Optional[str] = None
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
        if kv_host_tier == "auto":
            kv_host_tier = OrcaContext.kv_host_tier_bytes
        if isinstance(kv_host_tier, HostKVTier):
            host_tier = kv_host_tier
        else:
            cap = int(kv_host_tier or 0)
            host_tier = HostKVTier(cap) if cap > 0 else None
        self.host_tier = host_tier if self.prefix_caching else None
        self.prefix_cache = (PrefixCache(self.cache,
                                         host_tier=self.host_tier)
                             if self.prefix_caching else None)
        if self.host_tier is not None:
            self.prefix_cache.restore_writer = self._host_restore_write
        self.scheduler = SlotScheduler(
            self.cache, max_slots, max_context, prefill_buckets,
            prefill_token_budget, prefix_cache=self.prefix_cache,
            chunk_mode=self._use_chunks)
        #: the chunk size cap: the largest prefill bucket within the
        #: per-round token budget (at least the smallest bucket)
        fitting = [b for b in self.scheduler.prefill_buckets
                   if b <= prefill_token_budget]
        self._chunk_cap = (max(fitting) if fitting
                           else self.scheduler.prefill_buckets[0])
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._lock = threading.RLock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

        self.n_requests = 0
        self.n_tokens = 0
        self.n_prefills = 0
        self.n_chunks = 0
        self.n_prefill_tokens = 0
        self.n_decode_steps = 0
        self.n_verify_steps = 0
        self.n_cow_copies = 0
        self.n_spec_rounds = 0
        self.n_spec_proposed = 0
        self.n_spec_accepted = 0
        self.n_spec_parked = 0
        self.n_host_restores = 0
        self.n_host_restores_staged = 0
        self.n_evictions = 0
        self.prefill_seconds: deque = deque(maxlen=4096)
        self.decode_seconds: deque = deque(maxlen=4096)
        self.verify_seconds: deque = deque(maxlen=4096)

        #: the analytic FLOPs model of the dispatch ledger's MFU; None
        #: for a model without the CausalLM widths (a stand-in in tests)
        try:
            self._flops = profiling.CausalLMFlops.from_model(model)
        except (AttributeError, TypeError):
            self._flops = None
        #: JAX's engine families (engine.py:362-414), in `registry`:
        #: the process registry by default; each router replica has its
        #: own (a shared one would bind every replica's gauges to the
        #: last engine built)
        reg = self.registry = (registry if registry is not None
                               else get_registry())
        #: the telemetry spool's name for this engine's loop
        self.spool_name = "engine"
        self._c_tokens = reg.counter(
            "generation_tokens_total",
            help="tokens sampled (prefill first-tokens + decode)")
        self._c_prefill_tokens = reg.counter(
            "generation_prefill_tokens_total",
            help="prompt tokens prefilled (bucket-padded tokens excluded)")
        self._c_requests = reg.counter(
            "generation_requests_total", help="generation requests")
        self._h_prefill = reg.histogram(
            "generation_prefill_seconds",
            help="per-sequence prefill latency (records = real tokens)")
        self._h_decode = reg.histogram(
            "generation_decode_seconds",
            help="per-step decode latency (records = active lanes)")
        # the gauges read the engine through a weak reference: the
        # registry outlives it and must not keep its model and pool alive
        reg.gauge("generation_cache_occupancy",
                  fn=self._weak(lambda e: e.cache.allocator.occupancy()),
                  help="fraction of KV blocks held by live sequences")
        reg.gauge("generation_active_slots",
                  fn=self._weak(lambda e: len(e.scheduler.running())),
                  help="decode lanes occupied")
        reg.gauge("generation_queue_depth",
                  fn=self._weak(lambda e: len(e.scheduler.waiting)),
                  help="requests waiting for a lane")
        reg.gauge("generation_preemptions",
                  fn=self._weak(lambda e: e.scheduler.n_preemptions),
                  help="sequences preempted under cache pressure")
        self._c_cow = (reg.counter(
            "prefix_cache_cow_copies_total",
            help="shared blocks copy-on-write un-shared before a decode "
                 "write") if self.prefix_caching else None)
        if self.speculation is not None:
            self._c_spec_proposed = reg.counter(
                "speculation_proposed_total",
                help="drafted tokens fed to the spec-verify step")
            self._c_spec_accepted = reg.counter(
                "speculation_accepted_total",
                help="drafted tokens accepted (argmax-matched); the "
                     "free bonus tokens are NOT counted here")
            self._c_spec_rounds = reg.counter(
                "speculation_rounds_total",
                help="per-lane verify rounds (one lane scored once)")
            reg.gauge(
                "speculation_acceptance_rate",
                fn=self._weak(lambda e: (
                    e._c_spec_accepted.value / e._c_spec_proposed.value
                    if e._c_spec_proposed.value else 0.0)),
                help="accepted / proposed drafted tokens, lifetime")
            self._h_spec_accepted = reg.histogram(
                "speculation_accepted_length",
                help="accepted draft length per lane verify round "
                     "(one record per round; 0 = fully rejected)")
        #: the KV pool's occupancy rides the memory telemetry
        memory.register_provider("kv_pool", self._kv_pool_stats)
        #: goodput of the hot loops; a step fences on its token fetch,
        #: so every step but a middle chunk is fully split
        self._clock_prefill = step_clock("generation_prefill")
        self._clock_decode = step_clock("generation_decode")
        self._clock_spec = (step_clock("generation_spec_verify")
                            if self.speculation is not None else None)
        #: the stall watchdog (OrcaContext.watchdog_deadline_s): armed
        #: while the engine has work, beaten once a round
        self.watchdog = maybe_watchdog("generation")
        # the dispatch ledger's families; the lambdas read the methods
        # at call time, so a test's wrapper on the instance is called.
        # A wrapper's `last_call_new` marks this engine's first dispatch
        # of a step variant (the kernels' first launch at a shape builds
        # them): that step lands in the goodput "compile" bucket
        ledger = profiling.instrument
        self._prefill_step = ledger(
            "prefill", lambda *a: self._prefill(*a),
            argnames=("tokens", "length", "block_table", "temperature",
                      "top_k"))
        self._chunk_step = ledger(
            "chunk_prefill", lambda *a: self._chunk(*a),
            argnames=("tokens", "start", "length", "block_table"))
        self._decode_step = ledger(
            "decode", lambda *a: self._decode(*a),
            argnames=("tokens", "block_tables", "ctx_len", "active",
                      "temperature", "top_k"))
        self._verify_step = ledger(
            "spec_verify", lambda *a: self._verify(*a),
            argnames=("tokens", "block_tables", "start", "length",
                      "active"))
        self._copy_block_step = ledger(
            "copy_block", lambda *a: self._copy_block(*a),
            argnames=("src", "dst"))
        self._restore_block_step = ledger(
            "host_restore", lambda *a: self._restore_block(*a),
            argnames=("dst", "rows", "srows"))
        # signature budgets: the variants each family's geometry implies
        n_buckets = self.scheduler.expected_prefill_variants()
        profiling.declare_expected("prefill", n_buckets)
        profiling.declare_expected("chunk_prefill", n_buckets)
        profiling.declare_expected("decode", 1)
        profiling.declare_expected("copy_block", 1)
        if self.host_tier is not None:
            profiling.declare_expected("host_restore", 1)
        if self.speculation is not None:
            profiling.declare_expected(
                "spec_verify", self.speculation.expected_verify_variants())

    def _weak(self, read):
        """A gauge callback calling `read(engine)` while this engine
        lives, 0.0 after."""
        ref = weakref.ref(self)

        def fn() -> float:
            eng = ref()
            return float(read(eng)) if eng is not None else 0.0
        return fn

    def _kv_pool_stats(self) -> dict:
        """Pool occupancy: blocks used, shared (more than one reference)
        and cached by the prefix tree, and bytes — physical (int8 values
        and scales) against logical (dequantized at the cache dtype)."""
        alloc = self.cache.allocator
        used = alloc.capacity - alloc.available()
        nb = self.cache.num_blocks
        logical = self.cache.logical_nbytes
        physical = self.cache.physical_nbytes
        n_shared = alloc.n_shared()
        return {
            "blocks_used": used,
            "blocks_capacity": alloc.capacity,
            "blocks_shared": n_shared,
            "blocks_cached": (self.prefix_cache.n_blocks
                              if self.prefix_cache is not None else 0),
            "pool_bytes": physical,
            "used_bytes": physical * used // nb,
            "shared_bytes": physical * n_shared // nb,
            "exclusive_bytes": physical * (used - n_shared) // nb,
            "pool_bytes_logical": logical,
            "pool_bytes_physical": physical,
            "used_bytes_logical": logical * used // nb,
            "used_bytes_physical": physical * used // nb,
        }

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

    def _gather_ctx(self, tok_idx):
        # the pool rows at token indices tok_idx [..., T], per layer:
        # ([L, ..., T, h, d] K, V), dequantized when the pool is int8
        kv = self.cache.kv
        ctx_k = kv[:, 0][:, tok_idx]
        ctx_v = kv[:, 1][:, tok_idx]
        if self._quantized:
            ks = self.cache.kv_scale
            ctx_k = dequantize_kv_tokens(ctx_k, ks[:, 0][:, tok_idx])
            ctx_v = dequantize_kv_tokens(ctx_v, ks[:, 1][:, tok_idx])
        return ctx_k, ctx_v

    def _prefill_forward(self, tokens, length: int, block_table):
        # tokens [1, B] (bucket-padded), block_table [max_blocks]:
        # writes KV for the `length` real tokens; returns the logits of
        # the last real position
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
        return logits[0, length - 1]

    def _prefill(self, tokens, length: int, block_table, temperature,
                 top_k):
        # the whole-prompt prefill: KV for the prompt, and the first new
        # token sampled from the last real position
        last = self._prefill_forward(tokens, length, block_table)
        nxt = sample_tokens(last[None], self._gen, temperature, top_k)[0]
        return nxt, last

    def _chunk(self, tokens, start: int, length: int, block_table):
        # one chunk of a (prefix-matched or chunked) prefill: tokens
        # [1, B] (bucket-padded), `start` context tokens whose KV is
        # already written (cached prefix + earlier chunks), `length`
        # real tokens.  The chunk attends over the written context
        # (gathered from the pool by block table) plus itself causally
        # and writes its KV into block slots; returns the logits of its
        # last real position.  With nothing written yet (start 0) the
        # context is all masked, so the whole-prompt causal path gives
        # the same result without gathering it.
        if start == 0:
            return self._prefill_forward(tokens, length, block_table)
        B = tokens.shape[1]
        bs = self.cache.block_size
        MB = block_table.shape[0]
        rel = torch.arange(B, device=self.device)
        abs_pos = start + rel
        pos = torch.clamp_max(abs_pos, self.model.max_position_len - 1)
        tok_idx = (block_table.long()[:, None] * bs
                   + torch.arange(bs, device=self.device)[None]
                   ).reshape(-1)
        ctx_k, ctx_v = self._gather_ctx(tok_idx)
        ctx_len = torch.full((1,), start, dtype=torch.int32,
                             device=self.device)
        logits, new_k, new_v = self.model(
            tokens, pos[None], ctx_k=ctx_k[:, None], ctx_v=ctx_v[:, None],
            ctx_len=ctx_len)
        # padding positions may run past the table: they write the null
        # block
        blk = torch.clamp_max(abs_pos // bs, MB - 1)
        dest = block_table[blk].long() * bs + abs_pos % bs
        dest = torch.where(rel < length, dest, torch.zeros_like(dest))
        self._write_kv(dest, new_k[:, 0], new_v[:, 0])
        return logits[0, length - 1]

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
            ctx_k, ctx_v = self._gather_ctx(tok_idx)   # [L, S, C, h, d]
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

    def _verify(self, tokens, block_tables, start, length, active):
        # the speculative verify step over the slot grid: tokens [S, W]
        # = each lane's [pending token ; draft ; padding], start [S] =
        # tokens whose KV is written (context_len - 1), length [S] = 1 +
        # real draft tokens, active [S].  Every position attends over
        # the lane's pool context plus the preceding new tokens, writes
        # its KV into the lane's (pre-grown) blocks, and the greedy
        # argmax of every position comes back.  Returns (argmax [S, W]
        # int32, logits [S, W, vocab]).
        S, W = tokens.shape
        bs = self.cache.block_size
        nb = self.cache.num_blocks
        MB = block_tables.shape[1]
        kv = self.cache.kv
        L = kv.shape[0]
        rel = torch.arange(W, device=self.device)
        abs_pos = start.long()[:, None] + rel[None]             # [S, W]
        pos = torch.clamp_max(abs_pos, self.model.max_position_len - 1)
        if self.decode_attention == "paged":
            kvp = kv.view(L, 2, nb, bs, *kv.shape[-2:])
            scl = (self.cache.kv_scale.view(L, 2, nb, bs)
                   if self._quantized else None)
            logits, new_k, new_v = self.model(
                tokens, pos, kv_pool=kvp, kv_scale=scl,
                block_tables=block_tables, ctx_len=start)
        else:
            tok_idx = (block_tables.long()[:, :, None] * bs
                       + torch.arange(bs, device=self.device)[None, None]
                       ).reshape(S, -1)
            ctx_k, ctx_v = self._gather_ctx(tok_idx)
            logits, new_k, new_v = self.model(
                tokens, pos, ctx_k=ctx_k, ctx_v=ctx_v, ctx_len=start)
        # padding positions may run past the table: they write the null
        # block
        blk = torch.clamp_max(abs_pos // bs, MB - 1)
        dest = block_tables.long().gather(1, blk) * bs + abs_pos % bs
        keep = (rel[None] < length[:, None]) & active[:, None]
        dest = torch.where(keep, dest, torch.zeros_like(dest)).reshape(-1)
        self._write_kv(dest, new_k.reshape(L, S * W, *new_k.shape[-2:]),
                       new_v.reshape(L, S * W, *new_v.shape[-2:]))
        return torch.argmax(logits, dim=-1).to(torch.int32), logits

    def _copy_block(self, src: int, dst: int) -> None:
        # copy-on-write: duplicate one pool block's token slots and
        # their dequant scales
        bs = self.cache.block_size
        kv = self.cache.kv
        kv[:, :, dst * bs:(dst + 1) * bs] = kv[:, :, src * bs:(src + 1) * bs]
        if self._quantized:
            scl = self.cache.kv_scale
            scl[:, :, dst * bs:(dst + 1) * bs] = \
                scl[:, :, src * bs:(src + 1) * bs]

    def _restore_block(self, dst: int, rows, srows) -> None:
        # a host-tier restore: one block's KV rows (and int8 scales)
        # into pool block `dst`
        bs = self.cache.block_size
        self.cache.kv[:, :, dst * bs:(dst + 1) * bs] = rows
        if self._quantized:
            self.cache.kv_scale[:, :, dst * bs:(dst + 1) * bs] = srows

    @torch.no_grad()
    def warmup(self) -> None:
        """Run the decode step, every prefill bucket (of the chunk step,
        with and without written context, when prefix caching or
        chunked prefill is on; of the whole-prompt prefill otherwise)
        and every verify bucket once on dummy inputs (all writes land in
        the null block), so that kernels are built and libraries
        initialised before live traffic."""
        with self._lock:
            MB = self.scheduler.max_blocks_per_seq
            S = self.max_slots
            one = torch.zeros(1, dtype=torch.float32, device=self.device)
            onek = torch.zeros(1, dtype=torch.int32, device=self.device)
            table = torch.zeros(MB, dtype=torch.int32, device=self.device)
            for b in self.scheduler.prefill_buckets:
                tokens = torch.zeros((1, b), dtype=torch.int32,
                                     device=self.device)
                if not self._use_chunks:
                    self._prefill_step(tokens, 1, table, one, onek)
                elif not self.chunked_prefill or b <= self._chunk_cap:
                    self._chunk_step(tokens, 0, 1, table)
                    self._chunk_step(tokens, 1, 1, table)
            zi = torch.zeros(S, dtype=torch.int32, device=self.device)
            zt = torch.zeros((S, MB), dtype=torch.int32, device=self.device)
            zb = torch.zeros(S, dtype=torch.bool, device=self.device)
            self._decode_step(zi, zt, zi, zb,
                              torch.zeros(S, dtype=torch.float32,
                                          device=self.device), zi)
            if self.speculation is not None:
                for b in self.speculation.buckets:
                    self._verify_step(
                        torch.zeros((S, 1 + b), dtype=torch.int32,
                                    device=self.device), zt, zi, zi, zb)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # request intake
    # ------------------------------------------------------------------

    def retry_after_s(self) -> float:
        """Comeback hint attached to shed (503) responses: the queue's
        estimated drain time from the measured decode cadence — (depth +
        1) x mean decode-step wall — clamped to [0.05 s, 10 s] (0.5 s
        before any decode has been measured)."""
        with self._lock:          # the loop appends under it
            depth = len(self.scheduler.waiting)
            walls = tuple(self.decode_seconds)
        if walls:
            mean = sum(walls) / len(walls)
            return float(min(10.0, max(0.05, (depth + 1) * mean)))
        return 0.5

    # the queue-bound knobs live on the AdmissionCore
    @property
    def max_queue(self) -> Optional[int]:
        return self.admission.max_queue

    @max_queue.setter
    def max_queue(self, value: Optional[int]) -> None:
        self.admission.max_queue = value

    @property
    def slo_shed_min_queue(self) -> int:
        return self.admission.slo_shed_min_queue

    @slo_shed_min_queue.setter
    def slo_shed_min_queue(self, value: int) -> None:
        self.admission.slo_shed_min_queue = int(value)

    def submit(self, prompt, max_new_tokens: int = 32,
               temperature: float = 0.0, top_k: int = 0,
               eos_id: Optional[int] = None, stream_timeout: float = 120.0,
               request_id: Optional[str] = None,
               priority: Optional[int] = None,
               tenant: Optional[str] = None,
               request_class: str = "interactive",
               blame_seed: Optional[Dict[str, float]] = None
               ) -> GenerationStream:
        """Queue one request; returns its token stream.  Raises up front
        when the request can never run: ValueError for malformed
        prompts, `RequestTooLarge` (a ValueError; HTTP 413) when prompt +
        max_new_tokens exceed max_context or the whole block pool,
        `QueueFull` (HTTP 503) / `TenantQuotaExceeded` (HTTP 429) from
        the `AdmissionCore`'s queue, SLO and quota gates.  `request_id`
        is sanitized (one is made when absent) and readable from the
        returned stream's `.request_id`.  `tenant` charges its quota
        bucket and slices the SLO and blame planes; `request_class`
        ("interactive" | "batch" | "shadow") sets the scheduler priority
        (`priority`, when given, overrides it).  `blame_seed` ({phase:
        seconds}) records wait the request served before this submit (a
        router's re-queue after a replica died)."""
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
        with self._lock:
            cls_priority = self.admission.admit(
                len(self.scheduler.waiting), tenant=tenant,
                request_class=request_class)
            if priority is None:
                priority = cls_priority
            # the record opens once the request is taken, with the id
            # sanitized (or made) and kept through preemption
            rid = request_log.start(request_id, prompt_len=len(prompt),
                                    max_new_tokens=int(max_new_tokens),
                                    model=self.model_label, tenant=tenant,
                                    request_class=request_class,
                                    blame_seed=blame_seed)
            seq = Sequence(prompt, max_new_tokens=max_new_tokens,
                           temperature=temperature, top_k=top_k,
                           eos_id=eos_id, request_id=rid,
                           priority=priority)
            seq.stream = GenerationStream(seq, timeout=stream_timeout)
            if self.keep_logits:
                seq.logits = []
            self.scheduler.submit(seq)
            self.n_requests += 1
            self._c_requests.inc()
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
        if (self.prefix_cache is not None and seq.slot is not None
                and reason in ("length", "eos")):
            # decode wrote KV for every context token but the newest,
            # so the whole blocks of prompt + generated are publishable:
            # a follow-up request hits on this one's output too
            tokens = (seq.prompt + seq.generated)[:seq.context_len - 1]
            if len(tokens) >= self.cache.block_size:
                seq.block_table = self.prefix_cache.commit(
                    tokens, seq.block_table)
        self.scheduler.release(seq, reason)
        if seq.stream is not None:
            seq.stream._close()

    def _emit(self, seq: Sequence, token: int, logits=None) -> None:
        seq.generated.append(int(token))
        if seq.logits is not None and logits is not None:
            seq.logits.append(logits.clone())
        self.n_tokens += 1
        self._c_tokens.inc()
        request_log.token(seq.request_id)
        if seq.stream is not None:
            seq.stream._put(token)
        reason = seq.should_finish()
        if reason:
            self._finish(seq, reason)

    def _prefill_seq(self, seq: Sequence) -> None:
        rec = self._clock_prefill.begin(force_fence=True)
        t0 = now()
        ctx = seq.prompt + seq.generated
        L = len(ctx)
        bucket = self.scheduler.bucket_for(L)
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :L] = ctx
        table = np.zeros(self.scheduler.max_blocks_per_seq, np.int32)
        table[:len(seq.block_table)] = seq.block_table
        rec.lap("host_input")
        t1 = now()
        nxt, last = self._prefill_step(
            self._tensor(tokens), L, self._tensor(table),
            self._tensor(np.full(1, seq.temperature, np.float32)),
            self._tensor(np.full(1, seq.top_k, np.int32)))
        rec.cold = self._prefill_step.last_call_new
        rec.lap(None)
        nxt = int(nxt)            # token fetch = device fence
        rec.lap("device_compute")
        t2 = now()
        self.prefill_seconds.append((bucket, t2 - t0))
        dur = t2 - t1
        profiling.record_work(
            "prefill", dur, tokens=L,
            flops=self._flops.prefill(L) if self._flops else 0.0)
        self.n_prefills += 1
        self.n_prefill_tokens += L
        self._h_prefill.record(dur, L)
        self._c_prefill_tokens.inc(L)
        request_log.attribute(seq.request_id, "prefill_compute", dur)
        request_log.event(seq.request_id, "prefill", bucket=bucket,
                          tokens=L, dur_s=round(dur, 6),
                          resumed=seq.n_preempted > 0)
        self._emit(seq, nxt, last)
        rec.end()

    def _prefill_round(self) -> Tuple[bool, int]:
        """Spend this round's prefill token budget on the lanes still
        prefilling (admit order).  Without chunked prefill a lane's
        whole remaining tail is one chunk; with it chunks are capped at
        `_chunk_cap` tokens, so a long prompt yields to the decode step
        between chunks.  The head chunk always proceeds; the budget is
        charged at bucket granularity.  Returns (did work, leftover
        budget): the leftover is what the speculation round may spend
        on verify tokens."""
        did = False
        budget = self.scheduler.prefill_token_budget
        first = True
        for seq in self.scheduler.prefilling():
            while seq.status == "prefilling":
                remaining = seq.context_len - seq.prefill_pos
                cap = (min(remaining, self._chunk_cap)
                       if self.chunked_prefill else remaining)
                bucket = self.scheduler.bucket_for(cap)
                if not first and bucket > budget:
                    return did, 0
                self._prefill_chunk(seq, bucket)
                did = True
                first = False
                budget -= bucket
                if budget <= 0 and seq.status == "prefilling":
                    return did, 0
        return did, max(0, budget)

    def _prefill_chunk(self, seq: Sequence, bucket: int) -> None:
        """Write KV for the next `min(bucket, remaining)` context tokens;
        the final chunk commits the prompt's full blocks to the prefix
        cache, samples the first new token and flips the lane to
        running."""
        ctx = seq.prompt + seq.generated
        L = seq.context_len
        start = seq.prefill_pos
        real = min(bucket, L - start)
        final = start + real >= L
        # the final chunk fences on its token fetch.  A middle chunk
        # samples nothing: on the card it fences only at the clock's
        # sampled cadence, so the next chunk or decode is queued while
        # the card works; on the CPU its work is done when the call
        # returns, and every chunk is split as JAX splits it
        rec = self._clock_prefill.begin(
            force_fence=final or self.device.type != "cuda")
        t0 = now()
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :real] = ctx[start:start + real]
        table = np.zeros(self.scheduler.max_blocks_per_seq, np.int32)
        table[:len(seq.block_table)] = seq.block_table
        rec.lap("host_input")
        t1 = now()
        last = self._chunk_step(self._tensor(tokens), start, real,
                                self._tensor(table))
        rec.cold = self._chunk_step.last_call_new
        rec.lap(None)
        nxt = None
        if final:
            nxt = int(sample_tokens(
                last[None], self._gen,
                self._tensor(np.full(1, seq.temperature, np.float32)),
                self._tensor(np.full(1, seq.top_k, np.int32)))[0])
        elif rec.fenced and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t2 = now()
        dur = t2 - t1
        if rec.fenced:
            rec.lap("device_compute")
            profiling.record_work(
                "chunk_prefill", dur, tokens=real,
                flops=(self._flops.prefill(real, ctx_start=start)
                       if self._flops else 0.0))
        self.n_chunks += 1
        self.n_prefill_tokens += real
        self._h_prefill.record(dur, real)
        self._c_prefill_tokens.inc(real)
        seq.prefill_pos = start + real
        request_log.attribute(seq.request_id, "prefill_compute", dur)
        request_log.event(seq.request_id, "prefill", bucket=bucket,
                          tokens=real, start=start, dur_s=round(dur, 6),
                          resumed=seq.n_preempted > 0)
        if final:
            self.prefill_seconds.append((bucket, t2 - t0))
            if self.prefix_cache is not None:
                # the prompt's KV is written: publish its full blocks
                # (deduping against identical prefixes committed since
                # this lane's lookup)
                seq.block_table = self.prefix_cache.commit(
                    seq.prompt, seq.block_table)
            seq.status = "running"
            self._emit(seq, nxt, last)
        rec.end()

    # ------------------------------------------------------------------
    # host-tier restore (the device half; PrefixCache.restore calls it
    # through `restore_writer`)
    # ------------------------------------------------------------------

    def _host_restore_write(self, block: int, entry) -> bool:
        """Land one host-tier entry's KV rows (and scales) in pool block
        `block`, from the copy `_stage_host_restores` started when there
        is one (the compute stream waits on its event), else by a copy
        made now.  Returns False when the entry does not fit this pool:
        the caller recomputes."""
        bs = self.cache.block_size
        kv = self.cache.kv
        rows_shape = (kv.shape[0], 2, bs) + tuple(kv.shape[3:])
        if tuple(entry.kv.shape) != rows_shape or entry.kv.dtype != kv.dtype:
            return False
        if self._quantized and (entry.scale is None
                                or tuple(entry.scale.shape)
                                != rows_shape[:3]):
            return False
        t0 = now()
        staged = entry.staged_kv is not None
        if staged:
            rows, srows = entry.staged_kv, entry.staged_scale
            if entry.staged_event is not None:
                # the staged copy ran on a side stream: order the read
                # after it, and keep its memory from reuse until the
                # read is done
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(entry.staged_event)
                rows.record_stream(cur)
                if srows is not None:
                    srows.record_stream(cur)
        else:
            rows = entry.kv.to(self.device)
            srows = (entry.scale.to(self.device) if self._quantized
                     else None)
        self._restore_block_step(block, rows, srows)
        entry.staged_kv = entry.staged_scale = entry.staged_event = None
        self.n_host_restores += 1
        self.n_host_restores_staged += staged
        dur = now() - t0
        record_dma("host_restore", dur, entry.nbytes, staged=staged)
        profiling.record_work("host_restore", dur)
        # the scheduler names the beneficiary while the restore runs
        request_log.attribute(
            getattr(self.prefix_cache, "restoring_for", None),
            "host_restore", dur)
        return True

    def _stage_host_restores(self) -> None:
        """Start the copies to the card of host-resident prefix
        extensions for the waiting heads before admission, so the copy
        overlaps the round.  A staged entry that loses the race to an
        eviction is refetched as a miss (the lane recomputes)."""
        tier = self.host_tier
        if tier is None or not self.scheduler.waiting:
            return
        for seq in list(self.scheduler.waiting)[:4]:
            ctx = seq.prompt + seq.generated
            try:
                tier.stage_prefix(ctx, self.prefix_cache.peek(ctx),
                                  device=self.device)
            except torch.OutOfMemoryError:
                # staging is advisory: the restore copies synchronously
                return

    def _apply_cow(self) -> None:
        """Copy each shared block the scheduler un-shared into the fresh
        block the lane's table now points at (the device half of
        `SlotScheduler.resolve_write_conflicts`)."""
        for _seq, _idx, src, dst in \
                self.scheduler.resolve_write_conflicts():
            t0 = now()
            self._copy_block_step(src, dst)
            profiling.record_work("copy_block", now() - t0)
            self.n_cow_copies += 1
            if self._c_cow is not None:
                self._c_cow.inc()

    def _spec_round(self, budget: int) -> set:
        """One speculative-decoding pass over the running lanes: draft
        (greedy lanes out of their cooldown with an n-gram match), grow
        each drafted lane's table to cover its draft, score every
        drafted lane in ONE verify dispatch, emit each lane's accepted
        prefix plus the bonus token, and roll back the blocks past the
        next write.  Verify tokens charge `budget` (the prefill round's
        leftover) at bucket granularity.

        Every other greedy running lane rides the same dispatch as a
        length-1 row (its position-0 argmax is its decode token), so a
        verify round REPLACES the decode round for greedy lanes: a
        round whose drafts are all rejected costs one wider dispatch,
        not two.  Returns the lanes that advanced this round; `step()`
        leaves them out of the decode step."""
        done: set = set()
        spec = self.speculation
        drafted = []                  # (seq, state, draft)
        for seq in self.scheduler.running():
            if seq.temperature > 0:
                continue              # greedy lanes only
            st = spec.state(seq)
            if st.cooldown > 0:
                st.cooldown -= 1
                self.n_spec_parked += 1
                continue
            draft = spec.draft_for(seq)
            if not draft:
                continue
            bucket = spec.bucket_for(len(draft))
            if 1 + bucket > budget:
                continue              # out of this round's budget
            if not self.scheduler.grow_for_speculation(
                    seq, seq.context_len - 1 + len(draft)):
                continue              # pool too tight: decode normally
            budget -= 1 + bucket
            drafted.append((seq, st, draft))
        if not drafted:
            return done
        in_grid = {seq for seq, _st, _d in drafted}
        riders = [seq for seq in self.scheduler.running()
                  if seq.temperature <= 0 and seq not in in_grid]
        rec = self._clock_spec.begin(force_fence=True)
        try:
            # an injected raise costs one round's speculation: nothing
            # was emitted or written yet, so the drafted lanes rewind
            # their grown blocks and take the decode step
            fault_point("generation.spec_verify",
                        n_lanes=len(drafted) + len(riders))
        except FaultInjected:
            for seq, _st, _draft in drafted:
                self.scheduler.rollback_speculation(seq)
            rec.end()
            return done
        t0 = now()
        S = self.max_slots
        MB = self.scheduler.max_blocks_per_seq
        W = 1 + spec.bucket_for(max(len(d) for _, _, d in drafted))
        tokens = np.zeros((S, W), np.int32)
        tables = np.zeros((S, MB), np.int32)
        start = np.zeros(S, np.int32)
        length = np.zeros(S, np.int32)
        active = np.zeros(S, bool)
        rows = [(seq, draft) for seq, _st, draft in drafted] \
            + [(seq, []) for seq in riders]
        for seq, draft in rows:
            i = seq.slot
            tokens[i, 0] = seq.generated[-1] if seq.generated \
                else seq.prompt[-1]
            tokens[i, 1:1 + len(draft)] = draft
            tables[i, :len(seq.block_table)] = seq.block_table
            start[i] = seq.context_len - 1
            length[i] = 1 + len(draft)
            active[i] = True
        rec.lap("host_input")
        t1 = now()
        greedy, logits = self._verify_step(
            self._tensor(tokens), self._tensor(tables),
            self._tensor(start), self._tensor(length),
            self._tensor(active))
        rec.cold = self._verify_step.last_call_new
        rec.lap(None)
        greedy = greedy.cpu().numpy()   # token fetch = device fence
        rec.lap("device_compute")
        t2 = now()
        self.verify_seconds.append(t2 - t0)
        dur = t2 - t1
        n_rows = len(drafted) + len(riders)
        ctx_mean = float(np.sum(start[active])) / n_rows
        profiling.record_work(
            "spec_verify", dur, tokens=int(np.sum(length[active])),
            flops=(self._flops.verify(n_rows, W, ctx_mean)
                   if self._flops else 0.0))
        self.n_verify_steps += 1
        self._h_decode.record(dur, n_rows)
        for seq in riders:
            # an ordinary decode in verify clothing: no speculation
            # budget, counters or rollback
            request_log.decode_round(seq.request_id)
            request_log.attribute(seq.request_id, "decode_active", dur)
            done.add(seq)
            self._emit(seq, int(greedy[seq.slot, 0]), logits[seq.slot, 0])
        for seq, st, draft in drafted:
            i = seq.slot
            m = 0
            while m < len(draft) and draft[m] == greedy[i, m]:
                m += 1
            st.record(len(draft), m)
            self.n_spec_rounds += 1
            self.n_spec_proposed += len(draft)
            self.n_spec_accepted += m
            self._c_spec_rounds.inc()
            self._c_spec_proposed.inc(len(draft))
            self._c_spec_accepted.inc(m)
            self._h_spec_accepted.record(m)
            n = st.rounds
            if n & (n - 1) == 0:      # pow2-sampled, like decode
                request_log.event(seq.request_id, "spec_propose",
                                  round=n, proposed=len(draft))
                request_log.event(seq.request_id, "spec_accept",
                                  round=n, accepted=m)
            request_log.decode_round(seq.request_id, spec=True)
            # the verify round's wall split: the accepted prefix and
            # the bonus token are useful decode ((m + 1) of the k + 1
            # scored positions), the rejected rest speculation overhead
            k1 = 1 + len(draft)
            request_log.attribute(seq.request_id, "decode_active",
                                  dur * (m + 1) / k1)
            request_log.attribute(seq.request_id, "spec_verify_overhead",
                                  dur * (len(draft) - m) / k1)
            done.add(seq)
            # the accepted prefix + the bonus token: exactly what greedy
            # single-step decode gives, stopping at eos / length
            for j in range(m + 1):
                self._emit(seq, int(greedy[i, j]), logits[i, j])
                if seq.status == "finished":
                    break
            if seq.status != "finished":
                self.scheduler.rollback_speculation(seq)
        rec.end()
        return done

    def _decode_all(self, skip: frozenset = frozenset()) -> None:
        rec = self._clock_decode.begin(force_fence=True)
        t0 = now()
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
            if seq in skip:
                continue              # already advanced by verify
            i = seq.slot
            lanes[i] = seq
            tokens[i] = seq.generated[-1] if seq.generated \
                else seq.prompt[-1]
            tables[i, :len(seq.block_table)] = seq.block_table
            ctx_len[i] = seq.context_len - 1    # the pending position
            active[i] = True
            temp[i] = seq.temperature
            top_k[i] = seq.top_k
        # nothing is written before this point: a raise here leaves every
        # lane as it was, and a poisoned request's eviction lets the
        # others decode next round
        rec.lap("host_input")
        fault_point("generation.decode",
                    request_ids=[s.request_id for s in lanes.values()])
        t1 = now()
        nxt, last = self._decode_step(
            self._tensor(tokens), self._tensor(tables),
            self._tensor(ctx_len), self._tensor(active),
            self._tensor(temp), self._tensor(top_k))
        rec.cold = self._decode_step.last_call_new
        rec.lap(None)
        nxt = nxt.cpu().numpy()   # token fetch = device fence
        rec.lap("device_compute")
        t2 = now()
        self.decode_seconds.append(t2 - t0)
        dur = t2 - t1
        ctx_mean = (float(np.sum(ctx_len[active])) / len(lanes)
                    if lanes else 0.0)
        profiling.record_work(
            "decode", dur, tokens=len(lanes),
            flops=(self._flops.decode(len(lanes), ctx_mean)
                   if self._flops else 0.0))
        self.n_decode_steps += 1
        self._h_decode.record(dur, len(lanes))
        for i, seq in lanes.items():
            request_log.decode_round(seq.request_id)
            # every riding lane waited out the whole fenced round
            request_log.attribute(seq.request_id, "decode_active", dur)
            self._emit(seq, nxt[i], last[i])
        rec.end()

    @torch.no_grad()
    def step(self) -> bool:
        """One scheduling round: stage host-tier restores → admit →
        prefill (whole prompts, or budget-bounded chunks with prefix
        reuse) → grow/preempt for decode capacity → copy-on-write →
        speculative verify → one decode step for the lanes verify did
        not advance.  Returns whether any device work ran."""
        with self._lock:
            did = False
            spec_budget = self.scheduler.prefill_token_budget
            if self.host_tier is not None:
                self._stage_host_restores()
            admitted = self.scheduler.admit()
            if self._use_chunks:
                did, spec_budget = self._prefill_round()
            else:
                for seq in admitted:
                    self._prefill_seq(seq)
                    did = True
            self.scheduler.ensure_decode_capacity()
            if self.prefix_cache is not None:
                self._apply_cow()
            advanced: set = set()
            if self.speculation is not None and self.scheduler.running():
                advanced = self._spec_round(spec_budget)
                did = did or bool(advanced)
            if any(s not in advanced for s in self.scheduler.running()):
                try:
                    self._decode_all(skip=frozenset(advanced))
                except PoisonedRequestError as e:
                    self._evict_poisoned(e)
                did = True
            if self.watchdog is not None:
                self.watchdog.beat()
            return did

    def _evict_poisoned(self, e: PoisonedRequestError) -> None:
        """A step failure attributable to ONE request evicts exactly that
        request (its stream ends with finish_reason "error: evicted
        (...)", its record tagged 503, a flight bundle written); the
        engine keeps serving everyone else.  Caller holds the lock."""
        _log.warning("evicting request %s: %s", e.request_id, e)
        self.n_evictions += 1
        get_registry().counter(
            "resilience_evictions_total",
            help="requests evicted individually after an attributable "
                 "step failure (engine kept serving)").inc()
        log_event("generation_request_evicted",
                  request_id=e.request_id, error=str(e))
        request_log.event(e.request_id, "evicted", code=503,
                          error=str(e))
        flight_recorder.dump(
            "generation_request_evicted",
            extra={"request_id": e.request_id, "error": str(e)})
        for seq in self.scheduler.running():
            if seq.request_id == e.request_id:
                self._finish(seq, f"error: evicted ({e})")
                return

    def run_until_idle(self, max_steps: int = 1_000_000) -> None:
        if self.watchdog is not None:
            self.watchdog.arm()
        try:
            for _ in range(max_steps):
                if not self.scheduler.has_work():
                    return
                if not self.step():
                    stuck_ids = [s.request_id
                                 for s in self.scheduler.waiting]
                    for rid in stuck_ids:
                        request_log.event(rid, "stuck")
                    log_event("generation_stuck", waiting=len(stuck_ids),
                              request_ids=stuck_ids)
                    flight_recorder.dump(
                        "generation_stuck",
                        extra={"waiting": len(stuck_ids),
                               "request_ids": stuck_ids})
                    raise RuntimeError(
                        "generation engine stuck: waiting requests but no "
                        "schedulable work (block pool too small?)")
            raise RuntimeError(f"still busy after {max_steps} steps")
        finally:
            if self.watchdog is not None:
                self.watchdog.disarm()

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
            # durable telemetry: this loop's registry spooled (with
            # observability_dir, time-gated) and sampled into the
            # metrics history (with metrics_history_interval_s)
            maybe_spool(self.spool_name, (self.registry,))
            maybe_record((self.registry,))
            if not self.scheduler.has_work():
                if self.watchdog is not None:
                    # idle is not a stall: disarmed until work arrives
                    self.watchdog.disarm()
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            if self.watchdog is not None:
                self.watchdog.arm()
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
                            head = self.scheduler.waiting.popleft()
                            log_event("generation_stuck",
                                      request_ids=[head.request_id],
                                      waiting=len(
                                          self.scheduler.waiting) + 1)
                            request_log.event(head.request_id, "stuck")
                            flight_recorder.dump(
                                "generation_stuck",
                                extra={"request_ids": [head.request_id]})
                            self._finish(
                                head, "error: engine stuck (request "
                                "cannot be scheduled)")
            except Exception as e:   # fail the lanes loudly, keep serving
                _log.exception("generation step failed")
                affected = [s.request_id for s in self.scheduler.slotted()]
                log_event("generation_step_error",
                          error=f"{type(e).__name__}: {e}",
                          request_ids=affected)
                flight_recorder.dump("generation_step_error", exc=e,
                                     extra={"request_ids": affected})
                with self._lock:
                    for seq in list(self.scheduler.slotted()):
                        self._finish(seq, f"error: {e}")

    def consume_stream(self, stream, out_stream=None, **kw):
        """Attach this engine to a durable stream as a consumer-group
        member: each leased record's prompt is submitted under the
        stable id ``strm-<stream>-<record id>``, its tokens land in
        `out_stream`, and only then is the record acked (a replica dying
        mid-record leaves the lease to expire and the record replays
        under the same id).  Returns the started `StreamConsumer`."""
        from analytics_zoo_tpu_torch.serving.streaming.consumer import (
            generation_consumer,
        )
        return generation_consumer(stream, self, out_stream=out_stream,
                                   **kw)

    def stop(self) -> None:
        """Stop the background loop and close every stream still open."""
        self._stop.set()
        self._wake.set()
        if self.watchdog is not None:
            self.watchdog.stop()
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
