"""Profiling plane (a copy of analytics_zoo_tpu/observability/
profiling.py): the dispatch ledger, signature forensics and MFU.

**Dispatch ledger.**  Every named step family is wrapped once by
`instrument(family, fn)`; the family names are the closed set
`DISPATCH_FAMILIES`, JAX's eight.  Each call records its count and
argument bytes (derived per signature, so the hot path never re-walks
buffer sizes); the surrounding loop reports its FENCED wall and its
token/FLOP work through `record_work(family, dur_s, ...)` (a call
returns before the card finishes, so only the caller's fence-to-fence
wall is honest).  Per-family wall and work land in bounded reservoirs
and the ``dispatch_*`` metric family.

**Signature forensics.**  The wrapper derives each call's abstract
signature from the arguments' `.shape` and `.dtype` alone (leaf path,
shape, dtype; Python scalars by type, other statics by value), never
reading a tensor's value, which would wait on the card.  Leaves are the
tensors and arrays of nested dicts (keys in sorted order), lists and
tuples, with JAX's path strings (``batch['features'][0]``) and dtype
names (``float32``, ``int32``, ``bfloat16``), so the same arrays give
the same signature in both packages.  A signature never seen by the
family is a "compile event": JAX's jit compiles a program there; the
port's counterpart is the first dispatch of that signature, where a
kernel first launched at a new shape is built.  The event (family,
signature, first-call seconds, callsite) is appended to a bounded log
and, on any event after the family's first, a differ names the leaf
that changed (path, old shape/dtype -> new).  A step whose shapes never
change has exactly one event.  Events tick ``compile_events_total`` /
``compile_seconds_total``.

**MFU.**  `CausalLMFlops` is the analytic FLOPs model of prefill,
decode and verify (matmul and attention terms from the model's
widths); the train engine uses the standard ``6·P`` train / ``2·P``
eval FLOPs per token (`train_step_flops`).  Analytic FLOPs over the
ledger's measured wall give the ``mfu_ratio`` / ``mfu_decode`` /
``mfu_prefill`` gauges and the ``model_flops_total`` counter, against
``OrcaContext.hardware_peak_flops`` (default `DEFAULT_PEAK_FLOPS`).
"""

from __future__ import annotations

import threading
import time
import traceback
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.observability.registry import get_registry, now

#: Registered dispatch-ledger family names: the closed set
#: `instrument()` / `record_work()` accept (JAX's eight).
DISPATCH_FAMILIES = (
    "prefill",        # whole-prompt prefill, one signature per bucket
    "chunk_prefill",  # chunked/prefix-cached prefill chunk step
    "decode",         # the one-signature batched decode step
    "spec_verify",    # speculative verify, one signature per k-bucket
    "copy_block",     # prefix-cache copy-on-write block copy
    "host_restore",   # host-KV-tier restore writer
    "train_step",     # TrainEngine training step
    "eval_step",      # TrainEngine evaluation step
)

#: Hardware peak used for MFU when `OrcaContext.hardware_peak_flops`
#: is unset: 1 TFLOP/s, a round placeholder so CPU MFU numbers stay
#: comparable, not a real roofline.
DEFAULT_PEAK_FLOPS = 1.0e12

#: bounded per-family call reservoir (timeline + percentiles)
RESERVOIR = 256

#: bounded compile-event log
MAX_COMPILE_EVENTS = 256


def peak_flops() -> float:
    """The configured hardware peak (FLOP/s) MFU is computed against."""
    try:
        from analytics_zoo_tpu_torch.common.context import OrcaContext
        v = OrcaContext.hardware_peak_flops
        if v:
            return float(v)
    except Exception:
        pass
    return DEFAULT_PEAK_FLOPS


# ----------------------------------------------------------------------
# abstract signatures + the differ
# ----------------------------------------------------------------------

def _dtype_name(dtype) -> str:
    """JAX's dtype string: ``float32``, not ``torch.float32``."""
    return str(dtype).replace("torch.", "")


def _leaf_abstract(leaf: Any) -> Tuple[Any, ...]:
    """Hashable abstract view of one argument leaf.  Tensors and arrays
    by shape/dtype; Python numbers by type only (their values do not
    change the program); other statics by repr (they do)."""
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is not None and dtype is not None:
        return ("array", tuple(int(d) for d in shape), _dtype_name(dtype))
    if isinstance(leaf, bool):
        return ("py", "bool")
    if isinstance(leaf, (int, float, complex)):
        return ("py", type(leaf).__name__)
    return ("static", repr(leaf))


def _leaf_str(abstract: Tuple[Any, ...]) -> str:
    """Render one abstract leaf the way the forensics log prints it:
    ``int32[4,16]`` for arrays, ``py:int`` / ``static:...`` else."""
    if abstract[0] == "array":
        return "%s[%s]" % (abstract[2],
                           ",".join(str(d) for d in abstract[1]))
    return ":".join(str(p) for p in abstract)


def flatten_with_paths(tree: Any, prefix: str = ""
                       ) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs of a nested structure, in the order and with
    the path strings of `jax.tree_util.tree_flatten_with_path` and
    `keystr`: dicts by sorted key (``['name']``), lists and tuples by
    index (``[0]``); None holds no leaf; anything else (a tensor, an
    array, a scalar) is a leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(flatten_with_paths(tree[k], f"{prefix}[{k!r}]"))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(flatten_with_paths(v, f"{prefix}[{i}]"))
        return out
    return [(prefix, tree)]


def abstract_signature(args: Sequence[Any],
                       argnames: Optional[Sequence[str]] = None
                       ) -> Tuple[Tuple[str, Tuple[Any, ...]], ...]:
    """The abstract signature of a positional-arg tuple: one
    ``(path, abstract-leaf)`` per leaf, paths rooted at the argument
    name when `argnames` is given (else the position)."""
    out: List[Tuple[str, Tuple[Any, ...]]] = []
    for i, arg in enumerate(args):
        root = (argnames[i] if argnames is not None
                and i < len(argnames) else f"arg{i}")
        for path, leaf in flatten_with_paths(arg, root):
            out.append((path, _leaf_abstract(leaf)))
    return tuple(out)


def diff_signatures(old, new) -> List[Dict[str, Optional[str]]]:
    """Name the exact leaves that changed between two signatures: changed
    leaves as ``{path, old, new}`` (shape/dtype strings), added/removed
    leaves with the missing side None."""
    old_map = dict(old)
    new_map = dict(new)
    diffs: List[Dict[str, Optional[str]]] = []
    for path, ab in new_map.items():
        prev = old_map.get(path)
        if prev is None:
            diffs.append({"path": path, "old": None,
                          "new": _leaf_str(ab)})
        elif prev != ab:
            diffs.append({"path": path, "old": _leaf_str(prev),
                          "new": _leaf_str(ab)})
    for path, ab in old_map.items():
        if path not in new_map:
            diffs.append({"path": path, "old": _leaf_str(ab),
                          "new": None})
    diffs.sort(key=lambda d: d["path"])
    return diffs


def _itemsize(name: str) -> int:
    """Bytes per element of a dtype name (torch's names first: numpy
    has no bfloat16 of its own)."""
    dt = getattr(torch, name, None)
    if isinstance(dt, torch.dtype):
        return dt.itemsize
    try:
        return np.dtype(name).itemsize
    except TypeError:
        return 1


def _signature_bytes(sig) -> int:
    """Total argument bytes of one signature (arrays only), computed
    once per signature and reused for every call carrying it."""
    total = 0
    for _path, ab in sig:
        if ab[0] == "array":
            n = 1
            for d in ab[1]:
                n *= int(d)
            total += n * _itemsize(ab[2])
    return total


# ----------------------------------------------------------------------
# the ledger
# ----------------------------------------------------------------------

class _Family:
    """Per-family accumulators and a bounded call reservoir."""

    __slots__ = ("name", "calls", "wall_s", "bytes_total",
                 "flops_total", "tokens_total", "work_calls",
                 "signatures", "compile_count", "compile_seconds",
                 "reservoir", "last_event", "expected")

    def __init__(self, name: str):
        self.name = name
        #: declared signature budget (None = undeclared): the variants
        #: the call-site geometry implies (prefill's bucket count,
        #: decode's 1), so the ledger flags a family past it
        self.expected: Optional[int] = None
        self.calls = 0
        self.wall_s = 0.0
        self.bytes_total = 0
        self.flops_total = 0.0
        self.tokens_total = 0
        self.work_calls = 0
        #: signature -> arg bytes (insertion-ordered ≈ compile order)
        self.signatures: Dict[Tuple, int] = {}
        self.compile_count = 0
        self.compile_seconds = 0.0
        #: (wall ts at record, fenced dur_s, tokens) — newest kept
        self.reservoir: "deque[Tuple[float, float, int]]" = deque(
            maxlen=RESERVOIR)
        self.last_event: Optional[Dict[str, Any]] = None

    def mfu(self) -> float:
        if self.wall_s <= 0.0 or self.flops_total <= 0.0:
            return 0.0
        return self.flops_total / self.wall_s / peak_flops()

    def snapshot(self) -> Dict[str, Any]:
        res = list(self.reservoir)
        durs = sorted(d for _t, d, _n in res)
        mid = durs[len(durs) // 2] if durs else 0.0
        p99 = durs[min(len(durs) - 1,
                       int(0.99 * len(durs)))] if durs else 0.0
        out = {
            "calls": self.calls,
            "work_calls": self.work_calls,
            "wall_s": round(self.wall_s, 6),
            "mean_ms": round(self.wall_s / self.work_calls * 1e3, 3)
            if self.work_calls else 0.0,
            "p50_ms": round(mid * 1e3, 3),
            "p99_ms": round(p99 * 1e3, 3),
            "bytes_total": int(self.bytes_total),
            "tokens_total": int(self.tokens_total),
            "model_flops_total": float(self.flops_total),
            "mfu": round(self.mfu(), 6),
            "signatures": len(self.signatures),
            "compile_count": self.compile_count,
            "compile_seconds": round(self.compile_seconds, 6),
        }
        if self.expected is not None:
            out["expected_variants"] = self.expected
            out["over_budget"] = self.compile_count > self.expected
        if self.last_event is not None:
            out["last_compile"] = self.last_event
        return out


_lock = threading.Lock()
_families: Dict[str, _Family] = {}
_compile_events: "deque[Dict[str, Any]]" = deque(
    maxlen=MAX_COMPILE_EVENTS)
_metrics_installed = False


def _install_metrics() -> None:
    """Register the fn-backed gauges once (counters are ticked at
    record time; gauges read the ledger live)."""
    global _metrics_installed
    if _metrics_installed:
        return
    _metrics_installed = True
    reg = get_registry()
    reg.gauge("mfu_ratio", fn=lambda: _mfu_over(None),
              help="measured model FLOP/s over the configured "
                   "hardware peak, all ledger families combined")
    reg.gauge("mfu_decode", fn=lambda: _mfu_over(("decode",)),
              help="decode-step MFU: analytic decode FLOPs over "
                   "fenced decode wall, vs hardware peak")
    reg.gauge("mfu_prefill",
              fn=lambda: _mfu_over(("prefill", "chunk_prefill")),
              help="prefill MFU over both prefill program families")


def _mfu_over(names: Optional[Tuple[str, ...]]) -> float:
    with _lock:
        fams = [f for f in _families.values()
                if names is None or f.name in names]
        flops = sum(f.flops_total for f in fams)
        wall = sum(f.wall_s for f in fams if f.flops_total > 0.0)
    if wall <= 0.0 or flops <= 0.0:
        return 0.0
    return flops / wall / peak_flops()


def _family(name: str) -> _Family:
    if name not in DISPATCH_FAMILIES:
        raise ValueError(
            f"unknown dispatch family {name!r}: add it to "
            "profiling.DISPATCH_FAMILIES")
    with _lock:
        fam = _families.get(name)
        if fam is None:
            fam = _families[name] = _Family(name)
    _install_metrics()
    return fam


def _callsite() -> str:
    """First stack frame outside this module — where the compiling
    dispatch came from.  Compared by exact path: a suffix match would
    also swallow frames of files merely NAMED like this one (the test
    file tests/test_profiling.py, for instance)."""
    for fr in reversed(traceback.extract_stack(limit=12)):
        if fr.filename != __file__:
            return f"{fr.filename}:{fr.lineno}"
    return "?"


class LedgeredFunction:
    """The step wrapper: forwards calls to the wrapped callable, derives
    each call's abstract signature, and records a compile event for a
    signature the family has not dispatched before.  `last_call_new`
    says whether the latest call was the first through THIS wrapper
    with its signature: the owner's first dispatch at those shapes,
    where the kernels' first launch builds them (JAX: a jitted entry
    point's own cache).  The owners flag their step spans and goodput
    laps with it.  With `family` None the wrapper keeps that flag alone
    and writes nothing to the ledger (the train engine's predict
    forward, which JAX does not ledger)."""

    def __init__(self, family: Optional[str], fn: Callable,
                 argnames: Optional[Sequence[str]] = None):
        self.family = family
        self.fn = fn
        self.argnames = tuple(argnames) if argnames else None
        self._fam = _family(family) if family is not None else None
        #: the signatures dispatched through this wrapper
        self._seen: set = set()
        self.last_call_new = False

    def __call__(self, *args):
        fam = self._fam
        sig = abstract_signature(args, self.argnames)
        first = sig not in self._seen
        if fam is None:
            out = self.fn(*args)
            self._seen.add(sig)
            self.last_call_new = first
            return out
        with _lock:
            known = sig in fam.signatures
        t0 = now()
        out = self.fn(*args)
        dur = now() - t0
        self._seen.add(sig)
        self.last_call_new = first
        if not known:
            _record_compile(fam, sig, dur, _callsite())
        reg = get_registry()
        with _lock:
            fam.calls += 1
            fam.bytes_total += fam.signatures.get(sig, 0)
        reg.counter(
            "dispatch_calls_total",
            help="ledgered step dispatches, all families").inc()
        reg.counter(
            f"dispatch_{fam.name}_calls_total",
            help=f"{fam.name} program dispatches").inc()
        return out


def _record_compile(fam: _Family, sig, dur_s: float,
                    callsite: str) -> None:
    """Append one compile event (with the signature diff when this is
    not the family's first signature) and tick the forensics metrics."""
    with _lock:
        prev = (next(reversed(fam.signatures))
                if fam.signatures else None)
        fam.signatures[sig] = _signature_bytes(sig)
        fam.compile_count += 1
        fam.compile_seconds += dur_s
        event: Dict[str, Any] = {
            "ts": round(time.time(), 6),
            "family": fam.name,
            "n": fam.compile_count,
            "compile_s": round(dur_s, 6),
            "callsite": callsite,
            "signature": [(p, _leaf_str(ab)) for p, ab in sig],
        }
        if prev is not None:
            event["diff"] = diff_signatures(prev, sig)
        fam.last_event = {k: v for k, v in event.items()
                          if k != "signature"}
        _compile_events.append(event)
    reg = get_registry()
    reg.counter("compile_events_total",
                help="first dispatches of a new signature across all "
                     "ledgered families").inc()
    reg.counter("compile_seconds_total",
                help="wall seconds spent inside first dispatches of a "
                     "new signature").inc(max(0.0, dur_s))
    if fam.compile_count > 1:
        # a second signature for a family is what the forensics exist
        # for: leave a breadcrumb on the flight ring too
        try:
            from analytics_zoo_tpu_torch.observability import flight_recorder
            first = (event.get("diff") or [{}])[0]
            flight_recorder.record(
                "compile", family=fam.name, n=fam.compile_count,
                compile_s=event["compile_s"],
                path=str(first.get("path", "")),
                old=str(first.get("old", "")),
                new=str(first.get("new", "")))
        except Exception:
            pass


def instrument(family: Optional[str], fn: Callable,
               argnames: Optional[Sequence[str]] = None
               ) -> LedgeredFunction:
    """Register `fn` (a step callable) under a dispatch-ledger family
    (None: track its first dispatches only).  The wrapper adds one
    signature derivation per call."""
    return LedgeredFunction(family, fn, argnames)


def declare_expected(family: str, n_variants: int) -> None:
    """Declare a family's signature budget: how many variants its
    call-site geometry implies (the scheduler's prefill bucket count,
    speculation's verify k-bucket count, decode's 1).  Snapshot rows
    then carry ``expected_variants`` / ``over_budget``."""
    fam = _family(family)
    with _lock:
        fam.expected = int(n_variants)


def record_work(family: str, dur_s: float, tokens: int = 0,
                flops: float = 0.0) -> None:
    """Report one fenced unit of work for a family: the surrounding
    loop's measured wall (dispatch → device fence) plus the analytic
    token/FLOP content.  This is the wall MFU divides by: a wrapped
    call returns before the card finishes, and its time would overstate
    MFU."""
    fam = _family(family)
    with _lock:
        fam.work_calls += 1
        fam.wall_s += max(0.0, dur_s)
        fam.tokens_total += int(tokens)
        fam.flops_total += float(flops)
        fam.reservoir.append((time.time(), max(0.0, dur_s),
                              int(tokens)))
    reg = get_registry()
    reg.counter(
        f"dispatch_{family}_wall_seconds_total",
        help=f"fenced wall seconds attributed to the {family} "
             "program family").inc(max(0.0, dur_s))
    if flops:
        reg.counter(
            "model_flops_total",
            help="analytic model FLOPs executed (CausalLMFlops / "
                 "the train engine's 6P·tokens)").inc(float(flops))


# ----------------------------------------------------------------------
# snapshots (server block, flight bundles, timeline)
# ----------------------------------------------------------------------

def ledger_snapshot() -> Dict[str, Any]:
    """Per-family ledger rows, the MFU block and the compile-event tail
    (the server's ``GET /dispatch`` payload)."""
    with _lock:
        fams = {name: fam.snapshot()
                for name, fam in _families.items()}
        events = list(_compile_events)
    return {
        "families": fams,
        "peak_flops": peak_flops(),
        "mfu": {"overall": round(_mfu_over(None), 6),
                "decode": round(_mfu_over(("decode",)), 6),
                "prefill": round(
                    _mfu_over(("prefill", "chunk_prefill")), 6)},
        "compile_events_total": sum(
            f["compile_count"] for f in fams.values()),
        "compile_seconds_total": round(sum(
            f["compile_seconds"] for f in fams.values()), 6),
        "compile_events": events[-64:],
    }


def compile_events(n: Optional[int] = None) -> List[Dict[str, Any]]:
    """The compile-event log, oldest first (bounded)."""
    with _lock:
        events = list(_compile_events)
    return events[-int(n):] if n is not None else events


def recent_calls(n: Optional[int] = None
                 ) -> List[Tuple[str, float, float, int]]:
    """(family, wall_ts, dur_s, tokens) across all family reservoirs,
    oldest first (the timeline export's feed)."""
    with _lock:
        rows = [(fam.name, ts, dur, tok)
                for fam in _families.values()
                for ts, dur, tok in fam.reservoir]
    rows.sort(key=lambda r: r[1])
    return rows[-int(n):] if n is not None else rows


def registered_families() -> Tuple[str, ...]:
    """Families that have actually registered (subset of
    `DISPATCH_FAMILIES`), registration order."""
    with _lock:
        return tuple(_families)


def reset_profiling() -> None:
    """Drop all ledger/forensics state (tests).  Metric registrations
    persist — the fn-backed gauges simply read an empty ledger."""
    with _lock:
        _families.clear()
        _compile_events.clear()


# ----------------------------------------------------------------------
# analytic FLOPs models
# ----------------------------------------------------------------------

class CausalLMFlops:
    """Analytic per-token FLOPs of the serving `CausalLM`: the
    standard decomposition into a context-independent matmul term
    (QKV/proj/MLP/head, 2·m·n per m×n matmul) and a context-linear
    attention term (QKᵀ + weighted-V ≈ 4·ctx·hidden per layer).
    Embedding lookups and LayerNorms are dropped (≪1%)."""

    def __init__(self, vocab: int, hidden_size: int, n_block: int,
                 intermediate_size: int):
        self.vocab = int(vocab)
        self.hidden = int(hidden_size)
        self.n_block = int(n_block)
        self.intermediate = int(intermediate_size)
        H, I = self.hidden, self.intermediate
        #: per-token matmul FLOPs: qkv (H→3H) + proj (H→H) + fc1/fc2
        #: (H→I→H) per block, + the lm head (H→vocab)
        self.matmul_per_token = (
            self.n_block * (2 * H * 3 * H + 2 * H * H
                            + 2 * H * I + 2 * I * H)
            + 2 * H * self.vocab)

    @classmethod
    def from_model(cls, model: Any) -> "CausalLMFlops":
        return cls(model.vocab, model.hidden_size, model.n_block,
                   model.intermediate_size)

    def _attention(self, ctx: float) -> float:
        return self.n_block * 4.0 * max(0.0, float(ctx)) * self.hidden

    def prefill(self, n_tokens: int, ctx_start: int = 0) -> float:
        """FLOPs of prefilling `n_tokens` positions starting at
        context offset `ctx_start` (chunked prefill passes the chunk's
        start).  Attention sums over each position's causal context."""
        n = int(n_tokens)
        if n <= 0:
            return 0.0
        # sum_{i=0}^{n-1} (ctx_start + i + 1)
        ctx_sum = n * (int(ctx_start) + 1) + n * (n - 1) // 2
        return n * self.matmul_per_token + self._attention(ctx_sum)

    def decode(self, n_lanes: int, ctx_mean: float) -> float:
        """One batched decode step: `n_lanes` single-token rows each
        attending over ~`ctx_mean` context tokens."""
        n = int(n_lanes)
        if n <= 0:
            return 0.0
        return n * (self.matmul_per_token + self._attention(ctx_mean))

    def verify(self, n_rows: int, width: int, ctx_mean: float
               ) -> float:
        """One speculative verify step: `n_rows` lanes × `width`
        positions (draft + pending token), each attending over the
        lane context plus its preceding in-row positions."""
        tokens = int(n_rows) * int(width)
        if tokens <= 0:
            return 0.0
        return (tokens * self.matmul_per_token
                + self._attention(tokens * max(0.0, float(ctx_mean))
                                  + int(n_rows)
                                  * int(width) * (int(width) - 1) / 2))


def train_step_flops(n_params: int, batch_tokens: int,
                     train: bool = True) -> float:
    """The standard dense-model approximation the train engine uses:
    forward ≈ 2·P FLOPs per token, backward ≈ 4·P — 6·P per trained
    token, 2·P per evaluated one."""
    factor = 6.0 if train else 2.0
    return factor * float(n_params) * float(batch_tokens)
