#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, `nvcc`
and `triton`.  It builds the port's kernels from the sources in the
checkout (into `.kernel_build/`), holds each kernel against its plain
PyTorch version at its paths' shapes, times both beside the
kernel's bound and one PyTorch library call computing the same function,
then drives the port's paths with random weights from a seed:
generation through `GenerationEngine` at GPT-2 small's widths,
BERT-base classification through `InferenceModel`, BERT-base
fine-tuning through `Estimator.fit` (with remat, a learning-rate
schedule, checkpoints, a failure and its retry, and validation data in
phase 12), and recommendation training (NeuralCF, WideAndDeep,
SessionRecommender) through `Estimator.fit` from the DEVICE data
store, and Orca's data path (XShards, the DISK tier, pinned
prefetch, the new optimizers and losses) in phase 13; each path's
outputs (or first gradients,
or training steps) are checked against a recompute through the plain
versions or the port on the CPU.

Phases (each one failing exits non-zero, with no result line):
  1. setup: card name and power limit, versions, kernel build, TF32 off;
  2. K1 LayerNorm forward (Triton) vs its plain version;
  3. K6 paged decode attention (CUDA) vs its plain version, f32, int8,
     f16 and bf16 pools, on the body the wrapper picks (split) and the
     first design's body (rows) on the same operands, timed beside it;
     an unaligned pool, which takes the rows body;
  4. K2 fused dense + bias + GELU (CUDA) vs its plain version, bf16 and
     f32, at the BERT fc1 shapes and a ragged one, and in bf16 at m and n
     no multiple of the Hopper body's tile and at k % 8 != 0 (the
     cp_async body), each on the body its layout calls for; where the
     Hopper body runs, the cp_async body also runs on the same operands,
     held to the same gate and timed beside it (`cp_async_ms`); the bf16
     gate is 2^-7 of |ref| plus 1.13e-6 of sum |x w| + |b| (f32 sums in
     other orders, through GELU's largest slope) plus 1e-6;
  5. K3 flash attention forward (CUDA) vs its plain version, bf16 and
     f32: kv_mask with a fully padded row, a bias at each of
     [1|b, 1|h, t, t], causal, dropout, and q/k/v read in place from a
     fused qkv projection; out and lse; every case again on scenes with
     the edges of the padded-key-tile skip (a row ending on a tile's first
     key, rows with whole padded tiles) and at a t that ends inside a
     128-row block, drawn from a generator of their own;
  5b. K1b LayerNorm backward (Triton) vs its plain version at the
     fine-tune's 16384 x 768 f32 and at row counts that fill no block;
  5c. K4a, K4b and K5, the flash backward (CUDA), vs their plain
     version, bf16 and f32, in every case of phase 5 plus a loss on the
     lse and the fine-tune's own case (fused qkv, dropout, key mask); dq,
     dk, dv and the bias's gradient at each broadcast; the key mask has
     the edges of the padded-key-tile skips, and dk, dv must be exactly
     zero at every padded key, dbias at every key all of a bias plane's
     replicas pad; every case again at a t that ends inside a
     128-row block, drawn from the boundary scenes' own generator;
  5e. K3, K4a, K4b and K5 at b*h = 65544 (batch 5462, 12 heads, t = 128,
     bf16, kv_mask, a [b, 1, t, t] and then a [b, h, t, t] bias) vs
     their plain versions under phase 5's and 5c's gates;
  5d. the Hopper bodies (K2 sm90, K3, K4a, K4b, K5, bf16; K6's split
     body) launched from 6 new host threads at once, each thread's first
     CUDA call a launch, the flash kernels at t = 128 and 512 in turn:
     every launch goes through and matches the same call made alone bit
     for bit;
  6. slice 1: warm the generation engine, serve concurrent greedy
     requests through the background loop, check K1/K6 launch counts
     (every K6 launch on its split body) and the logits; again with an
     int8 KV pool and with an f16 one (bench.py's configuration);
  7. slice 2: BERTClassifier at BERT-base's widths (bf16, flash) behind
     InferenceModel, predict calls from 4 threads at t = 128 and 512;
     sequences/s, valid tokens/s, latency p50 per (batch, t); K1/K2/K3
     launch counts exact per forward, every K2 launch on its sm90 body;
     logits vs the plain recompute; an
     f32 model at a tight tolerance; the same traffic with
     attn_impl="einsum" as a comparison line;
  8. slice 3: BERTClassifier at BERT-base's widths fine-tuned through
     `Estimator.from_torch(...).fit(...)` (bf16, flash, dropout 0.1,
     Adam 2e-5, batch 32 x t = 512): the first step's gradients through
     the kernels vs the plain path (bf16, and an f32 model at a tight
     gate), 2 warm-up and 10 timed steps in one `fit`, step p50 (CUDA
     events recorded as each step is queued), tokens/s,
     `bert_train_mfu`, launches per step exact, every K2 launch on its
     sm90 body, an evaluate call that launches no backward kernel;
  9. the learnable-bias path: a 2-block encoder at BERT-base widths fed
     a `RelativePositionBias` [1, 12, 512, 512], trained a few steps,
     K5 launched once per attention layer per step, the bias table's
     gradient vs the plain path;
  12. BERT-base fine-tuning (phase 8's model and batch) with the rest of
     the fit surface: (a) the first step under remat with each policy
     (None, "dots", "dots_all") gives no-remat's gradients within the
     spread of two no-remat steps (0 under PyTorch's deterministic
     algorithms, which (a) and (e) run with; the default algorithms'
     spread is reported), and leaves the dropout generator in
     no-remat's state; (b) launches per step exact (K1 49, K1b 25, K2
     24 on its sm90 body, K3 24, K4a 12, K4b 12 under remat); (c) peak
     card memory and fit step p50 per remat configuration at batch 32
     and 128 x t = 512, the peaks over the weights ordered None <
     "dots" <= "dots_all" < off; (d) AdamWeightDecay(2e-5) under
     Warmup(5, 20) over a 20-step fit: each step's lr within 4 f32 ulps
     of optax's f32 formula evaluated on the host (its distance from the
     f64 value reported), and the lr-0 first step leaves the weights
     bitwise; (e) a 2 x
     10-step fit with model_dir under a temp dir that a fault plan kills
     once (train.step, epoch 2 step 5): one retry, the final weights
     those of an uninterrupted fit within (a)'s spread; the checkpoint's
     bytes, its save on the critical path sync and background, the
     background write and the load timed; `resume_latest` on a fresh
     Estimator restores epoch 2 bit for bit (about 5 GB written in all,
     at most 2 versions on disk at once, the directory removed after);
     (f) `validation_data` gives one `val_summary` row per epoch equal
     to `evaluate` after it (1e-6 relative); run after phase 9, before
     phase 11, its step profiles with phase 10's;
  11. recommendation training through `Estimator.fit` from the DEVICE
     data store: NeuralCF at bench.py's cell (200,000 users, 50,000
     items, embeddings 64, MLP 256-256-128, batch 65536 x 30 steps, Adam
     1e-3), gated (a) card vs the port on the CPU at f32 over 3 steps,
     (b) DEVICE vs DRAM per-step losses at bf16, (c) the loss falling
     over 3 epochs, (d) a second fit hitting the cache; samples/s through
     `fit` beside a plain PyTorch loop over 30 batches on the card
     (`estimator_vs_raw`) and the DRAM store, a fit step by device op,
     the busy share and the bound; WideAndDeep at the MovieLens-1M
     layout of the reference's wide-n-deep notebook (batch 16384) and
     SessionRecommender at the JAX defaults (50,000 items, batch 4096),
     each under gate (a), with samples/s; `recommend_for_user` over
     10,000 pairs; no kernel of the other paths is launched (run after
     phase 12, before phase 10's profiles);
  13. Orca's data path (after phase 11, before phase 10's profiles;
     results under "data_path" in the line before the kernels line):
     (a) bench.py's NCF cell from `XShards.partition` into 7 dict shards
     (batches span shard edges) on the DRAM store, per-step losses
     within 1e-6 of the fit from the arrays, and under the DEVICE store
     streamed from the host with JAX's warning, no cache entry; (b)
     host-input prefetch depth 0 against 2 (pinned double buffering):
     losses bitwise equal under deterministic algorithms, samples/s
     through `fit` (best of 5 one-epoch windows, in turns, beside phase
     11's DRAM and DEVICE stores), the busy share from a profiled fit,
     the pinned ring's slots, bytes and waits; (c) the DISK_2 tier:
     losses bitwise those of the DRAM tier, the spill directory removed
     with the XShards, samples/s; (e) RMSprop, Adagrad and Adadelta under
     phase 11's gate (a) at their registry rates, a non-finite step
     leaving weights and optimizer state bitwise with no host read, and
     one-logit NCF fits with binary_crossentropy and mse whose loss
     falls; no kernel launched in (a)-(c), (e); (d) phase 8's BERT-base
     recipe fed XShards of 100/70/90/64/60 rows: launches per step K1
     25, K1b 25, K2 12 (sm90), K3 12, K4a 12, K4b 12, losses bitwise a
     dict-input fit's, step p50 beside phase 8's;
  10. device times of phases 2-5c (profiler), one decode step, one BERT
     forward, one fine-tune step (t = 512, batch 32), one
     learnable-bias step and one batch-32 step of each of phase 12's
     remat configurations by device op, after the timed phases.
The line before the last is a JSON object of every kernel's numbers;
the last line is {"ok": true, "device": {...}}.

It imports nothing of JAX and nothing of the JAX package.  Without a
card it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from functools import partial

import numpy as np

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s outside
#: the tensor cores, dense bf16 FLOP/s on the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
D_MODEL = 768


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def smi(query: str) -> str:
    """One `nvidia-smi --query-gpu=<query>` line for the first card."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def card_line() -> str:
    return smi("name,power.limit")


def clocks(when: str, start: float) -> None:
    """Print the card's clocks, power draw and temperature beside a
    timing window (a card below its peak clocks times slower), and the
    seconds since `start` (a perf_counter reading)."""
    print(f"clocks {when} ({time.perf_counter() - start:.1f} s in): " + smi(
        "clocks.sm,clocks.mem,power.draw,temperature.gpu,"
        "clocks_throttle_reasons.active"), flush=True)


def cuda_ms(fn, iters: int = 50, warm: int = 5) -> float:
    """Time per call of `fn` over `iters` back-to-back calls, between
    two CUDA events (host launch gaps included)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 50):
    """(device ms per call, {device op name: ms per call}, profile) of
    every kernel, copy and fill `fn` puts on the card, from a
    torch.profiler trace: per op name, the median duration times the
    launches per call (a median, because single microsecond-long
    launches vary; the launches per call rounded to a whole number,
    because a trace can drop events).  The total is None when the trace
    holds no whole launch per call, and the caller then keeps its
    CUDA-event time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    runs = {}
    for e in prof.events():
        # a GPU user annotation (the range of `Optimizer.step`) spans
        # kernels counted on their own
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            runs.setdefault(e.name, []).append(
                e.time_range.elapsed_us() / 1e3)
    per = {name: statistics.median(d) * round(len(d) / iters)
           for name, d in runs.items()}
    total = sum(per.values())
    return (total if total > 0 else None), per, prof


def call_times(shape: dict, fns: dict) -> dict:
    """Per-call time of each of `fns` ({"ms" | "plain_ms" |
    "library_ms": fn}) between CUDA events, host launch gaps included,
    into shape["call_ms" | "plain_call_ms" | "library_call_ms"]; the
    functions are kept for `device_times`, which runs the profiler after
    the timed serving."""
    for key, fn in fns.items():
        shape[key.replace("ms", "call_ms")] = cuda_ms(fn)
    shape["_fns"] = fns
    return shape


def device_times(shape: dict) -> None:
    """shape[key] = device time per call of each kept function, from the
    profiler, or its CUDA-event time where the trace shows no device
    time; shape["ms_from"] says which."""
    fns = shape.pop("_fns")
    src = "profiler"
    for key, fn in fns.items():
        dev, _, _ = device_ms(fn, iters=20)
        if dev is None:
            src = "cuda_events"
        shape[key] = dev if dev is not None \
            else shape[key.replace("ms", "call_ms")]
    shape["ms_from"] = src


def k2_bodies(label: str, counts: dict) -> dict:
    """K2's launches per body since the last reset, checked: every launch
    of a bf16 path took the Hopper (sm90) body, none the cp_async one."""
    from analytics_zoo_tpu_torch.ops.kernels.fused_dense import (
        fused_dense_gelu,
    )
    bodies = dict(fused_dense_gelu.launches_by_body)
    check(bodies["sm90"] == counts["fused_dense_gelu"]
          and bodies["cp_async"] == 0 and bodies["f32"] == 0,
          f"{label}: K2 launches by body {bodies}; all "
          f"{counts['fused_dense_gelu']} must take the sm90 body")
    return bodies


def bound(n_bytes: float, n_flops: float, peak: float = F32_FLOPS):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the peak for their type (f32 by default)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------
# phase 2: K1
# ----------------------------------------------------------------------

def phase_layer_norm(torch, gen):
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops.kernels.layer_norm import (
        layer_norm_fwd,
        layer_norm_fwd_reference,
    )
    shapes = []
    # rows 8: the decode step at 8 lanes; rows 1024: the largest
    # prefill bucket; rows 16384: a BERT batch of 32 x 512
    for rows in (8, 1024, 16384):
        x = torch.randn(rows, D_MODEL, generator=gen, device="cuda")
        scale = 1 + 0.1 * torch.randn(D_MODEL, generator=gen, device="cuda")
        bias = 0.1 * torch.randn(D_MODEL, generator=gen, device="cuda")
        got = layer_norm_fwd(x, scale, bias, 1e-6)
        want = layer_norm_fwd_reference(x, scale, bias, 1e-6)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        # same formula in f32, another reduction order: 1e-5 absolute
        check(err <= 1e-5, f"K1 rows={rows}: max abs err {err} > 1e-5")
        n_bytes = 2 * rows * D_MODEL * 4 + 2 * D_MODEL * 4 + 2 * rows * 4
        b_ms, b_by = bound(n_bytes, 8 * rows * D_MODEL)
        shape = dict(name="layer_norm_fwd", rows=rows, d=D_MODEL,
                     max_abs_err=err, bound_ms=b_ms, bound_by=b_by)
        # partial, not lambda: the functions run again after the loop
        # and must keep this iteration's tensors
        shapes.append(call_times(shape, dict(
            ms=partial(layer_norm_fwd, x, scale, bias, 1e-6),
            plain_ms=partial(layer_norm_fwd_reference, x, scale, bias,
                             1e-6),
            library_ms=partial(F.layer_norm, x, (D_MODEL,), scale, bias,
                               1e-6))))
        print(f"K1 layer_norm_fwd rows={rows} d={D_MODEL}: max_abs_err="
              f"{err:.3e}; per call with launch gaps: kernel "
              f"{shape['call_ms']:.5f} ms, plain {shape['plain_call_ms']:.5f}"
              f" ms, F.layer_norm {shape['library_call_ms']:.5f} ms; bound "
              f"{b_ms:.5f} ms ({b_by})", flush=True)
    return shapes


# ----------------------------------------------------------------------
# phase 3: K6
# ----------------------------------------------------------------------

#: K6's pools: (label, pool dtype or None for int8, quantized)
PAGED_POOLS = (("f32", "float32", False), ("int8", None, True),
               ("f16", "float16", False), ("bf16", "bfloat16", False))
#: seed of the f16, bf16 and unaligned K6 scenes, drawn from a generator
#: of their own (the f32 and int8 scenes, and every later phase's
#: inputs, stay as they were)
PAGED_SEED = 3


def paged_scene(torch, gen, quantized: bool, pool_dtype=None):
    """A serving-shaped decode scene: 8 lanes, 12 heads of 64, blocks
    of 16, 64-block tables (1024 positions); ragged ctx_len including
    an empty lane and a full 1023-token lane; garbage everywhere past
    ctx_len.  The pool is f32 (rounded to `pool_dtype` when given), or
    int8 with per-slot scales."""
    from analytics_zoo_tpu_torch.serving.generation.kv_cache import (
        quantize_kv_tokens,
    )
    S, H, D, BS, MB = 8, 12, 64, 16, 64
    nb = S * MB + 1
    ctx = [0, 1023, 1, 16, 100, 517, 800, 255]
    k_pool = torch.randn(nb, BS, H, D, generator=gen, device="cuda")
    v_pool = torch.randn(nb, BS, H, D, generator=gen, device="cuda")
    perm = 1 + torch.randperm(nb - 1, generator=gen, device="cuda")
    tables = torch.zeros(S, MB, dtype=torch.int32, device="cuda")
    for s, c in enumerate(ctx):
        used = -(-c // BS)
        tables[s, :used] = perm[s * MB:s * MB + used].to(torch.int32)
    sc = dict(q=torch.randn(S, H, D, generator=gen, device="cuda"),
              new_k=torch.randn(S, H, D, generator=gen, device="cuda"),
              new_v=torch.randn(S, H, D, generator=gen, device="cuda"),
              k_pool=k_pool, v_pool=v_pool, block_tables=tables,
              ctx_len=torch.tensor(ctx, dtype=torch.int32, device="cuda"),
              k_scale=None, v_scale=None)
    if quantized:
        sc["k_pool"], sc["k_scale"] = quantize_kv_tokens(k_pool)
        sc["v_pool"], sc["v_scale"] = quantize_kv_tokens(v_pool)
    elif pool_dtype is not None:
        sc["k_pool"] = k_pool.to(pool_dtype)
        sc["v_pool"] = v_pool.to(pool_dtype)
    return sc, ctx


def sdpa_yardstick(torch, sc):
    """One library path computing the same function: gather + dequant
    + concat the new token + scaled_dot_product_attention with a mask
    (timed only; the port never calls it)."""
    import torch.nn.functional as F
    q = sc["q"]
    S, H, D = q.shape
    nb, bs = sc["k_pool"].shape[:2]
    tok = (sc["block_tables"].long()[:, :, None] * bs
           + torch.arange(bs, device="cuda")).reshape(S, -1)
    k = sc["k_pool"].reshape(nb * bs, H, D)[tok].float()
    v = sc["v_pool"].reshape(nb * bs, H, D)[tok].float()
    if sc["k_scale"] is not None:
        k = k * sc["k_scale"].reshape(-1)[tok][:, :, None, None]
        v = v * sc["v_scale"].reshape(-1)[tok][:, :, None, None]
    k = torch.cat([k, sc["new_k"][:, None]], 1).transpose(1, 2)
    v = torch.cat([v, sc["new_v"][:, None]], 1).transpose(1, 2)
    c = tok.shape[1]
    col = torch.arange(c + 1, device="cuda")
    mask = (col[None] < sc["ctx_len"][:, None].long()) | (col[None] == c)
    return F.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask[:, None, None])[:, :, 0]


def paged_body(name, *args, k_scale=None, v_scale=None):
    """K6's body `name` called past the wrapper on the wrapper's
    operands: a comparison, not counted."""
    import torch

    from analytics_zoo_tpu_torch.ops.kernels.paged_attention import _launch
    out = torch.empty(args[0].shape, device="cuda")
    check(_launch(name, *args, k_scale, v_scale, out) == 0,
          f"K6 {name} body: launch failed")
    return out


def phase_paged(torch, gen):
    """K6 on f32, int8, f16 and bf16 pools: the body the wrapper picks
    (split), and the first design's body (rows) on the same operands,
    each against the plain version; then a pool whose base is not
    16-byte aligned, which the wrapper sends to the rows body."""
    from analytics_zoo_tpu_torch.ops.kernels.paged_attention import (
        paged_decode,
        paged_decode_reference,
    )
    shapes = []
    pgen = torch.Generator(device="cuda")
    pgen.manual_seed(PAGED_SEED)
    for label, dtype_name, quantized in PAGED_POOLS:
        pool_dtype = None if dtype_name is None else getattr(torch,
                                                             dtype_name)
        own = label in ("f32", "int8")
        sc, ctx = paged_scene(torch, gen if own else pgen, quantized,
                              None if own else pool_dtype)
        args = (sc["q"], sc["new_k"], sc["new_v"], sc["k_pool"],
                sc["v_pool"], sc["block_tables"], sc["ctx_len"])
        kw = dict(k_scale=sc["k_scale"], v_scale=sc["v_scale"])
        before = dict(paged_decode.launches_by_body)
        got = paged_decode(*args, **kw)
        rows = paged_body("rows", *args, **kw)
        want = paged_decode_reference(*args, **kw)
        lib_out = sdpa_yardstick(torch, sc)
        torch.cuda.synchronize()
        taken = [b for b, c in paged_decode.launches_by_body.items()
                 if c != before[b]]
        check(taken == ["split"], f"K6 {label}: took the body {taken}, "
              "expected split")
        err = float((got - want).abs().max())
        rows_err = float((rows - want).abs().max())
        # both sides read the same pool values (f16 and bf16 upcast
        # exactly, int8 times the same scales), so the pool's rounding
        # is common to both and only f32 summation order is left: the
        # softmax summed online in another order (per-group and
        # per-chunk partial states merged) over up to 1024 columns,
        # 1e-4 absolute per element, as for f32
        check(err <= 1e-4 and rows_err <= 1e-4,
              f"K6 {label}: max abs err split {err}, rows {rows_err} > 1e-4")
        check(torch.equal(got[0], sc["new_v"][0])
              and torch.equal(rows[0], sc["new_v"][0]),
              f"K6 {label}: a ctx_len 0 lane must return exactly new_v")
        lib_err = float((lib_out - want).abs().max())
        S, H, D = sc["q"].shape
        item = sc["k_pool"].element_size()
        n_tok = sum(ctx)
        n_bytes = (n_tok * H * D * 2 * item + (n_tok * 8 if quantized
                                               else 0)
                   + 4 * S * H * D * 4 + sc["block_tables"].numel() * 4
                   + S * 4)
        b_ms, b_by = bound(n_bytes, n_tok * H * 4 * D)
        shape = dict(name="paged_decode", pool=label, S=S, h=H, d=D,
                     bs=16, max_blocks=64, ctx_len=ctx, body="split",
                     max_abs_err=max(err, rows_err), split_max_abs_err=err,
                     rows_max_abs_err=rows_err,
                     library_max_abs_err=lib_err, bound_ms=b_ms,
                     bound_by=b_by)
        # the design's floor: the same tables with every lane at 16
        # tokens, one chunk each (a launch's fixed chain of round trips)
        floor = (*args[:6], torch.full_like(sc["ctx_len"], 16))
        shapes.append(call_times(shape, dict(
            ms=partial(paged_decode, *args, **kw),
            plain_ms=partial(paged_decode_reference, *args, **kw),
            library_ms=partial(sdpa_yardstick, torch, sc),
            rows_ms=partial(paged_body, "rows", *args, **kw),
            floor_ms=partial(paged_decode, *floor, **kw))))
        print(f"K6 paged_decode pool={label} S={S} h={H} d={D} "
              f"bs=16 MB=64 ctx={ctx}: max_abs_err split={err:.3e} rows="
              f"{rows_err:.3e} (gather+sdpa {lib_err:.3e}); per call with "
              f"launch gaps: kernel {shape['call_ms']:.5f} ms, rows body "
              f"{shape['rows_call_ms']:.5f} ms, plain "
              f"{shape['plain_call_ms']:.5f} ms, gather+sdpa "
              f"{shape['library_call_ms']:.5f} ms; bound {b_ms:.5f} ms "
              f"({b_by})", flush=True)
    # a pool view whose base is 2 bytes past an aligned one: no bulk
    # copy reads it, so the wrapper takes the rows body
    sc, ctx = paged_scene(torch, pgen, False, torch.float16)
    flat = torch.empty(sc["k_pool"].numel() + 1, dtype=torch.float16,
                       device="cuda")
    k_off = flat[1:].view(sc["k_pool"].shape)
    k_off.copy_(sc["k_pool"])
    args = (sc["q"], sc["new_k"], sc["new_v"], k_off, sc["v_pool"],
            sc["block_tables"], sc["ctx_len"])
    before = dict(paged_decode.launches_by_body)
    got = paged_decode(*args)
    want = paged_decode_reference(*args)
    torch.cuda.synchronize()
    taken = [b for b, c in paged_decode.launches_by_body.items()
             if c != before[b]]
    err = float((got - want).abs().max())
    check(taken == ["rows"] and err <= 1e-4,
          f"K6 unaligned f16 pool: body {taken} (expected rows), max abs "
          f"err {err}")
    print(f"K6 paged_decode unaligned f16 pool: rows body, max_abs_err="
          f"{err:.3e}", flush=True)
    return shapes


# ----------------------------------------------------------------------
# phase 4: K2
# ----------------------------------------------------------------------

def phase_fused_dense(torch, gen):
    from analytics_zoo_tpu_torch.ops.kernels.fused_dense import (
        _launch,
        dense_bias_gelu_reference,
        fused_dense_gelu,
    )

    def cp_async_body(x, w, b, out):
        # the cp.async + mma.sync body on operands the sm90 body takes,
        # called past the wrapper: a comparison, not counted
        check(_launch("cp_async", x, w, b, out) == 0,
              "K2 cp_async body: launch failed")
        return out

    shapes = []
    # m = 8 x 128 and 32 x 512: BERT fc1 at the served batches; m = 100:
    # a ragged edge in every dimension but k; bf16 (1000, 768, 1000): m
    # and n no multiple of the sm90 body's 128 x 256 tile; bf16 (1000,
    # 770, 1000): k % 8 != 0, which TMA cannot read (the cp_async body)
    for m, k, n, dtypes in ((8 * 128, 768, 3072, "both"),
                            (32 * 512, 768, 3072, "both"),
                            (100, 768, 3072, "both"),
                            (1000, 768, 1000, "bf16"),
                            (1000, 770, 1000, "bf16")):
        for dtype in ((torch.bfloat16, torch.float32) if dtypes == "both"
                      else (torch.bfloat16,)):
            x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
            w = (torch.randn(n, k, generator=gen, device="cuda")
                 / k ** 0.5).to(dtype)
            b = (0.5 * torch.randn(n, generator=gen, device="cuda")
                 ).to(dtype)
            before = dict(fused_dense_gelu.launches_by_body)
            got = fused_dense_gelu(x, w, b)
            want = dense_bias_gelu_reference(x, w, b)
            torch.cuda.synchronize()
            body = [name for name, c in fused_dense_gelu.launches_by_body
                    .items() if c != before[name]]
            expect = ("f32" if dtype == torch.float32
                      else "cp_async" if k % 8 or n % 8 else "sm90")
            check(body == [expect], f"K2 {dtype} ({m}, {k}, {n}) took the "
                  f"body {body}, expected {expect}")
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            if dtype == torch.bfloat16:
                # both accumulate in f32 and cast once; a value on a
                # rounding boundary may land one bf16 ulp apart: 2^-7
                # relative.  Near zero, where the k products cancel, two
                # f32 sums in other orders differ by up to ~1e-6 of
                # sum |x w| (sum_gate's term), through GELU's largest
                # slope, 1.13; the magnitude is the gate's arithmetic, in
                # f32 (TF32 is off), not a kernel
                mag = torch.matmul(x.float().abs(), w.float().abs().t()) \
                    + b.float().abs()
                tol = 2.0 ** -7 * want.float().abs() + 1.13e-6 * mag + 1e-6
                del mag
            else:
                # f32 throughout, k = 768 products summed in another
                # order
                tol = torch.full_like(diff, 1e-4)
            check(bool((diff <= tol).all()),
                  f"K2 {dtype} ({m}, {k}, {n}): max abs err {err}, "
                  f"beyond its tolerance")
            item = x.element_size()
            b_ms, b_by = bound((m * k + n * k + n + m * n) * item,
                               2 * m * k * n,
                               BF16_FLOPS if dtype == torch.bfloat16
                               else F32_FLOPS)
            name = "bf16" if dtype == torch.bfloat16 else "f32"
            shape = dict(name="fused_dense_gelu", dtype=name, m=m, k=k, n=n,
                         body=expect, max_abs_err=err, bound_ms=b_ms,
                         bound_by=b_by)
            wt = w.t()
            fns = dict(ms=partial(fused_dense_gelu, x, w, b),
                       plain_ms=partial(dense_bias_gelu_reference, x, w, b),
                       library_ms=partial(torch._addmm_activation, b, x, wt,
                                          use_gelu=True))
            if expect == "sm90":
                # the same operands on the earlier body, held to the same
                # gate and timed beside the sm90 body as cp_async_ms
                old = cp_async_body(x, w, b, torch.empty_like(got))
                torch.cuda.synchronize()
                check(bool(((old.float() - want.float()).abs() <= tol).all()),
                      f"K2 bf16 ({m}, {k}, {n}) cp_async body: beyond its "
                      f"tolerance")
                fns["cp_async_ms"] = partial(cp_async_body, x, w, b,
                                             torch.empty_like(got))
            shapes.append(call_times(shape, fns))
            print(f"K2 fused_dense_gelu {name} ({m}, {k}, {n}) {expect} "
                  f"body: max_abs_err="
                  f"{err:.3e}; per call with launch gaps: kernel "
                  f"{shape['call_ms']:.5f} ms, plain "
                  f"{shape['plain_call_ms']:.5f} ms, _addmm_activation "
                  f"{shape['library_call_ms']:.5f} ms"
                  + (f", cp_async body {shape['cp_async_call_ms']:.5f} ms"
                     if expect == "sm90" else "")
                  + f"; bound {b_ms:.5f} ms ({b_by})", flush=True)
    return shapes


# ----------------------------------------------------------------------
# phase 5: K3
# ----------------------------------------------------------------------

def flash_scene(torch, gen, b, t, h, d, dtype, boundary=False):
    """q, k, v [b, t, h, d]; the same three read as strided thirds of
    one fused [b, t, 3*h*d] projection, as MultiHeadAttention reads them;
    a kv_mask with valid lengths uniform in [t/4, t] and batch 0 fully
    padded; a bias at each of the four broadcast shapes [1|b, 1|h, t, t];
    the dropout seed triple (seed, q offset, k offset).  `boundary` adds
    the edges of the padded-key skips (K4b's blocks of 128 keys, 64 per
    warpgroup; K3's and K4a's tiles of 64 keys): batch 1's last valid key
    is the first key of a block (of a warpgroup's half and a tile at t =
    128), batch 2 has two whole padded blocks (one valid key at t < 384:
    its other tiles are all padding)."""
    q, k, v = (torch.randn(b, t, h, d, generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    qkv = torch.randn(b, t, 3 * h * d, generator=gen, device="cuda"
                      ).to(dtype)
    fused = tuple(a.reshape(b, t, h, d) for a in qkv.split(h * d, dim=-1))
    lens = torch.randint(t // 4, t + 1, (b,), generator=gen, device="cuda")
    lens[0] = 0
    if boundary:
        lens[1] = 129 if t > 128 else 65
        lens[2] = t - 256 if t >= 384 else 1
    mask = (torch.arange(t, device="cuda")[None] < lens[:, None]).to(
        torch.int32)
    biases = {f"{bb}x{hh}": 0.5 * torch.randn(bb, hh, t, t, generator=gen,
                                                device="cuda")
              for bb, hh in ((1, h), (b, 1), (b, h), (1, 1))}
    seed3 = torch.tensor([1234, 3, 7], dtype=torch.int32, device="cuda")
    return (q, k, v), fused, mask, biases, seed3, int(lens.sum())


def flash_variants(scene, b):
    """Phase 5's cases of one flash_scene: {label: ((q, k, v), kwargs)}:
    a kv_mask alone, with a bias at each broadcast, causal, dropout, q/k/v
    read in place from a fused qkv, and all of them together."""
    qkv, fused, mask, biases, seed3, _ = scene
    variants = {"mask": (qkv, dict(kv_mask=mask))}
    for shp, bias in biases.items():
        variants[f"bias[{shp}]+mask"] = (qkv, dict(kv_mask=mask, bias=bias))
    variants["causal+mask"] = (qkv, dict(kv_mask=mask, causal=True))
    variants["dropout0.1+mask"] = (qkv, dict(kv_mask=mask, seed3=seed3,
                                             dropout=0.1))
    variants["fused-qkv+mask"] = (fused, dict(kv_mask=mask))
    variants[f"fused-qkv+bias[{b}x1]+causal+dropout0.1+mask"] = (
        fused, dict(kv_mask=mask, bias=biases[f"{b}x1"], causal=True,
                    seed3=seed3, dropout=0.1))
    return variants


def check_flash_fwd(torch, scene, b, t, dtype, what=""):
    """Hold K3 against its plain version in every case of `scene`: out
    per element, lse to 1e-4, zeros on the fully padded batch row 0.
    Returns ({label: (out err, lse err)}, {label: out err as a share of
    its tolerance})."""
    from analytics_zoo_tpu_torch.ops.kernels.flash_attention import (
        flash_fwd,
        flash_fwd_reference,
    )
    name = "bf16" if dtype == torch.bfloat16 else "f32"
    errs, shares = {}, {}
    for label, (args, kw) in flash_variants(scene, b).items():
        out, lse = flash_fwd(*args, **kw)
        rout, rlse = flash_fwd_reference(*args, **kw)
        torch.cuda.synchronize()
        diff = (out.float() - rout.float()).abs()
        e_out = float(diff.max())
        e_lse = float((lse - rlse).abs().max())
        if dtype == torch.bfloat16:
            # each side rounds the probabilities to bf16 (the kernel
            # unnormalized, the plain version normalized: up to 2^-8
            # relative each, so 2^-7 of sum_j p_j|v_j| between them) and
            # the output once (2^-7 of |out| between them); lse comes from
            # f32 scores either way
            mag, _ = flash_fwd_reference(
                *(a.float() for a in args[:2]), args[2].float().abs(), **kw)
            tol = 2.0 ** -7 * (rout.float().abs() + mag) + 1e-6
        else:
            # the same f32 arithmetic, the softmax summed online in
            # another order
            tol = torch.full_like(diff, 1e-4)
        share = float((diff / tol).max())
        check(share <= 1.0 and e_lse <= 1e-4,
              f"K3 {name} b={b} t={t}{what} {label}: out err {e_out} "
              f"({share:.3f} of its tolerance), lse err {e_lse} (tol 1e-4)")
        check(bool((out[0] == 0).all()),
              f"K3 {name}{what} {label}: a fully padded row must give zeros")
        errs[label] = (e_out, e_lse)
        shares[label] = share
    return errs, shares


#: seed of the scenes that hold the flash kernels at the edges of their
#: padded-key-tile skip: drawn from a generator of their own, so that no
#: other phase's inputs change with them
BOUNDARY_SEED = 5


def phase_flash(torch, gen):
    """K3 at the BERT paths' shapes, timed on the `mask` case; then the
    skip's edges (flash_scene's `boundary` rows) in every case, at those
    shapes and at a t that ends inside a 128-row block."""
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops.kernels.flash_attention import (
        flash_fwd,
        flash_fwd_reference,
    )
    shapes = []
    h, d = 12, 64
    for b, t in ((8, 128), (32, 512)):
        for dtype in (torch.bfloat16, torch.float32):
            scene = flash_scene(torch, gen, b, t, h, d, dtype)
            (q, k, v), _, mask, _, _, n_valid = scene
            name = "bf16" if dtype == torch.bfloat16 else "f32"
            errs, shares = check_flash_fwd(torch, scene, b, t, dtype)
            item = q.element_size()
            n_bytes = 4 * b * t * h * d * item + b * h * t * 4 + b * t * 4
            # the products over the valid keys only
            b_ms, b_by = bound(n_bytes, 4 * h * d * t * n_valid,
                               BF16_FLOPS if dtype == torch.bfloat16
                               else F32_FLOPS)
            bool_mask = mask.bool()[:, None, None, :]
            shape = dict(name="flash_fwd", dtype=name, b=b, t=t, h=h, d=d,
                         variant="mask", max_abs_err=max(
                             max(e) for e in errs.values()),
                         errors={k_: list(e) for k_, e in errs.items()},
                         out_err_share_of_tol=shares,
                         bound_ms=b_ms, bound_by=b_by)
            shapes.append(call_times(shape, dict(
                ms=partial(flash_fwd, q, k, v, kv_mask=mask),
                plain_ms=partial(flash_fwd_reference, q, k, v,
                                 kv_mask=mask),
                library_ms=partial(
                    F.scaled_dot_product_attention, q.transpose(1, 2),
                    k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=bool_mask))))
            print(f"K3 flash_fwd {name} b={b} t={t} h={h} d={d}: (out, lse) "
                  f"max abs err {errs}; out err as a share of its "
                  f"tolerance {shares}; per call with launch gaps (mask): "
                  f"kernel {shape['call_ms']:.5f} ms, plain "
                  f"{shape['plain_call_ms']:.5f} ms, sdpa "
                  f"{shape['library_call_ms']:.5f} ms; bound {b_ms:.5f} ms "
                  f"({b_by})", flush=True)
    bgen = torch.Generator(device="cuda")
    bgen.manual_seed(BOUNDARY_SEED)
    boundary = {}
    for b, t in ((8, 128), (32, 512), (4, 200)):
        for dtype in (torch.bfloat16, torch.float32):
            name = "bf16" if dtype == torch.bfloat16 else "f32"
            scene = flash_scene(torch, bgen, b, t, h, d, dtype, boundary=True)
            errs, shares = check_flash_fwd(torch, scene, b, t, dtype,
                                           " boundary")
            boundary[f"{name} b={b} t={t}"] = dict(
                max_abs_err=max(max(e) for e in errs.values()),
                max_err_share_of_tol=max(shares.values()))
            print(f"K3 flash_fwd {name} b={b} t={t} boundary rows: (out, "
                  f"lse) max abs err {errs}; out err as a share of its "
                  f"tolerance {shares}", flush=True)
    return shapes, boundary


# ----------------------------------------------------------------------
# phase 5b: K1b
# ----------------------------------------------------------------------

def sum_gate(diff, mag):
    """Per-element gate for an f32 sum of many terms taken in another
    order: 1e-6 of the magnitude of the terms summed, plus 1e-6."""
    return bool((diff <= 1e-6 * mag + 1e-6).all())


def phase_layer_norm_bwd(torch, gen):
    from analytics_zoo_tpu_torch.ops.kernels.layer_norm import (
        layer_norm_bwd,
        layer_norm_bwd_reference,
        layer_norm_fwd,
    )
    shapes = []
    # rows 16384: the BERT fine-tune batch of 32 x 512 (the main path);
    # 100 and 8: rows that fill no block of the kernel
    for rows in (16384, 100, 8):
        x = torch.randn(rows, D_MODEL, generator=gen, device="cuda")
        scale = 1 + 0.1 * torch.randn(D_MODEL, generator=gen, device="cuda")
        bias = 0.1 * torch.randn(D_MODEL, generator=gen, device="cuda")
        g = torch.randn(rows, D_MODEL, generator=gen, device="cuda")
        _, mean, rstd = layer_norm_fwd(x, scale, bias, 1e-6)
        got = layer_norm_bwd(x, scale, mean, rstd, g)
        want = layer_norm_bwd_reference(x, scale, mean, rstd, g)
        torch.cuda.synchronize()
        errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
        xhat = (x - mean) * rstd
        # dx: f32 row reductions of d = 768 terms in another order;
        # dscale/dbias: f32 sums over the rows in another order, gated
        # per column against the magnitude of the terms summed
        check(errs[0] <= 1e-5
              and sum_gate((got[1] - want[1]).abs(), (g * xhat).abs().sum(0))
              and sum_gate((got[2] - want[2]).abs(), g.abs().sum(0)),
              f"K1b rows={rows}: max abs err (dx, dscale, dbias) {errs}")
        n_bytes = 3 * rows * D_MODEL * 4 + 3 * D_MODEL * 4 + 2 * rows * 4
        b_ms, b_by = bound(n_bytes, 12 * rows * D_MODEL)
        shape = dict(name="layer_norm_bwd", rows=rows, d=D_MODEL,
                     max_abs_err=max(errs), errors=errs, bound_ms=b_ms,
                     bound_by=b_by)
        shapes.append(call_times(shape, dict(
            ms=partial(layer_norm_bwd, x, scale, mean, rstd, g),
            plain_ms=partial(layer_norm_bwd_reference, x, scale, mean, rstd,
                             g),
            library_ms=partial(torch.ops.aten.native_layer_norm_backward, g,
                               x, [D_MODEL], mean, rstd, scale, bias,
                               [True, True, True]))))
        print(f"K1b layer_norm_bwd rows={rows} d={D_MODEL}: max_abs_err "
              f"(dx, dscale, dbias) {errs}; per call with launch gaps: "
              f"kernel {shape['call_ms']:.5f} ms, plain "
              f"{shape['plain_call_ms']:.5f} ms, native_layer_norm_backward "
              f"{shape['library_call_ms']:.5f} ms; bound {b_ms:.5f} ms "
              f"({b_by})", flush=True)
    return shapes


# ----------------------------------------------------------------------
# phase 5c: K4a, K4b, K5
# ----------------------------------------------------------------------

def bwd_magnitudes(torch, q, k, v, dout, lse, delta, kv_mask=None, bias=None,
                   seed3=None, causal=False, dropout=0.0):
    """Sums of |terms| of each backward product in f32 (dq: |ds||k| scale,
    dk: |ds||q| scale, dv: |p~||dO|, dbias: |ds| over the replicas), for
    the bf16 gates."""
    from analytics_zoo_tpu_torch.ops.kernels.flash_attention import (
        drop_keep_mask,
    )
    b, t, h, d = q.shape
    scale = d ** -0.5

    def bh(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, t, d).float()

    qf, kf, vf, gf = bh(q), bh(k), bh(v), bh(dout)
    s = torch.einsum("btd,bsd->bts", qf, kf) * scale
    if bias is not None:
        s = s + bias.expand(b, h, t, t).reshape(b * h, t, t)
    keep = (kv_mask != 0).repeat_interleave(h, 0)[:, None, :] \
        if kv_mask is not None else torch.ones_like(s, dtype=torch.bool)
    if causal:
        keep = keep & torch.ones(t, t, dtype=torch.bool, device="cuda").tril()
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("btd,bsd->bts", gf, vf)
    # sum_d |dO||v|, the scale of dp's own f32 rounding
    dp_abs = torch.einsum("btd,bsd->bts", gf.abs(), vf.abs())
    pv = p
    if dropout > 0.0:
        ar = torch.arange(t, device="cuda")
        kd = drop_keep_mask(seed3[0].long(), torch.arange(
            b * h, device="cuda")[:, None, None], seed3[1].long() + ar[:, None],
            seed3[2].long() + ar[None], dropout)
        pv = torch.where(kd, p / (1 - dropout), 0.0)
        dp = torch.where(kd, dp / (1 - dropout), 0.0)
        dp_abs = torch.where(kd, dp_abs / (1 - dropout), 0.0)
    # |ds| plus its f32 rounding: where a row attends one key (causal row
    # 0), dp - delta cancels to ~0 and what is left is the rounding of
    # the d-term sum dp on each side, at most d 2^-24 sum|dO||v|; 2^-8
    # of that sum, times the gate's 2^-7, covers it 8-fold at d = 64
    ds = p * ((dp - delta[..., None]).abs() + 2.0 ** -8 * dp_abs)

    def back(x):
        return x.reshape(b, h, t, d).permute(0, 2, 1, 3)

    mags = [back(torch.einsum("bts,bsd->btd", ds, kf.abs()) * scale),
            back(torch.einsum("bts,btd->bsd", ds, qf.abs()) * scale),
            back(torch.einsum("bts,btd->bsd", pv.abs(), gf.abs()))]
    if bias is not None:
        full = ds.reshape(b, h, t, t)
        dims = [i for i in (0, 1) if bias.shape[i] == 1]
        mags.append(full.sum(dim=dims, keepdim=True) if dims else full)
    return mags


def dbias_zero_at_padding(dbias, padded):
    """Whether the bias's gradient is exactly 0 at every key each of its
    plane's replicas pads (`padded` [b, t]: True at a padded key): a
    [b, ...] bias plane per batch row, a [1, ...] one where every batch
    row pads.  K5 neither loads nor computes a replica's key tile with
    no valid key, and ds = 0 at a masked key."""
    pads = padded if dbias.shape[0] == padded.shape[0] \
        else padded.all(0, keepdim=True)
    return all(bool((dbias[i][..., pads[i]] == 0).all())
               for i in range(dbias.shape[0]))


def check_flash_bwd(torch, gen, scene, b, t, dtype, what=""):
    """Hold K4a, K4b and K5 against their plain version in every case of
    phase 5 plus a loss on the lse and the fine-tune's own case, each
    from the kernels' own forward and a cotangent drawn from `gen`: per
    element, zeros on the fully padded batch row 0, dk and dv exactly 0
    at every padded key.  Returns ({label: max abs err of dq, dk, dv[,
    dbias]}, {label: the worst as a share of its tolerance})."""
    from analytics_zoo_tpu_torch.ops.kernels.flash_attention import (
        flash_bwd,
        flash_bwd_reference,
        flash_fwd,
    )
    qkv, fused, mask, biases, seed3, _ = scene
    h = qkv[0].shape[2]
    name = "bf16" if dtype == torch.bfloat16 else "f32"
    variants = {"mask": (qkv, dict(kv_mask=mask))}
    for shp, bias in biases.items():
        variants[f"bias[{shp}]+mask"] = (qkv, dict(kv_mask=mask,
                                                   bias=bias))
    variants["causal+mask"] = (qkv, dict(kv_mask=mask, causal=True))
    variants["dropout0.1+mask"] = (qkv, dict(
        kv_mask=mask, seed3=seed3, dropout=0.1))
    variants["lse-loss+mask"] = (qkv, dict(kv_mask=mask))
    variants["fused-qkv+mask"] = (fused, dict(kv_mask=mask))
    # the fine-tune's own case: fused qkv, dropout and a key mask
    variants["fused-qkv+dropout0.1+mask"] = (fused, dict(
        kv_mask=mask, seed3=seed3, dropout=0.1))
    variants[f"fused-qkv+bias[{b}x1]+causal+dropout0.1+mask"] = (
        fused, dict(kv_mask=mask, bias=biases[f"{b}x1"],
                    causal=True, seed3=seed3, dropout=0.1))
    errs, shares = {}, {}
    for label, (args, kw) in variants.items():
        out, lse = flash_fwd(*args, **kw)
        dout = torch.randn(out.shape, generator=gen,
                           device="cuda").to(dtype)
        delta = (dout.float() * out.float()).sum(-1).permute(
            0, 2, 1).reshape(b * h, t)
        if label.startswith("lse-loss"):
            delta = delta - torch.randn(delta.shape, generator=gen,
                                        device="cuda")
        delta = delta.contiguous()
        grad_bias = "bias" in kw
        got = flash_bwd(*args, dout, lse, delta, **kw,
                        bias_grad=grad_bias)
        want = flash_bwd_reference(*args, dout, lse, delta, **kw,
                                   bias_grad=grad_bias)
        torch.cuda.synchronize()
        got, want = got[:3 + grad_bias], want[:3 + grad_bias]
        diffs = [(a.float() - w.float()).abs()
                 for a, w in zip(got, want)]
        if dtype == torch.bfloat16:
            # both sides round ds and p~ to bf16 before their
            # products (from f32 values computed in other orders:
            # at most one ulp apart, 2^-7 relative) and the
            # gradient once (one ulp of |ref|); dbias stays f32
            mags = bwd_magnitudes(torch, *args, dout, lse, delta,
                                  **kw)
            tols = [2.0 ** -7 * (w.float().abs() + m) + 1e-6
                    for w, m in zip(want, mags)]
        else:
            # the same f32 arithmetic summed in other orders
            tols = [torch.full_like(x, 1e-4) for x in diffs]
        ratios = [float((x / tl).max()) for x, tl in zip(diffs, tols)]
        share = max(ratios)
        e = [float(x.max()) for x in diffs]
        worst = ratios.index(share)
        at = int((diffs[worst] / tols[worst]).argmax())
        check(share <= 1.0, f"K4a/K4b/K5 {name} b={b} t={t}{what} "
              f"{label}: max abs err (dq, dk, dv[, dbias]) {e}, {share:.3f} of "
              f"the tolerance, worst in output {worst} at flat index "
              f"{at}: kernel {float(got[worst].flatten()[at])}, plain "
              f"{float(want[worst].flatten()[at])}, tolerance "
              f"{float(tols[worst].flatten()[at])}")
        check(all(bool((a[0] == 0).all()) for a in got[:3]),
              f"flash bwd {name}{what} {label}: a fully padded batch row "
              "must give zero dq, dk, dv")
        padded = kw["kv_mask"] == 0
        check(all(bool((a[padded] == 0).all()) for a in got[1:3]),
              f"flash bwd {name}{what} {label}: dk and dv must be exactly "
              "zero at every padded key")
        if grad_bias:
            check(dbias_zero_at_padding(got[3], padded),
                  f"flash bwd {name}{what} {label}: dbias must be exactly "
                  "zero at every key all of a plane's replicas pad")
        errs[label] = e
        shares[label] = share
    return errs, shares


def phase_flash_bwd(torch, gen):
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops.kernels.flash_attention import (
        flash_bwd_dbias,
        flash_bwd_dkv,
        flash_bwd_dq,
        flash_bwd_reference,
        flash_fwd,
    )
    shapes = {"flash_bwd_dq": [], "flash_bwd_dkv": [],
              "flash_bwd_dbias": []}
    h, d = 12, 64
    for b, t in ((8, 128), (32, 512)):
        for dtype in (torch.bfloat16, torch.float32):
            scene = flash_scene(torch, gen, b, t, h, d, dtype, boundary=True)
            qkv, fused, mask, biases, seed3, n_valid = scene
            name = "bf16" if dtype == torch.bfloat16 else "f32"
            errs, shares = check_flash_bwd(torch, gen, scene, b, t, dtype)
            q, k, v = qkv
            item = q.element_size()
            out, lse = flash_fwd(q, k, v, kv_mask=mask)
            dout = torch.randn(out.shape, generator=gen, device="cuda"
                               ).to(dtype)
            delta = (dout.float() * out.float()).sum(-1).permute(
                0, 2, 1).reshape(b * h, t).contiguous()
            peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
            head_bytes = b * t * h * d * item
            # products over the valid keys only (this run's kv_mask)
            prods = 2 * h * d * t * n_valid
            bargs = (q, k, v, dout, lse, delta)
            bool_mask = mask.bool()[:, None, None, :]
            lib = sdpa_backward(torch, F, q, k, v, dout, bool_mask)
            for kname, fn, n_prod, n_bytes, kw in (
                    ("flash_bwd_dq", flash_bwd_dq, 3,
                     5 * head_bytes + 2 * b * h * t * 4 + b * t * 4,
                     dict(kv_mask=mask)),
                    ("flash_bwd_dkv", flash_bwd_dkv, 4,
                     6 * head_bytes + 2 * b * h * t * 4 + b * t * 4,
                     dict(kv_mask=mask))):
                errs_k = {lb: e[:3] for lb, e in errs.items()}
                b_ms, b_by = bound(n_bytes, n_prod * prods, peak)
                shape = dict(name=kname, dtype=name, b=b, t=t, h=h, d=d,
                             variant="mask",
                             max_abs_err=max(max(e) for e in errs_k.values()),
                             errors=errs_k, err_share_of_tol=shares,
                             bound_ms=b_ms, bound_by=b_by,
                             library="SDPA backward (dq, dk, dv together), "
                                     "boolean mask, forward subtracted")
                shapes[kname].append(call_times(shape, dict(
                    ms=partial(fn, *bargs, **kw),
                    plain_ms=partial(flash_bwd_reference, *bargs, **kw),
                    **lib)))
            # K5 at the learnable-bias path's shape: a [1, h, t, t] f32
            # bias, no kv_mask
            bias = biases[f"1x{h}"]
            out, lse = flash_fwd(q, k, v, bias=bias)
            delta = (dout.float() * out.float()).sum(-1).permute(
                0, 2, 1).reshape(b * h, t).contiguous()
            bargs = (q, k, v, dout, lse, delta)
            b_ms, b_by = bound(4 * head_bytes + 2 * b * h * t * 4
                               + 2 * bias.numel() * 4, 2 * 2 * h * d * t * t
                               * b, peak)
            db_errs = {lb: e[3] for lb, e in errs.items() if len(e) == 4}
            shape = dict(name="flash_bwd_dbias", dtype=name, b=b, t=t, h=h,
                         d=d, variant=f"bias[1x{h}]",
                         max_abs_err=max(db_errs.values()), errors=db_errs,
                         bound_ms=b_ms, bound_by=b_by,
                         library="SDPA backward with a float bias needing "
                                 "its gradient (dq, dk, dv, dbias), "
                                 "forward subtracted")
            shapes["flash_bwd_dbias"].append(call_times(shape, dict(
                ms=partial(flash_bwd_dbias, *bargs, bias=bias),
                plain_ms=partial(flash_bwd_reference, *bargs, bias=bias,
                                 bias_grad=True),
                **sdpa_backward(torch, F, q, k, v, dout,
                                bias.to(dtype, copy=True).requires_grad_(
                                    True)))))
            for s in shapes.values():
                subtract_forward(s[-1], "library_call_ms")
            tail = {kn: (f"kernel {s[-1]['call_ms']:.5f}, plain "
                         f"{s[-1]['plain_call_ms']:.5f}, sdpa bwd "
                         f"{s[-1]['library_call_ms']:.5f}")
                    for kn, s in shapes.items()}
            print(f"K4a/K4b/K5 flash backward {name} b={b} t={t} h={h} d={d}:"
                  f" max abs err (dq, dk, dv[, dbias]) {errs}; share of the "
                  f"tolerance {shares}; per call with launch gaps (ms) "
                  f"{tail}", flush=True)
    # a t that ends inside a block of 128 queries or keys, from the
    # boundary scenes' own generator (the scenes above stay as they were)
    bgen = torch.Generator(device="cuda")
    bgen.manual_seed(BOUNDARY_SEED + 1)
    ragged = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        b, t = 4, 200
        scene = flash_scene(torch, bgen, b, t, h, d, dtype, boundary=True)
        errs, shares = check_flash_bwd(torch, bgen, scene, b, t, dtype,
                                       " ragged")
        ragged[f"{name} b={b} t={t}"] = dict(
            max_abs_err=[max(e[i] for e in errs.values()) for i in range(3)],
            max_err_share_of_tol=max(shares.values()))
        print(f"K4a/K4b/K5 flash backward {name} b={b} t={t} (ragged t): max "
              f"abs err (dq, dk, dv[, dbias]) {errs}; share of the tolerance "
              f"{shares}", flush=True)
    return shapes, ragged


#: seed of the scene at b*h past 65535, drawn from a generator of its own
WIDE_SEED = 11
#: its batch: 5462 rows of 12 heads, b*h = 65544
WIDE_B = 5462
#: batch rows a slice of the plain version takes
WIDE_SLICE = 512


def phase_flash_wide(torch):
    """K3, K4a, K4b and K5 at b*h = 65544 (BERT's 12 heads at batch
    5462), past the 65535 that a grid.y of b*h took: bf16, t = 128, a
    kv_mask (lengths uniform in [t/4, t], batch row 0 fully padded, row
    1 one valid key into its second 64-key tile), with a [b, 1, t, t]
    bias and then a [b, h, t, t] one (65544 planes for K5).  Each
    kernel against its plain version under phase 5's and 5c's gates, the
    plain version run over slices of WIDE_SLICE batch rows (each row's
    attention, and its planes of these biases' gradients, are its own)."""
    from analytics_zoo_tpu_torch.ops.kernels.flash_attention import (
        flash_bwd,
        flash_bwd_reference,
        flash_fwd,
        flash_fwd_reference,
    )
    wgen = torch.Generator(device="cuda")
    wgen.manual_seed(WIDE_SEED)
    b, t, h, d = WIDE_B, 128, 12, 64
    q, k, v = (torch.randn(b, t, h, d, generator=wgen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    lens = torch.randint(t // 4, t + 1, (b,), generator=wgen, device="cuda")
    lens[0], lens[1] = 0, 65
    mask = (torch.arange(t, device="cuda")[None] < lens[:, None]).to(
        torch.int32)
    dout = torch.randn(b, t, h, d, generator=wgen, device="cuda").to(
        torch.bfloat16)
    res = {}
    for label, lead in (("bias[bx1]+mask", (b, 1)),
                        ("bias[bxh]+mask", (b, h))):
        bias = 0.5 * torch.randn(*lead, t, t, generator=wgen, device="cuda")
        kw = dict(kv_mask=mask, bias=bias)
        out, lse = flash_fwd(q, k, v, **kw)
        delta = (dout.float() * out.float()).sum(-1).permute(0, 2, 1) \
            .reshape(b * h, t).contiguous()
        got = flash_bwd(q, k, v, dout, lse, delta, **kw, bias_grad=True)
        torch.cuda.synchronize()
        fwd_share = lse_err = 0.0
        bwd_share = [0.0] * 4
        errs = [0.0] * 5
        for i0 in range(0, b, WIDE_SLICE):
            i1 = min(b, i0 + WIDE_SLICE)
            rs, hs = slice(i0, i1), slice(i0 * h, i1 * h)
            args = (q[rs], k[rs], v[rs])
            ckw = dict(kv_mask=mask[rs], bias=bias[rs])
            rout, rlse = flash_fwd_reference(*args, **ckw)
            # phase 5's bf16 gate (check_flash_fwd)
            mag, _ = flash_fwd_reference(args[0].float(), args[1].float(),
                                         args[2].float().abs(), **ckw)
            diff = (out[rs].float() - rout.float()).abs()
            fwd_share = max(fwd_share, float((diff / (
                2.0 ** -7 * (rout.float().abs() + mag) + 1e-6)).max()))
            errs[0] = max(errs[0], float(diff.max()))
            lse_err = max(lse_err, float((lse[hs] - rlse).abs().max()))
            # phase 5c's bf16 gates (check_flash_bwd)
            bargs = (*args, dout[rs], lse[hs], delta[hs])
            want = flash_bwd_reference(*bargs, **ckw, bias_grad=True)
            mags = bwd_magnitudes(torch, *bargs, **ckw)
            for j in range(4):
                diff = (got[j][rs].float() - want[j].float()).abs()
                tol = 2.0 ** -7 * (want[j].float().abs() + mags[j]) + 1e-6
                bwd_share[j] = max(bwd_share[j], float((diff / tol).max()))
                errs[1 + j] = max(errs[1 + j], float(diff.max()))
            del rout, rlse, mag, want, mags
        padded = mask == 0
        check(fwd_share <= 1.0 and lse_err <= 1e-4 and max(bwd_share) <= 1.0,
              f"flash b*h={b * h} {label}: share of the tolerance out "
              f"{fwd_share:.3f}, (dq, dk, dv, dbias) {bwd_share}; lse err "
              f"{lse_err} (tol 1e-4)")
        check(bool((out[0] == 0).all())
              and all(bool((g[0] == 0).all()) for g in got[:3]),
              f"flash b*h={b * h} {label}: a fully padded row must give "
              "zeros")
        check(all(bool((g[padded] == 0).all()) for g in got[1:3])
              and dbias_zero_at_padding(got[3], padded),
              f"flash b*h={b * h} {label}: dk, dv and dbias must be exactly "
              "zero at every padded key")
        res[label] = dict(b=b, h=h, t=t, bh=b * h,
                          max_abs_err_out_dq_dk_dv_dbias=errs,
                          lse_err=lse_err, out_share_of_tol=fwd_share,
                          grad_shares_of_tol=bwd_share)
        print(f"K3/K4a/K4b/K5 bf16 at b*h={b * h} t={t} {label}: "
              f"{res[label]}", flush=True)
        del bias, out, lse, delta, got
        torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------------
# phase 5d: the Hopper bodies launched from several host threads at once
# ----------------------------------------------------------------------

#: seed of phase 5d's inputs, drawn from a generator of their own
THREADS_SEED = 7
#: rounds a thread launches each Hopper body, t alternating 128 / 512
THREADS_ROUNDS = 200


def phase_threads(torch):
    """The Hopper bodies (K2's sm90, K3's, K4a's, K4b's and K5's, which
    read through TMA tensor maps, and K6's split body, with its bulk
    copies and per-lane counters) launched back to back from 6 new host
    threads, the flash kernels at t = 128 and 512 in turn as phase 7's
    serving threads send them.  Thread i makes no CUDA call before its
    first launch, of the i-th kernel: a thread with no current context
    must launch as well as any.  Every launch must go through and give
    what the same call gave alone, bit for bit (each body sums in a
    fixed order).  Returns launches and mismatches."""
    from concurrent.futures import ThreadPoolExecutor

    from analytics_zoo_tpu_torch.ops.kernels.flash_attention import (
        flash_bwd_dbias,
        flash_bwd_dkv,
        flash_bwd_dq,
        flash_fwd,
    )
    from analytics_zoo_tpu_torch.ops.kernels.paged_attention import (
        paged_decode,
    )
    from analytics_zoo_tpu_torch.ops.kernels.fused_dense import (
        body,
        fused_dense_gelu,
    )
    tgen = torch.Generator(device="cuda")
    tgen.manual_seed(THREADS_SEED)
    h, d = 12, 64
    calls = []      # per t: [(label, call, its result alone)]
    x = torch.randn(1024, D_MODEL, generator=tgen, device="cuda").to(
        torch.bfloat16)
    w = (0.02 * torch.randn(4 * D_MODEL, D_MODEL, generator=tgen,
                            device="cuda")).to(torch.bfloat16)
    bias = torch.randn(4 * D_MODEL, generator=tgen, device="cuda").to(
        torch.bfloat16)
    check(body(x, w) == "sm90", "phase 5d: K2's operands must take sm90")
    # K6's scene from a generator of its own: the others' inputs stay
    pgen = torch.Generator(device="cuda")
    pgen.manual_seed(THREADS_SEED + 1)
    sc, _ = paged_scene(torch, pgen, False, torch.float16)
    paged = partial(paged_decode, sc["q"], sc["new_k"], sc["new_v"],
                    sc["k_pool"], sc["v_pool"], sc["block_tables"],
                    sc["ctx_len"])
    for t in (128, 512):
        (q, k, v), _, mask, biases, _, _ = flash_scene(
            torch, tgen, 8, t, h, d, torch.bfloat16)
        dout = torch.randn(q.shape, generator=tgen, device="cuda").to(q.dtype)
        out, lse = flash_fwd(q, k, v, kv_mask=mask)
        delta = ((dout.float() * out.float()).sum(-1).permute(0, 2, 1)
                 .reshape(-1, t).contiguous())
        grads = (q, k, v, dout, lse, delta)
        ops = [("K3", partial(flash_fwd, q, k, v, kv_mask=mask)),
               ("K4a", partial(flash_bwd_dq, *grads, kv_mask=mask)),
               ("K4b", partial(flash_bwd_dkv, *grads, kv_mask=mask)),
               ("K2", partial(fused_dense_gelu, x, w, bias)),
               ("K5", partial(flash_bwd_dbias, *grads, kv_mask=mask,
                              bias=biases[f"1x{h}"])),
               ("K6", paged)]
        calls.append([(label, fn, fn()) for label, fn in ops])
    n = len(calls[0])
    torch.cuda.synchronize()

    def same(a, b):
        if isinstance(a, tuple):
            return torch.stack([same(x_, y_) for x_, y_ in zip(a, b)]).all()
        return (a == b).all()

    def run(i):
        diffs = []
        for j in range(THREADS_ROUNDS):
            ops = calls[(i + j) % 2]
            for label, fn, want in ops[i:] + ops[:i]:
                diffs.append(same(fn(), want))
        return int((~torch.stack(diffs)).sum())

    t0 = time.perf_counter()
    errors, bad = [], 0
    with ThreadPoolExecutor(n) as pool:
        for f in [pool.submit(run, i) for i in range(n)]:
            try:
                bad += f.result()
            except RuntimeError as e:
                errors.append(str(e))
    check(not errors, f"Hopper bodies from {n} threads: {len(errors)} of "
          f"{n} threads raised, first: {errors[:1]}")
    check(bad == 0, f"Hopper bodies from {n} threads: {bad} launches "
          "differ from the same call made alone")
    res = dict(threads=n, kernels=[label for label, _, _ in calls[0]],
               launches=n * n * THREADS_ROUNDS, mismatches=bad,
               seconds=time.perf_counter() - t0)
    print(f"K3/K4a/K4b/K2/K5 bf16 (flash b=8 t=128|512, K5 at a [1, 12, t, "
          f"t] bias, K2 1024x768x3072) and K6 (phase 3's scene, f16 pool) "
          f"from {n} host threads: {res}", flush=True)
    return res


def sdpa_backward(torch, F, q, k, v, dout, mask):
    """{"library_ms": forward + backward, "library_fwd_ms": forward} of
    F.scaled_dot_product_attention at these inputs, for `call_times`:
    the library yardstick of the flash backward kernels is their
    difference (`subtract_forward`; timed only, the port never calls
    it).  A float `mask` that needs its gradient asks SDPA for the
    bias's gradient too.  q, k, v and dout go in SDPA's own contiguous
    [b, h, t, d] layout."""
    qs, ks, vs = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    go = dout.transpose(1, 2).contiguous()
    ins = (qs, ks, vs) + ((mask,) if mask.requires_grad else ())

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)

    def fwd_bwd():
        o = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
        torch.autograd.grad(o, ins, go)

    return {"library_ms": fwd_bwd, "library_fwd_ms": fwd}


def subtract_forward(shape: dict, key: str) -> None:
    """shape[key], timed as SDPA forward + backward, minus the forward
    alone (kept beside it), where the shape has such a pair."""
    fwd = key.replace("library", "library_fwd")
    if fwd in shape:
        shape[key] -= shape[fwd]


# ----------------------------------------------------------------------
# phase 7: slice 2, BERT classification serving
# ----------------------------------------------------------------------

BERT_BATCHES = (1, 5, 32, 48)
BERT_LENGTHS = (128, 512)
#: rounds of every (batch, t) each of the 4 threads sends
BERT_REPS = 5


def bert_request(rng, n: int, t: int, vocab: int):
    """n sequences of t tokens (ids, segments, mask) with valid lengths
    uniform in [t/4, t] and the padding masked; returns (inputs, valid
    tokens)."""
    import numpy as np
    ids = rng.integers(0, vocab, (n, t)).astype(np.int32)
    seg = (np.arange(t)[None] >= t // 2).astype(np.int32).repeat(n, 0)
    lens = rng.integers(t // 4, t + 1, n)
    mask = (np.arange(t)[None] < lens[:, None]).astype(np.int32)
    return (ids, seg, mask), int(lens.sum())


def serve_bert(torch, im, model, seed: int, label: str, flash: bool):
    """Send BERT_REPS rounds of every (batch, t) from 4 threads through
    `im.predict`; check the launch counts per forward; returns the
    summary and the requests with their served outputs."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor

    from analytics_zoo_tpu_torch.ops import kernels
    rng = np.random.default_rng(seed)
    vocab = model.bert.token_embed.num_embeddings
    plans = [[(n, t) + bert_request(rng, n, t, vocab)
              for _ in range(BERT_REPS) for t in BERT_LENGTHS
              for n in BERT_BATCHES] for _ in range(4)]
    for plan in plans:
        rng.shuffle(plan)

    def run(plan):
        done = []
        for n, t, inputs, valid in plan:
            t0 = time.perf_counter()
            out = im.predict(*inputs)
            done.append((n, t, inputs, valid, out,
                         time.perf_counter() - t0))
        return done

    served0 = im.records_served
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        done = [r for f in [pool.submit(run, p) for p in plans]
                for r in f.result()]
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    mb = im.max_batch_size
    forwards = sum(-(-n // mb) for n, *_ in done)
    n_seq = sum(n for n, *_ in done)
    check(im.records_served - served0 == n_seq,
          f"{label}: records_served moved by {im.records_served - served0},"
          f" {n_seq} sequences were sent")
    n_blk = len(model.bert.blocks)
    want = dict({name: 0 for name in counts},
                layer_norm_fwd=(2 * n_blk + 1) * forwards,
                fused_dense_gelu=n_blk * forwards,
                flash_fwd=n_blk * forwards if flash else 0)
    check(counts == want, f"{label}: launches {counts}, expected {want} "
          f"for {forwards} forwards")
    bodies = k2_bodies(label, counts)
    lat = {}
    for n, t, _, _, _, sec in done:
        lat.setdefault(f"{n}x{t}", []).append(sec * 1e3)
    summary = dict(
        label=label, predict_calls=len(done), sequences=n_seq,
        forwards=forwards, valid_tokens=sum(r[3] for r in done),
        wall_s=wall, sequences_per_s=n_seq / wall,
        valid_tokens_per_s=sum(r[3] for r in done) / wall,
        predict_ms_p50={k_: statistics.median(v)
                        for k_, v in sorted(lat.items())},
        launches=counts, k2_launches_by_body=bodies)
    return summary, done


def check_bert_logits(torch, model, done, tol: float, label: str):
    """Recompute one request of each (batch, t) through the plain
    versions; the served logits must agree within `tol`, and the argmax
    wherever the top-2 gap exceeds it."""
    seen, worst, n_cmp, n_top = set(), 0.0, 0, 0
    with torch.inference_mode():
        for n, t, inputs, _, out, _ in done:
            if (n, t) in seen:
                continue
            seen.add((n, t))
            ref = model(*(torch.from_numpy(a).cuda() for a in inputs),
                        impl="reference").float()
            got = torch.from_numpy(out).cuda()
            check(bool(torch.isfinite(got).all()),
                  f"{label}: non-finite served logits")
            worst = max(worst, float((got - ref).abs().max()))
            top2 = torch.topk(ref, 2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > tol
            check(bool((got.argmax(-1) == ref.argmax(-1))[clear].all()),
                  f"{label}: a served argmax differs from the recompute's "
                  f"where the top-2 gap exceeds {tol}")
            n_cmp += n
            n_top += int(clear.sum())
    check(worst <= tol, f"{label}: served logits differ from the plain "
          f"recompute by {worst} > {tol}")
    return dict(logits_max_abs_err=worst, logits_tol=tol,
                rows_compared=n_cmp, argmax_checked=n_top)


def phase_bert(torch, seed: int, card: str):
    from analytics_zoo_tpu_torch.convert import (
        bert_from_flax,
        init_bert_params,
    )
    from analytics_zoo_tpu_torch.models.bert import BERT_BASE, BERTClassifier
    from analytics_zoo_tpu_torch.serving.inference_model import (
        InferenceModel,
    )
    import numpy as np
    cfg = dict(BERT_BASE, num_classes=2)
    t0 = time.perf_counter()
    state = bert_from_flax(init_bert_params(cfg, seed=seed), cfg)
    models = {}
    for label, kw in (("bf16 flash", dict(attn_impl="flash")),
                      ("bf16 einsum", dict(attn_impl="einsum")),
                      ("f32 flash", dict(attn_impl="flash",
                                         compute_dtype=torch.float32))):
        m = BERTClassifier(**cfg, device="cuda", **kw)
        m.load_state_dict(state)
        models[label] = m.eval()
    del state
    n_params = sum(p.numel() for p in models["bf16 flash"].parameters())
    print(f"slice 2: BERTClassifier at BERT-base widths, {n_params} params "
          f"(f32), built in {time.perf_counter() - t0:.1f} s", flush=True)

    runs = []
    for label, tol in (("bf16 flash", 0.05), ("bf16 einsum", None)):
        im = InferenceModel(supported_concurrent_num=4, max_batch_size=32
                            ).load_module(models[label])
        t0 = time.perf_counter()
        rng = np.random.default_rng(seed + 1)
        for t in BERT_LENGTHS:             # every bucket the traffic uses
            for n in (1, 8, 32, 16):
                im.predict(*bert_request(rng, n, t, cfg["vocab"])[0])
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        summary, done = serve_bert(torch, im, models[label], seed + 2,
                                   label, label.endswith("flash"))
        summary["warmup_s"] = warm_s
        if tol is not None:
            summary.update(check_bert_logits(torch, models[label], done,
                                             tol, label))
        runs.append(summary)
        p50 = {k_: round(v, 3) for k_, v in summary["predict_ms_p50"].items()}
        print(f"slice 2 [{card}] {label}{'' if tol else ' (comparison)'}: "
              f"{summary['predict_calls']} predict calls from 4 threads, "
              f"{summary['sequences']} sequences, {summary['forwards']} "
              f"forwards in {summary['wall_s']:.3f} s = "
              f"{summary['sequences_per_s']:.1f} sequences/s, "
              f"{summary['valid_tokens_per_s']:.0f} valid tokens/s; "
              f"predict p50 ms by batch x t {p50}; launches "
              f"{summary['launches']}"
              + (f"; logits max abs err {summary['logits_max_abs_err']:.3e}"
                 f" over {summary['rows_compared']} rows (tol {tol})"
                 if tol else ""), flush=True)

    # f32 compute: the same path with f32 kernels, at a tight tolerance
    im = InferenceModel(supported_concurrent_num=4, max_batch_size=32
                        ).load_module(models["f32 flash"])
    rng = np.random.default_rng(seed + 3)
    done = []
    for n, t in zip((5, 32), BERT_LENGTHS):
        inputs, valid = bert_request(rng, n, t, cfg["vocab"])
        done.append((n, t, inputs, valid, im.predict(*inputs), 0.0))
    # f32 throughout; the kernels sum in other orders than cuBLAS and
    # the plain softmax, through 12 post-LN blocks: 1e-4, about 60x the
    # 1.7e-6 read on an H100
    f32 = check_bert_logits(torch, models["f32 flash"], done, 1e-4,
                            "f32 flash")
    print(f"slice 2 [{card}] f32 flash: logits max abs err "
          f"{f32['logits_max_abs_err']:.3e} over {f32['rows_compared']} "
          "rows (tol 0.0001)", flush=True)
    runs.append(dict(label="f32 flash", **f32))
    del models["f32 flash"], models["bf16 einsum"], im
    return runs, models["bf16 flash"]


def bert_profile(torch, model, seed: int, iters: int = 5):
    """Where one t = 512, batch-32 forward's time goes: host wall per
    forward without the profiler, then device time by device op from a
    profiled window."""
    import numpy as np
    (ids, seg, mask), _ = bert_request(np.random.default_rng(seed), 32,
                                       512, model.bert.token_embed
                                       .num_embeddings)
    args = [torch.from_numpy(a).cuda() for a in (ids, seg, mask)]

    def fwd():
        with torch.inference_mode():
            return model(*args)

    fwd()
    walls = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    dev, per, _ = device_ms(fwd, iters=iters)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    return dict(batch=32, t=512, wall_ms_per_forward=wall,
                device_ms_per_forward=dev,
                device_busy_share=(dev / wall if dev else None),
                top_device_ops_ms_per_forward=[(n[:100], v)
                                               for n, v in top])


# ----------------------------------------------------------------------
# phases 8 and 9: slice 3, BERT-base fine-tune through Estimator.fit,
# and the learnable-bias path
# ----------------------------------------------------------------------

TRAIN_BATCH, TRAIN_T = 32, 512
#: warm-up steps, then timed steps, all on the same batch
TRAIN_WARM, TRAIN_TIMED = 2, 10


def train_batch(rng, n: int, t: int, vocab: int):
    """bert_request's inputs with labels of a learnable rule: 1 where
    the first token id is below vocab / 2."""
    (ids, seg, mask), valid = bert_request(rng, n, t, vocab)
    return (ids, seg, mask), (ids[:, 0] < vocab // 2).astype(np.int32), \
        valid


def first_step_grads(torch, model, inputs, labels, impl, gen_state):
    """{param name: gradient} of one fine-tune step's loss through
    `impl`, dropout drawn from a generator at `gen_state` (a fork, so
    the kernel and plain paths draw the same masks and flash seeds)."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.set_state(gen_state)
    model.train()
    model.zero_grad(set_to_none=True)
    logits = model(*inputs, impl=impl, generator=gen)
    F.cross_entropy(logits, labels).backward()
    torch.cuda.synchronize()
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def grad_rel_err(torch, got, want):
    """max over parameters of max|got - want| / max|want|, and the
    parameter where it is reached.  The q, k and v thirds of a fused
    qkv projection count as parameters of their own, so a fault in one
    third (dK lands in the key third alone) is held to that third's
    largest gradient.  The key third of a qkv bias is the exception: the
    softmax cancels it, so its gradient is rounding on both sides and is
    held to the whole bias's largest gradient.  Also the worst error of
    each kind: the q, k and v thirds, and the other parameters."""
    check(got.keys() == want.keys(), "the kernel and plain paths gave "
          "gradients to different parameters")
    worst, where = 0.0, None
    by_kind = dict.fromkeys(("q", "k", "v", "other"), 0.0)
    for n, w in want.items():
        check(bool(torch.isfinite(got[n]).all()), f"non-finite grad of {n}")
        parts = zip(("q", "k", "v"), got[n].chunk(3), w.chunk(3)) \
            if n.split(".")[-2] == "qkv" else [("", got[n], w)]
        for third, g, w3 in parts:
            scale = w if n.endswith("qkv.bias") and third == "k" else w3
            err = float((g - w3).abs().max()) / max(float(scale.abs().max()),
                                                    1e-30)
            kind = third or "other"
            by_kind[kind] = max(by_kind[kind], err)
            if err >= worst:
                worst, where = err, f"{n}[{third}]" if third else n
    return worst, where, by_kind


def check_first_step(torch, model, inputs, labels, tol, label):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    state = gen.get_state()
    got = first_step_grads(torch, model, inputs, labels, "auto", state)
    want = first_step_grads(torch, model, inputs, labels, "reference", state)
    err, where, by_kind = grad_rel_err(torch, got, want)
    check(err <= tol, f"{label}: first-step gradients through the kernels "
          f"differ from the plain path by {err:.3e} of the largest "
          f"gradient (at {where}; worst by kind {by_kind}), over the gate "
          f"{tol}")
    model.zero_grad(set_to_none=True)
    return dict(grad_rel_err=err, grad_worst_param=where,
                grad_rel_err_by_kind=by_kind, grad_tol=tol,
                params_with_grad=len(want))


def phase_train(torch, seed: int, card: str):
    from analytics_zoo_tpu_torch.convert import (
        bert_from_flax,
        init_bert_params,
    )
    from analytics_zoo_tpu_torch.models.bert import BERT_BASE, BERTClassifier
    from analytics_zoo_tpu_torch.ops import kernels
    from analytics_zoo_tpu_torch.orca.learn import Estimator
    cfg = dict(BERT_BASE, num_classes=2)
    vocab = cfg["vocab"]
    state = bert_from_flax(init_bert_params(cfg, seed=seed), cfg)
    rng = np.random.default_rng(seed + 11)
    inputs, y, valid = train_batch(rng, TRAIN_BATCH, TRAIN_T, vocab)
    on_card = [torch.from_numpy(a).cuda() for a in inputs]
    y_card = torch.from_numpy(y).long().cuda()

    # first-step gradients, kernels vs plain versions, same masks: an
    # f32-compute model (batch 8) at a tight gate, then the bf16 model
    f32 = BERTClassifier(**cfg, attn_impl="flash",
                         compute_dtype=torch.float32, device="cuda")
    f32.load_state_dict(state)
    # f32 throughout; the kernels sum in other orders than cuBLAS and the
    # plain softmax, through 12 blocks forward and back: 1e-4 of the
    # largest gradient, about 30x the 3.2e-6 read on an H100
    f32_check = check_first_step(torch, f32, [a[:8] for a in on_card],
                                 y_card[:8], 1e-4, "f32 model")
    del f32
    model = BERTClassifier(**cfg, attn_impl="flash", device="cuda")
    model.load_state_dict(state)
    del state
    # bf16 rounds the dense outputs and attention operands at other
    # places on each side (the flash kernels round unnormalized
    # probabilities, the plain version normalized ones), compounded
    # through 12 blocks forward and back.  The worst part is the last
    # block's query third: only the [CLS] query reaches the loss there,
    # so its gradient is one row's sum of bf16-rounded ds, which cancels
    # to near 0 (read at 0.156 of that third's largest gradient on an
    # H100): 0.3 of each part's largest gradient, about 2x that.  The f32
    # model and phase 5c's per-element gates hold the kernels tightly.
    bf16_check = check_first_step(torch, model, on_card, y_card, 0.3,
                                  "bf16 model")
    print(f"slice 3 [{card}] first-step gradients vs the plain path: f32 "
          f"model {f32_check}; bf16 model {bf16_check}", flush=True)

    n_steps = TRAIN_WARM + TRAIN_TIMED
    data = {"x": [np.concatenate([a] * n_steps) for a in inputs],
            "y": np.concatenate([y] * n_steps)}
    est = Estimator.from_torch(model, loss="sparse_categorical_crossentropy",
                               optimizer="adam", learning_rate=2e-5,
                               metrics=["accuracy"], seed=seed)
    # a CUDA event as each step is queued, without a host wait: the
    # gaps between them are the steps' periods as fit runs them
    eng = est.engine
    marks = []

    def marked_step(batch, step=eng.train_step):
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        return step(batch)

    eng.train_step = marked_step
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    est.fit(data, epochs=1, batch_size=TRAIN_BATCH, shuffle=False)
    marks.append(torch.cuda.Event(enable_timing=True))
    marks[-1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    del eng.train_step
    n_blk = cfg["n_block"]
    want = {"layer_norm_fwd": (2 * n_blk + 1) * n_steps,
            "layer_norm_bwd": (2 * n_blk + 1) * n_steps,
            "fused_dense_gelu": n_blk * n_steps, "flash_fwd": n_blk * n_steps,
            "flash_bwd_dq": n_blk * n_steps, "flash_bwd_dkv": n_blk * n_steps,
            "flash_bwd_dbias": 0, "paged_decode": 0}
    check(counts == want, f"slice 3: launches {counts}, expected {want} for "
          f"{n_steps} steps")
    bodies = k2_bodies("slice 3", counts)
    steps = eng.last_steps
    losses = [s["loss"] for s in steps]
    check(all(np.isfinite(losses)) and len(steps) == n_steps,
          f"slice 3: step losses {losses}")
    # a sanity check on the repeated batch, not a measure
    check(np.mean(losses[-3:]) < np.mean(losses[:3]),
          f"slice 3: the loss did not fall on the repeated batch: {losses}")
    times = [a.elapsed_time(b) / 1e3
             for a, b in zip(marks[TRAIN_WARM:-1], marks[TRAIN_WARM + 1:])]
    p50 = statistics.median(times)
    padded = TRAIN_BATCH * TRAIN_T
    n_params = sum(p.numel() for p in model.parameters())
    flops_per_token = 6 * n_params + 12 * n_blk * cfg["hidden_size"] \
        * TRAIN_T
    summary = dict(
        label="bf16 flash fine-tune", batch=TRAIN_BATCH, t=TRAIN_T,
        params=n_params, steps=n_steps, timed_steps=len(times),
        wall_s=wall, step_ms_p50=p50 * 1e3,
        step_ms=[s * 1e3 for s in times],
        padded_tokens_per_s=padded / p50, valid_tokens_per_s=valid / p50,
        losses=losses, accuracy=est.train_summary[-1]["accuracy"],
        launches=counts, k2_launches_by_body=bodies,
        launches_per_step={k: v / n_steps for k, v in counts.items()},
        bert_train_mfu=flops_per_token * padded / p50 / BF16_FLOPS,
        first_step_f32=f32_check, first_step_bf16=bf16_check)

    # evaluate: forward kernels only
    kernels.reset_launch_counts()
    ev = est.evaluate({"x": list(inputs), "y": y}, batch_size=TRAIN_BATCH)
    torch.cuda.synchronize()
    ev_counts = kernels.launch_counts()
    want_ev = dict(want, layer_norm_fwd=2 * n_blk + 1, layer_norm_bwd=0,
                   fused_dense_gelu=n_blk, flash_fwd=n_blk, flash_bwd_dq=0,
                   flash_bwd_dkv=0)
    check(ev_counts == want_ev, f"slice 3 evaluate: launches {ev_counts}, "
          f"expected {want_ev}")
    k2_bodies("slice 3 evaluate", ev_counts)
    summary["evaluate"] = dict(ev, launches=ev_counts)
    print(f"slice 3 [{card}] BERT-base fine-tune, batch {TRAIN_BATCH} x t = "
          f"{TRAIN_T} ({valid} valid tokens), Adam 2e-5: step p50 "
          f"{summary['step_ms_p50']:.3f} ms over {len(times)} timed steps = "
          f"{summary['padded_tokens_per_s']:.0f} padded tokens/s, "
          f"{summary['valid_tokens_per_s']:.0f} valid tokens/s, "
          f"bert_train_mfu {summary['bert_train_mfu']:.4f} (of 989 TFLOP/s "
          f"bf16); losses {[round(x, 4) for x in losses]}; launches per step "
          f"{summary['launches_per_step']}; evaluate {summary['evaluate']}",
          flush=True)
    return summary, est, (on_card, y_card)


def train_profile(torch, est, batch, iters: int = 3):
    """Where one fine-tune step's time goes: host wall per step without
    the profiler, then device time by device op and the host's top ops
    from a profiled window."""
    on_card, y_card = batch
    eng = est.engine
    host = {"features": tuple(a.cpu().numpy() for a in on_card),
            "labels": (y_card.int().cpu().numpy(),),
            "mask": np.ones(len(y_card), np.float32)}

    def step():
        eng.train_step(eng.put_batch(host))

    step()
    walls = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    dev, per, prof = device_ms(step, iters=iters)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:14]
    # every device event summed: the per-op medians undercount ops whose
    # launches differ in size (copies, adds over tensors of every shape)
    from torch.autograd import DeviceType
    dev_all = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation) / 1e3 / iters
    # host reads inside the step (the window's own closing
    # cudaDeviceSynchronize is not counted)
    syncs = sum(e.count for e in prof.key_averages()
                if e.key in ("cudaStreamSynchronize",
                             "aten::_local_scalar_dense")) / iters
    host_ops = sorted(((e.key, e.self_cpu_time_total / 1e3 / iters,
                        e.count / iters) for e in prof.key_averages()),
                      key=lambda t: -t[1])[:10]
    return dict(batch=len(y_card), t=on_card[0].shape[1],
                wall_ms_per_step=wall, device_ms_per_step=dev,
                device_busy_share=(dev / wall if dev else None),
                device_ms_per_step_all_events=dev_all,
                host_syncs_per_step=syncs,
                top_device_ops_ms_per_step=[(n[:100], v) for n, v in top],
                top_host_ops_self_ms_and_calls_per_step=[
                    (n[:100], ms, c) for n, ms, c in host_ops])


def phase_bias_path(torch, seed: int, card: str):
    """K5 on its path: a learnable T5 bias (`RelativePositionBias`,
    [1, 12, 512, 512]) fed as the attention mask of a 2-block encoder at
    BERT-base widths (flash, bf16, dropout 0.1) with a pooled head,
    trained a few Adam steps."""
    import torch.nn.functional as F
    from torch import nn

    from analytics_zoo_tpu_torch.keras.layers.self_attention import (
        RelativePositionBias,
        TransformerEncoder,
    )
    from analytics_zoo_tpu_torch.models.bert import BERT_BASE
    from analytics_zoo_tpu_torch.ops import kernels
    from analytics_zoo_tpu_torch.orca.learn import Estimator

    widths = {k: BERT_BASE[k] for k in ("vocab", "hidden_size", "n_head",
                                         "intermediate_size",
                                         "max_position_len")}

    class BiasedEncoder(nn.Module):
        def __init__(self):
            super().__init__()
            self.rel = RelativePositionBias(widths["n_head"], device="cuda")
            self.enc = TransformerEncoder(**widths, n_block=2,
                                          with_pooler=True,
                                          attn_impl="flash", device="cuda")
            self.head = nn.Linear(widths["hidden_size"], 2, device="cuda")

        def forward(self, ids, impl="auto", generator=None):
            bias = self.rel(ids.shape[1])
            _, pooled = self.enc(ids, None, None, bias, impl, generator)
            return self.head(pooled)

    torch.manual_seed(seed)
    model = BiasedEncoder()
    rng = np.random.default_rng(seed + 13)
    (ids, _, _), y, _ = train_batch(rng, TRAIN_BATCH, TRAIN_T,
                                    widths["vocab"])
    ids_card = torch.from_numpy(ids).cuda()
    y_card = torch.from_numpy(y).long().cuda()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    grads = {}
    for impl in ("auto", "reference"):
        g = torch.Generator(device="cuda")
        g.set_state(gen.get_state())
        model.zero_grad(set_to_none=True)
        F.cross_entropy(model(ids_card, impl=impl, generator=g),
                        y_card).backward()
        grads[impl] = model.rel.weight.grad.detach().clone()
    diff = (grads["auto"] - grads["reference"]).abs().max()
    err = float(diff) / max(float(grads["reference"].abs().max()), 1e-30)
    # bf16 operands rounded at other places on each side (as the BERT
    # model's gate); the table's gradient sums every [t, t] cell's dbias
    check(err <= 0.1, f"bias path: the bias table's gradient differs from "
          f"the plain path by {err:.3e} of its largest element")
    model.zero_grad(set_to_none=True)
    n_steps = 3
    est = Estimator.from_torch(model, loss="sparse_categorical_crossentropy",
                               optimizer="adam", learning_rate=1e-4,
                               seed=seed)
    kernels.reset_launch_counts()
    est.fit((np.concatenate([ids] * n_steps), np.concatenate([y] * n_steps)),
            epochs=1, batch_size=TRAIN_BATCH, shuffle=False)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check(counts["flash_bwd_dbias"] == 2 * n_steps
          and counts["flash_bwd_dq"] == 2 * n_steps,
          f"bias path: launches {counts}, expected 2 K5 and 2 K4a per step "
          f"over {n_steps} steps")
    out = dict(label="learnable bias, 2 blocks", steps=n_steps,
               table_grad_rel_err=err, launches=counts,
               losses=[s["loss"] for s in est.engine.last_steps])
    print(f"bias path [{card}]: {out}", flush=True)
    return out, est, ((ids_card,), y_card)


# ----------------------------------------------------------------------
# phase 11: recommendation training
# ----------------------------------------------------------------------

#: bench.py's NCF cell (bench.py:65-79 and :163-176): NeuralCF at full
#: width, 30 steps of 65536 rows an epoch from the DEVICE store
NCF_CELL = dict(user_count=200_000, item_count=50_000, class_num=2,
                user_embed=64, item_embed=64, hidden_layers=(256, 256, 128),
                mf_embed=64)
NCF_BATCH = 65536
NCF_STEPS = 30
#: timed windows of (3 `fit` epochs; 30 plain steps), best of each taken
REC_WINDOWS = 5
#: the MovieLens-1M column layout of the reference's
#: apps/recommendation-wide-n-deep notebook; the batch is this script's
WND_COLUMNS = dict(
    wide_base_cols=["occupation", "gender"], wide_base_dims=[21, 3],
    wide_cross_cols=["age-gender"], wide_cross_dims=[100],
    indicator_cols=["genres", "gender"], indicator_dims=[19, 3],
    embed_cols=["userId", "itemId"], embed_in_dims=[6041, 3953],
    embed_out_dims=[64, 64], continuous_cols=["age"])
WND_HIDDEN = (40, 20, 10)
WND_BATCH = 16384
#: the JAX class's defaults (the reference's), with history, over 50,000
#: items (this script's choice, as is the batch)
SESSION_CELL = dict(item_count=50_000, item_embed=100,
                    rnn_hidden_layers=(40, 20), session_length=10,
                    include_history=True, mlp_hidden_layers=(40, 20),
                    history_length=5)
SESSION_BATCH = 4096
#: epochs of 30 steps the WideAndDeep and SessionRecommender data hold
REC_STEPS = 30
RANK_USERS = RANK_ITEMS = 100
RANK_TOP = 10


def ncf_data(n: int):
    """bench.py:72-77's generator: ids from 1, labels (u + i) % 2."""
    rng = np.random.default_rng(0)
    u = rng.integers(1, NCF_CELL["user_count"] + 1, n).astype(np.int32)
    i = rng.integers(1, NCF_CELL["item_count"] + 1, n).astype(np.int32)
    return u, i, ((u + i) % 2).astype(np.int32)


def wnd_data(rng, n: int):
    """Synthetic rows in the notebook's layout: ids inside each column's
    dim, the age as MovieLens-1M codes it; label (user + item) % 2."""
    cols = WND_COLUMNS
    gender = rng.integers(0, cols["wide_base_dims"][1], n)
    user = rng.integers(1, cols["embed_in_dims"][0], n)
    item = rng.integers(1, cols["embed_in_dims"][1], n)
    x = np.stack([rng.integers(0, cols["wide_base_dims"][0], n), gender,
                  rng.integers(0, cols["wide_cross_dims"][0], n),
                  rng.integers(0, cols["indicator_dims"][0], n), gender,
                  user, item,
                  rng.choice([1, 18, 25, 35, 45, 50, 56], n)], axis=1)
    return [x.astype(np.float32)], ((user + item) % 2).astype(np.int32)


def session_data(rng, n: int):
    count = SESSION_CELL["item_count"]
    s = rng.integers(1, count + 1, (n, SESSION_CELL["session_length"]))
    h = rng.integers(1, count + 1, (n, SESSION_CELL["history_length"]))
    y = rng.integers(1, count + 1, n)
    return [s.astype(np.int32), h.astype(np.int32)], y.astype(np.int32)


def rec_fit(torch, model, x, y, batch: int, epochs: int = 1,
            store: str = "DEVICE", optimizer: str = "adam",
            learning_rate=1e-3):
    """`epochs` of `optimizer` (Adam 1e-3 unless given; a None rate is
    the optimizer's default) through `model.estimator()`
    (Estimator.from_torch) on `store`, no shuffle; the Estimator."""
    from analytics_zoo_tpu_torch.common.context import OrcaContext
    prev, OrcaContext.train_data_store = OrcaContext.train_data_store, store
    try:
        est = model.estimator(optimizer=optimizer,
                              learning_rate=learning_rate, metrics=[])
        est.fit({"x": x, "y": y}, epochs=epochs, batch_size=batch,
                shuffle=False)
    finally:
        OrcaContext.train_data_store = prev
    return est


def card_vs_cpu(torch, build, x, y, batch: int, label: str, card: str,
                optimizer: str = "adam", learning_rate=1e-3):
    """Gate (a): 3 steps at f32 from the same weights, the model on the
    card against the port on the CPU (an explicit reference run, not a
    fallback), a `fit` of one step, then one of two.  The same arithmetic
    summed in other orders (cuBLAS and cuDNN against the CPU's; TF32
    off): the per-step losses within 1e-5 absolute, and every parameter after the
    first step within 1e-5 (rounding of ~1e-11 in the gradients times
    Adam's gain near its eps, up to 1/eps).  After that step the two
    sides' weights differ by that much, and a ReLU whose pre-activation
    lies that close to zero may switch on one side only, replacing a
    gradient of ~1e-8 (a row of a mean over 65536 samples, near Adam's
    eps) by another; so the parameters after 3 steps are reported, not
    gated (on the CPU alone, two summation orders of NCF at batch 65536
    part so at step 3).  Returns the starting state."""
    state = {k: v.clone() for k, v in build("cpu").state_dict().items()}
    losses, first, last = [], [], []
    t0 = time.perf_counter()
    for device in ("cpu", "cuda"):
        model = build(device)
        model.load_state_dict(state)
        est = rec_fit(torch, model, [a[:batch] for a in x], y[:batch], batch,
                      optimizer=optimizer, learning_rate=learning_rate)
        steps = [s["loss"] for s in est.engine.last_steps]
        first.append({k: v.detach().cpu().double()
                      for k, v in model.state_dict().items()})
        est.fit({"x": [a[batch:3 * batch] for a in x],
                 "y": y[batch:3 * batch]}, batch_size=batch, shuffle=False)
        steps += [s["loss"] for s in est.engine.last_steps]
        last.append({k: v.detach().cpu().double()
                     for k, v in model.state_dict().items()})
        losses.append(steps)
        del model, est
    seconds = time.perf_counter() - t0

    def diffs(pair):
        return {k: (pair[1][k] - v).abs() for k, v in pair[0].items()}
    loss_err = max(abs(a - b) for a, b in zip(*losses))
    step1 = {k: float(d.max()) for k, d in diffs(first).items()}
    step3 = {k: (float(d.max()), int((d > 1e-5).sum()))
             for k, d in diffs(last).items()}
    moved = max(float((v - state[k].double()).abs().max())
                for k, v in first[0].items())
    check(len(losses[0]) == len(losses[1]) == 3 and loss_err <= 1e-5
          and max(step1.values()) <= 1e-5 and moved > 1e-4,
          f"{label} gate (a): card vs CPU at f32: losses {losses}, loss err "
          f"{loss_err}, param errs after step 1 {step1}, moved {moved}")
    print(f"{label} [{card}] gate (a) card vs CPU, f32: losses {losses[1]}; "
          f"max |loss diff| {loss_err:.3e} over 3 steps, max |param diff| "
          f"after step 1 {max(step1.values()):.3e} (gate 1e-5 each; params "
          f"moved up to {moved:.3e}); after step 3, not gated, (max |diff|, "
          f"elements past 1e-5): {step3}; {seconds:.2f} s", flush=True)
    return state, dict(losses=losses[1], loss_err=loss_err,
                       param_err_step1=max(step1.values()),
                       param_err_and_count_past_1e5_step3=step3,
                       seconds=seconds)


def best_fit_s(torch, est, x, y, batch: int, epochs: int, windows=None,
               between=None, data=None):
    """The shortest of `windows` (REC_WINDOWS) `fit` calls of `epochs`
    (each ends by reading its stats, a wait on the card) on `data`, or
    {"x": x, "y": y}; `between` runs after each."""
    best = float("inf")
    for _ in range(windows or REC_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est.fit({"x": x, "y": y} if data is None else data, epochs=epochs,
                batch_size=batch, shuffle=False)
        best = min(best, time.perf_counter() - t0)
        if between is not None:
            between()
    return best


def fit_step_profile(torch, est, x, y, batch: int, steps: int, data=None):
    """Where a `fit` step's time goes: device time per step by device op
    and every device event summed, from a profiled one-epoch `fit` on
    `data` (or {"x": x, "y": y}), and the host reads inside it."""
    from torch.autograd import DeviceType
    _, per, prof = device_ms(
        lambda: est.fit({"x": x, "y": y} if data is None else data, epochs=1,
                        batch_size=batch, shuffle=False), iters=1)
    dev_all = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation) / 1e3 / steps
    syncs = sum(e.count for e in prof.key_averages()
                if e.key in ("cudaStreamSynchronize",
                             "aten::_local_scalar_dense")) / steps
    top = sorted(per.items(), key=lambda kv: -kv[1])[:14]
    return dict(device_ms_per_step_all_events=dev_all,
                host_syncs_per_step=syncs,
                top_device_ops_ms_per_step=[(n[:100], v / steps)
                                            for n, v in top])


def ncf_bound(n_params: int, n_embed: int, batch: int):
    """An NCF step's least time: the larger of the bytes a step must move
    (parameters and both Adam moments read and written once, the batch
    read once) over HBM, and the MLP's products (forward, and the two of
    the backward) over the bf16 peak; beside it the bytes this design
    moves, counting each once: Adam reading the gradients too (7 x 4 B a
    parameter), the dense embedding gradients' fill and the scatter of
    the batch's rows, and the two `_foreach_norm` passes."""
    widths = [NCF_CELL["user_embed"] + NCF_CELL["item_embed"],
              *NCF_CELL["hidden_layers"]]
    macs = sum(a * b for a, b in zip(widths, widths[1:])) + \
        NCF_CELL["class_num"] * (widths[-1] + NCF_CELL["mf_embed"])
    flops = 3 * 2 * macs * batch
    # the batch's rows of the four f32 tables
    rows = batch * 4 * (widths[0] + 2 * NCF_CELL["mf_embed"])
    least = 24 * n_params + 16 * batch
    design = 28 * n_params + 4 * n_embed + 2 * rows + 8 * n_params
    b_ms, b_by = bound(least, flops, BF16_FLOPS)
    return dict(bound_ms=b_ms, bound_by=b_by, least_bytes=least,
                flops=flops, design_bytes=design,
                design_bytes_ms=design / HBM_BYTES_PER_S * 1e3)


def check_ranking(torch, model, seed: int, card: str):
    """`recommend_for_user` over RANK_USERS x RANK_ITEMS pairs: RANK_TOP
    items a user, the output in descending (prediction, probability)."""
    from analytics_zoo_tpu_torch.models.recommendation import (
        UserItemFeature,
    )
    rng = np.random.default_rng(seed + 17)
    users = rng.choice(np.arange(1, NCF_CELL["user_count"] + 1), RANK_USERS,
                       replace=False)
    items = rng.choice(np.arange(1, NCF_CELL["item_count"] + 1), RANK_ITEMS,
                       replace=False)
    pairs = [UserItemFeature(u, i, None) for u in users for i in items]
    t0 = time.perf_counter()
    top = model.recommend_for_user(pairs, max_items=RANK_TOP,
                                   batch_size=NCF_BATCH)
    wall = time.perf_counter() - t0
    counts = {}
    for p in top:
        counts[p.user_id] = counts.get(p.user_id, 0) + 1
    keys = [(p.prediction, p.probability) for p in top]
    check(sorted(counts) == sorted(int(u) for u in users)
          and set(counts.values()) == {RANK_TOP}
          and keys == sorted(keys, reverse=True)
          and all(p.prediction in (1, 2) and 0.5 <= p.probability <= 1.0
                  for p in top),
          f"ranking: counts {sorted(set(counts.values()))} over "
          f"{len(counts)} users, or the order is not descending")
    print(f"ranking [{card}]: recommend_for_user over {len(pairs)} pairs, "
          f"{RANK_TOP} a user for {len(counts)} users, order descending by "
          f"(prediction, probability), in {wall:.3f} s; the first "
          f"{top[:2]}", flush=True)
    return dict(pairs=len(pairs), users=len(counts), top=RANK_TOP,
                wall_s=wall)


def phase_recommendation(torch, seed: int, card: str):
    """Phase 11: NCF at bench.py's cell through `Estimator.fit` from the
    DEVICE store (gates (a) card vs CPU at f32, (b) DEVICE vs DRAM at
    bf16, (c) the loss falls, (d) a second fit hits the cache), timed
    beside a plain PyTorch loop; WideAndDeep and SessionRecommender at
    their layouts (gate (a), samples/s); the ranking surface once."""
    import torch.nn.functional as F
    from analytics_zoo_tpu_torch.common.context import OrcaContext
    from analytics_zoo_tpu_torch.models.recommendation import (
        ColumnFeatureInfo,
        NeuralCF,
        SessionRecommender,
        WideAndDeep,
    )
    from analytics_zoo_tpu_torch.ops import kernels
    kernels.reset_launch_counts()
    prev = OrcaContext.train_data_store, OrcaContext.device_cache_bytes
    OrcaContext.train_data_store = "DEVICE"
    OrcaContext.device_cache_bytes = 1 << 30
    out = {}

    def ncf(device, dtype=torch.bfloat16):
        torch.manual_seed(seed)
        return NeuralCF(**NCF_CELL, compute_dtype=dtype, device=device)

    u, i, y = ncf_data(NCF_BATCH * NCF_STEPS)
    x = [u, i]
    state, gate_a = card_vs_cpu(torch, lambda device: ncf(device,
                                                          torch.float32),
                                x, y, NCF_BATCH, "NCF", card)

    # gate (b): one epoch from the same weights on each store, bf16
    model = ncf("cuda")
    model.load_state_dict(state)
    dram = ncf("cuda")
    dram.load_state_dict(state)
    est = rec_fit(torch, model, x, y, NCF_BATCH)
    dram_est = rec_fit(torch, dram, x, y, NCF_BATCH, store="DRAM")
    dev_losses = [s["loss"] for s in est.engine.last_steps]
    dram_losses = [s["loss"] for s in dram_est.engine.last_steps]
    store_err = max(abs(a - b) for a, b in zip(dev_losses, dram_losses))
    # the same batches through the same bf16 arithmetic on one card; only
    # where each batch is read from differs
    check(len(dev_losses) == len(dram_losses) == NCF_STEPS
          and store_err <= 1e-6 and len(est._device_cache) == 1,
          f"NCF gate (b): DEVICE {dev_losses} vs DRAM {dram_losses}")
    # gates (c), (d): two more warm-up epochs in a second fit on the
    # same arrays, a cache hit; the loss falls over the three
    est.fit({"x": x, "y": y}, epochs=2, batch_size=NCF_BATCH, shuffle=False)
    warm = [s["loss"] for s in est.train_summary]
    check(est.device_cache_hits == 1 and len(est._device_cache) == 1,
          f"NCF gate (d): cache hits {est.device_cache_hits}")
    check(len(warm) == 3 and all(np.isfinite(warm)) and warm[2] < warm[0],
          f"NCF gate (c): epoch losses {warm} did not fall")
    print(f"NCF [{card}] gate (b) DEVICE vs DRAM, bf16, {NCF_STEPS} steps: "
          f"max |loss diff| {store_err:.3e} (gate 1e-6); gate (c) epoch "
          f"losses {warm}; gate (d) cache hits {est.device_cache_hits}",
          flush=True)

    # the plain loop (bench.py:80's counterpart): the same model and
    # optimizer, NCF_STEPS distinct batches resident on the card
    raw = ncf("cuda")
    raw.load_state_dict(state)
    opt = torch.optim.Adam(raw.parameters(), lr=1e-3, fused=True)
    batches = [tuple(torch.from_numpy(a[s * NCF_BATCH:(s + 1) * NCF_BATCH])
                     .cuda().long() for a in (u, i, y))
               for s in range(NCF_STEPS)]

    def raw_steps(n=NCF_STEPS):
        for k in range(n):
            ub, ib, yb = batches[k % NCF_STEPS]
            opt.zero_grad(set_to_none=True)
            loss = F.cross_entropy(raw(ub, ib), yb)
            loss.backward()
            opt.step()
        return float(loss.detach())     # a read: the steps are done

    raw_steps(5)
    raw_times = []

    def time_raw():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        raw_steps()
        raw_times.append(time.perf_counter() - t0)

    fit_s = best_fit_s(torch, est, x, y, NCF_BATCH, 3, between=time_raw)
    check(est.device_cache_hits == 1 + REC_WINDOWS,
          f"NCF: a timed fit re-uploaded ({est.device_cache_hits} hits)")
    OrcaContext.train_data_store = "DRAM"
    dram_s = best_fit_s(torch, dram_est, x, y, NCF_BATCH, 1, windows=3)
    OrcaContext.train_data_store = "DEVICE"
    samples = NCF_BATCH * NCF_STEPS
    raw_s = min(raw_times)
    n_params = sum(p.numel() for p in model.parameters())
    n_embed = sum(p.numel() for n, p in model.named_parameters()
                  if "embed" in n)
    step_ms = fit_s / (3 * NCF_STEPS) * 1e3
    prof = fit_step_profile(torch, est, x, y, NCF_BATCH, NCF_STEPS)
    prof["device_busy_share_of_fit_step"] = \
        prof["device_ms_per_step_all_events"] / step_ms
    (dds, _), = est._device_cache.values()
    out["ncf"] = dict(
        cell=NCF_CELL, batch=NCF_BATCH, steps_per_epoch=NCF_STEPS,
        params=n_params, dataset_bytes=dds.nbytes,
        fit_samples_per_s=3 * samples / fit_s,
        raw_samples_per_s=samples / raw_s,
        estimator_vs_raw=(3 * samples / fit_s) / (samples / raw_s),
        dram_samples_per_s=samples / dram_s, fit_step_ms=step_ms,
        raw_step_ms=raw_s / NCF_STEPS * 1e3,
        dram_step_ms=dram_s / NCF_STEPS * 1e3, gate_a=gate_a,
        gate_b_max_loss_diff=store_err, gate_c_epoch_losses=warm,
        gate_d_cache_hits=est.device_cache_hits, step_profile=prof,
        **ncf_bound(n_params, n_embed, NCF_BATCH))
    r = out["ncf"]
    print(f"NCF [{card}] bench.py's cell ({n_params} params, batch "
          f"{NCF_BATCH} x {NCF_STEPS} steps, {r['dataset_bytes']} bytes on "
          f"the card): fit {r['fit_samples_per_s']:.0f} samples/s "
          f"({step_ms:.4f} ms a step, best of {REC_WINDOWS} x 3 epochs), "
          f"plain loop {r['raw_samples_per_s']:.0f} samples/s "
          f"({r['raw_step_ms']:.4f} ms), estimator_vs_raw "
          f"{r['estimator_vs_raw']:.4f}; DRAM store "
          f"{r['dram_samples_per_s']:.0f} samples/s ({r['dram_step_ms']:.4f} "
          f"ms); device {prof['device_ms_per_step_all_events']:.4f} ms a "
          f"step (busy {prof['device_busy_share_of_fit_step']:.3f}); bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}: {r['least_bytes']} "
          f"bytes, {r['flops']} FLOPs), this design's bytes "
          f"{r['design_bytes']} = {r['design_bytes_ms']:.4f} ms", flush=True)
    print(f"NCF fit step profile [{card}]: {json.dumps(prof)}", flush=True)
    out["ranking"] = check_ranking(torch, model, seed, card)
    del raw, opt, batches, dram, dram_est

    # WideAndDeep at the notebook's layout, SessionRecommender at the
    # JAX defaults: gate (a), then samples/s on the DEVICE store
    rng = np.random.default_rng(seed + 13)
    cells = (
        ("wide_and_deep", WND_BATCH, wnd_data(rng, WND_BATCH * REC_STEPS),
         lambda device, dtype: WideAndDeep(
             ColumnFeatureInfo(**WND_COLUMNS), hidden_layers=WND_HIDDEN,
             compute_dtype=dtype, device=device)),
        # all f32, as the JAX module
        ("session_recommender", SESSION_BATCH,
         session_data(rng, SESSION_BATCH * REC_STEPS),
         lambda device, dtype: SessionRecommender(**SESSION_CELL,
                                                  device=device)))
    for name, batch, (xs, ys), make in cells:
        def build(device, dtype=torch.bfloat16, make=make):
            torch.manual_seed(seed)
            return make(device, dtype)
        state, gate = card_vs_cpu(
            torch, lambda device, build=build: build(device, torch.float32),
            xs, ys, batch, name, card)
        model = build("cuda")
        model.load_state_dict(state)
        est = rec_fit(torch, model, xs, ys, batch)
        best = best_fit_s(torch, est, xs, ys, batch, 1)
        losses = [s["loss"] for s in est.train_summary]
        check(all(np.isfinite(losses)) and est.device_cache_hits
              == REC_WINDOWS, f"{name}: losses {losses}, cache hits "
              f"{est.device_cache_hits}")
        step_ms = best / REC_STEPS * 1e3
        prof = fit_step_profile(torch, est, xs, ys, batch, REC_STEPS)
        prof["device_busy_share_of_fit_step"] = \
            prof["device_ms_per_step_all_events"] / step_ms
        out[name] = dict(batch=batch, steps_per_epoch=REC_STEPS,
                         params=sum(p.numel() for p in model.parameters()),
                         samples_per_s=batch * REC_STEPS / best,
                         step_ms=step_ms, epoch_losses=losses, gate_a=gate,
                         step_profile=prof)
        print(f"{name} [{card}] batch {batch}, {out[name]['params']} params: "
              f"{out[name]['samples_per_s']:.0f} samples/s through fit on "
              f"the DEVICE store ({step_ms:.4f} ms a step, best of "
              f"{REC_WINDOWS} epochs; device "
              f"{prof['device_ms_per_step_all_events']:.4f} ms a step, busy "
              f"{prof['device_busy_share_of_fit_step']:.3f}); epoch losses "
              f"{losses}", flush=True)
        print(f"{name} fit step profile [{card}]: {json.dumps(prof)}",
              flush=True)
        del model, est
    launches = kernels.launch_counts()
    check(not any(launches.values()),
          f"phase 11 launched a kernel of another path: {launches}")
    out["launches"] = launches
    OrcaContext.train_data_store, OrcaContext.device_cache_bytes = prev
    return out


# ----------------------------------------------------------------------
# phase 13: the data path (XShards, prefetch depth, the DISK tier)
# ----------------------------------------------------------------------

#: phase 13 (a)-(c): bench.py's NCF cell fed as XShards of 7 dict shards
#: (they do not divide the 30 batches: batches carry rows across edges)
DATA_SHARDS = 7
#: phase 13 (b): the host-input prefetch depths compared
DATA_DEPTHS = (0, 2)
#: phase 13 (d): 12 x 32 BERT rows in shards of uneven sizes
BERT_SHARD_ROWS = (100, 70, 90, 64, 60)
#: phase 13 (e): the optimizers written here, each at its registry rate
NEW_OPTIMIZERS = ("rmsprop", "adagrad", "adadelta")
#: phase 13 (e): steps of the one-logit fits with the new losses
LOSS_FIT_STEPS = 8


class _Warnings:
    """The messages `analytics_zoo_tpu_torch` logs at WARNING and above
    inside the block."""

    def __enter__(self):
        import logging

        class Keep(logging.Handler):
            def __init__(self, out):
                super().__init__(logging.WARNING)
                self.out = out

            def emit(self, record):
                self.out.append(record.getMessage())

        self.messages = []
        self.logger = logging.getLogger("analytics_zoo_tpu_torch")
        self.handler = Keep(self.messages)
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def data_ncf_fit(torch, seed: int, data, store: str, depth: int,
                 optimizer="adam"):
    """One epoch of bench.py's cell from phase 11's starting weights
    through `Estimator.fit` on `store` at prefetch `depth`, no shuffle:
    (the Estimator, its per-step losses)."""
    from analytics_zoo_tpu_torch.common.context import OrcaContext
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
    OrcaContext.train_data_store = store
    OrcaContext.host_input_prefetch = depth
    torch.manual_seed(seed)
    model = NeuralCF(**NCF_CELL, compute_dtype=torch.bfloat16, device="cuda")
    est = model.estimator(optimizer=optimizer, learning_rate=1e-3,
                          metrics=[])
    est.fit(data, epochs=1, batch_size=NCF_BATCH, shuffle=False)
    return est, [s["loss"] for s in est.engine.last_steps]


def skipped_step_on_card(torch, est, x, y, label: str):
    """One train step whose gradients are made non-finite (a hook
    multiplies one parameter's gradient by inf): the weights and the
    optimizer state stay bitwise as they were, the step is counted as
    skipped, and no host read happens inside it (profiled)."""
    from torch.profiler import ProfilerActivity, profile
    eng = est.engine
    model = eng.model
    before = params_of(model)
    state = {id(p): {k: v.clone() for k, v in s.items()}
             for p, s in eng.opt.state.items()}
    batch = eng.put_batch({"features": tuple(a[:NCF_BATCH] for a in x),
                           "labels": (y[:NCF_BATCH],),
                           "mask": np.ones(NCF_BATCH, np.float32)})
    first = next(p for p in model.parameters() if p.requires_grad)
    hook = first.register_hook(lambda g: g * float("inf"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        stats = eng.train_step(batch)
    hook.remove()
    # the profiler's own closing cudaDeviceSynchronize is not counted
    reads = sum(e.count for e in prof.key_averages()
                if e.key in ("cudaStreamSynchronize",
                             "aten::_local_scalar_dense", "aten::item"))
    kept = all(torch.equal(p, before[n])
               for n, p in model.named_parameters())
    kept_state = all(torch.equal(v, state[id(p)][k])
                     for p, s in eng.opt.state.items() for k, v in s.items())
    skipped = float(stats["_nan_steps"])
    check(kept and kept_state and skipped == 1.0 and reads == 0,
          f"{label}: a non-finite step changed the weights ({not kept}) or "
          f"the optimizer state ({not kept_state}), skipped {skipped}, host "
          f"reads inside the step {reads}")
    return dict(weights_kept=kept, state_kept=kept_state,
                host_reads_in_step=reads)


def phase_data_path(torch, seed: int, card: str, rec: dict, train: dict):
    """Phase 13: Orca's data path on the card.  (a) bench.py's NCF cell
    from XShards of 7 dict shards (DRAM store) against the fit from the
    arrays, and under the DEVICE store (streamed, with JAX's warning);
    (b) host-input prefetch depth 0 against 2: bitwise losses under
    deterministic algorithms, samples/s through `fit`, the busy share,
    the pinned ring; (c) the DISK tier: bitwise losses, the spill
    directory gone with the XShards, samples/s; (e) RMSprop, Adagrad and
    Adadelta under phase 11's gate (a), a skipped non-finite step, and
    fits with binary_crossentropy and mse; no kernel launched in (a)-(c)
    and (e); (d) BERT-base fine-tuned from XShards of uneven shards:
    launches per step exact, losses bitwise those of a dict-input fit."""
    import gc
    import os

    from analytics_zoo_tpu_torch.common.context import OrcaContext
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
    from analytics_zoo_tpu_torch.ops import kernels
    from analytics_zoo_tpu_torch.orca.data import XShards
    prev = (OrcaContext.train_data_store, OrcaContext.host_input_prefetch,
            OrcaContext.device_cache_bytes)
    OrcaContext.device_cache_bytes = 1 << 30
    out = {}
    samples = NCF_BATCH * NCF_STEPS
    u, i, y = ncf_data(samples)
    arrays = {"x": [u, i], "y": y}
    OrcaContext.train_data_store = "DRAM"
    shards = XShards.partition(arrays, num_shards=DATA_SHARDS)
    kernels.reset_launch_counts()

    # (a) XShards against the arrays, both streamed from the host
    _, from_arrays = data_ncf_fit(torch, seed, arrays, "DRAM", 2)
    est_xs, from_xs = data_ncf_fit(torch, seed, shards, "DRAM", 2)
    err_a = max(abs(a - b) for a, b in zip(from_xs, from_arrays))
    check(len(from_xs) == len(from_arrays) == NCF_STEPS and err_a <= 1e-6,
          f"phase 13 (a): XShards {from_xs} vs arrays {from_arrays}")
    with _Warnings() as warned:
        est_dev, from_dev = data_ncf_fit(torch, seed, shards, "DEVICE", 2)
    streamed = any("ignored for streaming input" in m
                   for m in warned.messages)
    err_dev = max(abs(a - b) for a, b in zip(from_dev, from_xs))
    check(streamed and not est_dev._device_cache
          and est_dev.device_cache_hits == 0 and err_dev <= 1e-6,
          f"phase 13 (a): DEVICE store with XShards: warned {streamed}, "
          f"cache {len(est_dev._device_cache)} entries, "
          f"{est_dev.device_cache_hits} hits, losses {from_dev}")
    del est_dev
    out["a"] = dict(shards=DATA_SHARDS, steps=NCF_STEPS,
                    max_loss_diff_vs_arrays=err_a,
                    device_store_streamed_with_warning=streamed,
                    device_store_max_loss_diff=err_dev, losses=from_xs)
    print(f"data path [{card}] (a) NCF from {DATA_SHARDS} XShards, "
          f"{NCF_STEPS} steps of {NCF_BATCH}: max |loss diff| vs the arrays "
          f"{err_a:.3e} (gate 1e-6); DEVICE store streamed with the "
          f"warning, no cache entry, max |loss diff| {err_dev:.3e}",
          flush=True)

    # (b) prefetch depth: bitwise under deterministic algorithms
    with deterministic(torch):
        det = {d: data_ncf_fit(torch, seed, shards, "DRAM", d)[1]
               for d in DATA_DEPTHS}
    check(det[0] == det[2], f"phase 13 (b): depth 0 losses {det[0]} vs "
          f"depth 2 {det[2]}")
    # samples/s through fit: one Estimator a depth, windows in turns
    ests = {("xshards", d): data_ncf_fit(torch, seed, shards, "DRAM", d)[0]
            for d in DATA_DEPTHS}
    for d in DATA_DEPTHS:
        ests[("arrays", d)] = data_ncf_fit(torch, seed, arrays, "DRAM", d)[0]
    best = dict.fromkeys(ests, float("inf"))
    for _ in range(REC_WINDOWS):
        for (kind, d), est in ests.items():
            OrcaContext.host_input_prefetch = d
            data = shards if kind == "xshards" else arrays
            best[(kind, d)] = min(best[(kind, d)], best_fit_s(
                torch, est, None, None, NCF_BATCH, 1, windows=1, data=data))
    rates = {f"{kind}_depth{d}": samples / s for (kind, d), s in best.items()}
    ring = ests[("xshards", 2)].engine.ring.stats()
    profiles = {}
    for d in DATA_DEPTHS:
        OrcaContext.host_input_prefetch = d
        step_ms = best[("xshards", d)] / NCF_STEPS * 1e3
        prof = fit_step_profile(torch, ests[("xshards", d)], None, None,
                                NCF_BATCH, NCF_STEPS, data=shards)
        prof["fit_step_ms"] = step_ms
        prof["device_busy_share_of_fit_step"] = \
            prof["device_ms_per_step_all_events"] / step_ms
        profiles[d] = prof
    ncf = rec["ncf"]
    out["b"] = dict(bitwise_equal_depths=True, losses_depth0=det[0],
                    samples_per_s=rates,
                    phase11_dram_samples_per_s=ncf["dram_samples_per_s"],
                    phase11_device_samples_per_s=ncf["fit_samples_per_s"],
                    busy_share={d: profiles[d]
                                ["device_busy_share_of_fit_step"]
                                for d in DATA_DEPTHS},
                    profiles=profiles, pinned_ring=ring)
    print(f"data path [{card}] (b) prefetch depth 0 vs 2: losses bitwise "
          f"equal over {NCF_STEPS} steps (deterministic algorithms); "
          f"samples/s through fit (best of {REC_WINDOWS} one-epoch "
          f"windows, in turns): XShards depth 0 "
          f"{rates['xshards_depth0']:.0f}, depth 2 "
          f"{rates['xshards_depth2']:.0f}, arrays depth 0 "
          f"{rates['arrays_depth0']:.0f}, depth 2 "
          f"{rates['arrays_depth2']:.0f}; phase 11 in this run: DRAM store "
          f"{ncf['dram_samples_per_s']:.0f}, DEVICE store "
          f"{ncf['fit_samples_per_s']:.0f}; busy share depth 0 "
          f"{out['b']['busy_share'][0]:.3f}, depth 2 "
          f"{out['b']['busy_share'][2]:.3f}; pinned ring {ring}", flush=True)
    for d in DATA_DEPTHS:
        print(f"data path fit step profile depth {d} [{card}]: "
              f"{json.dumps(profiles[d])}", flush=True)
    del ests, est_xs

    # (c) the DISK tier: shards pickled to a temp dir, loaded on the
    # IO thread
    OrcaContext.train_data_store = "DISK_2"
    disk = XShards.partition(arrays, num_shards=DATA_SHARDS)
    spill = disk._store._dir
    spilled = len(os.listdir(spill))
    with deterministic(torch):
        _, from_disk = data_ncf_fit(torch, seed, disk, "DISK_2", 2)
    check(from_disk == det[2], f"phase 13 (c): DISK tier losses {from_disk} "
          f"vs the DRAM tier's {det[2]}")
    est_disk, _ = data_ncf_fit(torch, seed, disk, "DISK_2", 2)
    disk_s = best_fit_s(torch, est_disk, None, None, NCF_BATCH, 1,
                        data=disk)
    del disk, est_disk
    gc.collect()
    gone = not os.path.exists(spill)
    check(spilled == DATA_SHARDS and gone, f"phase 13 (c): {spilled} files "
          f"spilled, directory removed {gone}")
    out["c"] = dict(bitwise_equal_dram_tier=True, spilled_files=spilled,
                    spill_dir_removed=gone, samples_per_s=samples / disk_s)
    print(f"data path [{card}] (c) DISK_2 tier: {spilled} shards pickled, "
          f"losses bitwise equal to the DRAM tier's, the spill directory "
          f"removed with the XShards; {samples / disk_s:.0f} samples/s "
          f"through fit (best of {REC_WINDOWS})", flush=True)

    # (e) the optimizers written here, on the card against the CPU
    OrcaContext.train_data_store = "DRAM"
    OrcaContext.host_input_prefetch = 2
    out["e"] = {}
    for name in NEW_OPTIMIZERS:
        def build(device, name=name):
            torch.manual_seed(seed)
            return NeuralCF(**NCF_CELL, compute_dtype=torch.float32,
                            device=device)
        state, gate = card_vs_cpu(torch, build, [u, i], y, NCF_BATCH,
                                  f"NCF {name}", card, optimizer=name,
                                  learning_rate=None)
        model = build("cuda")
        model.load_state_dict(state)
        est = rec_fit(torch, model, [a[:NCF_BATCH] for a in (u, i)],
                      y[:NCF_BATCH], NCF_BATCH, store="DRAM", optimizer=name,
                      learning_rate=None)
        gate["skipped_step"] = skipped_step_on_card(torch, est, [u, i], y,
                                                    f"NCF {name}")
        out["e"][name] = gate
        print(f"data path [{card}] (e) {name}: a non-finite step left the "
              f"weights and the optimizer state bitwise, no host read in "
              f"the step", flush=True)
        del model, est
    n_rows = NCF_BATCH * LOSS_FIT_STEPS
    for loss in ("binary_crossentropy", "mse"):
        torch.manual_seed(seed)
        model = NeuralCF(**dict(NCF_CELL, class_num=1),
                         compute_dtype=torch.bfloat16, device="cuda")
        est = model.estimator(loss=loss, optimizer="adam",
                              learning_rate=1e-3, metrics=[])
        est.fit(XShards.partition({"x": [u[:n_rows], i[:n_rows]],
                                   "y": y[:n_rows].astype(np.float32)},
                                  num_shards=DATA_SHARDS),
                epochs=3, batch_size=NCF_BATCH, shuffle=True)
        epochs = [s["loss"] for s in est.train_summary]
        check(all(np.isfinite(epochs)) and epochs[2] < epochs[0],
              f"phase 13 (e): {loss} epoch losses {epochs} did not fall")
        out["e"][loss] = dict(epoch_losses=epochs)
        print(f"data path [{card}] (e) one-logit NCF with {loss} from "
              f"XShards, 3 epochs of {LOSS_FIT_STEPS} steps: epoch losses "
              f"{epochs}", flush=True)
        del model, est
    launches = kernels.launch_counts()
    check(not any(launches.values()),
          f"phase 13 (a)-(c), (e) launched a kernel: {launches}")
    out["launches_recommendation"] = launches

    # (d) BERT-base fine-tuned from XShards of uneven shards
    out["d"] = phase_data_bert(torch, seed, card, train)
    (OrcaContext.train_data_store, OrcaContext.host_input_prefetch,
     OrcaContext.device_cache_bytes) = prev
    return out


def phase_data_bert(torch, seed: int, card: str, train: dict):
    """Phase 13 (d): phase 8's model and recipe fed XShards of 12 x 32
    rows in shards of BERT_SHARD_ROWS, against a dict-input fit over the
    same rows (both under deterministic algorithms); launches per step
    exact; step p50 from CUDA events as each step is queued."""
    from analytics_zoo_tpu_torch.convert import (
        bert_from_flax,
        init_bert_params,
    )
    from analytics_zoo_tpu_torch.models.bert import BERT_BASE, BERTClassifier
    from analytics_zoo_tpu_torch.ops import kernels
    from analytics_zoo_tpu_torch.orca.data import XShards
    from analytics_zoo_tpu_torch.orca.learn import Estimator
    cfg = dict(BERT_BASE, num_classes=2)
    vocab, n_blk = cfg["vocab"], cfg["n_block"]
    state = bert_from_flax(init_bert_params(cfg, seed=seed), cfg)
    steps = sum(BERT_SHARD_ROWS) // TRAIN_BATCH
    rng = np.random.default_rng(seed + 29)
    (ids, seg, mask), y, _ = train_batch(rng, steps * TRAIN_BATCH, TRAIN_T,
                                         vocab)
    edges = np.cumsum((0,) + BERT_SHARD_ROWS)
    shards = XShards([{"x": (ids[a:b], seg[a:b], mask[a:b]), "y": y[a:b]}
                      for a, b in zip(edges, edges[1:])])

    def fit(data, marks=None):
        model = BERTClassifier(**cfg, attn_impl="flash", device="cuda")
        model.load_state_dict(state)
        est = Estimator.from_torch(
            model, loss="sparse_categorical_crossentropy", optimizer="adam",
            learning_rate=2e-5, metrics=["accuracy"], seed=seed)
        if marks is not None:
            eng = est.engine

            def marked_step(batch, step=eng.train_step):
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
                return step(batch)
            eng.train_step = marked_step
        est.fit(data, epochs=1, batch_size=TRAIN_BATCH, shuffle=False)
        if marks is not None:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        torch.cuda.synchronize()
        return [s["loss"] for s in est.engine.last_steps]

    with deterministic(torch):
        want = fit({"x": [ids, seg, mask], "y": y})
        free_card(torch)
        kernels.reset_launch_counts()
        got = fit(shards)
        counts = kernels.launch_counts()
    free_card(torch)
    per_step = {"layer_norm_fwd": 2 * n_blk + 1,
                "layer_norm_bwd": 2 * n_blk + 1, "fused_dense_gelu": n_blk,
                "flash_fwd": n_blk, "flash_bwd_dq": n_blk,
                "flash_bwd_dkv": n_blk, "flash_bwd_dbias": 0,
                "paged_decode": 0}
    want_counts = {k: v * steps for k, v in per_step.items()}
    check(counts == want_counts, f"phase 13 (d): launches {counts}, "
          f"expected {want_counts} for {steps} steps")
    bodies = k2_bodies("phase 13 (d)", counts)
    check(got == want and len(got) == steps and all(np.isfinite(got)),
          f"phase 13 (d): XShards losses {got} vs the dict input's {want}")
    # the step period with PyTorch's default algorithms, as phase 8 times
    # it, XShards and the dict input over the same rows in turns
    periods = {"xshards": [], "dict": []}
    for kind in ("xshards", "dict", "dict", "xshards"):
        marks = []
        fit(shards if kind == "xshards" else {"x": [ids, seg, mask], "y": y},
            marks)
        free_card(torch)
        periods[kind].append([a.elapsed_time(b) for a, b in zip(
            marks[TRAIN_WARM:-1], marks[TRAIN_WARM + 1:])])
    p50 = {k: min(statistics.median(t) for t in v)
           for k, v in periods.items()}
    out = dict(shard_rows=list(BERT_SHARD_ROWS), steps=steps,
               losses=got, bitwise_equal_dict_input=True, launches=counts,
               launches_per_step={k: v / steps for k, v in counts.items()},
               k2_launches_by_body=bodies, step_ms_p50=p50["xshards"],
               dict_input_step_ms_p50=p50["dict"], step_ms=periods,
               phase8_step_ms_p50=train["step_ms_p50"])
    print(f"data path [{card}] (d) BERT-base fine-tune from XShards of "
          f"{list(BERT_SHARD_ROWS)} rows, batch {TRAIN_BATCH} x t = "
          f"{TRAIN_T}, {steps} steps: losses bitwise those of the dict "
          f"input (deterministic algorithms); launches per step "
          f"{out['launches_per_step']}; step p50 {p50['xshards']:.3f} ms, "
          f"the dict input over the same rows {p50['dict']:.3f} ms (the "
          f"better of 2 fits each, in turns, {len(periods['dict'][0])} "
          f"steps a fit); phase 8's repeated batch in this run "
          f"{train['step_ms_p50']:.3f} ms", flush=True)
    return out


# ----------------------------------------------------------------------
# phase 12: the BERT-base fine-tune with the full fit surface
# ----------------------------------------------------------------------

#: remat configurations of phase 12: (label, remat, remat_policy)
REMAT_CASES = (("off", False, None), ("none", True, None),
               ("dots", True, "dots"), ("dots_all", True, "dots_all"))
#: the batches phase 12 (c) times each configuration at (phase 8's batch
#: of 32, and it repeated 4 times)
REMAT_BATCHES = (32, 128)
FIT_WARM, FIT_TIMED = 2, 8
#: phase 12 (d): AdamWeightDecay(2e-5) under Warmup(5, 20), 20 steps
SCHED_LR, SCHED_WARMUP, SCHED_STEPS = 2e-5, 5, 20
#: phase 12 (e): 2 epochs of 10 steps, a raise at train.step hit 15
RESUME_EPOCHS, RESUME_STEPS, RESUME_FAULT_HIT = 2, 10, 15


def fit_surface_model(torch, cfg, state, remat=False, policy=None):
    from analytics_zoo_tpu_torch.models.bert import BERTClassifier
    model = BERTClassifier(**cfg, attn_impl="flash", remat=remat,
                           remat_policy=policy, device="cuda")
    model.load_state_dict(state)
    return model


def fit_surface_estimator(model, seed: int, optimizer=None, **kw):
    """The Estimator of phase 12: phase 8's Adam 2e-5 unless given
    another optimizer."""
    from analytics_zoo_tpu_torch.orca.learn import Estimator, optimizers
    return Estimator.from_torch(
        model, loss="sparse_categorical_crossentropy",
        optimizer=optimizer or optimizers.Adam(2e-5),
        metrics=["accuracy"], seed=seed, **kw)


def free_card(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def max_abs_diff(torch, got: dict, want: dict) -> float:
    """max over parameters of max |got - want| (gradients or params)."""
    check(got.keys() == want.keys(), "different parameter sets")
    return max(float((got[n].float() - want[n].float()).abs().max())
               for n in want)


def remat_step(torch, cfg, state, seed, inputs, y, remat, policy):
    """One fine-tune step through `TrainEngine.train_step` from the
    weights `state` and a fresh engine's generator (seeded by `seed`):
    (gradients, the generator's state after the step, launches)."""
    from analytics_zoo_tpu_torch.ops import kernels
    model = fit_surface_model(torch, cfg, state, remat, policy)
    est = fit_surface_estimator(model, seed)
    eng = est.engine
    host = {"features": tuple(inputs), "labels": (y,),
            "mask": np.ones(len(y), np.float32)}
    batch = eng.put_batch(host)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    eng.train_step(batch)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    bodies = k2_bodies(f"phase 12 (b) remat {remat} {policy}", counts)
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    gen_state = eng.generator.get_state()
    del model, est, eng, batch
    free_card(torch)
    return grads, gen_state, counts, bodies


def timed_fit(torch, est, data, batch: int):
    """`fit` of FIT_WARM + FIT_TIMED steps with a CUDA event as each step
    is queued (phase 8's timing), the peak of allocated card memory over
    it (reset before) and the launches it made: (step times in s, peak
    bytes, bytes allocated before, launches)."""
    from analytics_zoo_tpu_torch.ops import kernels
    eng = est.engine
    marks = []

    def marked_step(b, step=eng.train_step):
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        return step(b)

    eng.train_step = marked_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    est.fit(data, epochs=1, batch_size=batch, shuffle=False)
    marks.append(torch.cuda.Event(enable_timing=True))
    marks[-1].record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counts = kernels.launch_counts()
    del eng.train_step
    times = [a.elapsed_time(b) / 1e3
             for a, b in zip(marks[FIT_WARM:-1], marks[FIT_WARM + 1:])]
    return times, peak, base, counts


def remat_launches_want(n_blk: int, remat: bool, steps: int) -> dict:
    """Launches of `steps` fine-tune steps: with remat every block's two
    LayerNorms, fc1 + GELU and flash forward run again in the backward."""
    again = n_blk if remat else 0
    return {"layer_norm_fwd": (2 * n_blk + 1 + 2 * again) * steps,
            "layer_norm_bwd": (2 * n_blk + 1) * steps,
            "fused_dense_gelu": (n_blk + again) * steps,
            "flash_fwd": (n_blk + again) * steps,
            "flash_bwd_dq": n_blk * steps, "flash_bwd_dkv": n_blk * steps,
            "flash_bwd_dbias": 0, "paged_decode": 0}


def warmup_lr(step: int, dtype) -> float:
    """optax's warmup_cosine_decay_schedule(0, SCHED_LR, SCHED_WARMUP,
    SCHED_STEPS) at count `step` (0-based), each operation in `dtype`
    (np.float32 as optax computes it, the cosine of the f32 angle
    rounded once; np.float64 for the exact value)."""
    f = dtype
    c = f(step)
    if c < SCHED_WARMUP:
        frac = f(1) - c / f(SCHED_WARMUP)
        return float(f(0.0 - SCHED_LR) * frac + f(SCHED_LR))
    decay = SCHED_STEPS - SCHED_WARMUP
    c = min(c - f(SCHED_WARMUP), f(decay))
    angle = f(np.pi) * c / f(decay)
    cos = f(np.cos(np.float64(angle)))
    return float(f(SCHED_LR) * (f(0.5) * (f(1) + cos)))


@contextlib.contextmanager
def deterministic(torch):
    """PyTorch's deterministic algorithms on (warning where an op has
    none): on the card the CUDA embedding backward sums the segment
    table's 8,192 duplicate rows a step in a varying order otherwise,
    the one gradient of the step two runs do not reproduce bit for bit,
    and Adam spreads that into every weight within a few steps."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def params_of(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def ckpt_bytes(path: str) -> int:
    import os
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def phase_fit_surface(torch, seed: int, card: str):
    """Phase 12: BERT-base fine-tuning (phase 8's model and batch) with
    the rest of the fit surface: (a) remat replays the step, (b) its
    launches per step, (c) peak memory and step time per remat policy at
    two batches, (d) a Warmup schedule, (e) a checkpointed fit that
    fails once and resumes, with the save and load costs, (f)
    validation data."""
    import os
    import shutil
    import tempfile

    from analytics_zoo_tpu_torch.common.context import OrcaContext
    from analytics_zoo_tpu_torch.convert import (
        bert_from_flax,
        init_bert_params,
    )
    from analytics_zoo_tpu_torch.models.bert import BERT_BASE
    from analytics_zoo_tpu_torch.ops import kernels
    from analytics_zoo_tpu_torch.orca.learn import optimizers
    from analytics_zoo_tpu_torch.orca.learn.checkpoint import (
        load_checkpoint,
    )
    from analytics_zoo_tpu_torch.resilience import (
        get_background_checkpointer,
    )
    cfg = dict(BERT_BASE, num_classes=2)
    n_blk = cfg["n_block"]
    state = bert_from_flax(init_bert_params(cfg, seed=seed), cfg)
    state = {k: v.cuda() for k, v in state.items()}
    rng = np.random.default_rng(seed + 11)       # phase 8's batch
    inputs, y, valid = train_batch(rng, TRAIN_BATCH, TRAIN_T, cfg["vocab"])
    out = dict(batch=TRAIN_BATCH, t=TRAIN_T, valid_tokens=valid, card=card)

    # (a), (b): the first step with remat off twice (the spread), then
    # under each policy; gradients, generator state and launches.  The
    # spread of PyTorch's default algorithms is recorded first; the gate
    # runs with its deterministic ones
    pair = [remat_step(torch, cfg, state, seed, inputs, y, False, None)[0]
            for _ in range(2)]
    default_spread = {n: float((pair[1][n] - pair[0][n]).abs().max())
                      for n in pair[0]
                      if not torch.equal(pair[1][n], pair[0][n])}
    del pair
    free_card(torch)
    steps = {}
    with deterministic(torch):
        for label, remat, policy in (REMAT_CASES[0],) + REMAT_CASES:
            key = label if label not in steps else "off_again"
            steps[key] = remat_step(torch, cfg, state, seed, inputs, y,
                                    remat, policy)
    ref_grads, ref_state = steps["off"][0], steps["off"][1]
    spread = max_abs_diff(torch, steps["off_again"][0], ref_grads)
    check(torch.equal(steps["off_again"][1], ref_state),
          "phase 12 (a): two no-remat steps left the generator in "
          "different states")
    replay = {}
    for label, remat, policy in REMAT_CASES:
        grads, gen_state, counts, bodies = steps[label]
        err = max_abs_diff(torch, grads, ref_grads)
        check(err <= spread, f"phase 12 (a) remat {label}: gradients "
              f"differ from no remat by {err:.3e}, over the determinism "
              f"spread {spread:.3e}")
        check(torch.equal(gen_state, ref_state),
              f"phase 12 (a) remat {label}: the generator's state after "
              "the step differs from no remat's")
        want = remat_launches_want(n_blk, remat, 1)
        check(counts == want, f"phase 12 (b) remat {label}: launches "
              f"{counts}, expected {want}")
        replay[label] = dict(max_abs_grad_diff=err, launches=counts,
                             k2_launches_by_body=bodies)
    out["replay"] = dict(determinism_spread=spread,
                         default_algorithms_spread_by_param=default_spread,
                         by_policy=replay)
    del steps, ref_grads
    free_card(torch)
    print(f"phase 12 (a, b) [{card}] remat replay: determinism spread "
          f"{spread:.3e} (PyTorch's default algorithms: {default_spread}); "
          f"{json.dumps(replay)}", flush=True)

    # (c): peak memory and step time per configuration at two batches
    n_steps = FIT_WARM + FIT_TIMED
    mem = {}
    for batch in REMAT_BATCHES:
        reps = batch // TRAIN_BATCH
        x = [np.concatenate([a] * (reps * n_steps)) for a in inputs]
        data = {"x": x, "y": np.concatenate([y] * (reps * n_steps))}
        rows = {}
        for label, remat, policy in REMAT_CASES:
            model = fit_surface_model(torch, cfg, state, remat, policy)
            est = fit_surface_estimator(model, seed)
            times, peak, base, counts = timed_fit(torch, est, data, batch)
            want = remat_launches_want(n_blk, remat, n_steps)
            check(counts == want, f"phase 12 (c) remat {label} batch "
                  f"{batch}: launches {counts}, expected {want}")
            k2_bodies(f"phase 12 (c) remat {label}", counts)
            losses = [s["loss"] for s in est.engine.last_steps]
            check(all(np.isfinite(losses)), f"phase 12 (c): losses {losses}")
            p50 = statistics.median(times)
            rows[label] = dict(
                step_ms_p50=p50 * 1e3, step_ms=[t * 1e3 for t in times],
                peak_bytes=peak, bytes_before=base,
                step_peak_bytes=peak - base,
                padded_tokens_per_s=batch * TRAIN_T / p50,
                launches=counts)
            if batch == TRAIN_BATCH and label == "none":
                out["launches"] = counts          # the path's own count
            del model, est
            free_card(torch)
        # the peak over the fit less what was allocated before it (the
        # weights): gradients, Adam's moments, activations, temporaries
        peaks = {k: r["step_peak_bytes"] for k, r in rows.items()}
        check(peaks["none"] < peaks["dots"] <= peaks["dots_all"]
              < peaks["off"], f"phase 12 (c) batch {batch}: peak memory "
              f"{peaks} out of order none < dots <= dots_all < off")
        mem[batch] = rows
        print(f"phase 12 (c) [{card}] batch {batch} x t = {TRAIN_T}: " +
              "; ".join(f"{k} p50 {r['step_ms_p50']:.3f} ms, peak "
                        f"{r['peak_bytes'] / 2**30:.3f} GiB (over the "
                        f"weights {r['step_peak_bytes'] / 2**30:.3f})"
                        for k, r in rows.items()), flush=True)
    out["memory_and_time"] = mem

    # (d): the Warmup schedule over a 20-step fit
    kernels.reset_launch_counts()
    model = fit_surface_model(torch, cfg, state)
    est = fit_surface_estimator(model, seed, optimizers.AdamWeightDecay(
        SCHED_LR, learningrate_schedule=optimizers.Warmup(
            SCHED_WARMUP, SCHED_STEPS)))
    initial = params_of(model)
    after_first = {}
    eng = est.engine

    def first_step(b, step=eng.train_step):
        stats = step(b)
        if not after_first:
            after_first.update(params_of(model))
        return stats

    eng.train_step = first_step
    data = {"x": [np.concatenate([a] * SCHED_STEPS) for a in inputs],
            "y": np.concatenate([y] * SCHED_STEPS)}
    est.fit(data, epochs=1, batch_size=TRAIN_BATCH, shuffle=False,
            profile=True)
    del eng.train_step
    lrs = [r["lr"] for r in est.profile_stats]

    def ulps(got, want):
        return [abs(g - w) / float(np.spacing(np.float32(w))) if w else
                (0.0 if g == 0.0 else float("inf"))
                for g, w in zip(got, want)]

    # optax's f32 formula is itself up to ~20 f32 ulps from the exact
    # value where 1 + cos cancels (the cosine's tail): the card is held
    # to the f32 formula on the host, and its distance from the f64
    # value is reported
    want = [warmup_lr(i, np.float32) for i in range(SCHED_STEPS)]
    exact = [warmup_lr(i, np.float64) for i in range(SCHED_STEPS)]
    off_f32, off_f64 = ulps(lrs, want), ulps(lrs, exact)
    check(len(lrs) == SCHED_STEPS and max(off_f32) <= 4,
          f"phase 12 (d): learning rates {lrs} against optax's f32 formula "
          f"{want}: {max(off_f32)} f32 ulps apart, over 4")
    unmoved = max_abs_diff(torch, after_first, initial)
    check(unmoved == 0.0, f"phase 12 (d): the step at lr 0 moved the "
          f"parameters by up to {unmoved:.3e}")
    moved = max_abs_diff(torch, params_of(model), initial)
    check(moved > 0.0, "phase 12 (d): 20 steps did not move the weights")
    out["schedule"] = dict(lrs=lrs, want_f32=want, want_f64=exact,
                           max_ulps_from_f32=max(off_f32),
                           ulps_from_f64=off_f64,
                           first_step_moved=unmoved, moved=moved,
                           step_ms=[r["step_time_s"] * 1e3
                                    for r in est.profile_stats])
    del model, est, eng, initial, after_first
    free_card(torch)
    print(f"phase 12 (d) [{card}] Warmup({SCHED_WARMUP}, {SCHED_STEPS}) at "
          f"{SCHED_LR}: lrs {lrs}, at most {max(off_f32):.2f} f32 ulps from "
          f"optax's f32 formula on the host ({max(off_f64):.2f} from its "
          f"f64 value); the lr-0 step moved nothing", flush=True)

    # (e): checkpoint, failure and resume; (f): validation data
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    prev = (OrcaContext.failure_retry_interval_s,
            OrcaContext.background_checkpointing,
            os.environ.get("ZOO_ASYNC_CHECKPOINT"))
    try:
        OrcaContext.failure_retry_interval_s = 0.0
        data = {"x": [np.concatenate([a] * RESUME_STEPS) for a in inputs],
                "y": np.concatenate([y] * RESUME_STEPS)}

        def resume_estimator(model_dir=None):
            return fit_surface_estimator(
                fit_surface_model(torch, cfg, state), seed,
                optimizers.AdamWeightDecay(
                    SCHED_LR, learningrate_schedule=optimizers.Warmup(
                        2, RESUME_EPOCHS * RESUME_STEPS)),
                model_dir=model_dir)

        ref = resume_estimator()
        t0 = time.perf_counter()
        with deterministic(torch):
            ref.fit(data, epochs=RESUME_EPOCHS, batch_size=TRAIN_BATCH)
        torch.cuda.synchronize()
        ref_wall = time.perf_counter() - t0
        ref_params = params_of(ref.get_model())
        del ref
        free_card(torch)
        model_dir = os.path.join(tmp, "run")
        est = resume_estimator(model_dir)
        OrcaContext.fault_plan = {"faults": [
            {"site": "train.step", "at": RESUME_FAULT_HIT,
             "action": "raise"}]}
        t0 = time.perf_counter()
        try:
            with deterministic(torch):
                est.fit(data, epochs=RESUME_EPOCHS, batch_size=TRAIN_BATCH)
        finally:
            OrcaContext.fault_plan = None
        torch.cuda.synchronize()
        fit_wall = time.perf_counter() - t0
        diff = max_abs_diff(torch, params_of(est.get_model()), ref_params)
        check(est.retries == 1 and est.epoch == RESUME_EPOCHS,
              f"phase 12 (e): retries {est.retries}, epoch {est.epoch}")
        check(diff <= spread, f"phase 12 (e): the resumed fit's parameters "
              f"differ from an uninterrupted fit's by {diff:.3e}, over the "
              f"determinism spread {spread:.3e}")
        versions = sorted(n for n in os.listdir(model_dir)
                          if n.startswith("ckpt-") and "." not in n)
        check(versions == [f"ckpt-{RESUME_STEPS}",
                           f"ckpt-{RESUME_EPOCHS * RESUME_STEPS}"],
              f"phase 12 (e): checkpoints {versions}")
        shutil.rmtree(os.path.join(model_dir, versions[0]))
        last = os.path.join(model_dir, versions[1])
        # the save's critical path, sync then background, of the same
        # state (each overwrites the last version: one stays on disk)
        os.environ["ZOO_ASYNC_CHECKPOINT"] = "0"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est.save_checkpoint()
        sync_s = time.perf_counter() - t0
        del os.environ["ZOO_ASYNC_CHECKPOINT"]
        OrcaContext.background_checkpointing = True
        writer = get_background_checkpointer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est.save_checkpoint()
        background_s = time.perf_counter() - t0
        writer.drain()
        t0 = time.perf_counter()
        host_state = load_checkpoint(last)
        read_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        est.engine.load_state_dict(host_state)
        torch.cuda.synchronize()
        to_card_s = time.perf_counter() - t0
        del host_state
        nbytes = ckpt_bytes(last)
        final = params_of(est.get_model())
        check(max_abs_diff(torch, final, ref_params) <= spread,
              "phase 12 (e): a load of the last checkpoint changed the "
              "parameters")
        del est
        free_card(torch)
        fresh = resume_estimator(model_dir)
        got = fresh.resume_latest()
        resumed = max_abs_diff(torch, params_of(fresh.get_model()), final)
        check(got == last and fresh.epoch == RESUME_EPOCHS
              and resumed == 0.0,
              f"phase 12 (e): resume_latest gave {got}, epoch "
              f"{fresh.epoch}, parameters {resumed:.3e} apart")
        out["resume"] = dict(
            retries=1, epochs=RESUME_EPOCHS, steps_per_epoch=RESUME_STEPS,
            fault_hit=RESUME_FAULT_HIT, max_abs_param_diff=diff,
            checkpoint_bytes=nbytes, save_sync_s=sync_s,
            save_background_critical_path_s=background_s,
            background_snapshot_s=writer.last_snapshot_s,
            background_write_s=writer.last_write_s,
            load_read_s=read_s, load_to_card_s=to_card_s,
            uninterrupted_fit_wall_s=ref_wall,
            interrupted_fit_wall_s=fit_wall, resumed_epoch=fresh.epoch)
        print(f"phase 12 (e) [{card}] {RESUME_EPOCHS} x {RESUME_STEPS}-step "
              f"fit, a raise at train.step hit {RESUME_FAULT_HIT}: retries 1,"
              f" parameters {diff:.3e} from the uninterrupted fit; "
              f"checkpoint {nbytes} bytes: save sync {sync_s:.3f} s, "
              f"background {background_s:.3f} s on the critical path "
              f"(write {writer.last_write_s:.3f} s on the writer thread); "
              f"load {read_s:.3f} s read + {to_card_s:.3f} s to the card; "
              f"resume_latest restored epoch {fresh.epoch}", flush=True)

        # (f): validation after each epoch equals evaluate after it, on
        # a fresh Adam fit (the resumed schedule has reached lr 0)
        del fresh
        free_card(torch)
        fresh = fit_surface_estimator(fit_surface_model(torch, cfg, state),
                                      seed)
        vrng = np.random.default_rng(seed + 12)
        vx, vy, _ = train_batch(vrng, 2 * TRAIN_BATCH, TRAIN_T,
                                cfg["vocab"])
        val = {"x": list(vx), "y": vy}
        small = {"x": [np.concatenate([a] * 2) for a in inputs],
                 "y": np.concatenate([y] * 2)}
        rows = []
        for _ in range(2):
            fresh.fit(small, epochs=1, batch_size=TRAIN_BATCH,
                      validation_data=val)
            ev = fresh.evaluate(val, batch_size=TRAIN_BATCH)
            row = fresh.val_summary[-1]
            rel = abs(row["loss"] - ev["loss"]) / abs(ev["loss"])
            check(rel <= 1e-6 and row["accuracy"] == ev["accuracy"],
                  f"phase 12 (f): val_summary {row} against evaluate {ev}")
            rows.append(dict(row, evaluate_loss=ev["loss"], rel_diff=rel))
        check(len(fresh.val_summary) == 2,
              f"phase 12 (f): {len(fresh.val_summary)} validation rows for "
              "2 epochs")
        out["validation"] = rows
        print(f"phase 12 (f) [{card}] val_summary {rows}", flush=True)
        del fresh
    finally:
        (OrcaContext.failure_retry_interval_s,
         OrcaContext.background_checkpointing) = prev[:2]
        if prev[2] is None:
            os.environ.pop("ZOO_ASYNC_CHECKPOINT", None)
        else:
            os.environ["ZOO_ASYNC_CHECKPOINT"] = prev[2]
        get_background_checkpointer().drain(raise_on_error=False)
        shutil.rmtree(tmp, ignore_errors=True)
        free_card(torch)
    return out, (cfg, state, inputs, y)


def fit_surface_profiles(torch, out: dict, ctx, seed: int, card: str):
    """Where a batch-32 step's time goes under each remat configuration
    (host wall, device work by op), after every timed phase: a profiler
    session leaves tracing costs on the host that slow the steps timed
    after it."""
    cfg, state, inputs, y = ctx
    batch = ([torch.from_numpy(a).cuda() for a in inputs],
             torch.from_numpy(y).long().cuda())
    rows = out["memory_and_time"][TRAIN_BATCH]
    for label, remat, policy in REMAT_CASES:
        est = fit_surface_estimator(
            fit_surface_model(torch, cfg, state, remat, policy), seed)
        rows[label]["step_profile"] = train_profile(torch, est, batch)
        del est
        free_card(torch)
    print(f"phase 12 step profiles [{card}] batch {TRAIN_BATCH}: " +
          "; ".join(f"{k} wall {r['step_profile']['wall_ms_per_step']:.3f} "
                    f"ms, device work "
                    f"{r['step_profile']['device_ms_per_step_all_events']:.3f}"
                    f" ms" for k, r in rows.items()), flush=True)


# ----------------------------------------------------------------------
# phase 6: slice 1, generation serving
# ----------------------------------------------------------------------

def decode_profile(torch, engine, vocab: int, seed: int, steps: int = 5):
    """Where a decode step's time goes, with every lane busy (prompts of
    200 tokens): host wall per step without the profiler, then device
    time per step, by device op, from a profiled window."""
    import numpy as np
    rng = np.random.default_rng(seed)
    streams = [engine.submit(rng.integers(0, vocab, 200).tolist(),
                             max_new_tokens=3 * steps + 2)
               for _ in range(engine.max_slots)]
    engine.step()                 # admit + prefill every lane, 1 decode
    check(len(engine.scheduler.running()) == engine.max_slots,
          "decode profile: not every lane was admitted in one round")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps * 1e3
    dev, per, prof = device_ms(engine.step, iters=steps)
    host = sorted(((e.key, e.self_cpu_time_total / 1e3 / steps, e.count
                    / steps) for e in prof.key_averages()),
                  key=lambda t: -t[1])[:12]
    engine.run_until_idle()
    check(all(len(s.tokens()) == 3 * steps + 2 for s in streams),
          "decode profile: a request was cut short")
    top = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    return dict(lanes=engine.max_slots, prompt_len=200,
                wall_ms_per_step=wall, device_ms_per_step=dev,
                device_busy_share=(dev / wall if dev else None),
                top_device_ops_ms_per_step=[(n[:100], v) for n, v in top],
                top_host_ops_self_ms_and_calls_per_step=[
                    (n[:100], ms, c) for n, ms, c in host])


def serve(torch, model, n_requests: int, kv_quantization, seed: int,
          label: str, tol: float, cache_dtype=None):
    """Serve `n_requests` greedy requests through the background loop
    (the KV pool at `cache_dtype`, f32 by default), check launch counts,
    K6's body and the served logits; returns (summary, engine)."""
    import numpy as np

    from analytics_zoo_tpu_torch.ops import kernels
    from analytics_zoo_tpu_torch.ops.kernels.paged_attention import (
        paged_decode,
    )
    from analytics_zoo_tpu_torch.serving.generation import GenerationEngine

    n_block = model.n_block
    engine = GenerationEngine(model, max_slots=8, block_size=16,
                              max_context=1024,
                              cache_dtype=cache_dtype or torch.float32,
                              kv_quantization=kv_quantization,
                              keep_logits=True, device="cuda")
    t0 = time.perf_counter()
    engine.warmup()
    warm_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, model.vocab, int(n)).tolist()
               for n in rng.integers(32, 513, n_requests)]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    streams = [engine.submit(p, max_new_tokens=64) for p in prompts]
    engine.ensure_started()
    try:
        outs = [s.tokens() for s in streams]
    finally:
        engine.stop()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    for s, out in zip(streams, outs):
        check(s.finish_reason == "length" and len(out) == 64,
              f"{label}: a request ended {s.finish_reason!r} after "
              f"{len(out)} tokens")
    n_pre, n_dec = engine.n_prefills, engine.n_decode_steps
    check(n_pre >= n_requests and n_dec > 0,
          f"{label}: {n_pre} prefills, {n_dec} decode steps")
    want_ln = (2 * n_block + 1) * (n_pre + n_dec)
    want_pd = n_block * n_dec
    check(counts["layer_norm_fwd"] == want_ln,
          f"{label}: K1 launched {counts['layer_norm_fwd']} times, "
          f"expected {want_ln}")
    check(counts["paged_decode"] == want_pd,
          f"{label}: K6 launched {counts['paged_decode']} times, "
          f"expected {want_pd}")
    bodies = dict(paged_decode.launches_by_body)
    check(bodies["split"] == want_pd,
          f"{label}: K6 launches by body {bodies}; all {want_pd} must take "
          "the split body")

    # recompute every finished stream once through the plain versions
    worst, n_cmp, n_top = 0.0, 0, 0
    with torch.no_grad():
        for s, prompt, out in zip(streams, prompts, outs):
            seq = prompt + out
            ids = torch.tensor([seq], dtype=torch.int32, device="cuda")
            pos = torch.arange(len(seq), device="cuda")[None]
            ref, _, _ = model(ids, pos, token_mask=torch.ones_like(ids),
                              impl="reference")
            ref = ref[0, len(prompt) - 1:len(seq) - 1]
            got = torch.stack(s.seq.logits)
            check(bool(torch.isfinite(got).all()),
                  f"{label}: non-finite served logits")
            worst = max(worst, float((got - ref).abs().max()))
            top2 = torch.topk(ref, 2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > tol
            agree = torch.tensor(out, device="cuda") == ref.argmax(-1)
            check(bool(agree[clear].all()),
                  f"{label}: a served token is not the recompute's argmax "
                  f"where the top-2 gap exceeds {tol}")
            n_cmp += got.shape[0]
            n_top += int(clear.sum())
    check(worst <= tol, f"{label}: served logits differ from the plain "
          f"recompute by {worst} > {tol}")

    n_tok = sum(len(o) for o in outs)
    dec = sorted(engine.decode_seconds)
    by_bucket = {}
    for b, sec in engine.prefill_seconds:
        by_bucket.setdefault(b, []).append(sec * 1e3)
    summary = dict(
        label=label, requests=n_requests, kv_quantization=kv_quantization,
        cache_dtype=str(cache_dtype or torch.float32),
        generated_tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall,
        warmup_s=warm_s, prefills=n_pre, decode_steps=n_dec,
        preemptions=engine.scheduler.n_preemptions,
        decode_step_ms_p50=statistics.median(dec) * 1e3,
        prefill_ms_p50_by_bucket={b: statistics.median(v)
                                  for b, v in sorted(by_bucket.items())},
        launches=counts, logits_max_abs_err=worst, logits_compared=n_cmp,
        argmax_checked=n_top)
    return summary, engine


def phase_slice(torch, n_requests: int, seed: int, card: str):
    from analytics_zoo_tpu_torch.convert import (
        causal_lm_from_flax,
        init_causal_lm_params,
    )
    from analytics_zoo_tpu_torch.serving.generation import (
        GPT2_SMALL,
        CausalLM,
    )
    t0 = time.perf_counter()
    params = init_causal_lm_params(GPT2_SMALL, seed=seed)
    model = CausalLM(**GPT2_SMALL, device="cuda")
    model.load_state_dict(causal_lm_from_flax(params, GPT2_SMALL))
    del params
    n_params = sum(p.numel() for p in model.parameters())
    print(f"slice: CausalLM at GPT-2 small widths, {n_params} params, f32, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    # f32 pool: served logits vs the plain recompute within 1e-3 (f32
    # throughout; kernels and matmul shapes differ from the recompute)
    f32, engine = serve(torch, model, n_requests, None, seed, "f32", 1e-3)
    # int8 pool: each cached K/V element is rounded by up to amax/254,
    # so the served logits drift from the full-precision recompute by
    # more than the kernels' own error (held to 1e-4 in phase 3); this
    # bound checks that drift stays small
    int8, _ = serve(torch, model, max(4, n_requests // 3), "int8",
                    seed + 1, "int8", 0.5)
    # f16 pool (bench.py's generation configuration): each cached K/V
    # element is rounded to within 2^-11 of its value, an eighth of the
    # int8 pool's amax/254 (about 2^-8 of the row's largest value), so
    # the drift from the f32 recompute is held to an eighth of the int8
    # bound
    f16, _ = serve(torch, model, max(4, n_requests // 3), None, seed + 2,
                   "f16", 0.5 / 8, cache_dtype=torch.float16)
    runs = [f32, int8, f16]
    for r in runs:
        pre = {b: round(v, 3)
               for b, v in r["prefill_ms_p50_by_bucket"].items()}
        print(f"slice [{card}] {r['label']}: {r['requests']} requests, "
              f"{r['generated_tokens']} tokens in {r['wall_s']:.3f} s = "
              f"{r['tokens_per_s']:.1f} tokens/s; decode step p50 "
              f"{r['decode_step_ms_p50']:.3f} ms over {r['decode_steps']} "
              f"steps; prefill ms p50 by bucket "
              f"{pre}; "
              f"{r['prefills']} prefills, {r['preemptions']} preemptions; "
              f"launches {r['launches']}; logits max abs err "
              f"{r['logits_max_abs_err']:.3e} over "
              f"{r['logits_compared']} positions", flush=True)
    return runs, engine


def kernel_entry(name, route, source, replaces, launches, shapes,
                 main: int, checks=()):
    """One kernel's record of the result line: the numbers at its main
    path's shape (`shapes[main]`), every shape beside them; its max abs
    err also covers the untimed `checks` (max abs errs)."""
    m = shapes[main]
    entry = dict(name=name, route=route, source=source, replaces=replaces,
                 launches=launches,
                 max_abs_err=max([s["max_abs_err"] for s in shapes]
                                 + list(checks)),
                 ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
                 bound_by=m["bound_by"], library_ms=m["library_ms"],
                 shapes=shapes)
    return entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from analytics_zoo_tpu_torch.ops.kernels import _build

    # phase 1: setup
    start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    logs = _build.build(_build.cuda_sources(), extra_flags=["-Xptxas", "-v"])
    print(f"built CUDA sources {_build.cuda_sources()} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in logs.items():
        print(f"nvcc {name}:\n{log.strip()}", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    t0 = time.perf_counter()
    from analytics_zoo_tpu_torch.ops.kernels.layer_norm import layer_norm_fwd
    x = torch.ones(1, D_MODEL, device="cuda")
    layer_norm_fwd(x, x[0], x[0])
    torch.cuda.synchronize()
    print(f"built the Triton LayerNorm kernel in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    clocks("before phase 2", start)
    ln = phase_layer_norm(torch, gen)
    pd = phase_paged(torch, gen)
    fd = phase_fused_dense(torch, gen)
    fa, fa_edges = phase_flash(torch, gen)
    lnb = phase_layer_norm_bwd(torch, gen)
    fab, fab_ragged = phase_flash_bwd(torch, gen)
    wide = phase_flash_wide(torch)
    threads = phase_threads(torch)
    clocks("after phase 5d", start)
    runs, engine = phase_slice(torch, args.requests, args.seed, card)
    clocks("after phase 6", start)
    bert_runs, bert_model = phase_bert(torch, args.seed, card)
    clocks("after phase 7", start)
    train, est, train_batch_ = phase_train(torch, args.seed, card)
    bias_run, bias_est, bias_batch = phase_bias_path(torch, args.seed, card)
    clocks("after phase 9", start)
    fit_surface, fit_ctx = phase_fit_surface(torch, args.seed, card)
    clocks("after phase 12", start)
    rec = phase_recommendation(torch, args.seed, card)
    clocks("after phase 11", start)
    data_path = phase_data_path(torch, args.seed, card, rec, train)
    clocks("after phase 13", start)

    # phase 10: device times from the profiler, after the timed serving
    # (a profiler session may leave tracing costs behind on the host)
    for shape in ln + pd + fd + fa + lnb + [s for v in fab.values()
                                             for s in v]:
        device_times(shape)
        subtract_forward(shape, "library_ms")
        what = {k: shape[k] for k in ("rows", "pool", "dtype", "m", "k", "n",
                                      "b", "t") if k in shape}
        print(f"{shape['name']} {what} device time per call [{card}] "
              f"({shape['ms_from']}): kernel {shape['ms']:.5f} ms, plain "
              f"{shape['plain_ms']:.5f} ms, library "
              f"{shape['library_ms']:.5f} ms, bound {shape['bound_ms']:.5f} "
              f"ms" + (f", cp_async body {shape['cp_async_ms']:.5f} ms"
                       if "cp_async_ms" in shape else "")
              + (f", rows body (the PR 1 design) {shape['rows_ms']:.5f} ms"
                 f", every lane at 16 tokens {shape['floor_ms']:.5f} ms"
                 if "rows_ms" in shape else ""), flush=True)
    clocks("after phase 10 kernel timings", start)
    engine.keep_logits = False
    runs[0]["decode_profile"] = decode_profile(
        torch, engine, engine.model.vocab, args.seed + 7)
    print(f"decode step profile [{card}]: "
          f"{json.dumps(runs[0]['decode_profile'])}", flush=True)
    bert_runs[0]["forward_profile"] = bert_profile(torch, bert_model,
                                                   args.seed + 9)
    print(f"BERT forward profile [{card}]: "
          f"{json.dumps(bert_runs[0]['forward_profile'])}", flush=True)
    train["step_profile"] = train_profile(torch, est, train_batch_)
    # the fit's steps run back to back, with no host wait between them
    train["step_profile"]["device_share_of_fit_step_p50"] = \
        train["step_profile"]["device_ms_per_step_all_events"] \
        / train["step_ms_p50"]
    print(f"BERT train step profile [{card}]: "
          f"{json.dumps(train['step_profile'])}", flush=True)
    bias_run["step_profile"] = train_profile(torch, bias_est, bias_batch)
    print(f"learnable-bias step profile [{card}]: "
          f"{json.dumps(bias_run['step_profile'])}", flush=True)
    fit_surface_profiles(torch, fit_surface, fit_ctx, args.seed, card)
    del fit_ctx

    clocks("at the end", start)
    gpt2, bert = runs[0]["launches"], bert_runs[0]["launches"]
    tr, remat = train["launches"], fit_surface["launches"]
    xs_bert = data_path["d"]["launches"]
    kernels = [
        kernel_entry("layer_norm_fwd", "triton",
                     "analytics_zoo_tpu_torch/ops/kernels/layer_norm.py",
                     "analytics_zoo_tpu/ops/pallas/layer_norm.py:78",
                     tr["layer_norm_fwd"], ln, 2),
        kernel_entry("layer_norm_bwd", "triton",
                     "analytics_zoo_tpu_torch/ops/kernels/layer_norm.py",
                     "analytics_zoo_tpu/ops/pallas/layer_norm.py:108",
                     tr["layer_norm_bwd"], lnb, 0),
        kernel_entry("fused_dense_gelu", "cuda",
                     "analytics_zoo_tpu_torch/csrc/fused_dense.cu",
                     "analytics_zoo_tpu/ops/pallas/fused_dense.py:79",
                     tr["fused_dense_gelu"], fd, 2),
        kernel_entry("flash_fwd", "cuda",
                     "analytics_zoo_tpu_torch/csrc/flash_fwd.cu",
                     "analytics_zoo_tpu/ops/pallas/flash_attention.py:408",
                     tr["flash_fwd"], fa, 2,
                     [c["max_abs_err"] for c in fa_edges.values()]),
        kernel_entry("flash_bwd_dq", "cuda",
                     "analytics_zoo_tpu_torch/csrc/flash_bwd.cu",
                     "analytics_zoo_tpu/ops/pallas/flash_attention.py:741",
                     tr["flash_bwd_dq"], fab["flash_bwd_dq"], 2,
                     [c["max_abs_err"][0] for c in fab_ragged.values()]),
        kernel_entry("flash_bwd_dkv", "cuda",
                     "analytics_zoo_tpu_torch/csrc/flash_bwd.cu",
                     "analytics_zoo_tpu/ops/pallas/flash_attention.py:825",
                     tr["flash_bwd_dkv"], fab["flash_bwd_dkv"], 2,
                     [c["max_abs_err"][1] for c in fab_ragged.values()]),
        kernel_entry("flash_bwd_dbias", "cuda",
                     "analytics_zoo_tpu_torch/csrc/flash_bwd.cu",
                     "analytics_zoo_tpu/ops/pallas/flash_attention.py:807",
                     bias_run["launches"]["flash_bwd_dbias"],
                     fab["flash_bwd_dbias"], 2),
        kernel_entry("paged_decode", "cuda",
                     "analytics_zoo_tpu_torch/csrc/paged_decode.cu",
                     "analytics_zoo_tpu/ops/pallas/paged_attention.py:155",
                     gpt2["paged_decode"], pd, 0),
    ]
    by_path = {"layer_norm_fwd": {"generation": gpt2, "bert_serving": bert,
                                  "bert_fine_tune": tr,
                                  "bert_fine_tune_remat": remat,
                                  "bert_fine_tune_xshards": xs_bert},
               "layer_norm_bwd": {"bert_fine_tune": tr,
                                  "bert_fine_tune_remat": remat,
                                  "bert_fine_tune_xshards": xs_bert},
               "fused_dense_gelu": {"bert_serving": bert,
                                    "bert_fine_tune": tr,
                                    "bert_fine_tune_remat": remat,
                                    "bert_fine_tune_xshards": xs_bert},
               "flash_fwd": {"bert_serving": bert, "bert_fine_tune": tr,
                             "learnable_bias": bias_run["launches"],
                             "bert_fine_tune_remat": remat,
                             "bert_fine_tune_xshards": xs_bert},
               "flash_bwd_dq": {"bert_fine_tune": tr,
                                "learnable_bias": bias_run["launches"],
                                "bert_fine_tune_remat": remat,
                                "bert_fine_tune_xshards": xs_bert},
               "flash_bwd_dkv": {"bert_fine_tune": tr,
                                 "learnable_bias": bias_run["launches"],
                                 "bert_fine_tune_remat": remat,
                                 "bert_fine_tune_xshards": xs_bert},
               "paged_decode": {f"generation_{r['label']}": r["launches"]
                                for r in runs}}
    for k in kernels:
        paths = by_path.get(k["name"])
        if paths:
            k["launches_by_path"] = {p: c[k["name"]] for p, c in paths.items()}
        # no kernel lies on phase 11's path nor on phase 13's NCF and
        # optimizer runs (checked there: all 0)
        k.setdefault("launches_by_path", {})["recommendation_training"] = \
            rec["launches"][k["name"]]
        k["launches_by_path"]["data_path_recommendation"] = \
            data_path["launches_recommendation"][k["name"]]
        check(k["launches"] > 0, f"{k['name']} was not launched on its path")
    print(json.dumps({"card": card, "slice": runs, "bert": bert_runs,
                      "train": train, "bias_path": bias_run,
                      "recommendation": rec, "fit_surface": fit_surface,
                      "data_path": data_path,
                      "flash_fwd_boundary": fa_edges,
                      "flash_bwd_ragged_t": fab_ragged,
                      "flash_bh_past_65535": wide,
                      "threads": threads}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
