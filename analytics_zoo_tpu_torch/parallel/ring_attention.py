"""Ring attention: sequence parallelism over the "sp" axis (counterpart of
analytics_zoo_tpu/parallel/ring_attention.py).

The sequence dimension of q, k and v is split over the ranks of the
mesh's "sp" group (`init_orca_context(cluster_mode="distributed",
mesh_shape={"sp": N})`).  Each rank keeps its q shard and attends to the
k/v shard it holds, then passes that shard on to the next rank of the
ring, N steps in all; the shards' results merge by their logsumexp
(`logaddexp` in f32), so the [T, T] scores never exist.

Forward, as JAX's flash ring (ring_attention.py:196-271): with `causal`
the diagonal step runs the kernel's causal mask, shards of earlier
positions are attended fully and later ones launch nothing.  The
[b, t] `kv_mask` travels with its k/v shard.  A bias shard (this rank's
q rows against every key, [1|b, 1|h, t_local, T]) has the columns of
the k/v shard held sliced at each step.  Dropout hashes the global
(q, k) positions (`dropout_pos`), so the keep mask is the unsharded
call's.

Backward: JAX differentiates through `ppermute`; torch does not through
send/recv, so the ring is one `torch.autograd.Function` whose backward is
a second ring.  Each live step runs the flash backward on the held
shard with the merged lse and delta = rowsum(dO * O): dQ accumulates on
its rank, dK and dV in f32 accumulators that travel with their shard
and reach its owner after the last step, and a bias gradient lands in
the columns of the held shard.  That is the gradient of JAX's merge
(the lse cotangent of each block folds into the merged delta).

impl: "flash" runs the CUDA kernels (`ops/kernels/flash_attention.py`:
K3 forward, K4a dQ, K4b dK/dV, K5 dbias) on a CUDA tensor and their
plain versions on a CPU tensor; "einsum" the plain versions on either,
as JAX's einsum ring is plain XLA; "auto" flash at a shard of
`RING_FLASH_MIN_TLOCAL` positions or more.  No `try` lets a kernel give
way to its plain version.

The exchange is `torch.distributed.batch_isend_irecv` to the ring's
neighbours.  Under gloo, which sends host tensors only, a card's
tensors are copied through pinned host buffers; the kernels run on the
card either way.  `ring_self_attention` takes the global arrays on
every rank, slices this rank's shard, runs the ring and all-gathers the
output, so every rank holds the whole output and, in the backward, the
whole gradients.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from analytics_zoo_tpu_torch.common.context import current_mesh
from analytics_zoo_tpu_torch.ops.attention import flash_attention
from analytics_zoo_tpu_torch.ops.kernels.flash_attention import (
    NEG_INF,
    flash_bwd,
    flash_bwd_reference,
    flash_fwd,
    flash_fwd_reference,
)

#: impl="auto" takes the flash kernels from this shard length on (JAX's
#: crossover; below it the per-shard scores are small)
RING_FLASH_MIN_TLOCAL = 2048

_IMPLS = ("einsum", "flash", "auto")


class _Transport:
    """Neighbour shifts and gathers along one process group.  Under
    gloo a card's tensor is staged through a pinned host buffer (gloo's
    send and recv take host tensors)."""

    def __init__(self, group):
        self.group = group
        ranks = dist.get_process_group_ranks(group)
        self.size = len(ranks)
        self.index = dist.get_rank(group)
        self.next = ranks[(self.index + 1) % self.size]
        self.prev = ranks[(self.index - 1) % self.size]
        self.staged = dist.get_backend(group) == "gloo"

    def _host(self, t):
        return self.staged and t.is_cuda

    def shift(self, tensors: List[torch.Tensor]) -> "_Shift":
        """Start sending `tensors` to the next rank and receiving the
        previous rank's of the same shapes; `.wait()` returns them."""
        sends, recvs, ops = [], [], []
        for t in tensors:
            t = t.contiguous()
            if self._host(t):
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t)
                t = host
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            else:
                buf = torch.empty_like(t)
            sends.append(t)
            recvs.append(buf)
            ops.append(dist.P2POp(dist.isend, t, self.next, self.group))
            ops.append(dist.P2POp(dist.irecv, buf, self.prev, self.group))
        return _Shift(dist.batch_isend_irecv(ops), sends, recvs,
                      [t.device for t in tensors])

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's `t`, concatenated along `dim` in rank order."""
        t = t.contiguous()
        dev = t.device
        if self._host(t):
            t = t.to("cpu")
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=dim).to(dev)


class _Shift:
    """An exchange in flight; its buffers live until `wait`."""

    def __init__(self, works, sends, recvs, devices):
        self.works, self.sends = works, sends
        self.recvs, self.devices = recvs, devices

    def wait(self) -> List[torch.Tensor]:
        for w in self.works:
            w.wait()
        return [r.to(d, non_blocking=True)
                for r, d in zip(self.recvs, self.devices)]


def _group(axis_name: str):
    mesh = current_mesh()
    group = None if mesh is None else mesh.groups.get(axis_name)
    if group is None:
        raise ValueError(
            f"ring attention needs a process group on the {axis_name!r} "
            "axis: init_orca_context(cluster_mode='distributed', "
            f"mesh_shape={{{axis_name!r}: N}})")
    return group


def _as_seed(seed, device) -> torch.Tensor:
    return torch.as_tensor(seed, device=device).to(torch.int32).reshape(1)


def _seed3(seed, q_off: int, k_off: int):
    """(seed, global q offset, global k offset), int32 [3] on the seed's
    device, filled there (a host copy would synchronize the stream)."""
    if seed is None:
        return None
    offs = torch.full((2,), 0, dtype=torch.int32, device=seed.device)
    offs[0], offs[1] = q_off, k_off
    return torch.cat([seed, offs])


def _step_kind(causal: bool, src: int, me: int) -> str:
    """"full", "diag" (the causal diagonal) or "dead" (a later shard
    under causal masking: nothing to attend, nothing launched)."""
    if not causal:
        return "full"
    if src == me:
        return "diag"
    return "full" if src < me else "dead"


def _cols(bias, src: int, tl: int):
    """The bias columns of shard `src`, as the kernels take a bias: f32,
    contiguous."""
    if bias is None:
        return None
    return bias[..., src * tl:(src + 1) * tl].float().contiguous()


def _rows_bthd(x, b, h, tl):
    """[b*h, t] -> [b, t, h, 1]."""
    return x.reshape(b, h, tl).permute(0, 2, 1)[..., None]


class _Ring(torch.autograd.Function):
    """The ring's forward and its backward ring (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, kv_mask, seed, transport, causal,
                dropout, kernel):
        n, me = transport.size, transport.index
        b, tl, h, d = q.shape
        fwd = flash_fwd if kernel else flash_fwd_reference
        o = torch.zeros((b, tl, h, d), dtype=torch.float32, device=q.device)
        lse = torch.full((b * h, tl), NEG_INF, dtype=torch.float32,
                         device=q.device)
        cur = [k, v] + ([kv_mask] if kv_mask is not None else [])
        for step in range(n):
            src = (me - step) % n
            pending = transport.shift(cur) if step < n - 1 else None
            kind = _step_kind(causal, src, me)
            if kind != "dead":
                o_blk, lse_blk = fwd(
                    q, cur[0], cur[1], cur[2] if len(cur) > 2 else None,
                    _cols(bias, src, tl), _seed3(seed, me * tl, src * tl),
                    kind == "diag", dropout)
                new = torch.logaddexp(lse, lse_blk)
                o = (o * _rows_bthd(torch.exp(lse - new), b, h, tl)
                     + o_blk.float()
                     * _rows_bthd(torch.exp(lse_blk - new), b, h, tl))
                lse = new
            if pending is not None:
                cur = pending.wait()
        ctx.save_for_backward(q, k, v, bias, kv_mask, seed, o, lse)
        ctx.args = (transport, causal, dropout, kernel)
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, kv_mask, seed, o, lse = ctx.saved_tensors
        transport, causal, dropout, kernel = ctx.args
        n, me = transport.size, transport.index
        b, tl, h, d = q.shape
        bwd = flash_bwd if kernel else flash_bwd_reference
        bias_grad = bias is not None and ctx.needs_input_grad[3]
        dout = dout.to(q.dtype).contiguous()
        # the merged output's delta (a plain op, as in JAX)
        delta = (dout.float() * o).sum(-1).permute(0, 2, 1) \
            .reshape(b * h, tl).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkv = [torch.zeros(k.shape, dtype=torch.float32, device=q.device)
               for _ in range(2)]
        dbias = (torch.zeros(bias.shape, dtype=torch.float32,
                             device=q.device) if bias_grad else None)
        cur = [k, v] + ([kv_mask] if kv_mask is not None else [])
        for step in range(n):
            src = (me - step) % n
            pending = transport.shift(cur) if step < n - 1 else None
            kind = _step_kind(causal, src, me)
            if kind != "dead":
                dq_b, dk_b, dv_b, db_b = bwd(
                    q, cur[0], cur[1], dout, lse, delta,
                    cur[2] if len(cur) > 2 else None, _cols(bias, src, tl),
                    _seed3(seed, me * tl, src * tl), kind == "diag",
                    dropout, bias_grad=bias_grad)
                dq += dq_b.float()
                dkv[0] += dk_b.float()
                dkv[1] += dv_b.float()
                if bias_grad:
                    dbias[..., src * tl:(src + 1) * tl] += db_b
            # the dK/dV accumulators travel with their shard; after the
            # last step's shift they are at its owner
            dkv = transport.shift(dkv).wait()
            if pending is not None:
                cur = pending.wait()
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None if dbias is None else dbias.to(bias.dtype),
                None, None, None, None, None, None)


def ring_attention(q, k, v, axis_name: str = "sp", causal: bool = False,
                   kv_mask=None, impl: str = "einsum", bias=None,
                   dropout_rate: float = 0.0, dropout_seed=None):
    """One rank's ring attention.  q, k, v: this rank's [b, t_local, h,
    d] shards of the sequence; kv_mask: its [b, t_local] key-validity
    shard (1 = attend); bias: its [1|b, 1|h, t_local, T] rows against
    every key; dropout_seed: an int32 seed, the same on every rank.
    Returns this rank's output shard [b, t_local, h, d] at q's dtype,
    differentiable in q, k, v and the bias."""
    return _ring(q, k, v, _Transport(_group(axis_name)), causal, kv_mask,
                 impl, bias, dropout_rate, dropout_seed)


def _ring(q, k, v, transport, causal, kv_mask, impl, bias, dropout_rate,
          dropout_seed):
    if impl not in ("einsum", "flash"):
        raise ValueError("impl must be 'einsum' or 'flash'")
    dropout_rate = float(dropout_rate)
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 needs dropout_seed (the same "
                         "on every rank)")
    b, tl, h, _ = q.shape
    if bias is not None and (
            bias.dim() != 4 or bias.shape[0] not in (1, b)
            or bias.shape[1] not in (1, h)
            or tuple(bias.shape[2:]) != (tl, tl * transport.size)):
        raise ValueError(
            f"bias shard shape {tuple(bias.shape)} != (1|{b}, 1|{h}, {tl}, "
            f"{tl * transport.size})")
    seed = (_as_seed(dropout_seed, q.device) if dropout_rate > 0.0
            else None)
    if kv_mask is not None:
        kv_mask = kv_mask.to(torch.int32).contiguous()
    kernel = impl == "flash" and q.is_cuda
    return _Ring.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                       bias, kv_mask, seed, transport, causal,
                       dropout_rate, kernel)


class _SliceSeq(torch.autograd.Function):
    """This rank's shard of a global tensor along `dim`; the backward
    gathers every rank's gradient shard (each rank computes the same
    global loss, so nothing is summed)."""

    @staticmethod
    def forward(ctx, x, dim, transport):
        ctx.args = (dim, transport)
        tl = x.shape[dim] // transport.size
        return x.narrow(dim, transport.index * tl, tl).contiguous()

    @staticmethod
    def backward(ctx, g):
        dim, transport = ctx.args
        return transport.all_gather(g, dim), None, None


class _GatherSeq(torch.autograd.Function):
    """Every rank's shard along `dim`, concatenated; the backward takes
    this rank's rows of the (identical on every rank) gradient."""

    @staticmethod
    def forward(ctx, x, dim, transport):
        ctx.args = (dim, transport, x.shape[dim])
        return transport.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        dim, transport, tl = ctx.args
        return g.narrow(dim, transport.index * tl, tl), None, None


def ring_self_attention(q, k, v, mesh=None, causal: bool = False,
                        kv_mask=None, impl: str = "einsum", bias=None,
                        dropout_rate: float = 0.0, dropout_rng=None):
    """Ring attention over global [b, t, h, d] arrays, the same on every
    rank (JAX's signature): each rank slices its shard of the sequence
    over the mesh's "sp" axis (default: the started runtime's mesh),
    runs `ring_attention` and all-gathers the output.  kv_mask [b, t];
    bias [1|b, 1|h, t, t], differentiable; dropout_rng: an int32 seed or
    a torch.Generator (seeded alike on every rank) that draws one.
    Without an "sp" axis, or at size 1, one `flash_attention` call
    (impl "flash") or its plain version (impl "einsum").

    impl: "einsum" | "flash" | "auto" (flash from a shard of
    `RING_FLASH_MIN_TLOCAL` positions)."""
    if impl not in _IMPLS:
        raise ValueError("impl must be 'einsum', 'flash' or 'auto'")
    b, t, h, d = q.shape
    if bias is not None and (
            bias.dim() != 4 or bias.shape[0] not in (1, b)
            or bias.shape[1] not in (1, h)
            or tuple(bias.shape[2:]) != (t, t)):
        raise ValueError(
            f"bias shape {tuple(bias.shape)} != (1|{b}, 1|{h}, {t}, {t})")
    dropout_rate = float(dropout_rate)
    seed = None
    if dropout_rate > 0.0:
        if dropout_rng is None:
            raise ValueError("dropout_rate > 0 needs dropout_rng")
        if isinstance(dropout_rng, torch.Generator):
            # the draw flash_attention makes from a generator
            seed = torch.randint(-2 ** 31, 2 ** 31 - 1, (1,),
                                 generator=dropout_rng, dtype=torch.int32,
                                 device=dropout_rng.device).to(q.device)
        else:
            seed = _as_seed(dropout_rng, q.device)
    mesh = mesh if mesh is not None else current_mesh()
    sp = mesh.shape.get("sp", 1) if mesh is not None else 1
    if impl == "auto":
        impl = ("flash" if t // max(sp, 1) >= RING_FLASH_MIN_TLOCAL
                else "einsum")
    if sp == 1:
        return flash_attention(
            q, k, v, kv_mask=kv_mask, bias=bias, causal=causal,
            dropout_rate=dropout_rate, dropout_seed=seed,
            impl="auto" if impl == "flash" else "reference")
    if t % sp:
        raise ValueError(f"sequence length {t} does not split over "
                         f"sp = {sp} ranks")
    transport = _Transport(mesh.groups["sp"])
    q_l, k_l, v_l = (_SliceSeq.apply(x, 1, transport) for x in (q, k, v))
    mask_l = (None if kv_mask is None
              else _SliceSeq.apply(kv_mask, 1, transport))
    bias_l = None if bias is None else _SliceSeq.apply(bias, 2, transport)
    out = _ring(q_l, k_l, v_l, transport, causal, mask_l, impl, bias_l,
                dropout_rate, seed)
    return _GatherSeq.apply(out, 1, transport)
