"""Sharding helpers over process groups (counterpart of
analytics_zoo_tpu/parallel/sharding.py).

JAX lays a batch out as one global `jax.Array` over the mesh's data
axes and a parameter by a rule table, and XLA inserts the collectives.
The port runs one process a rank (`init_orca_context(cluster_mode=
"distributed")`, `common/context.py`), so the same helpers speak of
this rank: `shard_batch` returns this rank's rows of a global batch, and
`logical_to_sharding` / `infer_param_shardings` return the rule table's
answer as a spec, a tuple with one mesh axis (or None) a dimension, the
entries of JAX's `PartitionSpec` (an empty tuple: replicated).

Nothing in the port calls them yet: ring attention takes its shard of
the sequence by its own rank in the "sp" group (`parallel/
ring_attention.py`), and the data axes these helpers split over come
with data-parallel `fit` (ROADMAP Queue 1 item 8b).

JAX's `shard_map_compat`, `named_sharding`, `batch_sharding`,
`stacked_batch_sharding` and `replicated` build `jax.sharding` objects
and have no counterpart (ROADMAP Known differences).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.context import DATA_AXES, OrcaContext


def _present_axes(mesh, axes) -> Tuple[str, ...]:
    return tuple(a for a in axes if a in mesh.axis_names)


def data_axes(mesh=None) -> Tuple[str, ...]:
    """The mesh axes a batch dimension is split over."""
    mesh = mesh or OrcaContext.mesh
    return _present_axes(mesh, DATA_AXES)


def data_parallelism(mesh=None) -> int:
    """Number of data-parallel shards (the product of the data axes)."""
    mesh = mesh or OrcaContext.mesh
    n = 1
    for a in data_axes(mesh):
        n *= mesh.shape[a]
    return n


def mesh_axis_size(axis: str, mesh=None) -> int:
    """Size of a mesh axis, 1 when the axis is absent."""
    mesh = mesh or OrcaContext.mesh
    if mesh is None or axis not in mesh.axis_names:
        return 1
    return int(mesh.shape[axis])


def _data_index(mesh) -> int:
    """This rank's index among the data-parallel shards (row-major over
    the data axes, as JAX's device array is laid out)."""
    idx = 0
    for a in data_axes(mesh):
        idx = idx * mesh.shape[a] + mesh.coords[a]
    return idx


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch: Any, mesh=None) -> Any:
    """This rank's rows of a global batch (dicts, lists and tuples of
    arrays or tensors): dim 0 split evenly over the data axes, each
    leaf a tensor on the mesh's device.  Raises when a leaf's rows do
    not divide by the data parallelism."""
    mesh = mesh or OrcaContext.mesh
    n = data_parallelism(mesh)
    i = _data_index(mesh)

    def one(x):
        t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
        rows = t.shape[0]
        if rows % n:
            raise ValueError(f"a batch of {rows} rows does not split over "
                             f"{n} data-parallel shards")
        per = rows // n
        return t[i * per:(i + 1) * per].to(mesh.device)

    return _map(one, batch)


def logical_to_sharding(rules: Dict[str, Optional[str]],
                        path: Tuple[str, ...],
                        shape: Tuple[int, ...],
                        mesh=None) -> Tuple[Optional[str], ...]:
    """JAX's substring rules for one parameter (its path and shape):
    ``{"kernel": "tp"}`` splits the largest dimension the axis divides
    of every parameter whose "/"-joined path holds "kernel"; ``"ep:0"``
    pins dimension 0; ``"tp,fsdp"`` applies entries in order, each to
    the largest dimension still whole.  Axes absent from the mesh, or
    of size 1, are skipped.  Returns the spec (JAX's `PartitionSpec`
    entries), () when replicated."""
    mesh = mesh or OrcaContext.mesh
    joined = "/".join(str(p) for p in path)
    ndim = len(shape)
    for key, rule in rules.items():
        if key not in joined or rule is None or ndim == 0:
            continue
        spec = [None] * ndim
        for entry in rule.split(","):
            entry = entry.strip()
            if not entry:
                continue
            axis, _, dim_s = entry.partition(":")
            if axis not in mesh.axis_names or mesh.shape[axis] <= 1:
                continue
            if dim_s:
                dim = int(dim_s)
                if (dim < ndim and spec[dim] is None
                        and shape[dim] % mesh.shape[axis] == 0):
                    spec[dim] = axis
                continue
            order = sorted((i for i in range(ndim) if spec[i] is None),
                           key=lambda i: -shape[i])
            for dim in order:
                if shape[dim] % mesh.shape[axis] == 0:
                    spec[dim] = axis
                    break
        if any(a is not None for a in spec):
            return tuple(spec)
    return ()


def infer_param_shardings(params: Any, mesh=None,
                          rules: Optional[Dict[str, str]] = None
                          ) -> Dict[str, Tuple[Optional[str], ...]]:
    """The spec of every parameter of `params` (a module or a
    state_dict): name -> `logical_to_sharding` of its path (the
    dotted name's parts) and shape.  No rules: every one replicated."""
    mesh = mesh or OrcaContext.mesh
    rules = rules or {}
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    return {name: logical_to_sharding(rules, tuple(name.split(".")),
                                      tuple(np.shape(leaf)), mesh)
            for name, leaf in params.items()}
