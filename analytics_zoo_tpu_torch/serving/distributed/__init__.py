"""Distributed serving (a port of analytics_zoo_tpu/serving/
distributed/): `router.ReplicaRouter` owns N engine replicas and admits
by least-loaded scoring over their live queue-depth, KV-occupancy and
lane gauges, with drain / undrain, heartbeat health, sticky request ids
and one re-queue of a request whose replica dies mid-stream
(`ServingServer(router=...)`).  JAX's tensor-parallel decode (tp.py) is
not ported.
"""

from analytics_zoo_tpu_torch.serving.distributed.router import (
    ReplicaRouter,
    RouterStream,
)

__all__ = ["ReplicaRouter", "RouterStream"]
