"""Serving configuration (a port of analytics_zoo_tpu/serving/config.py)
— the reference's `config.yaml` surface
(`scripts/cluster-serving/config.yaml`, parsed by
`serving/utils/ConfigParser.scala`).  The keys, defaults and errors are
the JAX package's:
  modelPath         -> a port `ZooModel.save_model` directory
  jobName           -> server name (informational)
  modelParallelism  -> InferenceModel(supported_concurrent_num=...)
  maxBatchSize      -> InferenceModel(max_batch_size=...) and the
                       batcher's max batch
  quantize          -> int8 weights (InferenceModel.load_model's
                       quantize=True, serving/quantize.py)
  protocol          -> "http" | "grpc" | "both" (the HTTP front end,
                       the gRPC one, grpc_frontend.py, or both over one
                       batcher)
  host/port/grpcPort-> bind addresses
  batchTimeoutMs    -> the batcher's window
  modelClass        -> the saved class name's override
  decryptKeyEnv     -> the env var holding the key of encrypted weights
  replicas          -> > 1: that many worker processes
                       (serving/worker_pool.py) behind the batcher
`start_serving` / `stop_serving` bring the server up and down; the model
(or each worker's copy) is built on the CUDA card.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict

_DEFAULTS = {
    "jobName": "serving_stream",
    "protocol": "http",
    "host": "127.0.0.1",
    "port": 10020,
    "grpcPort": 10021,
    "modelParallelism": 4,
    "maxBatchSize": 256,
    "batchTimeoutMs": 5.0,
    "quantize": False,
    "modelClass": None,
    # name of the ENV VAR holding the decrypt key for encrypted-at-rest
    # models (the key itself never belongs in a config file)
    "decryptKeyEnv": None,
    # >1 starts that many replica worker PROCESSES behind the batcher
    # (the reference's Flink modelParallelism scale-out,
    # ClusterServing.scala:57-70); 1 = serve from the in-process model
    "replicas": 1,
}

_KNOWN = set(_DEFAULTS) | {"modelPath"}


class ServingConfig:
    """Validated serving configuration."""

    def __init__(self, **kwargs):
        unknown = set(kwargs) - _KNOWN
        if unknown:
            raise ValueError(
                f"unknown serving config key(s): {sorted(unknown)}; "
                f"known: {sorted(_KNOWN)}")
        if "modelPath" not in kwargs or not kwargs["modelPath"]:
            raise ValueError("serving config requires modelPath")
        self.model_path = kwargs["modelPath"]
        merged = {**_DEFAULTS, **kwargs}
        self.job_name = str(merged["jobName"])
        self.protocol = str(merged["protocol"]).lower()
        if self.protocol not in ("http", "grpc", "both"):
            raise ValueError("protocol must be http, grpc or both")
        self.host = str(merged["host"])
        self.port = int(merged["port"])
        self.grpc_port = int(merged["grpcPort"])
        self.model_parallelism = int(merged["modelParallelism"])
        self.max_batch_size = int(merged["maxBatchSize"])
        self.batch_timeout_ms = float(merged["batchTimeoutMs"])
        self.quantize = bool(merged["quantize"])
        self.model_class = merged["modelClass"]
        self.decrypt_key_env = merged["decryptKeyEnv"]
        self.replicas = int(merged["replicas"])
        if self.replicas < 1:
            raise ValueError("replicas must be >= 1")

    @staticmethod
    def load(path: str) -> "ServingConfig":
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        if not isinstance(raw, dict):
            raise ValueError(f"{path} must contain a YAML mapping")
        return ServingConfig(**raw)

    def to_dict(self) -> Dict[str, Any]:
        return {"modelPath": self.model_path, "jobName": self.job_name,
                "protocol": self.protocol, "host": self.host,
                "port": self.port, "grpcPort": self.grpc_port,
                "modelParallelism": self.model_parallelism,
                "maxBatchSize": self.max_batch_size,
                "batchTimeoutMs": self.batch_timeout_ms,
                "quantize": self.quantize,
                "modelClass": self.model_class,
                "decryptKeyEnv": self.decrypt_key_env,
                "replicas": self.replicas}


def start_serving(config: "ServingConfig | str", block: bool = False,
                  model_cls=None, device=None):
    """Bring up serving from a config (path or object) — the
    `cluster-serving-start` analog.  Returns the started front ends:
    {"http": ServingServer?, "grpc": GrpcServingFrontend?, "model":
    InferenceModel or None, "pool": WorkerPool?} ("_batcher" holds the
    server of a gRPC-only config, which binds no HTTP port).  The model,
    or each of `replicas` > 1 worker processes' copies, is built on
    `device` (None = the CUDA card).  `decryptKeyEnv` names the
    environment variable that holds the key of weights saved encrypted
    at rest (unset: ValueError before anything starts); the workers
    read the same variable."""
    from analytics_zoo_tpu_torch.serving.inference_model import (
        InferenceModel,
        find_zoo_model_class,
    )
    from analytics_zoo_tpu_torch.serving.server import ServingServer

    if isinstance(config, str):
        config = ServingConfig.load(config)
    decrypt_key = None
    if config.decrypt_key_env:
        decrypt_key = os.environ.get(config.decrypt_key_env)
        if not decrypt_key:
            raise ValueError(
                f"config names decryptKeyEnv={config.decrypt_key_env!r} "
                "but that environment variable is unset")
    cls = model_cls
    if cls is None and config.model_class:
        cls = find_zoo_model_class(config.model_class)
    pool = model = None
    if config.replicas > 1:
        # N worker processes each load their own copy; the parent holds
        # no model.  A caller's model_cls goes by name (the workers
        # resolve it as they resolve config.modelClass)
        from analytics_zoo_tpu_torch.serving.worker_pool import WorkerPool
        cls_name = config.model_class
        if cls is not None:
            cls_name = getattr(cls, "__name__", str(cls))
        pool = WorkerPool(config.model_path, n_workers=config.replicas,
                          model_cls=cls_name, quantize=config.quantize,
                          decrypt_key_env=config.decrypt_key_env,
                          max_batch_size=config.max_batch_size,
                          model_parallelism=config.model_parallelism,
                          device=None if device is None else str(device))
    else:
        model = InferenceModel(
            supported_concurrent_num=config.model_parallelism,
            max_batch_size=config.max_batch_size)
        model.load_model(config.model_path, model_cls=cls,
                         quantize=config.quantize, decrypt_key=decrypt_key,
                         device=device)
    serve_http = config.protocol in ("http", "both")
    try:
        srv = ServingServer(model, host=config.host,
                            port=config.port if serve_http else 0,
                            max_batch_size=config.max_batch_size,
                            batch_timeout_ms=config.batch_timeout_ms,
                            worker_pool=pool)
        srv.start(block=False, http=serve_http)
    except Exception:
        # no live worker processes left behind when the server cannot
        # come up (a port already bound)
        if pool is not None:
            pool.stop()
        raise
    out: Dict[str, Any] = {"model": model}
    if pool is not None:
        out["pool"] = pool
    if serve_http:
        out["http"] = srv
    else:
        out["_batcher"] = srv          # still needs stop()
    if config.protocol in ("grpc", "both"):
        try:
            from analytics_zoo_tpu_torch.serving.grpc_frontend import (
                GrpcServingFrontend,
            )
            out["grpc"] = GrpcServingFrontend(
                srv, host=config.host, port=config.grpc_port).start()
        except Exception:
            # the batcher, the HTTP port and the workers already up
            stop_serving(out)
            raise
    if block:
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            stop_serving(out)
    return out


def stop_serving(servers: Dict[str, Any]) -> None:
    for key in ("http", "grpc", "_batcher", "pool"):
        srv = servers.get(key)
        if srv is not None:
            srv.stop()
