"""`python -m analytics_zoo_tpu_torch.serving.start -c config.yaml` (a port
of analytics_zoo_tpu/serving/start.py, the reference's
`cluster-serving-start` script): serve the model a config names, on the
CUDA card (or `--device`'s), until interrupted; `--no-block` starts it
and returns."""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Start analytics_zoo_tpu_torch model serving")
    ap.add_argument("-c", "--config", required=True,
                    help="path to config.yaml")
    ap.add_argument("--no-block", action="store_true",
                    help="return instead of serving forever")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the CUDA "
                         "card)")
    args = ap.parse_args(argv)

    from analytics_zoo_tpu_torch.serving.config import (
        ServingConfig,
        start_serving,
    )

    cfg = ServingConfig.load(args.config)
    servers = start_serving(cfg, block=not args.no_block,
                            device=args.device)
    if args.no_block:
        ports = {k: getattr(v, "port", None) for k, v in servers.items()
                 if k != "model"}
        print(f"serving '{cfg.job_name}' started: {ports}")
    return servers


if __name__ == "__main__":
    main()
