"""PyTorch + CUDA port of `analytics_zoo_tpu`, for one NVIDIA H100.

The JAX package beside this one is the reference: every module here
mirrors the module path of its JAX counterpart, and the tests hold the
two against each other on the same inputs.  This package imports
`torch` and never `jax`, nor anything of `analytics_zoo_tpu`: what it
needs from there it keeps as its own copy.

Every TPU kernel of a ported path is a kernel written by hand for
Hopper (`ops/kernels/`, CUDA sources under `csrc/`), with its plain
PyTorch version beside it.  A CUDA tensor goes to the kernel or raises;
a CPU tensor goes to the plain version.

Entry points run on `cuda` unless the caller passes `device="cpu"`;
without a card and without that argument they raise
(`resolve_device`).

Ported so far: the paged-KV generation serving path
(`serving.generation`: `CausalLM`, `GenerationEngine`), BERT
classification serving (`serving.inference_model`) and fine-tuning
(`orca.learn.Estimator`), recommendation training
(`models.recommendation`) from the DEVICE data store
(`common.context.OrcaContext`), and Orca's data path (`orca.data`:
XShards, the DISK tier, the pandas readers; DataFrame and XShards input
to the Estimator, staged to the card through pinned double buffering).
"""

from analytics_zoo_tpu_torch.device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]
