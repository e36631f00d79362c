"""Hand-written Hopper kernels and their launch wrappers.

Each wrapper checks its inputs, launches on the current stream, and
counts its launches in a plain integer attribute (`<wrapper>.launches`,
raised by `_build.count_launch`), so a run can show that the main path
went through the kernel.
Nothing here imports `triton` or builds a kernel at import time: that
happens on the first launch (`_build.py` for the CUDA sources).
"""

from analytics_zoo_tpu_torch.ops.kernels.flash_attention import (  # noqa: F401,E501
    flash_bwd_dbias,
    flash_bwd_dkv,
    flash_bwd_dq,
    flash_fwd,
)
from analytics_zoo_tpu_torch.ops.kernels.fused_dense import (  # noqa: F401
    fused_dense_gelu,
)
from analytics_zoo_tpu_torch.ops.kernels.layer_norm import (  # noqa: F401
    layer_norm_bwd,
    layer_norm_fwd,
)
from analytics_zoo_tpu_torch.ops.kernels.paged_attention import (  # noqa: F401,E501
    paged_decode,
)

#: every kernel wrapper of the port, by kernel name
KERNELS = {"layer_norm_fwd": layer_norm_fwd,
           "layer_norm_bwd": layer_norm_bwd,
           "fused_dense_gelu": fused_dense_gelu, "flash_fwd": flash_fwd,
           "flash_bwd_dq": flash_bwd_dq, "flash_bwd_dkv": flash_bwd_dkv,
           "flash_bwd_dbias": flash_bwd_dbias,
           "paged_decode": paged_decode}


def reset_launch_counts() -> None:
    """Set every wrapper's launch count (and count per body) to 0."""
    for fn in KERNELS.values():
        fn.launches = 0
        for body in getattr(fn, "launches_by_body", {}):
            fn.launches_by_body[body] = 0


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {name: fn.launches for name, fn in KERNELS.items()}
