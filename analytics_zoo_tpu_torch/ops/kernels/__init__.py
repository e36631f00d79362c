"""Hand-written Hopper kernels and their launch wrappers.

Each wrapper checks its inputs, launches on the current stream, and
counts its launches in a plain integer attribute (`<wrapper>.launches`),
so a run can show that the main path went through the kernel.
Nothing here imports `triton` or builds a kernel at import time: that
happens on the first launch (`_build.py` for the CUDA sources).
"""

from analytics_zoo_tpu_torch.ops.kernels.layer_norm import (  # noqa: F401
    layer_norm_fwd,
)
from analytics_zoo_tpu_torch.ops.kernels.paged_attention import (  # noqa: F401,E501
    paged_decode,
)

#: every kernel wrapper of the port, by kernel name
KERNELS = {"layer_norm_fwd": layer_norm_fwd, "paged_decode": paged_decode}


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {name: fn.launches for name, fn in KERNELS.items()}
