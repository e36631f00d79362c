"""Device choice for the port's entry points.

An entry point runs on the card unless its caller names another device.
Without a card it raises instead of carrying on on the CPU, so that a
run that meant to measure the card can never quietly measure the host.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`device` as a `torch.device`; None means the CUDA card, and
    raises RuntimeError when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        return torch.device("cuda")
    return torch.device(device)
