"""The DoppelGANger time-series simulator."""

from analytics_zoo_tpu_torch.chronos.simulator.doppelganger_simulator import (  # noqa: E501
    DPGANSimulator,
)

__all__ = ["DPGANSimulator"]
