"""Closed-loop SNN <-> fabric co-simulation (the PyTorch port of
``repro.cosim``).

* :mod:`repro_torch.cosim.placement` maps neuron populations onto
  fabric chips and compiles projections into unicast routes and
  in-fabric multicast tags;
* :mod:`repro_torch.cosim.engine` runs the tick-phased loop:
  populations spike (the LIF kernel on the card), spikes pack into
  26-bit AEs and ride ``Fabric.run``, delivered events scatter back as
  later ticks' synaptic current;
* :mod:`repro_torch.cosim.traffic_bridge` exposes the resulting
  spike-driven traffic as generators for sweeps.
"""

from .engine import (CosimConfig, CosimEngine, CosimResult, EventSpec,
                     reference_rollout)
from .placement import Placement, Population, Projection, place

__all__ = ["CosimConfig", "CosimEngine", "CosimResult", "EventSpec",
           "Placement", "Population", "Projection", "place",
           "reference_rollout"]
