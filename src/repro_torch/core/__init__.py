"""The fabric simulator's core: link physics, routing, traffic, the slot
engine and the ``Fabric`` front door.  Import the submodules directly
(``repro_torch.core.fabric`` and so on)."""
