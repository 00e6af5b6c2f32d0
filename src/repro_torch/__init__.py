"""PyTorch / CUDA port of the AER transceiver fabric simulator.

Mirrors the layout and names of the JAX reference package (``core/``,
``kernels/``) so each module's counterpart is easy to find.  Plain
tensor code is PyTorch; the queue scan and the pop/append scatter of the
slot engine, and the multi-step kernel that runs its whole step for
chunks of steps, are CUDA C++ kernels written for Hopper
(``kernels/csrc/``), each beside its plain-PyTorch version in
``kernels/ref.py``.  Importing this package touches neither
JAX nor the reference package.
"""

from .device import require_hopper, resolve_device
