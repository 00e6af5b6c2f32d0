"""Where the port runs: the device resolver and the Hopper check.

Every entry point (``Fabric``, ``simulate_fabric``,
``protocol_sim.simulate``) takes ``device=None``, which means the CUDA
card.  Without CUDA that is an error, not a quiet move to the CPU: the
caller who wants the plain-PyTorch path says ``device="cpu"``, as the
tests do.  ``device="meta"`` is the abstract device of the dry-run:
tensors with shapes and dtypes and no storage, on which the LM paths
trace without computing.  It is reached only when named, never chosen
for the caller.  There is no environment override.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "require_hopper", "H100"]

#: compute capability the hand-written kernels are built for (sm_90a)
HOPPER = (9, 0)

#: NVIDIA H100 80GB HBM3 SXM data-sheet rates (dense, at its 700 W
#: limit; none measured): bf16 tensor-core FLOP/s, float32 FLOP/s outside
#: the tensor cores (an FMA is two), HBM bytes/s, device memory, and the
#: special function units' exponentials a second (16 a clock per SM x
#: 132 SMs x 1.98 GHz boost)
H100 = {"bf16_flops_s": 989e12, "fp32_flops_s": 67e12,
        "hbm_bytes_s": 3.35e12, "hbm_bytes": 80e9,
        "sfu_ops_s": 16 * 132 * 1.98e9}


def resolve_device(device: str | torch.device | None = None
                   ) -> torch.device:
    """``None`` -> the current CUDA device (raises without CUDA); any
    other value is taken as given (``cuda``, ``cpu`` or ``meta``), and a
    CUDA device without CUDA raises too."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on the GPU by "
                "default; pass device='cpu' for the plain-PyTorch path")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} asked for but CUDA is not "
                               f"available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; expected cuda, cpu "
                         f"or meta")
    return dev


def require_hopper(device: torch.device) -> None:
    """Refuse to build or launch the sm_90a kernels on another card."""
    cap = torch.cuda.get_device_capability(device)
    if tuple(cap) != HOPPER:
        raise RuntimeError(
            f"the fabric kernels are built for sm_90a (capability "
            f"{HOPPER}); {torch.cuda.get_device_name(device)} has "
            f"capability {tuple(cap)}")
