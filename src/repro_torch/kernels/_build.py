"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

The sources under ``csrc/`` (``fabric_queue.cu``,
``fabric_queue_multistep.cu``, ``lif_step.cu``, ``aer_encode.cu``,
``aer_decode.cu``, ``selective_scan.cu``) have a plain C interface, so
one ``nvcc`` call per source (each its own library) builds them in
seconds, with no PyTorch headers:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o <build>/fabric_queue-<hash>.so csrc/fabric_queue.cu

The build runs at first use, into ``build/repro_torch_kernels/`` of the
checkout (``build/`` is git-ignored); the library name carries a hash of
the source, so an edited source is rebuilt and never confused with an
old binary.  Nothing is built or imported at module import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from ..device import require_hopper

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_PI = ctypes.POINTER(ctypes.c_int)
#: ctypes signatures of the C entry points, by library
SIGNATURES = {
    "fabric_queue": {
        "fabric_queue_step_launch": [_P, _P, _P, _I, _I] + [_P] * 6 + [_P],
        "fabric_queue_update_launch": [_P, _P, _P, _I, _I, _P, _P, _I,
                                       _P, _P, _P, _P, _P, _I, _P],
    },
    "fabric_queue_multistep": {
        "fabric_queue_multistep_smem_bytes": [_I, _I],
        "fabric_queue_multistep_layout_bytes": [_I] * 6,
        "fabric_queue_multistep_smem_limit": [_PI],
        "fabric_queue_multistep_launch": [_P] * 14 + [_I] * 11 + [_P],
    },
    "lif_step": {
        "lif_step_launch": [_P, _P, _LL, _F, _F, _F, _P, _P, _P],
    },
    "aer_encode": {
        "aer_encode_plan": [_P, _I, _I, _I, _PI],
        "aer_encode_launch": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    },
    "aer_decode": {
        "aer_decode_plan": [_I, _I, _PI],
        "aer_decode_launch": [_P, _P, _I, _I, _I, _I, _P, _P, _P],
    },
    "selective_scan": {
        "selective_scan_launch": [_P] * 5 + [_I] * 4 + [_P, _P, _P],
    },
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels are built from source at "
                           "first use")
    return nvcc


def build(name: str) -> tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists.

    Returns ``(library path, build seconds (0 when cached), nvcc's
    output)``.  The library is written under a temporary name and moved
    into place, so concurrent builders never load a partial file.
    """
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS)
                            .encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                          capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {src} ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, secs, proc.stdout + proc.stderr


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library, with its argument
    types declared.  Needs a Hopper card (sm_90a)."""
    require_hopper(torch.device("cuda", torch.cuda.current_device()))
    path, _secs, _log = build(name)
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = _I
    # every library exports <name>_error_string(code) for its messages
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [_I]
    err.restype = ctypes.c_char_p
    lib.error_string = err
    return lib


def check_operands(name: str, dev: torch.device, dtype: torch.dtype,
                   **tensors) -> None:
    """Refuse operands a C entry point cannot take: another device than
    the current CUDA one (the entry launches there, rather than
    switching devices on every launch), another dtype, or a strided
    layout."""
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors are on {dev} but the current "
                         f"CUDA device is {torch.cuda.current_device()}")
    for arg, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected "
                             f"{dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {dtype}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
