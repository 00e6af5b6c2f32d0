"""The port stands alone: importing it loads neither JAX nor the
reference package, no source of the port (or ``chip_smoke.py``, or the
test files that run on the card) imports them, and its entry points
refuse to run without CUDA unless the caller asks for the CPU."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
IMPORT_RE = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)|"
    r"importlib\.import_module\(\s*['\"](jax|repro)(\.|['\"])|"
    r"__import__\(\s*['\"](jax|repro)", re.M)


def test_import_pulls_in_neither_jax_nor_reference():
    mods = ["repro_torch", "repro_torch.interop", "repro_torch.core.fabric",
            "repro_torch.core.network", "repro_torch.core.protocol_sim",
            "repro_torch.core.traffic", "repro_torch.core.telemetry",
            "repro_torch.kernels.ops", "repro_torch.kernels._build",
            "repro_torch.core.events", "repro_torch.kernels.lif_step",
            "repro_torch.models.snn", "repro_torch.cosim",
            "repro_torch.cosim.traffic_bridge"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods) +
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\nprint(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [*PORT.rglob("*.py"), ROOT / "chip_smoke.py",
     # what chip_smoke.py and the card tests import on the card's machine
     ROOT / "tests" / "_torch_cases.py",
     ROOT / "tests" / "test_torch_kernels_cuda.py"]))
def test_sources_import_neither(path):
    text = (ROOT / path).read_text()
    assert not IMPORT_RE.search(text), path


def test_default_device_needs_cuda(monkeypatch):
    """``device=None`` means the card: without CUDA every entry point
    raises instead of quietly running on the CPU."""
    from repro_torch import cosim, interop
    from repro_torch.core import fabric, network, protocol_sim, router
    from repro_torch.core.traffic import TrafficSpec
    from repro_torch.cosim.traffic_bridge import spike_traffic
    from repro_torch.models import snn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = TrafficSpec(*(torch.tensor(a, dtype=torch.int32)
                         for a in ([0], [0], [1])))
    topo = router.line_topology(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        fabric.Fabric(topo)
    with pytest.raises(RuntimeError, match="CUDA"):
        network.simulate_fabric(topo, spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        protocol_sim.simulate(np.zeros(1, np.int32), np.zeros(1, np.int32))
    with pytest.raises(RuntimeError, match="CUDA"):
        fabric.Fabric(topo, device="cuda")
    pl = cosim.place([cosim.Population("a"), cosim.Population("b")],
                     [cosim.Projection(0, (1,))], topo)
    with pytest.raises(RuntimeError, match="CUDA"):
        pl.fabric()
    with pytest.raises(RuntimeError, match="CUDA"):
        cosim.CosimEngine(pl)
    with pytest.raises(RuntimeError, match="CUDA"):
        snn.init_snn(snn.SnnConfig(grid=(1, 2), neurons=128),
                     torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        spike_traffic(torch.Generator(), 2, 4)
    w = np.zeros((1, 2, 128, 128), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.snn_params_from_reference({"w_rec": w, "w_in": w})
