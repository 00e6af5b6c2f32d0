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
            "repro_torch.cosim.traffic_bridge", "repro_torch.core.fifo",
            "repro_torch.core.halfduplex",
            "repro_torch.core.sparse_collectives",
            "repro_torch.kernels.aer_encode",
            "repro_torch.kernels.aer_decode",
            "repro_torch.parallel.compat", "repro_torch.configs",
            "repro_torch.configs.falcon_mamba_7b", "repro_torch.data",
            "repro_torch.kernels.selective_scan",
            "repro_torch.models.layers", "repro_torch.models.mamba",
            "repro_torch.models.transformer", "repro_torch.models.model",
            "repro_torch.launch.serve", "repro_torch.core.adaptive",
            "repro_torch.analysis", "repro_torch.analysis.verify",
            "repro_torch.models.moe", "repro_torch.configs.granite_3_2b",
            "repro_torch.configs.mixtral_8x22b",
            "repro_torch.configs.jamba_v01_52b",
            "repro_torch.configs.llama32_vision_11b",
            "repro_torch.configs.hubert_xlarge", "repro_torch.optim",
            "repro_torch.optim.adamw", "repro_torch.runtime.train_loop",
            "repro_torch.runtime.fault", "repro_torch.checkpoint",
            "repro_torch.checkpoint.checkpointer",
            "repro_torch.launch.train", "repro_torch.parallel.sharding",
            "repro_torch.launch.mesh", "repro_torch.launch.cost",
            "repro_torch.launch.dryrun", "repro_torch.launch.roofline",
            "repro_torch.analysis.lint"]
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


#: the port's examples: neither JAX, the reference, nor the reference's
#: benchmarks (which import JAX)
EXAMPLES = sorted(p.name for p in (ROOT / "examples").glob("torch_*.py"))
EXAMPLE_RE = re.compile(
    IMPORT_RE.pattern.replace("jax|jaxlib|repro", "jax|jaxlib|repro|"
                              "benchmarks"), re.M)


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_import_neither(name):
    text = (ROOT / "examples" / name).read_text()
    assert not EXAMPLE_RE.search(text), name
    assert not re.search(r"^sys\.path\.insert\(0, \"\.\"\)", text, re.M), \
        f"{name} puts the repository root (benchmarks/) on the path"


def test_examples_load_neither():
    """Loading every ``examples/torch_*.py`` (its ``main`` not run)
    pulls in no module of JAX, the reference or its benchmarks."""
    code = ("import importlib.util, sys\n"
            f"for name in {EXAMPLES!r}:\n"
            "    spec = importlib.util.spec_from_file_location(\n"
            "        name[:-3], 'examples/' + name)\n"
            "    spec.loader.exec_module(\n"
            "        importlib.util.module_from_spec(spec))\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'benchmarks'))\nprint(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


#: the examples that drive the fabric and co-simulation (their ``main``
#: takes ``--device``; without it they run on the card)
FABRIC_EXAMPLES = ("multi_chip_fabric", "heterogeneous_links",
                   "multicast_fanout", "lossless_hotspot",
                   "adaptive_hotspot", "monte_carlo_sweep",
                   "closed_loop_snn", "snn_chip_array")


@pytest.mark.parametrize("name", FABRIC_EXAMPLES)
def test_example_default_device_needs_cuda(monkeypatch, name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main(argv)


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
    from repro_torch.core import fifo
    with pytest.raises(RuntimeError, match="CUDA"):
        fifo.make_fifo(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.aer_states_from_reference({"w": np.zeros(3, np.float32)})
    i32 = np.zeros((1, 4), np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.event_blocks_from_reference(
            (i32, np.zeros((1, 4), np.float32), i32[0, :1], i32[0, :1]))
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model
    cfg = get_smoke_config("falcon_mamba_7b")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg, device="cuda")
    from repro_torch.launch import train
    for argv in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--arch", "falcon_mamba_7b", "--smoke", *argv])
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main(["--arch", "falcon_mamba_7b", "--smoke", *argv])
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main(["--arch", "falcon_mamba_7b", "--smoke",
                        "--mesh-data", "2", *argv])
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.lm_params_from_reference({}, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.mamba_cache_from_reference(
            {"h": np.zeros((1, 4, 2), np.float32),
             "conv": np.zeros((1, 3, 4), np.float32)})
    # the scan runs on the card, for CPU tensors as its plain version,
    # and for meta tensors (named by the caller) as shape-only outputs;
    # the fabric kernels refuse meta, naming the devices they take
    meta = torch.empty((1, 2, 4), device="meta")
    y, h = ops.selective_scan(meta, meta, meta[..., :2], meta[..., :2],
                              meta[0, :, :2])
    assert (y.device.type, tuple(y.shape), tuple(h.shape)) == \
        ("meta", (1, 2, 4), (1, 4, 2))
    with pytest.raises(ValueError, match="unsupported device meta; it "
                                         "takes cuda or cpu"):
        ops.lif_step(meta[0], meta[0])
