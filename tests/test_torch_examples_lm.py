"""The port's two LM examples on the CPU: ``examples/torch_train_lm_100m.py``
trains its tiny config through a checkpoint, an injected failure and a
restart with the script's asserts live, and
``examples/torch_sparse_allreduce_demo.py`` runs on the card unless
``--device cpu`` says otherwise: without CUDA it raises, with fewer
than 8 cards its 8 ranks share them over gloo, with 8 or more they take
NCCL, and ``--device cpu`` spawns 8 gloo ranks on the host.  The demo's
spawn is replaced by a stand-in that checks what it was handed and
writes the ranks' results file: a real run of its 8 ranks takes about
a minute on the CPU (it runs on the card in ``chip_smoke.py``'s
``examples`` phase)."""

import importlib.util
import json
import math
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_example_restarts_from_its_checkpoint(capsys):
    mod = _example("train_lm_100m")
    state, info = mod.main(["--tiny", "--device", "cpu", "--steps", "12"])
    assert int(state.step) == 12
    assert info["restarts"] == 1
    assert info["checkpoints"] == [10, 12]
    assert math.isfinite(info["last_loss"])
    out = capsys.readouterr().out
    assert "finished at step 12: restarts=1 (injected 1)" in out


@pytest.fixture
def demo():
    return _example("sparse_allreduce_demo")


def _fake_spawn(seen, mod):
    """Stands in for ``mp.spawn``: records the call and writes rank 0's
    results file as the ranks would."""
    def spawn(fn, args, nprocs, join):
        seen.update(fn=fn, args=args, nprocs=nprocs, join=join)
        steps = args[4]
        modes = {m: {"losses": [6.75] * steps, "wire_words": 0.0,
                     "params": 1000,
                     "launches": {"aer_encode": 0, "aer_decode": 0}}
                 for m in mod.MODES}
        modes["aer_topk"]["wire_words"] = 40.0 * steps
        with open(args[3], "w") as f:
            json.dump(modes, f)
    return spawn


def test_demo_default_device_needs_cuda(monkeypatch, demo):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seen = {}
    monkeypatch.setattr(demo.mp, "spawn", _fake_spawn(seen, demo))
    for argv in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            demo.main(argv)
    assert not seen


def test_demo_on_the_cpu_spawns_eight_gloo_ranks(monkeypatch, demo, capsys):
    seen = {}
    monkeypatch.setattr(demo.mp, "spawn", _fake_spawn(seen, demo))
    out = demo.main(["--device", "cpu"])
    assert seen["fn"] is demo._rank and seen["nprocs"] == 8 and seen["join"]
    assert seen["args"][1:3] == ("cpu", "gloo")
    assert seen["args"][4] == demo.STEPS == 40
    assert (out["device"], out["backend"]) == ("cpu", "gloo")
    assert sorted(out["modes"]) == sorted(demo.MODES)
    text = capsys.readouterr().out
    assert "share" not in text and "bidir_ring vs psum" in text


@pytest.mark.parametrize("cards,backend", [(1, "gloo"), (4, "gloo"),
                                           (8, "nccl")])
def test_demo_on_the_card_picks_its_transport(monkeypatch, demo, capsys,
                                              cards, backend):
    """With no ``--device`` the ranks go to the card(s): gloo with host
    staging below 8 cards (and the script says so), NCCL from 8."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    seen = {}
    monkeypatch.setattr(demo.mp, "spawn", _fake_spawn(seen, demo))
    out = demo.main(["--steps", "4"])
    assert seen["args"][1:3] == ("cuda", backend) and seen["nprocs"] == 8
    assert seen["args"][4] == 4
    assert (out["device"], out["backend"]) == ("cuda", backend)
    said = f"8 ranks share {cards} card(s) over gloo" in \
        capsys.readouterr().out
    assert said == (backend == "gloo")
