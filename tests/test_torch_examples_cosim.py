"""The port's two co-simulation examples (``examples/torch_closed_loop_snn.py``
and ``examples/torch_snn_chip_array.py``) held against the reference's
own examples on the reference's weights and drive, on the CPU.

Each reference example's runs go once through the reference package with
its own keys (its placement and constants read from the example itself
through ``runpy``), recording membranes and every tick's fabric result.
Its weights (``_w_np``) and per-tick drive (``ref_drive``, as
``tests/test_torch_cosim_parity.py`` builds it) then go into the port's
script, whose ``scenarios`` / ``scenario`` takes them, and its
``main(["--device", "cpu"])`` runs once to ``OK``: so one port run gives
both the run to its end and the trajectories.  Those are held with
``test_torch_cosim_parity.assert_runs_match``: membranes within 1e-6,
a spike flipped only by a membrane within 1e-6 of the threshold (and
nothing compared past the first such tick), per-tick counters and every
tick's fabric result bit for bit.  Where no run flips a spike, the
summary numbers the script prints equal the reference's.
"""

import contextlib
import functools
import importlib.util
import io
import pathlib
import runpy

import jax
import numpy as np
import pytest

from repro import cosim as jc
from repro.core.fabric import QueuePolicy as JQueues
from repro.models import snn as jsnn
from test_torch_cosim_parity import assert_runs_match, ref_drive
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
V_TH = 1.0


def port_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", EXAMPLES / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_main(mod, fn: str, **inputs):
    """``mod.main(["--device", "cpu"])`` with ``mod.<fn>`` taking the
    reference's weights and drive; returns what it returned and what it
    printed."""
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.setattr(mod, fn, functools.partial(getattr(mod, fn), **inputs))
        out = mod.main(["--device", "cpu"])
    return out, buf.getvalue()


def rec(jeng, ticks):
    return jeng.run(ticks, record_state=True, record_fabric=True)


# --- 7. closed_loop_snn -----------------------------------------------------

@pytest.fixture(scope="module")
def closed_loop():
    ref = runpy.run_path(str(EXAMPLES / "closed_loop_snn.py"))
    T, key = ref["TICKS"], ref["KEY"]
    pl = ref["build_placement"]()
    eng_open = jc.CosimEngine(pl, jc.CosimConfig(feedback="none"), key=key)
    want = {"rollout": jc.reference_rollout(eng_open, T, record_state=True),
            "open": eng_open.run(T, record_state=True)}
    fab = pl.fabric(queues=JQueues(capacity=256, flow="credit"))
    want["closed"] = rec(jc.CosimEngine(
        pl, jc.CosimConfig(feedback="next_tick"), fabric=fab, key=key), T)
    cfg_m = jc.CosimConfig(feedback="measured", tick_dt_ns=600)
    for label, cfg in (("measured", cfg_m),
                       ("next_tick", cfg_m._replace(feedback="next_tick"))):
        f = pl.fabric(timing=ref["SERIAL_LVDS_TIMING"],
                      queues=JQueues(capacity=256, flow="credit"))
        want[label] = rec(jc.CosimEngine(pl, cfg, fabric=f, key=key), T)
    mod = port_script("closed_loop_snn")
    out, text = run_main(mod, "scenarios", weights=eng_open._w_np,
                         drive=ref_drive(eng_open, T))
    return want, mod, out, text


@pytest.mark.parametrize("run", ["rollout", "open", "closed", "measured",
                                 "next_tick"])
def test_closed_loop_snn_matches_reference(closed_loop, run):
    want, mod, out, _ = closed_loop
    flip = assert_runs_match(want[run], out["runs"][run], V_TH, mod.TICKS)
    if run == "open":
        # transport adds nothing, on the port as on the reference
        assert np.array_equal(out["runs"]["open"].v,
                              out["runs"]["rollout"].v)
    if flip is None and run == "closed":
        jr = want["closed"]
        assert out["closed_delivered"] == int(jr.delivered.sum())
        assert out["closed_injected"] == int(jr.injected.sum())


def test_closed_loop_snn_summary(closed_loop):
    """The printed figures equal the reference's where no run flipped a
    spike; every claim holds on the port's run of the reference's
    network (``main`` ran to OK)."""
    want, mod, out, text = closed_loop
    assert "OK — closed-loop contracts all hold" in text
    assert out["ticks_run"] == 5 * mod.TICKS
    flips = {r: bool((want[r].raster != out["runs"][r].raster).any())
             for r in ("open", "closed", "measured", "next_tick")}
    if not flips["open"]:
        assert out["open_spikes"] == want["open"].total_spikes
    if not (flips["open"] or flips["closed"]):
        assert out["divergence"] == int(np.abs(
            want["closed"].spikes - want["open"].spikes).sum())
    jm, ji = want["measured"], want["next_tick"]
    if not flips["measured"]:
        assert out["lag_ticks"] == int(jm.latency_ns.max()) / 600
        assert out["late_events"] == int((jm.latency_ns >= 600).sum())
    if not (flips["measured"] or flips["next_tick"]):
        assert out["measured_gap"] == int(np.abs(jm.spikes - ji.spikes).sum())
    print("spike flips by run:", flips)


# --- 8. snn_chip_array ------------------------------------------------------

@pytest.fixture(scope="module")
def chip_array():
    ref = runpy.run_path(str(EXAMPLES / "snn_chip_array.py"))
    T, dt = ref["TICKS"], ref["TICK_DT_NS"]
    pl = ref["build_placement"]()
    fab = pl.fabric(queues=JQueues(capacity=512, flow="credit"))
    jeng = jc.CosimEngine(pl, jc.CosimConfig(input_rate=0.08,
                                             tick_dt_ns=dt),
                          fabric=fab, key=jax.random.PRNGKey(42))
    want = rec(jeng, T)
    mod = port_script("snn_chip_array")
    out, text = run_main(mod, "scenario", weights=jeng._w_np,
                         drive=ref_drive(jeng, T))
    return want, mod, out, text


def test_snn_chip_array_matches_reference(chip_array):
    want, mod, out, text = chip_array
    assert "OK — closed-loop conservation" in text
    assert out["ticks_run"] == mod.TICKS
    flip = assert_runs_match(want, out["result"], V_TH, mod.TICKS)
    if flip is None:
        assert out["delivered"] == int(want.delivered.sum())
        lat = want.latency_ns
        assert out["latency_ns"] == (int(np.percentile(lat, 50)),
                                     int(np.percentile(lat, 99)),
                                     int(lat.max()))
        assert out["rate"] == want.total_spikes / (
            mod.TICKS * 16 * mod.NEURONS)
        assert out["report"] == pytest.approx(jsnn.fabric_report(
            want, mod.TICKS, tick_dt_us=mod.TICK_DT_NS / 1e3))
