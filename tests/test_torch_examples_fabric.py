"""The port's six fabric examples (``examples/torch_*.py``) held against
the reference's own examples on the reference's traffic, on the CPU.

Each reference example's scenario runs once, on the reference package,
with its own generators and keys (its constants and helpers read from
the example itself through ``runpy``).  The same arrays then go into the
port's script, whose ``make_traffic`` is swapped for them, and its
``main(["--device", "cpu"])`` runs once to its end: so one port run
gives both the run to ``OK`` and the results, which must equal the
reference's field for field (``network.assert_results_equal``: integers
bit for bit, telemetry included), with the summary numbers the script
prints equal to the reference's.  That includes the two comparisons the
reference example fails on its own traffic (ROADMAP queue C), which the
port's scripts print and do not assert.  The port's own draws, which
the scripts use on the card, are checked for their shapes here and run
in ``chip_smoke.py``.
"""

import contextlib
import importlib.util
import io
import pathlib
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from benchmarks import fabric_sweep as jsweep
from repro.core import network as jnet
from repro.core import traffic as jtr
from repro.core.fabric import Fabric as JFabric
from repro.core.fabric import MulticastPolicy as JMcast
from repro.core.fabric import QueuePolicy as JQueues
from repro.core.link import PAPER_TIMING as J_PAPER
from repro.core.router import MulticastTable as JMcastTable
from repro.core.router import mesh2d_topology as j_mesh
from repro.core.router import ring_topology as j_ring
from repro.core.telemetry import link_load as j_link_load
from repro_torch import interop
from repro_torch.core import network as tnet
from repro_torch.core import traffic as ttr
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def port_script(name: str):
    """``examples/torch_<name>.py`` as a module (``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", EXAMPLES / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_script(name: str) -> dict:
    """The reference example's globals (its ``main`` not run)."""
    return runpy.run_path(str(EXAMPLES / f"{name}.py"))


def to_port(jspec) -> ttr.TrafficSpec:
    return interop.from_reference(
        traffic=[np.array(a) for a in jspec]).traffic


def run_main(mod, **swap):
    """``mod.main(["--device", "cpu"])`` with module globals swapped;
    returns what it returned and what it printed."""
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        for k, v in swap.items():
            mp.setattr(mod, k, v)
        out = mod.main(["--device", "cpu"])
    return out, buf.getvalue()


def same_stats(got: dict, jres):
    """The figures ``latency_stats`` gives, equal to the reference's."""
    want = jnet.latency_stats(jres)
    assert {k: got[k] for k in want} == want


def same_port_traffic_shapes(specs, jspecs):
    """The port's own draw keeps the reference's shapes and dtypes."""
    for s, j in zip(specs, jspecs):
        for f in ("src", "t", "dest"):
            a, b = getattr(s, f), np.asarray(getattr(j, f))
            assert tuple(a.shape) == b.shape and a.numpy().dtype == b.dtype
        np.testing.assert_array_equal(s.src.numpy(), np.asarray(j.src))


# --- 1. multi_chip_fabric ---------------------------------------------------

@pytest.fixture(scope="module")
def multi_chip():
    ref = reference_script("multi_chip_fabric")
    key = jax.random.PRNGKey(0)
    epc = ref["EVENTS_PER_CHIP"]
    ring, mesh = j_ring(8), j_mesh(4, 4)
    addr = ref["AddressSpec"]()
    groups = np.zeros((2, 8), bool)
    groups[0, :4] = True
    groups[1, ::2] = True
    i = np.arange(24, dtype=np.int32)
    spec = {
        "poisson": jtr.poisson(key, 8, epc, mean_gap_ns=300.0),
        "broadcast": jtr.TrafficSpec(
            src=jnp.zeros(24, jnp.int32), t=jnp.asarray(i * 500),
            dest=jnp.asarray(addr.pack_multicast(i % 2, core=i))),
        "hot_spot": jtr.hot_spot(key, 16, epc // 2, hot_chip=5,
                                 hot_frac=0.6)}
    want = {"poisson": JFabric(ring).compile(spec["poisson"]).run(
                spec["poisson"]),
            "broadcast": JFabric(ring, addr=addr,
                                 mcast=JMcastTable(groups)).run(
                spec["broadcast"]),
            "hot_spot": jnet.simulate_fabric(mesh, spec["hot_spot"])}
    mod = port_script("multi_chip_fabric")
    port_spec = {k: to_port(v) for k, v in spec.items()}
    out, text = run_main(mod, make_traffic=lambda: port_spec)
    return spec, want, mod, out, text


@pytest.mark.parametrize("case", ["poisson", "broadcast", "hot_spot"])
def test_multi_chip_fabric_matches_reference(multi_chip, case):
    _, want, _, out, _ = multi_chip
    tnet.assert_results_equal(out["results"][case], want[case], case)
    got = out[case]
    same_stats(got, want[case])
    jres = want[case]
    assert got["drops"] == int(jres.drops)
    assert got["mev_s"] == float(jnet.fabric_throughput_mev_s(jres))
    assert got["busiest_link_mev_s"] == float(
        np.asarray(jnet.per_link_throughput_mev_s(jres)).max())
    assert got["max_switches"] == int(np.asarray(jres.n_switches).max())
    assert got["energy_pj"] == float(jnet.fabric_energy_pj(jres, J_PAPER))


def test_multi_chip_fabric_main_and_port_draw(multi_chip):
    spec, _, mod, out, text = multi_chip
    assert text.count("=== ") == 3 and "delivered        : 512/512" in text
    tnet.assert_results_equal(out["replay"]["result"],
                              out["results"]["poisson"], "replay")
    own = mod.make_traffic()
    same_port_traffic_shapes([own[k] for k in spec],
                             [spec[k] for k in spec])
    # the broadcast draws nothing: the port's is the reference's
    np.testing.assert_array_equal(own["broadcast"].dest.numpy(),
                                  np.asarray(spec["broadcast"].dest))


# --- 2. heterogeneous_links -------------------------------------------------

@pytest.fixture(scope="module")
def heterogeneous():
    ref = reference_script("heterogeneous_links")
    topo = j_ring(ref["N_CHIPS"])
    spec = jtr.poisson(jax.random.PRNGKey(0), ref["N_CHIPS"],
                       ref["EVENTS_PER_CHIP"], mean_gap_ns=400.0)
    mixed = ref["per_link_timing"](
        [J_PAPER, ref["SERIAL_LVDS_TIMING"]],
        [1 if l == ref["SLOW_LINK"] else 0 for l in range(topo.n_links)])
    cf_u = JFabric(topo, timing=J_PAPER).compile(spec)
    cf_h = JFabric(topo, timing=mixed).compile(spec)
    want = {"uniform": cf_u.run(spec), "mixed": cf_h.run(spec),
            "bucket": cf_u.bucket, "mixed_timing": mixed}
    mod = port_script("heterogeneous_links")
    port_spec = to_port(spec)
    out, text = run_main(mod, make_traffic=lambda: port_spec)
    return want, mod, out, text


@pytest.mark.parametrize("case", ["uniform", "mixed"])
def test_heterogeneous_links_matches_reference(heterogeneous, case):
    want, _, out, _ = heterogeneous
    jres = want[case]
    tnet.assert_results_equal(out["results"][case], jres, case)
    same_stats(out[case], jres)
    timing = J_PAPER if case == "uniform" else want["mixed_timing"]
    assert out[case]["mev_s"] == float(jnet.fabric_throughput_mev_s(jres))
    assert out[case]["energy_nj"] == \
        float(jnet.fabric_energy_pj(jres, timing)) * 1e-3


def test_heterogeneous_links_per_link_and_deltas(heterogeneous):
    want, mod, out, text = heterogeneous
    ju, jh = want["uniform"], want["mixed"]
    pl = out["per_link"]
    np.testing.assert_array_equal(
        pl["thr_u"], np.asarray(jnet.per_link_throughput_mev_s(ju)))
    np.testing.assert_array_equal(
        pl["thr_h"], np.asarray(jnet.per_link_throughput_mev_s(jh)))
    sent_h = np.asarray(jh.sent).sum(axis=1)
    np.testing.assert_array_equal(pl["sent_h"], sent_h)
    tc = np.full(len(sent_h), J_PAPER.t_req2req_ns)
    tc[mod.SLOW_LINK] = mod.SERIAL_LVDS_TIMING.t_req2req_ns
    np.testing.assert_array_equal(
        pl["occ_h"], 100.0 * sent_h * tc / np.asarray(jh.t_link))
    lu, lh = jnet.delivered_latencies(ju), jnet.delivered_latencies(jh)
    assert out["d_p99_ns"] == np.percentile(lh, 99) - np.percentile(lu, 99)
    assert out["d_p50_ns"] == np.percentile(lh, 50) - np.percentile(lu, 50)
    assert out["bucket"] == want["bucket"]
    assert text.rstrip().endswith("OK")
    same_port_traffic_shapes([mod.make_traffic()],
                             [jtr.poisson(jax.random.PRNGKey(0), 8, 48)])


# --- 3. multicast_fanout ----------------------------------------------------

@pytest.fixture(scope="module")
def multicast():
    ref = reference_script("multicast_fanout")
    n, members, n_ev = ref["N_CHIPS"], ref["MEMBERS"], ref["N_EVENTS"]
    topo, addr = j_ring(n), ref["AddressSpec"]()
    grp = np.zeros((1, n), bool)
    grp[0, members] = True
    spec = jtr.TrafficSpec(
        src=jnp.zeros(n_ev, jnp.int32),
        t=jnp.arange(n_ev, dtype=jnp.int32) * 300,
        dest=jnp.asarray(addr.pack_multicast(np.zeros(n_ev, np.int64))))
    want = {mode: JFabric(topo, addr=addr,
                          mcast=JMcast(mode, JMcastTable(grp))).run(spec)
            for mode in ("source_expand", "in_fabric")}
    tree = ref["MulticastTree"].build(topo, ref["RoutingTable"].build(topo),
                                      0, members)
    mod = port_script("multicast_fanout")
    port_spec = to_port(spec)
    out, text = run_main(mod, make_traffic=lambda: port_spec)
    return spec, want, tree, mod, out, text


@pytest.mark.parametrize("mode", ["source_expand", "in_fabric"])
def test_multicast_fanout_matches_reference(multicast, mode):
    _, want, _, _, out, _ = multicast
    jres = want[mode]
    tnet.assert_results_equal(out["results"][mode], jres, mode)
    same_stats(out[mode], jres)
    assert out[mode]["energy_nj"] == \
        float(jnet.fabric_energy_pj(jres, J_PAPER)) * 1e-3
    assert tnet.delivery_multiset(out["results"][mode]) == \
        jnet.delivery_multiset(jres)


def test_multicast_fanout_tree_and_traversals(multicast):
    spec, want, tree, mod, out, text = multicast
    assert out["tree_edges"] == tree.n_edges
    np.testing.assert_array_equal(
        out["sent_source"], np.asarray(want["source_expand"].sent).sum(1))
    np.testing.assert_array_equal(
        out["sent_in_fabric"], np.asarray(want["in_fabric"].sent).sum(1))
    assert text.rstrip().endswith("OK")
    # the workload draws nothing: the port's own is the reference's
    own = mod.make_traffic()
    for f in ("src", "t", "dest"):
        np.testing.assert_array_equal(getattr(own, f).numpy(),
                                      np.asarray(getattr(spec, f)))


# --- 4. lossless_hotspot ----------------------------------------------------

@pytest.fixture(scope="module")
def lossless():
    ref = reference_script("lossless_hotspot")
    points = {"mild": jsweep.LOSSLESS_RING, "hot": jsweep.LOSSLESS_RING_HOT}
    topo = j_ring(jsweep.LOSSLESS_RING["n_chips"])
    spec = {p: jsweep._lossless_spec(cfg) for p, cfg in points.items()}
    # the reference example's own run_modes (its conservation assert)
    want = {p: ref["run_modes"](topo, cfg) for p, cfg in points.items()}
    mod = port_script("lossless_hotspot")
    by_key = {cfg["key"]: to_port(spec[p]) for p, cfg in points.items()}
    out, text = run_main(mod, _lossless_spec=lambda cfg: by_key[cfg["key"]])
    return want, mod, out, text


@pytest.mark.parametrize("point", ["mild", "hot"])
@pytest.mark.parametrize("flow", ["drop", "credit", "onoff"])
def test_lossless_hotspot_matches_reference(lossless, point, flow):
    want, _, out, _ = lossless
    jres = want[point][flow]
    tnet.assert_results_equal(out["results"][point][flow], jres,
                              f"{point}/{flow}")
    same_stats(out[point][flow], jres)
    assert out[point][flow]["stalls"] == \
        int(np.asarray(jres.telemetry.stall_steps).sum())


def test_lossless_hotspot_claims_and_stall_table(lossless):
    """The stall telemetry by link equals the reference's, and so do
    both p99s of the mild point, whose order the reference asserts and
    fails here (credit 415 ns against drop 379 ns): the port prints it
    and runs to OK."""
    want, mod, out, text = lossless
    ll = j_link_load(want["hot"]["credit"])
    np.testing.assert_array_equal(out["stalls_by_link"],
                                  np.asarray(ll.stalls))
    assert out["link_load"].table(mod.TOPO.links) == \
        ll.table(np.asarray(j_ring(16).links))
    p99 = {f: jnet.latency_stats(want["mild"][f])["p99_ns"]
           for f in ("drop", "credit")}
    assert (out["p99_drop_ns"], out["p99_credit_ns"]) == \
        (p99["drop"], p99["credit"])
    assert text.rstrip().endswith("OK")
    assert mod.LOSSLESS_RING == jsweep.LOSSLESS_RING
    assert mod.LOSSLESS_RING_HOT == jsweep.LOSSLESS_RING_HOT
    assert mod.EVENTS_PER_CHIP == jsweep.EVENTS_PER_CHIP
    same_port_traffic_shapes(
        [mod._lossless_spec(mod.LOSSLESS_RING)],
        [jsweep._lossless_spec(jsweep.LOSSLESS_RING)])


# --- 5. adaptive_hotspot ----------------------------------------------------

@pytest.fixture(scope="module")
def adaptive():
    ref = reference_script("adaptive_hotspot")
    n = ref["N_CHIPS"]
    topo = j_ring(n)
    spec = jtr.hot_spot(jax.random.PRNGKey(3), n, ref["EVENTS_PER_CHIP"],
                        mean_gap_ns=ref["MEAN_GAP_NS"])
    queues = JQueues(capacity=ref["CAPACITY"])
    static = JFabric(topo, queues=queues)
    adaptive = JFabric(topo, routing=ref["POLICY"], queues=queues)
    want = {"diag": JFabric(topo).run(spec),
            "static": static.run_epochs(spec, epochs=ref["EPOCHS"]),
            "adaptive": adaptive.run(spec),
            "static_report": static.last_report,
            "adaptive_report": adaptive.last_report}
    mod = port_script("adaptive_hotspot")
    port_spec = to_port(spec)
    out, text = run_main(mod, make_traffic=lambda: port_spec)
    return want, mod, out, text


@pytest.mark.parametrize("case", ["diag", "static", "adaptive"])
def test_adaptive_hotspot_matches_reference(adaptive, case):
    want, _, out, _ = adaptive
    tnet.assert_results_equal(out["results"][case], want[case], case)
    if case != "diag":
        same_stats(out[case], want[case])
        rep = out["results"][f"{case}_report"]
        jrep = want[f"{case}_report"]
        assert rep.n_epochs == jrep.n_epochs
        assert rep.buckets == jrep.buckets
        for e, (r, jr) in enumerate(zip(rep.records, jrep.records)):
            tnet.assert_results_equal(r.result, jr.result, f"epoch {e}")


def test_adaptive_hotspot_claims_and_epochs(adaptive):
    """Occupancy and the epoch table equal the reference's, and so do
    adaptive's drops and p99 against static's, which the reference
    asserts and fails here (224 drops against 221, 1490 ns against
    1392): the port prints them and runs to OK."""
    want, _, out, text = adaptive
    np.testing.assert_array_equal(out["occupancy"],
                                  j_link_load(want["diag"]).occupancy)
    rows = [(int(rs.load.drops.sum()), int(ra.load.drops.sum()),
             jnet.latency_stats(rs.result)["p99_ns"],
             jnet.latency_stats(ra.result)["p99_ns"])
            for rs, ra in zip(want["static_report"].records,
                              want["adaptive_report"].records)]
    assert out["epochs"] == rows
    s, a = want["static"], want["adaptive"]
    assert out["drops_saved"] == int(s.drops) - int(a.drops)
    assert out["p99_saved_ns"] == (jnet.latency_stats(s)["p99_ns"]
                                   - jnet.latency_stats(a)["p99_ns"])
    assert out["recompiled"] is False
    assert text.rstrip().endswith("OK")


# --- 6. monte_carlo_sweep ---------------------------------------------------

@pytest.fixture(scope="module")
def monte_carlo():
    ref = reference_script("monte_carlo_sweep")
    cfg, n_seeds = jsweep.BATCH_RING, ref["N_SEEDS"]
    specs = jtr.monte_carlo(cfg["pattern"], jax.random.PRNGKey(cfg["key"]),
                            n_seeds, cfg["n_chips"], cfg["epc"])
    cell = JFabric(j_ring(cfg["n_chips"])).sweep_batch(specs)
    mod = port_script("monte_carlo_sweep")
    port_specs = [to_port(s) for s in specs]
    # the script counts the batched runners the process holds: start it
    # from an empty cache, as a fresh process does
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tnet, "_RUNNERS", {})
        out, text = run_main(mod, make_traffic=lambda: port_specs)
    return specs, cell.result, mod, out, text


def test_monte_carlo_sweep_instances_match_reference(monte_carlo):
    _, jbatch, _, out, _ = monte_carlo
    got = out["batch"]
    assert got.n_instances == jbatch.n_instances == 64
    for i in range(got.n_instances):
        tnet.assert_results_equal(got.instance(i), jbatch.instance(i),
                                  f"seed {i}")


def test_monte_carlo_sweep_stats_match_reference(monte_carlo):
    specs, jbatch, mod, out, text = monte_carlo
    stats = jnet.batch_latency_stats(jbatch)
    np.testing.assert_array_equal(out["p50_ns"],
                                  [s["p50_ns"] for s in stats])
    np.testing.assert_array_equal(out["p99_ns"],
                                  [s["p99_ns"] for s in stats])
    np.testing.assert_array_equal(
        out["mev_s"], np.asarray(jnet.batch_throughput_mev_s(jbatch)))
    np.testing.assert_array_equal(out["delivered"],
                                  np.asarray(jbatch.delivered))
    assert out["n_compiles"] == 1
    assert "64-seed Monte-Carlo" in text
    tnet.assert_results_equal(out["replay"]["result"],
                              out["batch"].instance(0), "replay")
    assert mod.BATCH_RING == jsweep.BATCH_RING
    own = mod.make_traffic()
    assert len(own) == len(specs)
    same_port_traffic_shapes(own, specs)
