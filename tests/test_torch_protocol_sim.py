"""The port's link physics against the JAX reference, bit for bit.

Same numpy-made inputs go through ``repro.core`` (JAX, CPU) and
``repro_torch.core`` (PyTorch, ``device="cpu"``): the SW_Control FSM,
the batched link micro-transaction and whole ``simulate`` traces (Figs.
7 and 8 and random arrivals).  Every integer output is compared exactly,
dtype included; the float throughput to 1e-6 relative (both packages
compute it in float32 from the same integers, so only the division's
rounding could differ)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import protocol_sim as ps
from repro.core import transceiver as jx
from repro.core.link import PAPER_TIMING, link_timing_arrays
from repro_torch.core import protocol_sim as tps
from repro_torch.core import transceiver as tx


def _eq(jax_arr, torch_t, what=""):
    a = np.asarray(jax_arr)
    b = torch_t.numpy()
    assert b.dtype == np.int32 and a.dtype == np.int32, what
    np.testing.assert_array_equal(a, b, err_msg=what)


def _t32(a):
    return torch.as_tensor(np.asarray(a, np.int32))


class TestFsm:
    def test_step_exhaustive(self):
        """Every (state, input) combination of small values."""
        grid = np.array(list(itertools.product(
            (0, 1), (0, 1), (0, 1), (0, 1, 2), (0, 1), (0, 1, 2), (0, 1))),
            np.int32).T
        mode, ack, rxp, burst, req, pend, strobe = grid
        for mb in (0, 1, 2):
            js, jo = jx.step(jx.XcvrState(*map(jnp.asarray,
                                               (mode, ack, rxp, burst))),
                             jnp.asarray(req), jnp.asarray(pend),
                             jnp.asarray(strobe), max_burst=mb)
            ts, to = tx.step(tx.XcvrState(*map(_t32,
                                               (mode, ack, rxp, burst))),
                             _t32(req), _t32(pend), _t32(strobe),
                             max_burst=mb)
            for f in jx.XcvrState._fields:
                _eq(getattr(js, f), getattr(ts, f), f"{f} mb={mb}")
            for f in jx.XcvrOut._fields:
                _eq(getattr(jo, f), getattr(to, f), f"{f} mb={mb}")

    def test_reset(self):
        for m in (0, 1):
            js, ts = jx.reset_state(m), tx.reset_state(m)
            for f in jx.XcvrState._fields:
                _eq(getattr(js, f), getattr(ts, f), f)


def _random_links(rng, L):
    """A random (L,)-leaved LinkState, as int32 numpy leaves."""
    r = lambda hi: rng.integers(0, hi, L).astype(np.int32)  # noqa: E731
    return dict(t=r(10_000), xl=[r(2), r(2), r(2), r(3)],
                xr=[r(2), r(2), r(2), r(3)], last_dir=r(2),
                bus_busy=r(2), prev_tx_l=r(2), prev_tx_r=r(2))


@pytest.mark.parametrize("per_link", [False, True])
@pytest.mark.parametrize("max_burst", [0, 1])
def test_link_step_batch_bit_exact(per_link, max_burst):
    rng = np.random.default_rng(11 + per_link + 2 * max_burst)
    L = 64
    st = _random_links(rng, L)
    pend_l = rng.integers(0, 3, L).astype(np.int32)
    pend_r = rng.integers(0, 3, L).astype(np.int32)
    t_next = np.where(rng.random(L) < 0.3, ps.BIG_NS,
                      rng.integers(0, 20_000, L)).astype(np.int32)

    def build(mod, xmod, conv):
        return mod.LinkState(
            t=conv(st["t"]), xl=xmod.XcvrState(*map(conv, st["xl"])),
            xr=xmod.XcvrState(*map(conv, st["xr"])),
            last_dir=conv(st["last_dir"]), bus_busy=conv(st["bus_busy"]),
            prev_tx_l=conv(st["prev_tx_l"]),
            prev_tx_r=conv(st["prev_tx_r"]))

    kw_j, kw_t = {}, {}
    if per_link:
        tc = rng.integers(20, 400, L)
        timing = PAPER_TIMING.for_links(L)
        timing = type(timing)(**{**timing.__dict__, "t_req2req_ns": tc,
                                 "t_bidir_ns": tc + 4})
        arrs = link_timing_arrays(timing, L)
        kw_j["timing_arrays"] = tuple(jnp.asarray(a) for a in arrs)
        kw_t["timing_arrays"] = tuple(_t32(a) for a in arrs)
    js, jo = ps.link_step_batch(build(ps, jx, jnp.asarray),
                                jnp.asarray(pend_l), jnp.asarray(pend_r),
                                jnp.asarray(t_next), max_burst=max_burst,
                                **kw_j)
    ts, to = tps.link_step_batch(build(tps, tx, _t32), _t32(pend_l),
                                 _t32(pend_r), _t32(t_next),
                                 max_burst=max_burst, **kw_t)
    for f in ("t", "last_dir", "bus_busy", "prev_tx_l", "prev_tx_r"):
        _eq(getattr(js, f), getattr(ts, f), f)
    for side in ("xl", "xr"):
        for f in jx.XcvrState._fields:
            _eq(getattr(getattr(js, side), f), getattr(getattr(ts, side), f),
                f"{side}.{f}")
    for f in ps.LinkStepOut._fields:
        _eq(getattr(jo, f), getattr(to, f), f)


def _assert_sim_equal(r, q):
    for f in ps.SimTrace._fields:
        _eq(getattr(r.trace, f), getattr(q.trace, f), f)
    for f in ("sent_l", "sent_r", "t_end", "n_switches"):
        _eq(getattr(r, f), getattr(q, f), f)


@pytest.mark.parametrize("seed,initial_tx,max_burst",
                         [(0, 1, 0), (1, 0, 0), (2, 1, 1), (3, 0, 8)])
def test_simulate_random_arrivals(seed, initial_tx, max_burst):
    rng = np.random.default_rng(seed)
    al = np.sort(rng.integers(0, 40_000, 70)).astype(np.int32)
    ar = np.sort(rng.integers(0, 40_000, 50)).astype(np.int32)
    r = ps.simulate(jnp.asarray(al), jnp.asarray(ar),
                    initial_tx=initial_tx, max_burst=max_burst)
    q = tps.simulate(al, ar, initial_tx=initial_tx, max_burst=max_burst,
                     device="cpu")
    _assert_sim_equal(r, q)


def test_fig7_onedir_trace():
    r = ps.saturated_onedir(96)
    q = tps.saturated_onedir(96, device="cpu")
    _assert_sim_equal(r, q)
    assert int(q.t_end) == 10 + 31 * 96


def test_fig8_anchor_28_6():
    """The paper's bidirectional figure: 28.6 MEv/s within 0.1, the
    trace bit-exact and the float32 rate equal to 1e-6 relative."""
    r = ps.alternating_bidir(256)
    q = tps.alternating_bidir(256, device="cpu")
    _assert_sim_equal(r, q)
    thr = float(tps.throughput_mev_s(q))
    assert thr == pytest.approx(28.6, abs=0.1)
    assert thr == pytest.approx(float(ps.throughput_mev_s(r)), rel=1e-6)
    assert float(tps.energy_pj(q)) == pytest.approx(
        float(ps.energy_pj(r)), rel=1e-6)


def test_empty_side_and_zero_steps():
    q = tps.simulate(np.zeros(0, np.int32), np.zeros(0, np.int32),
                     max_steps=0, device="cpu")
    assert q.trace.t.shape == (0,) and int(q.n_switches) == 0
