"""The LIF update, the AER protocol words and the Fig. 6 SNN chip array of
the port, on ``device="cpu"``, against the reference.

The reference runs as its own tests run it: its LIF update jitted, with
the Pallas kernel in interpret mode.  Under ``jax.jit`` XLA contracts
``v * decay + i`` into one fused multiply-add, so the port's plain LIF
update (``ref.lif_step``) is the single-rounded update and must equal
the jitted reference bit for bit, on membranes that land exactly on the
threshold or one ulp either side and on inputs where one and two
roundings disagree.

The SNN's matrix products are float32 sums in another order than
XLA's (they differ in the last bits), so a trajectory can flip a spike
wherever a membrane lands within ~1e-6 of the threshold.  The step tests
are teacher-forced: every tick both steps start from the reference's
state and drive; membranes match to 1e-6 (the tolerance of
``tests/test_kernels.py:100``) and spikes exactly, except at neurons
whose reference update lies within 1e-6 of the threshold (counted and
printed)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import events as jev
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import snn as jsnn
from repro_torch import interop
from repro_torch.core import events as tev
from repro_torch.kernels import lif_step as lk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import snn as tsnn

from _torch_cases import LIF_PARAMS, fma_f32, lif_case, lif_cases

CPU = "cpu"
TOL = 1e-6


def _bits(a):
    return np.ascontiguousarray(np.asarray(a), np.float32).view(np.int32)


@functools.cache
def _jit_lif(decay, v_th, v_reset):
    return jax.jit(functools.partial(jops.lif_step, decay=decay, v_th=v_th,
                                     v_reset=v_reset))


# --- B4's plain version -------------------------------------------------

@pytest.mark.parametrize("name,v,i,decay,v_th,v_reset", lif_cases(),
                         ids=[c[0] for c in lif_cases()])
def test_lif_plain_matches_jitted_reference(name, v, i, decay, v_th,
                                            v_reset):
    want_v, want_s = _jit_lif(decay, v_th, v_reset)(v, i)
    got_v, got_s = tops.lif_step(torch.from_numpy(v), torch.from_numpy(i),
                                 decay=decay, v_th=v_th, v_reset=v_reset)
    assert got_v.dtype == got_s.dtype == torch.float32
    assert np.array_equal(_bits(want_v), _bits(got_v.numpy())), name
    assert np.array_equal(_bits(want_s), _bits(got_s.numpy())), name
    # the jitted plain JAX version computes the same single rounding
    jr_v, _ = jax.jit(lambda a, b: jref.lif_step(a, b, decay, v_th,
                                                 v_reset))(v, i)
    assert np.array_equal(_bits(jr_v), _bits(got_v.numpy())), name


@pytest.mark.parametrize("decay,v_th,v_reset", LIF_PARAMS)
def test_lif_edges_land_where_they_claim(decay, v_th, v_reset):
    """The case generator's edge elements: 6 updates each exactly on
    v_th, one ulp below and one ulp above, and ±inf membranes."""
    v, i = lif_case(7, (8, 128), decay, v_th, v_reset)
    th = np.float32(v_th)
    got = [fma_f32(a, decay, b) for a, b in zip(v.reshape(-1)[:18],
                                                i.reshape(-1)[:18])]
    assert got[:6] == [th] * 6
    assert got[6:12] == [np.nextafter(th, np.float32(-np.inf))] * 6
    assert got[12:18] == [np.nextafter(th, np.float32(np.inf))] * 6
    want_v, want_s = _jit_lif(decay, v_th, v_reset)(v, i)
    assert np.asarray(want_s).reshape(-1)[:18].tolist() == \
        [1.0] * 6 + [0.0] * 6 + [1.0] * 6
    assert np.asarray(want_s).reshape(-1)[18:20].tolist() == [1.0, 0.0]


def test_lif_reference_rounds_once_under_jit():
    """The finding the plain version rests on: where one rounding and two
    roundings of ``v * decay + i`` disagree, the jitted reference (kernel
    and plain) takes the single rounding, the eager plain reference the
    double one — and some of those inputs flip a spike."""
    decay, v_th, v_reset = LIF_PARAMS[0]
    v, i = lif_case(11, (8, 128), decay, v_th, v_reset)
    split = slice(20, 38)      # the 18 rounding-split pairs
    single = np.array([fma_f32(a, decay, b) for a, b in
                       zip(v.reshape(-1)[split], i.reshape(-1)[split])])
    two = (v * np.float32(decay) + i).astype(np.float32).reshape(-1)[split]
    assert np.all(single != two)
    flips = (single >= v_th) != (two >= v_th)
    assert flips.sum() >= 6
    jit_v, jit_s = _jit_lif(decay, v_th, v_reset)(v, i)
    eager_v, eager_s = jref.lif_step(jnp.asarray(v), jnp.asarray(i), decay,
                                     v_th, v_reset)
    want = np.where(single >= v_th, np.float32(v_reset), single)
    assert np.array_equal(np.asarray(jit_v).reshape(-1)[split], want)
    assert not np.array_equal(np.asarray(eager_v).reshape(-1)[split], want)
    assert np.any(np.asarray(jit_s) != np.asarray(eager_s))
    got_v, _ = tref.lif_step(torch.from_numpy(v), torch.from_numpy(i),
                             decay, v_th, v_reset)
    assert np.array_equal(got_v.numpy().reshape(-1)[split], want)


def test_lif_routing_and_operand_contract():
    v = torch.zeros((8, 128))
    i = torch.full((8, 128), 2.0)
    got = tops.lif_step(v, i)                      # CPU -> plain version
    assert torch.equal(got[1], torch.ones((8, 128)))
    assert torch.equal(got[0], torch.zeros((8, 128)))
    with pytest.raises(ValueError, match="CUDA kernel"):
        lk.lif_step(v, i, decay=0.9, v_th=1.0, v_reset=0.0)
    with pytest.raises(TypeError, match="float32"):
        tref.lif_step(v.double(), i.double(), 0.9, 1.0, 0.0)
    assert lk.lif_step.launches == 0


# --- AER protocol words ------------------------------------------------

@pytest.mark.parametrize("neuron_bits", [16, 10, 4])
def test_aer_words_match_reference(neuron_bits):
    rng = np.random.default_rng(neuron_bits)
    core = rng.integers(0, 1 << 20, 512)        # wider than the field
    neuron = rng.integers(0, 1 << 18, 512)
    want = np.asarray(jev.pack_aer_address(core, neuron, neuron_bits))
    got = tev.pack_aer_address(core, neuron, neuron_bits)
    assert got.dtype == torch.int32
    assert np.array_equal(want.astype(np.int64), got.numpy())
    assert int(got.max()) <= tev.AER_ADDR_MASK
    jc, jn = jev.unpack_aer_address(want, neuron_bits)
    tc, tn = tev.unpack_aer_address(got, neuron_bits)
    assert np.array_equal(np.asarray(jc).astype(np.int64), tc.numpy())
    assert np.array_equal(np.asarray(jn).astype(np.int64), tn.numpy())
    # round trip of in-range fields, from the reference's uint32 words too
    c_ok = core % (1 << (26 - neuron_bits))
    n_ok = neuron % (1 << neuron_bits)
    words = tev.pack_aer_address(torch.from_numpy(c_ok),
                                 torch.from_numpy(n_ok), neuron_bits)
    back = tev.unpack_aer_address(words, neuron_bits)
    assert np.array_equal(back[0].numpy(), c_ok)
    assert np.array_equal(back[1].numpy(), n_ok)
    from_ref = tev.unpack_aer_address(
        np.asarray(jev.pack_aer_address(c_ok, n_ok, neuron_bits)),
        neuron_bits)
    assert np.array_equal(from_ref[0].numpy(), c_ok)


def test_event_constants_and_bytes():
    for name in ("AER_ADDR_BITS", "AER_ADDR_MASK", "EVENT_IDX_BITS",
                 "EVENT_MAX_BLOCK"):
        assert getattr(tev, name) == getattr(jev, name)
    assert tev.event_bytes(10) == jev.event_bytes(10) == 40
    assert tev.event_bytes(3, word_bytes=8) == 24


# --- the SNN chip array ------------------------------------------------------

CFG = dict(grid=(2, 2), neurons=256)


def _ref_net(cfg_kw, seed=0):
    cfg = jsnn.SnnConfig(**cfg_kw)
    params, state = jsnn.init_snn(cfg, jax.random.PRNGKey(seed))
    return cfg, params, state


def _ref_drive(cfg, key):
    """The drive the reference's snn_step draws from ``key``."""
    R, C = cfg.grid
    _, k1 = jax.random.split(key)
    return np.array(jax.random.uniform(k1, (R, C, cfg.neurons))
                      < cfg.input_rate)


def _port_state(st):
    return tsnn.SnnState(v=torch.from_numpy(np.array(st.v)),
                         spikes=torch.from_numpy(np.array(st.spikes)),
                         gen=None)


def _tick_stats(spk, fanout):
    """A tick's stats from its (R, C, rows, 128) raster, as ``snn_step``
    forms them."""
    R, C = spk.shape[:2]
    per_chip = spk.reshape(R, C, -1).sum(-1).astype(np.float64)
    return {"spikes": per_chip.sum(), "rate": spk.mean(dtype=np.float64),
            "ew_events_lr": fanout * per_chip[:, :-1].sum(),
            "ew_events_rl": fanout * per_chip[:, 1:].sum(),
            "ns_events": 2 * fanout * per_chip[:-1, :].sum(),
            "busiest_chip": per_chip.max()}


def test_snn_step_teacher_forced_matches_reference():
    """Every tick both steps start from the reference's state and drive."""
    cfg, params, st = _ref_net(dict(CFG, input_rate=0.08))
    tcfg = tsnn.SnnConfig(**cfg._asdict())
    tparams = interop.snn_params_from_reference(
        {k: np.asarray(w) for k, w in params.items()}, device=CPU)
    step = jax.jit(jsnn.snn_step, static_argnums=1)
    # the reference's update before the reset: v_th = inf never fires
    pre = jax.jit(jsnn.snn_step, static_argnums=1)
    open_cfg = cfg._replace(v_th=float("inf"))
    near_total = spikes_total = flips = 0
    for tick in range(12):
        drive = _ref_drive(cfg, st.key)
        nxt, jtick = step(params, cfg, st)
        v_pre = np.asarray(pre(params, open_cfg, st)[0].v)
        tst, ttick = tsnn.snn_step(tparams, tcfg, _port_state(st),
                                   drive=drive)
        jv, js = np.asarray(nxt.v), np.asarray(nxt.spikes)
        tv, ts = tst.v.numpy(), tst.spikes.numpy()
        near = np.abs(v_pre - cfg.v_th) <= TOL
        near_total += int(near.sum())
        spikes_total += int(js.sum())
        flips += int((js != ts).sum())
        assert np.array_equal(js[~near], ts[~near]), tick
        same = js == ts
        assert np.allclose(jv[same], tv[same], rtol=0, atol=TOL), tick
        # each side's stats are its own raster's; with the near-threshold
        # neurons taken out of both rasters, the stats agree
        for spk, got in ((js, jtick), (ts, ttick)):
            for k, want in _tick_stats(spk, cfg.xchip_fanout).items():
                assert float(got[k]) == pytest.approx(want), (tick, k)
        assert (_tick_stats(np.where(near, 0, js), cfg.xchip_fanout)
                == _tick_stats(np.where(near, 0, ts), cfg.xchip_fanout)), tick
        st = nxt
    # most near-threshold neurons sit exactly on it: a neuron at rest
    # with drive and no synaptic input updates to 0 * decay + 1.0 = v_th
    print(f"near-threshold neurons over 12 ticks: {near_total}, of which "
          f"{flips} spiked differently; spikes {spikes_total}")
    assert spikes_total > 0


def test_run_snn_with_reference_weights_and_drive():
    """The whole 16-tick run, host loop against ``lax.scan``: equal tick
    stats, or a divergence that starts at a near-threshold neuron."""
    cfg, params, st0 = _ref_net(dict(CFG, input_rate=0.08), seed=4)
    tcfg = tsnn.SnnConfig(**cfg._asdict())
    tparams = interop.snn_params_from_reference(
        {k: np.asarray(w) for k, w in params.items()}, device=CPU)
    T = 16
    jfinal, jticks = jax.jit(jsnn.run_snn, static_argnums=(1, 3))(
        params, cfg, st0, T)
    drives, st = [], st0
    step = jax.jit(jsnn.snn_step, static_argnums=1)
    states = []
    for _ in range(T):
        drives.append(_ref_drive(cfg, st.key))
        states.append(st)
        st, _ = step(params, cfg, st)
    tfinal, tticks = tsnn.run_snn(tparams, tcfg, _port_state(st0), T,
                                  drive=np.stack(drives))
    assert set(tticks) == set(jticks)
    assert all(t.shape == (T,) for t in tticks.values())
    js, ts = np.asarray(jticks["spikes"]), tticks["spikes"].numpy()
    if np.array_equal(js, ts):
        assert np.allclose(np.asarray(jfinal.v), tfinal.v.numpy(), rtol=0,
                           atol=TOL)
        for k in jticks:
            assert np.allclose(np.asarray(jticks[k]), tticks[k].numpy(),
                               rtol=1e-6), k
    else:
        t0 = int(np.flatnonzero(js != ts)[0])
        open_cfg = cfg._replace(v_th=float("inf"))
        v_pre = np.asarray(step(params, open_cfg, states[t0])[0].v)
        assert np.any(np.abs(v_pre - cfg.v_th) <= TOL), t0
    assert float(js.sum()) > 0


def test_snn_generator_contract():
    """Deterministic per seed; weight std ~ w_scale / sqrt(n); with zero
    weights, no leak and v_th 0.5 the spikes are the drive, whose rate is
    input_rate within sampling tolerance."""
    cfg = tsnn.SnnConfig(**CFG)
    p1, s1 = tsnn.init_snn(cfg, torch.Generator().manual_seed(5), device=CPU)
    p2, _ = tsnn.init_snn(cfg, torch.Generator().manual_seed(5), device=CPU)
    p3, _ = tsnn.init_snn(cfg, torch.Generator().manual_seed(6), device=CPU)
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert not torch.equal(p1["w_rec"], p3["w_rec"])
    want = cfg.w_scale / np.sqrt(cfg.neurons)
    for w in p1.values():
        assert w.shape == (2, 2, 256, 256) and w.dtype == torch.float32
        assert float(w.std()) == pytest.approx(want, rel=0.01)
        assert abs(float(w.mean())) < 0.01 * want
    zcfg = cfg._replace(decay=0.0, v_th=0.5, input_rate=0.2)
    zero = {k: torch.zeros_like(w) for k, w in p1.items()}
    _, ticks = tsnn.run_snn(zero, zcfg, s1, 40)
    n = 40 * 4 * 256
    rate = float(ticks["spikes"].sum()) / n
    sd = np.sqrt(0.2 * 0.8 / n)
    assert abs(rate - 0.2) < 5 * sd


def test_spikes_to_events_and_link_report_match_reference():
    rng = np.random.default_rng(0)
    spk = (rng.random(256) < 0.1).astype(np.float32)
    jw, jn = jsnn.spikes_to_events(jnp.asarray(spk), 5)
    tw, tn = tsnn.spikes_to_events(torch.from_numpy(spk), 5)
    assert int(jn) == int(tn)
    assert np.array_equal(np.asarray(jw).astype(np.int64), tw.numpy())
    ticks = {k: rng.random(6).astype(np.float32) * 9
             for k in ("ew_events_lr", "ew_events_rl", "ns_events")}
    want = jsnn.link_report(ticks)
    got = tsnn.link_report({k: torch.from_numpy(a)
                            for k, a in ticks.items()})
    assert got == pytest.approx(want)
    assert tsnn._neighbor_sum(torch.ones(3, 2, 4)).tolist() == \
        np.asarray(jsnn._neighbor_sum(jnp.ones((3, 2, 4)))).tolist()
