"""The CUDA kernels on the card, against their plain PyTorch versions
(the per-step pair, the multi-step kernel on packed carries of the
chip_smoke cells, solo and as B = 3 instances, and the LIF update on the
shared LIF cases), and the co-simulation and SNN paths launching them.

Marked ``gpu``: each test skips where there is no CUDA card (the kernels
have no CPU mode).  This file imports no JAX, so it runs on the machine
with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_cuda.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import network as net
from repro_torch.core.fabric import EngineSpec, Fabric, QueuePolicy
from repro_torch.core.router import ring_topology
from repro_torch.core.traffic import hot_spot
from repro_torch import cosim
from repro_torch.core.router import AddressSpec
from repro_torch.kernels import fabric_queue as fq
from repro_torch.kernels import lif_step as lk
from repro_torch.kernels import ref
from repro_torch.models import snn

from _torch_cases import (LIF_CARD_SHAPES, LIF_PARAMS, MS_BATCH, MS_STEPS,
                          carry_err, clone, lif_cases,
                          lif_double_roundings, multistep_cases,
                          multistep_operands, planes, run_schedule,
                          scan_case, update_case)

SHAPES = [(4, 7), (2, 5), (16, 96), (32, 768), (224, 3072)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _t(a, device="cpu"):
    return torch.tensor(np.asarray(a, np.int32), device=device)


def _equal(want, got):
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        assert torch.equal(w, g.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("nq,nc", SHAPES)
def test_step_kernel_matches_plain(cuda, nq, nc):
    q, qd, t = scan_case(np.random.default_rng(nq + nc), nq, nc)
    _equal(ref.fabric_queue_scan(_t(q), _t(qd), _t(t)),
           fq.fabric_queue_step(_t(q, cuda), _t(qd, cuda), _t(t, cuda)))


@pytest.mark.gpu
@pytest.mark.parametrize("nq,nc", SHAPES)
@pytest.mark.parametrize("k", [1, 4])
def test_update_kernel_matches_plain(cuda, nq, nc, k):
    rng = np.random.default_rng(nq * 3 + nc + k)
    pl = planes(rng, nq, nc)
    lanes = update_case(rng, nq, nc, k)
    want = ref.fabric_queue_update(*map(_t, pl), *map(_t, lanes))
    on_card = [_t(p, cuda) for p in pl]
    got = fq.fabric_queue_update(*on_card,
                                 *(_t(a, cuda) for a in lanes))
    assert all(g is p for g, p in zip(got, on_card))   # in place
    _equal(want, got)


@pytest.mark.gpu
def test_wrappers_validate_operands(cuda):
    q = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    t = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        fq.fabric_queue_step(q.long(), q, t)
    with pytest.raises(ValueError, match="contiguous"):
        fq.fabric_queue_step(q.t().contiguous().t(), q, t)
    with pytest.raises(ValueError):
        fq.fabric_queue_step(q, q, t[:3])


@pytest.mark.gpu
def test_engine_on_card_matches_cpu(cuda):
    """A small credit-flow run: the kernel engine on the card against
    the plain engine on the CPU, and 2·max_steps launches."""
    spec = hot_spot(torch.Generator().manual_seed(0), 6, 12)
    kw = dict(queues=QueuePolicy(capacity=5, flow="credit"))
    cf = Fabric(ring_topology(6), device=cuda, **kw).compile(spec)
    fq.fabric_queue_step.launches = fq.fabric_queue_update.launches = 0
    res = cf.run(spec)
    torch.cuda.synchronize()
    steps = cf.bucket[4]
    assert fq.fabric_queue_step.launches == steps
    assert fq.fabric_queue_update.launches == steps
    cpu = Fabric(ring_topology(6), device="cpu", engine="reference",
                 **kw).run(spec)
    net.assert_results_equal(res, cpu, "card vs cpu")


# --- the multi-step kernel ----------------------------------------------

MS_CASES = {name: (kw, arrays, chunks)
            for name, kw, arrays, chunks in multistep_cases()}


def _ms_plain(carry, consts, step_fn):
    return run_schedule(
        lambda c, b, ch: ref.fabric_queue_multistep(
            c, consts, b, step_fn=step_fn, chunk=ch, max_steps=MS_STEPS),
        clone(carry), MS_STEPS, 128)


def _ms_kernel(carry, consts, chunk, max_burst):
    return run_schedule(
        lambda c, b, ch: fq.fabric_queue_multistep(
            c, consts, b, chunk=ch, max_steps=MS_STEPS, max_burst=max_burst),
        clone(carry), MS_STEPS, chunk)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(MS_CASES))
def test_multistep_kernel_matches_plain(cuda, name):
    """Every chunk of the case against one plain run of MS_STEPS steps:
    launches with base > 0, and a max_steps that binds mid-chunk."""
    kw, arrays, chunks = MS_CASES[name]
    carry, consts, step_fn, plan = multistep_operands(kw, arrays, MS_STEPS,
                                                      cuda)
    want = _ms_plain(carry, consts, step_fn)
    for chunk in chunks:
        got = _ms_kernel(carry, consts, chunk, plan.bucket[5])
        torch.cuda.synchronize()
        assert carry_err(want, got, plan.E) == 0, (name, chunk)


@pytest.mark.gpu
def test_multistep_batch_matches_solo(cuda):
    """One launch schedule of B = 3 instances (credit, drop, on/off)
    against the three solo plain runs."""
    ops = [multistep_operands(MS_CASES[n][0], MS_CASES[n][1], MS_STEPS,
                              cuda) for n in MS_BATCH]
    carry = tuple(torch.stack([o[0][j] for o in ops]) for j in range(7))
    consts = tuple(torch.stack([o[1][j] for o in ops]) for j in range(6))
    got = _ms_kernel(carry, consts, 128, ops[0][3].bucket[5])
    torch.cuda.synchronize()
    for i, (c, k, step_fn, plan) in enumerate(ops):
        want = _ms_plain(c, k, step_fn)
        assert carry_err(want, tuple(g[i] for g in got), plan.E) == 0, i


@pytest.mark.gpu
def test_multistep_engine_launches(cuda):
    """ceil(max_steps / chunk) launches, none of the per-step pair, and
    the CPU plain engine's result."""
    spec = hot_spot(torch.Generator().manual_seed(0), 6, 12)
    kw = dict(queues=QueuePolicy(capacity=5, flow="credit"))
    eng = EngineSpec("pallas", kernel="multistep", chunk_size=16)
    cf = Fabric(ring_topology(6), device=cuda, engine=eng,
                **kw).compile(spec)
    fq.fabric_queue_step.launches = fq.fabric_queue_update.launches = 0
    fq.fabric_queue_multistep.launches = 0
    res = cf.run(spec)
    torch.cuda.synchronize()
    steps = cf.bucket[4]
    assert fq.fabric_queue_multistep.launches == -(-steps // 16)
    assert fq.fabric_queue_step.launches == 0
    assert fq.fabric_queue_update.launches == 0
    cpu = Fabric(ring_topology(6), device="cpu", engine="reference",
                 **kw).run(spec)
    net.assert_results_equal(res, cpu, "multistep card vs cpu")


@pytest.mark.gpu
def test_multistep_wrapper_validates_operands(cuda):
    kw, arrays, _ = MS_CASES["anchor"]
    carry, consts, _, _ = multistep_operands(kw, arrays, MS_STEPS, cuda)
    base = torch.zeros(1, dtype=torch.int32, device=cuda)
    call = dict(chunk=4, max_steps=8, max_burst=1)
    with pytest.raises(TypeError, match="int32"):
        fq.fabric_queue_multistep((carry[0].long(),) + carry[1:], consts,
                                  base, **call)
    strided = carry[0].t().contiguous().t()          # (Q, C) = (2, 2048)
    with pytest.raises(ValueError, match="contiguous"):
        fq.fabric_queue_multistep((strided,) + carry[1:], consts, base,
                                  **call)
    with pytest.raises(ValueError, match="is on cpu"):
        fq.fabric_queue_multistep(carry[:6] + (carry[6].cpu(),), consts,
                                  base, **call)
    with pytest.raises(ValueError, match="on cpu"):
        fq.fabric_queue_multistep(tuple(t.cpu() for t in carry),
                                  tuple(t.cpu() for t in consts),
                                  base.cpu(), **call)
    with pytest.raises(ValueError, match="shape"):
        fq.fabric_queue_multistep(carry, consts[:4] + (consts[4][:2],)
                                  + consts[5:], base, **call)
    # a fabric whose lane and side planes do not fit in shared memory
    L, k = 2048, 1
    big = [torch.zeros(s, dtype=torch.int32, device=cuda) for s in (
        (2 * L, 1), (2 * L, 1), (2 * L, 1), (16, L), (9, L, 2), (3, 2),
        (2,))]
    bconsts = [torch.zeros(s, dtype=torch.int32, device=cuda) for s in (
        (L, 2), (2, 2, k), (2, 2), (2, 2, k), (3, L), (3,))]
    with pytest.raises(ValueError, match="shared memory"):
        fq.fabric_queue_multistep(big, bconsts, base, **call)


# --- the LIF update ---------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("shape", LIF_CARD_SHAPES)
@pytest.mark.parametrize("params", LIF_PARAMS)
def test_lif_kernel_matches_plain(cuda, shape, params):
    """Bit for bit, except where the plain version's float64 route
    rounds twice: each such element must be the kernel's exact single
    rounding (none is expected)."""
    ((_, v, i, decay, v_th, v_reset),) = lif_cases((shape,), (params,))
    before = lk.lif_step.launches
    got = lk.lif_step(torch.from_numpy(v).to(cuda),
                      torch.from_numpy(i).to(cuda), decay=decay,
                      v_th=v_th, v_reset=v_reset)
    torch.cuda.synchronize()
    assert lk.lif_step.launches == before + 1
    plain = ref.lif_step(torch.from_numpy(v).to(cuda),
                         torch.from_numpy(i).to(cuda), decay, v_th, v_reset)
    got = tuple(t.cpu().numpy() for t in got)
    plain = tuple(t.cpu().numpy() for t in plain)
    _, unexplained = lif_double_roundings(v, i, decay, v_th, v_reset, got,
                                          plain)
    assert unexplained == 0


@pytest.mark.gpu
def test_lif_wrapper_validates_operands(cuda):
    v = torch.zeros((8, 128), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        lk.lif_step(v.double(), v.double(), decay=0.9, v_th=1.0,
                    v_reset=0.0)
    with pytest.raises(ValueError, match="contiguous"):
        lk.lif_step(v.t(), v.t(), decay=0.9, v_th=1.0, v_reset=0.0)
    with pytest.raises(ValueError, match="shape"):
        lk.lif_step(v, v[:4], decay=0.9, v_th=1.0, v_reset=0.0)
    with pytest.raises(ValueError, match="is on cpu"):
        lk.lif_step(v, v.cpu(), decay=0.9, v_th=1.0, v_reset=0.0)


def _ring4():
    pops = [cosim.Population(f"p{i}") for i in range(4)]
    projs = [cosim.Projection(i, (j,), 0.4) for i in range(4)
             for j in ((i + 1) % 4, (i - 1) % 4)]
    projs += [cosim.Projection(i, (i,), 0.3) for i in range(4)]
    return cosim.place(pops, projs, ring_topology(4), addr=AddressSpec())


def _spikes_agree(a, b, tol=1e-6):
    """Equal rasters, or a first differing tick whose differing neurons
    sit within ``tol`` of the threshold (1.0) on the side that did not
    spike.  ``raster`` and ``v`` lead with the tick axis."""
    diff = a.raster != b.raster
    if not diff.any():
        return True
    t0 = int(np.flatnonzero(diff.reshape(len(diff), -1).any(axis=1))[0])
    d = diff[t0]
    v_pre = np.where(a.raster[t0] == 0, a.v[t0], b.v[t0])[d]
    return bool(np.all(np.abs(v_pre - 1.0) <= tol))


@pytest.mark.gpu
def test_cosim_on_card_launches_and_matches_cpu(cuda):
    """An 8-tick closed loop over the multi-step fabric: one LIF launch a
    tick, only B3 for transport, and the CPU run's trajectory (same
    seed) up to near-threshold flips."""
    pl = _ring4()
    runs = {}
    for dev in (cuda, "cpu"):
        fab = pl.fabric(engine=EngineSpec("pallas", kernel="multistep"),
                        queues=QueuePolicy(capacity=128, flow="credit"),
                        device=dev)
        eng = cosim.CosimEngine(pl, fabric=fab, device=dev,
                                generator=torch.Generator().manual_seed(3))
        lk.lif_step.launches = fq.fabric_queue_multistep.launches = 0
        fq.fabric_queue_step.launches = fq.fabric_queue_update.launches = 0
        runs[str(dev)] = eng.run(8, record_state=True)
        counts = (lk.lif_step.launches, fq.fabric_queue_multistep.launches,
                  fq.fabric_queue_step.launches,
                  fq.fabric_queue_update.launches)
        if dev == cuda:
            assert counts[0] == 8 and counts[1] > 0 and counts[2:] == (0, 0)
        else:
            assert counts == (0, 0, 0, 0)
    card, cpu = runs[str(cuda)], runs["cpu"]
    assert card.conservation_exact and int(card.drops.sum()) == 0
    assert _spikes_agree(cpu, card)


@pytest.mark.gpu
def test_snn_on_card_launches_and_matches_cpu(cuda):
    """Six ticks of the 2x2 array, one ``run_snn`` tick at a time: one
    LIF launch a tick on the card, and the CPU run's trajectory (same
    seed) up to near-threshold flips."""
    cfg = snn.SnnConfig(grid=(2, 2), neurons=256)
    out = {}
    for dev in (cuda, "cpu"):
        params, st = snn.init_snn(cfg, torch.Generator().manual_seed(0),
                                  device=dev)
        lk.lif_step.launches = 0
        raster, v = [], []
        for _ in range(6):
            st, _ticks = snn.run_snn(params, cfg, st, 1)
            raster.append(st.spikes.cpu().numpy())
            v.append(st.v.cpu().numpy())
        out[str(dev)] = (lk.lif_step.launches, SimpleNamespace(
            raster=np.stack(raster), v=np.stack(v)))
    (n_card, card), (n_cpu, cpu) = out[str(cuda)], out["cpu"]
    assert n_card == 6 and n_cpu == 0
    assert cpu.raster.sum() > 0
    assert _spikes_agree(cpu, card)
    if np.array_equal(card.raster, cpu.raster):
        np.testing.assert_allclose(card.v, cpu.v, rtol=0, atol=1e-5)
