"""The CUDA kernels on the card, against their plain PyTorch versions
(the per-step pair, and the multi-step kernel on packed carries of the
chip_smoke cells, solo and as B = 3 instances).

Marked ``gpu``: each test skips where there is no CUDA card (the kernels
have no CPU mode).  This file imports no JAX, so it runs on the machine
with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import network as net
from repro_torch.core.fabric import EngineSpec, Fabric, QueuePolicy
from repro_torch.core.router import ring_topology
from repro_torch.core.traffic import hot_spot
from repro_torch.kernels import fabric_queue as fq
from repro_torch.kernels import ref

from _torch_cases import (MS_BATCH, MS_STEPS, carry_err, clone,
                          multistep_cases, multistep_operands, planes,
                          run_schedule, scan_case, update_case)

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
