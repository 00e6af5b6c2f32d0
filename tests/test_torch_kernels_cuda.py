"""The CUDA kernels on the card, against their plain PyTorch versions.

Marked ``gpu``: each test skips where there is no CUDA card (the kernels
have no CPU mode).  This file imports no JAX, so it runs on the machine
with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import network as net
from repro_torch.core.fabric import Fabric, QueuePolicy
from repro_torch.core.router import ring_topology
from repro_torch.core.traffic import hot_spot
from repro_torch.kernels import fabric_queue as fq
from repro_torch.kernels import ref

from _torch_cases import planes, scan_case, update_case

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
