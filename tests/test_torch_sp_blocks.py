"""The pieces of the port's sequence parallelism
(``parallel.tensor_parallel.Parallel``): each rank's block of
``ceil(S / tp)`` positions and the zero padding of an uneven split,
with no processes (an abstract mesh's context, its rank set by hand),
and the four sequence collectives' values and gradients on 2 gloo
ranks (``mp.spawn``) against the same sums written out."""

import numpy as np
import pytest
import torch

import _torch_dp as D
from repro_torch.parallel.compat import Mesh
from repro_torch.parallel.sharding import make_rules
from repro_torch.parallel.tensor_parallel import Parallel

SPLITS = [(16, 2), (15, 2), (18, 4), (5, 4), (1, 4), (2048, 4)]


def _par(tp: int, sp: bool = True, rank: int = 0) -> Parallel:
    mesh = Mesh({"data": 1, "model": tp})
    par = Parallel(mesh, rank, {}, make_rules(mesh, seq_parallel=sp).act_map)
    par.tp_rank = rank
    return par


@pytest.mark.parametrize("S,tp", SPLITS)
def test_blocks_cover_the_sequence_in_order(S, tp):
    c = -(-S // tp)
    bounds = [_par(tp, rank=r).block(S) for r in range(tp)]
    assert all(_par(tp, rank=r).block_len(S) == c for r in range(tp))
    assert [i for b in bounds for i in range(b.start, b.stop)] == \
        list(range(S))
    for r, b in enumerate(bounds):
        assert b.start == min(r * c, S) and b.stop - b.start <= c


@pytest.mark.parametrize("S,tp", SPLITS)
def test_pad_and_unpad_an_uneven_split(S, tp):
    x = torch.randn((3, S, 5), generator=torch.Generator().manual_seed(S))
    par = _par(tp).for_sequence(S)
    padded = par._pad_seq(x)
    c = par.block_len(S)
    assert padded.shape == (3, c * tp, 5)
    assert torch.equal(padded[:, :S], x)
    assert not padded[:, S:].any()
    blocks = [padded[:, r * c:(r + 1) * c] for r in range(tp)]
    for r, blk in enumerate(blocks):
        b = _par(tp, rank=r).block(S)
        assert torch.equal(blk[:, :b.stop - b.start], x[:, b])
    assert torch.equal(torch.cat(blocks, 1)[:, :S], x)


def test_for_sequence_marks_only_a_split_stream():
    plain, one, sp = _par(2, sp=False), _par(1), _par(2)
    assert plain.for_sequence(15) is plain and not plain.sp
    assert one.for_sequence(15) is one and not one.seq_split
    run = sp.for_sequence(15)
    assert run is not sp and run.sp and run.seq_len == 15
    assert not sp.sp and sp.seq_len is None
    assert run.model is sp.model and run.splits is sp.splits


def _collectives_rank(rank, S):
    """Each sequence collective's value and input gradient on this
    rank, beside the same written out from every rank's inputs."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(data=1, model=2)
    par = Parallel(mesh, rank, {}, make_rules(
        mesh, seq_parallel=True).act_map).for_sequence(S)
    c = par.block_len(S)

    def draw(seed, n):           # every rank can draw every rank's
        return torch.randn((2, n, 3), dtype=torch.float64,
                           generator=torch.Generator().manual_seed(seed))

    def pad(t):
        return torch.cat([t, t.new_zeros((2, 2 * c - S, 3))], 1)

    mine = slice(rank * c, (rank + 1) * c)
    out = {}
    cases = {
        # name: (input of rank r, gradient of rank r's output)
        "enter": (lambda r: draw(r, c), lambda r: draw(10 + r, S)),
        "exit": (lambda r: draw(r, S), lambda r: draw(10 + r, c)),
        "block": (lambda r: draw(0, S), lambda r: draw(10 + r, c)),
        "whole": (lambda r: draw(r, c), lambda r: draw(10, S)),
    }
    for name, (x_of, g_of) in cases.items():
        x = x_of(rank).requires_grad_()
        y = getattr(par, f"seq_{name}")(x)
        y.backward(g_of(rank))
        xs, gs = [x_of(r) for r in range(2)], [g_of(r) for r in range(2)]
        if name == "enter":
            want, grad = torch.cat(xs, 1)[:, :S], pad(sum(gs))[:, mine]
        elif name == "exit":
            want, grad = pad(sum(xs))[:, mine], torch.cat(gs, 1)[:, :S]
        elif name == "block":
            want, grad = pad(xs[0])[:, mine], torch.cat(gs, 1)[:, :S]
        else:
            want, grad = torch.cat(xs, 1)[:, :S], pad(gs[0])[:, mine]
        out[name] = np.array([float((y - want).abs().max()),
                              float((x.grad - grad).abs().max()),
                              y.shape == want.shape])
    out["at"] = (par.seq_at(draw(rank, c), S - 1)
                 - draw(1, c)[:, S - 1 - c:S - c]).abs().max().numpy()
    return out


def test_sequence_collectives(tmp_path):
    ranks = D.spawn(tmp_path, _collectives_rank, 5, world=2)
    for r, got in enumerate(ranks):
        for name in ("enter", "exit", "block", "whole"):
            err, gerr, shaped = got[name]
            assert shaped and err < 1e-12 and gerr < 1e-12, (r, name, got)
        assert float(got["at"]) == 0.0, (r, got["at"])
