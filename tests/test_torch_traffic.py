"""The port's traffic generators keep the reference's contract: int32
flat specs, chip-major order, nondecreasing times per source, no
self-addressed events, and the pattern's distribution.  (PyTorch cannot
reproduce JAX's random bits, so nothing here is bit-exact.)"""

import numpy as np
import pytest
import torch

from repro_torch.core import traffic as tr


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _check_contract(spec, n_chips, per_chip):
    for f in spec._fields:
        assert getattr(spec, f).dtype == torch.int32
    src, t, dest = (getattr(spec, f).numpy() for f in spec._fields)
    assert spec.n_events == n_chips * per_chip
    np.testing.assert_array_equal(
        src, np.repeat(np.arange(n_chips), per_chip))
    assert (np.diff(t.reshape(n_chips, per_chip), axis=1) >= 0).all()
    assert (t >= 0).all()
    assert ((dest >= 0) & (dest < max(n_chips, 2)) & (dest != src)).all()
    return src, t, dest


@pytest.mark.parametrize("name", sorted(tr.PATTERNS))
def test_patterns_keep_the_contract(name):
    per_chip = 16
    spec = tr.PATTERNS[name](_gen(), 6, per_chip)
    _check_contract(spec, 6, per_chip)


def test_poisson_rate_and_uniform_dests():
    spec = tr.poisson(_gen(1), 8, 2000, mean_gap_ns=300.0)
    src, t, dest = _check_contract(spec, 8, 2000)
    gaps = np.diff(t.reshape(8, 2000), axis=1)
    # truncated exponential gaps: mean ~ 300 - 0.5
    assert gaps.mean() == pytest.approx(299.5, rel=0.05)
    counts = np.bincount(dest, minlength=8)
    assert counts.min() > 0.8 * counts.mean()


def test_hot_spot_concentrates():
    spec = tr.hot_spot(_gen(2), 8, 1000, hot_chip=3, hot_frac=0.65)
    src, _t, dest = _check_contract(spec, 8, 1000)
    share = (dest[src != 3] == 3).mean()
    # 0.65 forced + 0.35 of the uniform draws that land on chip 3
    assert share == pytest.approx(0.65 + 0.35 / 7, abs=0.03)


def test_bursty_trains_and_ping_pong_pairs():
    spec = tr.bursty(_gen(3), 4, 10, burst_len=8)
    _src, t, dest = _check_contract(spec, 4, 80)
    trains = t.reshape(4, 10, 8)
    assert (trains == trains[:, :, :1]).all()
    assert (dest.reshape(4, 10, 8) == dest.reshape(4, 10, 8)[:, :, :1]).all()
    pp = tr.ping_pong(5, 3)           # odd trailing chip stays silent
    assert pp.n_events == 12 and (pp.t == 0).all()
    np.testing.assert_array_equal(pp.dest.numpy(), np.repeat([1, 0, 3, 2], 3))


def test_same_seed_same_traffic():
    a = tr.hot_spot(_gen(9), 4, 32)
    b = tr.hot_spot(_gen(9), 4, 32)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f))
