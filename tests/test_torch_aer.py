"""The AER payload path of the port on ``device="cpu"``, against the
reference: the payload wire words, the FIFO, the plain event encoder and
decoder (B5's and B6's plain versions) against the reference's Pallas
kernels run in interpret mode, the per-block threshold, and the
compress path with error feedback.

Tolerances: integers (idx, count, wanted, words, FIFO state) are exact.
Encoder values are exact under ``==`` with NaN at the same places:
every value is an input entry, a 0 or a NaN.  Decoder values are exact
in the same way where an address receives one slot; where slots repeat
an address the two packages add in another order, so those entries
match to 1e-6 (the tolerance of ``tests/test_kernels.py``).  The
threshold is within one float32 ulp of ``jnp.quantile`` (it is the same
formula; XLA may round its last line differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import events as jev
from repro.core import fifo as jfifo
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.aer_decode import aer_decode_pallas
from repro.kernels.aer_encode import aer_encode_pallas
from repro_torch import interop
from repro_torch.core import events as tev
from repro_torch.core import fifo as tfifo
from repro_torch.kernels import aer_decode as adk
from repro_torch.kernels import aer_encode as aek
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from _torch_cases import (aer_cases, aer_encode_case, bf16_round,
                          clear_of_tau)

CPU = "cpu"
TOL = 1e-6
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(a) -> np.ndarray:
    """float32 / int numpy view of a jax array or a torch tensor."""
    if torch.is_tensor(a):
        return (a.float() if a.is_floating_point() else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _t(a, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def assert_same(want, got, approx=None):
    """Equal under ``==`` with NaN at the same places; where ``approx``
    (a bool mask) is set, within ``TOL`` instead."""
    w, g = _np(want), _np(got)
    assert w.shape == g.shape and w.dtype == g.dtype, (w.dtype, g.dtype)
    nan = np.isnan(w)
    np.testing.assert_array_equal(nan, np.isnan(g))
    exact = ~nan if approx is None else ~nan & ~approx
    np.testing.assert_array_equal(w[exact], g[exact])
    if approx is not None:
        np.testing.assert_allclose(g[approx & ~nan], w[approx & ~nan],
                                   rtol=TOL, atol=TOL)


# --- payload wire words ---------------------------------------------------

EDGE_BITS = np.array([
    0x00000000, 0x80000000,                          # +0, -0
    0x7F800000, 0xFF800000,                          # +inf, -inf
    0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFC00123,  # NaNs with payloads
    0x7FFFFFFF, 0xFF812345,
    0x00000001, 0x80000001, 0x007FFFFF, 0x00400000,  # subnormals
    0x3F808000, 0x3F818000, 0x3F808001, 0xBF808000,  # ties, even and odd
    0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8000,              # rounding to inf
    0x3F800000, 0x40490FDB], np.uint32)


def _edge_values(n_random=4096, seed=0):
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, 2**32, n_random, dtype=np.uint64).astype(
        np.uint32)
    return np.concatenate([EDGE_BITS, rand]).view(np.float32)


def test_pack_events_matches_reference_word_for_word():
    val = _edge_values()
    idx = np.arange(val.size, dtype=np.int64) * 37 - 5   # negative, > 2**16
    want = np.asarray(jev.pack_events(idx.astype(np.int32), val))
    got = tev.pack_events(_t(idx), _t(val))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # NaN becomes 0x7FC0 | sign whatever its payload (the reference's cast)
    nan = np.isnan(val)
    sign = val.view(np.uint32)[nan] >> 31
    np.testing.assert_array_equal(got.numpy()[nan] & 0xFFFF,
                                  0x7FC0 | (sign.astype(np.int64) << 15))


def test_unpack_events_matches_reference():
    rng = np.random.default_rng(1)
    words = np.concatenate([
        (np.arange(EDGE_BITS.size, dtype=np.uint32) << 16)
        | (EDGE_BITS >> 16),
        rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)])
    ji, jv = jev.unpack_events(words)
    for w in (_t(words.astype(np.int64)), words, words.view(np.int32)):
        ti, tv = tev.unpack_events(w)
        assert ti.dtype == torch.int32 and tv.dtype == torch.float32
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        # bit for bit, NaN payloads included
        np.testing.assert_array_equal(tv.numpy().view(np.uint32),
                                      np.asarray(jv).view(np.uint32))


def test_payload_roundtrip_and_bound():
    rng = np.random.default_rng(0)
    val = rng.standard_normal(1024).astype(np.float32)
    idx = np.arange(1024) % tev.EVENT_MAX_BLOCK
    i2, v2 = tev.unpack_events(tev.pack_events(_t(idx), _t(val)))
    np.testing.assert_array_equal(i2.numpy(), idx)
    rel = np.abs(v2.numpy() - val) / (np.abs(val) + 1e-30)
    assert rel.max() <= tev.roundtrip_error_bound()
    assert tev.roundtrip_error_bound() == jev.roundtrip_error_bound()
    exact = np.array([0.0, 1.0, -2.5, 0.15625], np.float32)
    np.testing.assert_array_equal(
        tev.unpack_events(tev.pack_events(_t(np.arange(4)),
                                          _t(exact)))[1].numpy(), exact)
    # the 16-bit index wraps, as the reference's
    assert int(tev.unpack_events(tev.pack_events(65537, 1.0))[0]) == 1
    # bfloat16 values pack as their own bits
    bf = _t(bf16_round(val)).to(torch.bfloat16)
    np.testing.assert_array_equal(
        tev.pack_events(_t(idx), bf).numpy() & 0xFFFF,
        bf.view(torch.int16).numpy().astype(np.int64) & 0xFFFF)


# --- the FIFO (the scenarios of tests/test_events_fifo.py) ---------------

def _fifo_state(f):
    return (np.asarray(f.buf).astype(np.int64).tolist(), int(f.head),
            int(f.count))


def _run_fifo(lib, cap, ops, mk):
    """Apply ``ops`` ("push", v) / ("pop",) / ("peek",) and record every
    state and flag."""
    f = lib.make_fifo(cap) if mk is None else mk(cap)
    log = []
    for op in ops:
        if op[0] == "push":
            f, ok = lib.fifo_push(f, op[1])
            log.append(("push", bool(ok)))
        elif op[0] == "pop":
            f, v, ok = lib.fifo_pop(f)
            log.append(("pop", bool(ok), int(v) if bool(ok) else None))
        else:
            v, ne = lib.fifo_peek(f)
            log.append(("peek", bool(ne), int(v) if bool(ne) else None))
        log.append((_fifo_state(f), bool(lib.fifo_empty(f)),
                    bool(lib.fifo_full(f))))
    return log


FIFO_SCENARIOS = {
    "push_pop_order": (4, [("push", 10), ("push", 20), ("push", 30),
                           ("pop",), ("pop",), ("pop",)]),
    "overflow_dropped": (2, [("push", 1), ("push", 2), ("push", 3),
                             ("pop",), ("pop",), ("pop",)]),
    "pop_empty": (2, [("pop",), ("peek",)]),
    "wraparound": (2, [op for v in (1, 2, 3, 4, 5)
                       for op in (("push", v), ("pop",))]),
    "peek_nondestructive": (3, [("push", 42), ("peek",), ("peek",)]),
    "wide_words": (3, [("push", 0xFFFFFFFF), ("push", 0x80000000),
                       ("pop",), ("push", 7), ("push", 8), ("push", 9),
                       ("pop",), ("pop",)]),
}


@pytest.mark.parametrize("name", sorted(FIFO_SCENARIOS))
def test_fifo_matches_reference(name):
    cap, ops = FIFO_SCENARIOS[name]
    want = _run_fifo(jfifo, cap, [(o[0], *(jnp.uint32(v) for v in o[1:]))
                                  for o in ops], None)
    got = _run_fifo(tfifo, cap, ops,
                    lambda c: tfifo.make_fifo(c, device=CPU))
    assert got == want


def test_fifo_is_pure_and_honours_enable():
    f = tfifo.make_fifo(2, device=CPU)
    f1, ok = tfifo.fifo_push(f, 5)
    assert bool(ok) and int(f.count) == 0 and int(f.buf[0]) == 0
    f2, ok = tfifo.fifo_push(f1, 6, enable=False)
    assert not bool(ok) and _fifo_state(f2) == _fifo_state(f1)
    f3, _, ok = tfifo.fifo_pop(f1, enable=torch.tensor(False))
    assert not bool(ok) and _fifo_state(f3) == _fifo_state(f1)


# --- B5's and B6's plain versions against the Pallas kernels -------------

CASES = aer_cases()


def _reference_encode(x, tau, budget, dtype):
    xj, tj = jnp.asarray(x, JDT[dtype]), jnp.asarray(tau, JDT[dtype])
    return aer_encode_pallas(xj, tj, budget, rows_per_block=x.shape[0],
                             interpret=True)


@pytest.mark.parametrize("case", [c for c in CASES if c[1] == "encode"],
                         ids=lambda c: c[0])
def test_plain_encode_matches_pallas(case):
    _, _, x, tau, budget, dtype = case
    want = _reference_encode(x, tau, budget, dtype)
    got = tref.aer_encode(_t(x, TDT[dtype]), _t(tau, TDT[dtype]), budget)
    names = ("idx", "val", "count", "wanted")
    for n, w, g in zip(names, want, got):
        assert g.dtype == (TDT[dtype] if n == "val" else torch.int32), n
        assert_same(w, g)
    # the interpret-mode kernel and the reference's oracle agree too
    for w, r in zip(want, jref.aer_encode(jnp.asarray(x, JDT[dtype]),
                                          jnp.asarray(tau, JDT[dtype]),
                                          budget)):
        assert_same(w, r)


@pytest.mark.parametrize("case", [c for c in CASES if c[1] == "decode"],
                         ids=lambda c: c[0])
def test_plain_decode_matches_pallas(case):
    _, _, idx, val, block, dtype = case
    want = aer_decode_pallas(jnp.asarray(idx), jnp.asarray(val, JDT[dtype]),
                             block, rows_per_block=idx.shape[0],
                             interpret=True)
    got = tref.aer_decode(_t(idx), _t(val, TDT[dtype]), block)
    assert got.dtype == TDT[dtype] and got.shape == (idx.shape[0], block)
    # addresses that receive two or more slots sum in another order
    hits = np.zeros((idx.shape[0], block + 1), np.int64)
    ok = (idx >= 0) & (idx < block)
    np.add.at(hits, (np.nonzero(ok)[0], idx[ok]), 1)
    assert (hits[:, :block] > 1).any()                # the case has some
    assert_same(want, got, approx=hits[:, :block] > 1)


def test_encode_spreads_nonfinite_like_reference():
    """Trap of the reference: a row with x[5] = 3 and x[9] = inf gives
    val = [nan, inf, nan, ...]; a NaN never selected poisons its row;
    idx, count and wanted are untouched."""
    x = np.zeros((3, 128), np.float32)
    x[:, 5], x[0, 9], x[1, 9], x[1, 20] = 3.0, np.inf, 2.0, np.nan
    x[2, 9] = 2.0
    tau = np.array([1.0, 1.0, 1.0], np.float32)
    want = jref.aer_encode(jnp.asarray(x), jnp.asarray(tau), 4)
    got = tref.aer_encode(_t(x), _t(tau), 4)
    for w, g in zip(want, got):
        assert_same(w, g)
    val = got[1].numpy()
    assert np.isnan(val[0, 0]) and val[0, 1] == np.inf
    assert np.isnan(val[0, 2:]).all() and np.isnan(val[1]).all()
    np.testing.assert_array_equal(val[2], [3.0, 2.0, 0.0, 0.0])
    np.testing.assert_array_equal(got[0].numpy()[1], [5, 9, -1, -1])
    assert got[2].tolist() == [2, 2, 2] and got[3].tolist() == [2, 2, 2]


def test_decode_accumulates_duplicates_in_slot_order():
    idx = np.array([[3, 3, -1, -1]], np.int32)
    val = np.array([[1.5, 2.0, 9.0, 9.0]], np.float32)
    dense = tref.aer_decode(_t(idx), _t(val), 8)
    assert float(dense[0, 3]) == 3.5 and float(dense.abs().sum()) == 3.5
    # float32 addition in slot order from +0, rounded once to bf16
    idx = np.array([[0, 0, 0, 1]], np.int32)
    val = np.array([[1.0, 2.0**-24, 2.0**-24, -0.0]], np.float32)
    d32 = tref.aer_decode(_t(idx), _t(val), 2)
    assert float(d32[0, 0]) == np.float32(1.0) + np.float32(2.0**-24) \
        + np.float32(2.0**-24)
    assert np.signbit(d32[0, 1].numpy()) == np.False_    # +0 + -0 = +0
    dbf = tref.aer_decode(_t(idx), _t(val).to(torch.bfloat16), 2)
    assert dbf.dtype == torch.bfloat16 and float(dbf[0, 0]) == 1.0


# --- threshold, compress path, error feedback ----------------------------

def _ulps(a, b):
    a = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("frac", [0.02, 0.05, 0.3, 0.0, 1.0, 0.9 * 48 / 384])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tau_within_one_ulp_of_reference(frac, dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 1024)).astype(np.float32)
    x[3, 17] = np.nan                         # a NaN row: tau NaN
    x[4, :3] = np.inf                         # infinities sort last
    x[5, 11] = -np.nan
    if dtype == "bfloat16":
        x = bf16_round(x)
    want = _np(jops.tau_from_fraction(jnp.asarray(x, JDT[dtype]), frac))
    got = tops.tau_from_fraction(_t(x, TDT[dtype]), frac)
    assert got.dtype == TDT[dtype] and got.shape == (64,)
    got = _np(got)
    nan = np.isnan(want)
    assert nan[3] and nan[5]
    np.testing.assert_array_equal(nan, np.isnan(got))
    if dtype == "float32":
        assert _ulps(want[~nan], got[~nan]).max() <= 1
    else:   # one float32 ulp before the cast: at most one bfloat16 ulp
        assert _ulps(bf16_round(want[~nan]), got[~nan]).max() <= 1 << 16


@pytest.mark.parametrize("nb,block,budget,frac", [
    (8, 1024, 128, 0.05), (16, 512, 64, 0.2), (12, 384, 48, 0.1)])
def test_aer_compress_matches_reference(nb, block, budget, frac):
    rng = np.random.default_rng(nb + block)
    x = rng.standard_normal((nb, block)).astype(np.float32)
    xt = _t(x)
    tau = tops.tau_from_fraction(xt, frac)
    assert clear_of_tau(xt, tau)
    jtau = jops.tau_from_fraction(jnp.asarray(x), frac)
    want = jops.aer_compress(jnp.asarray(x), jtau, budget, interpret=True)
    got = tops.aer_compress(xt, tau, budget)
    assert isinstance(got, tops.EventBlocks)
    for w, g in zip(want, got):
        assert_same(w, g)
    np.testing.assert_array_equal(got.wire_words.numpy(),
                                  np.asarray(want.wire_words)
                                  .astype(np.int64))
    assert int(got.wire_bytes()) == int(want.wire_bytes())
    dec = tops.aer_decompress(got, block)
    assert_same(jops.aer_decompress(want, block, interpret=True), dec)


@pytest.mark.parametrize("shape", [(4096,), (3, 700), (2048, 3)])
def test_compress_with_feedback_matches_reference(shape):
    rng = np.random.default_rng(11)
    x = rng.standard_normal(shape).astype(np.float32)
    jres = jnp.zeros(shape, jnp.float32)
    tres = torch.zeros(shape)
    for step in range(3):
        y = _t(x) + tres
        tiles, _ = tops.pad_to_blocks(y)
        assert clear_of_tau(tiles, tops.tau_from_fraction(tiles, 0.05)), \
            step
        jev_, jres, jn = jops.compress_with_feedback(jnp.asarray(x), jres,
                                                     interpret=True)
        tev_, tres, tn = tops.compress_with_feedback(_t(x), tres)
        assert tn == jn == int(np.prod(shape))
        for w, g in zip(jev_, tev_):
            assert_same(w, g)
        assert_same(jres, tres)
        # mass conservation, exactly: decoded + residual' == x + residual
        dec = tops.unpad_from_blocks(tops.aer_decompress(tev_), tn, shape)
        assert torch.equal(dec + tres, y)


def test_pad_and_unpad_match_reference():
    x = np.arange(2500, dtype=np.float32).reshape(50, 50)
    for block in (1024, 64, 2500, 4096):
        jt, jn = jops.pad_to_blocks(jnp.asarray(x), block)
        tt, tn = tops.pad_to_blocks(_t(x), block)
        assert tn == jn
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(
            tops.unpad_from_blocks(tt, tn, x.shape).numpy(), x)
    tt, tn = tops.pad_to_blocks(torch.zeros(0))
    assert tt.shape == (1, 1024) and tn == 0


def test_interop_carries_reference_state():
    x, tau = aer_encode_case(5, 8, 256, 32, "bfloat16")
    want = jops.aer_compress(jnp.asarray(x, jnp.bfloat16),
                             jnp.asarray(tau, jnp.bfloat16), 32,
                             interpret=True)
    evb = interop.event_blocks_from_reference(
        jax.tree.map(np.asarray, tuple(want)), device=CPU)
    assert evb.val.dtype == torch.bfloat16
    for w, g in zip(want, evb):
        assert_same(w, g)
    assert_same(jops.aer_decompress(want, 256, interpret=True),
                tops.aer_decompress(evb, 256))
    res = {"b": {"w": np.ones((3, 2), np.float32)}, "a": np.zeros(5)}
    st = interop.aer_states_from_reference(res, device=CPU)
    assert list(st) == ["a", "b"] and st["b"]["w"].residual.shape == (3, 2)
    assert st["a"].residual.dtype == torch.float64


def test_kernel_wrappers_refuse_cpu_and_bad_operands():
    """On the CPU ``ops`` runs the plain versions; the CUDA wrappers
    refuse a CPU tensor (they launch or raise, never fall back)."""
    x = torch.ones(2, 128)
    tau = torch.zeros(2)
    with pytest.raises(ValueError, match="CUDA kernel"):
        aek.aer_encode(x, tau, 8)
    with pytest.raises(ValueError, match="CUDA kernel"):
        adk.aer_decode(torch.zeros(2, 8, dtype=torch.int32), x[:, :8], 128)
    for a, b in zip(tops.aer_encode(x, tau, 8), tref.aer_encode(x, tau, 8)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="tau must be"):
        tops.aer_compress(x, torch.zeros(3))


def test_wire_accounting_and_tree_order_match_reference():
    from repro.core import halfduplex as jhd
    from repro.core import sparse_collectives as jsc
    from repro_torch.core import halfduplex as thd
    from repro_torch.core import sparse_collectives as tsc
    for n_params, n_dev in ((60_821_504, 8), (4096, 2), (1, 1)):
        for bidir in (False, True):
            assert tsc.dense_allreduce_bytes(n_params, n_dev,
                                             bidirectional=bidir) == \
                jsc.dense_allreduce_bytes(n_params, n_dev,
                                          bidirectional=bidir)
            assert thd.wire_bytes_per_direction(4 * n_params, n_dev,
                                                bidir) == \
                jhd.wire_bytes_per_direction(4 * n_params, n_dev, bidir)
        for frac, budget in ((0.02, 128), (0.5, 64)):
            assert tsc.aer_allreduce_bytes(n_params, n_dev, frac, budget) \
                == jsc.aer_allreduce_bytes(n_params, n_dev, frac, budget)
    # leaves in jax.tree's order (sorted keys), whatever the insertion
    tree = {"z": 1, "a": {"y": 2, "b": 3}, "m": {"k": {"q": 4}}}
    assert tsc.tree_leaves(tree) == jax.tree.leaves(tree)
    assert tsc.tree_map(lambda a, b: a + b, tree, tree) == \
        jax.tree.map(lambda a, b: a + b, tree, tree)
