"""The Mamba block of the port and its scan (B7's plain version), on
``device="cpu"``, against the reference on the same numpy inputs.

The reference's Pallas scan runs as its own tests run it (interpret
mode); its model path runs the chunked associative scan.  Tolerances:
the plain scan meets the reference's own (rtol/atol 1e-5 against the
oracle and the Pallas kernel, 1e-4 against the chunked path,
``tests/test_kernels_scan.py``).  The block in float32 compute is held
to 2e-5: its products are float32 sums in another order than XLA's and
its scan is the time-step loop, not the chunked scan (measured ~3e-6 on
these shapes).  The block's parameters come from the reference's
``mamba_init`` (``jax.random`` cannot be reproduced), loaded by name;
the port's own init is held to its distribution contract."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.selective_scan import selective_scan_pallas
from repro.models import mamba as jm
from repro.configs.base import get_smoke_config as ref_smoke_config
from repro_torch import interop
from repro_torch.configs.base import get_smoke_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import selective_scan as ssk
from repro_torch.models import mamba as tm

from _torch_cases import SCAN_TOL, scan_arrays, scan_specs

CPU = "cpu"
BLOCK_TOL = 2e-5
SPECS = scan_specs()
IDS = [s[0] for s in SPECS]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _plain(spec):
    args = map(_t, scan_arrays(spec))
    return [v.numpy() for v in tref.selective_scan(*args)]


def _close(want, got, tol):
    for w, g in zip(want, got, strict=True):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=tol,
                                   atol=tol)


# --- B7's plain version -------------------------------------------------

@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_plain_scan_matches_oracle(spec):
    _close(jref.selective_scan_ref(*scan_arrays(spec)), _plain(spec),
           SCAN_TOL)


@pytest.mark.parametrize("d_block", [8, 16])
@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_plain_scan_matches_pallas_interpret(spec, d_block):
    want = selective_scan_pallas(*scan_arrays(spec), d_block=d_block,
                                 interpret=True)
    _close(want, _plain(spec), SCAN_TOL)


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_plain_scan_matches_chunked_path(spec):
    _close(jm.selective_scan(*scan_arrays(spec), chunk=16), _plain(spec),
           1e-4)


@pytest.mark.parametrize("spec", [s for s in scan_specs(card=True)
                                  if s[0].startswith("edge-")],
                         ids=lambda s: s[0])
def test_scan_edge_specs_sit_on_tile_edges(spec):
    """Each edge case is one 32-step tile +- 1 long and one block's
    channels +- 1 wide (a block of 128 threads holds 64 channels at two
    threads a channel, 128 at N = 1), with N in {1, 17, 32}."""
    bsz, seq, d_in, n = spec[1]
    block = 128 if n == 1 else 64
    assert seq % 32 in (1, 31)
    assert d_in % block in (1, block - 1)
    assert n in (1, 17, 32)


def test_scan_routing_by_device():
    """CPU tensors take the plain version (the same tensors); the kernel
    wrapper refuses them; meta tensors (the dry-run's abstract device)
    take the shape-only route: the plain version's shapes and dtypes on
    meta, no kernel launched."""
    args = tuple(map(_t, scan_arrays(SPECS[0])))
    got, want = tops.selective_scan(*args), tref.selective_scan(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="CUDA kernel"):
        ssk.selective_scan(*args)
    before = ssk.selective_scan.launches
    meta = tops.selective_scan(*(a.to("meta") for a in args))
    assert ssk.selective_scan.launches == before
    for m, w in zip(meta, want):
        assert m.device.type == "meta"
        assert (m.shape, m.dtype) == (w.shape, w.dtype)


def test_state_carries_information_across_time():
    """An impulse at t=0 echoes in y_t for t>0 through the state, and
    decays (the reference test's impulse, on the plain scan)."""
    x = torch.zeros((1, 8, 4))
    x[0, 0] = 1.0
    y, _ = tref.selective_scan(x, torch.full((1, 8, 4), 0.5),
                               torch.ones((1, 8, 2)), torch.ones((1, 8, 2)),
                               -torch.ones((4, 2)) * 0.1)
    assert y[0, 3].abs().max() > 0
    assert y[0, 7].abs().max() < y[0, 1].abs().max()


# --- the block against the reference -------------------------------------

def _cfgs(compute=torch.float32):
    jcd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[compute]
    return (ref_smoke_config("falcon_mamba_7b").with_(compute_dtype=jcd),
            get_smoke_config("falcon_mamba_7b").with_(compute_dtype=compute))


def _block(rcfg, pcfg, seed=0):
    """The reference's ``mamba_init`` params and the port's block holding
    them."""
    params, _ = jm.mamba_init(jax.random.PRNGKey(seed), rcfg)
    p = tm.Mamba(pcfg, device=CPU)
    p.load_state_dict({k: _t(np.asarray(v)) for k, v in params.items()})
    return params, p


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_mamba_apply_matches_reference():
    rcfg, pcfg = _cfgs()
    params, p = _block(rcfg, pcfg)
    x = _x((2, 32, pcfg.d_model))
    want = jax.jit(lambda p_, x_: jm.mamba_apply(p_, rcfg, x_))(params, x)
    _close([want], [tm.mamba_apply(p, pcfg, _t(x))], BLOCK_TOL)


def test_mamba_prefill_matches_reference():
    rcfg, pcfg = _cfgs()
    params, p = _block(rcfg, pcfg, seed=2)
    x = _x((3, 20, pcfg.d_model), seed=3)
    out, cache = jax.jit(lambda p_, x_: jm.mamba_prefill(p_, rcfg, x_))(
        params, x)
    pout, pcache = tm.mamba_prefill(p, pcfg, _t(x))
    _close([out, cache["h"], cache["conv"]],
           [pout, pcache["h"], pcache["conv"]], BLOCK_TOL)


def test_mamba_decode_teacher_forced_matches_reference():
    """Every step both decodes start from the reference's cache."""
    rcfg, pcfg = _cfgs()
    params, p = _block(rcfg, pcfg, seed=4)
    x = _x((2, 24, pcfg.d_model), seed=5)
    _, cache = jax.jit(lambda p_, x_: jm.mamba_prefill(p_, rcfg, x_))(
        params, x[:, :16])
    dec = jax.jit(lambda p_, x_, c_: jm.mamba_decode(p_, rcfg, x_, c_))
    for t in range(16, 24):
        pc = interop.mamba_cache_from_reference(
            jax.tree.map(np.asarray, cache), device=CPU)
        pout, pnew = tm.mamba_decode(p, pcfg, _t(x[:, t:t + 1]), pc)
        out, cache = dec(params, x[:, t:t + 1], cache)
        _close([out, cache["h"], cache["conv"]],
               [pout, pnew["h"], pnew["conv"]], BLOCK_TOL)


def test_mamba_bf16_compute_matches_reference():
    """bf16 products: outputs within two bf16 ulps of their magnitude
    (a product can round to the other neighbour)."""
    rcfg, pcfg = _cfgs(torch.bfloat16)
    params, p = _block(rcfg, pcfg, seed=6)
    x = _x((2, 32, pcfg.d_model), seed=7)
    want = np.asarray(jax.jit(lambda p_, x_: jm.mamba_apply(p_, rcfg, x_))(
        params, x), np.float32)
    got = tm.mamba_apply(p, pcfg, _t(x)).float().numpy()
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -9)


def test_causal_conv_tap_order_on_impulse():
    """An impulse at t = 0 reads the taps backwards in time: out[t] =
    w[k-1-t] (+ b), as the reference's HIO cross-correlation."""
    k, d = 4, 3
    w = _x((k, d), seed=8)
    b = _x((d,), seed=9)
    x = np.zeros((1, 6, d), np.float32)
    x[0, 0] = 1.0
    got = tm._causal_depthwise_conv(_t(x), _t(w), _t(b)).numpy()
    want = np.asarray(jm._causal_depthwise_conv(x, w, b))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, :k], w[::-1] + b)
    np.testing.assert_array_equal(got[0, k:], np.broadcast_to(b, (6 - k, d)))


def test_decode_conv_equals_last_prefill_row():
    """Prefill of S tokens then one decode step: the decode's window sum
    equals the last row of the full prefill conv (checked through the
    block's output and state against the S+1-token prefill)."""
    _, pcfg = _cfgs()
    p = tm.Mamba(pcfg, device=CPU)
    tm.mamba_init(p, pcfg, torch.Generator().manual_seed(3))
    x = _t(_x((2, 9, pcfg.d_model), seed=10))
    _, c8 = tm.mamba_prefill(p, pcfg, x[:, :8])
    out, c9 = tm.mamba_decode(p, pcfg, x[:, 8:9], c8)
    full, want = tm.mamba_prefill(p, pcfg, x)
    _close([full[:, 8:9], want["h"], want["conv"]],
           [out, c9["h"], c9["conv"]], BLOCK_TOL)


def test_short_prompt_raises():
    _, pcfg = _cfgs()
    p = tm.Mamba(pcfg, device=CPU)
    tm.mamba_init(p, pcfg, torch.Generator().manual_seed(0))
    x = torch.zeros((1, pcfg.mamba.d_conv - 2, pcfg.d_model))
    with pytest.raises(ValueError, match="shorter than d_conv - 1"):
        tm.mamba_prefill(p, pcfg, x)
    # one token fewer than the cache depth is refused; the depth itself
    # is taken
    x = torch.zeros((1, pcfg.mamba.d_conv - 1, pcfg.d_model))
    _, cache = tm.mamba_prefill(p, pcfg, x)
    assert cache["conv"].shape == (1, pcfg.mamba.d_conv - 1,
                                   2 * pcfg.d_model)


def test_softplus_is_logaddexp():
    """Within two ulps of ``jax.nn.softplus`` and of ``F.softplus`` (whose
    identity above 20 agrees in float32), except that XLA on the CPU
    flushes subnormal results to zero."""
    v = np.concatenate([np.linspace(-120, 120, 4001, dtype=np.float32),
                        np.array([0.0, -0.0, 19.99, 20.0, 20.01, 88.7, 1e-8,
                                  -1e-8], np.float32)])
    got = tm.softplus(_t(v)).numpy()
    want = np.asarray(jax.nn.softplus(v))
    normal = np.abs(got) >= np.finfo(np.float32).tiny
    np.testing.assert_array_max_ulp(got[normal], want[normal], maxulp=2)
    assert (want[~normal] == 0).all()
    np.testing.assert_array_max_ulp(
        got, torch.nn.functional.softplus(_t(v)).numpy(), maxulp=2)


def test_init_distribution_contract():
    """``A_log`` = log(1..N) rounded once (the reference's jnp.log is one
    ulp high at n = 7), ``D_skip`` ones, ``conv_b`` zeros,
    softplus(dt_bias) in [1e-3, 1e-1] spread over the whole range, and
    each normal parameter at its reference scale (within 2 % of the std
    the reference draws)."""
    rcfg, _ = _cfgs()
    rcfg = rcfg.with_(d_model=256)
    pcfg = get_smoke_config("falcon_mamba_7b").with_(d_model=256)
    ref, _ = jm.mamba_init(jax.random.PRNGKey(0), rcfg)
    p = tm.Mamba(pcfg, device=CPU)
    tm.mamba_init(p, pcfg, torch.Generator().manual_seed(0))
    n = pcfg.mamba.d_state
    exact = np.log(np.arange(1, n + 1, dtype=np.float64)).astype(np.float32)
    np.testing.assert_array_equal(p.A_log.numpy(),
                                  np.broadcast_to(exact, p.A_log.shape))
    np.testing.assert_array_max_ulp(p.A_log.numpy(), np.asarray(ref["A_log"]),
                                    maxulp=1)
    assert torch.equal(p.D_skip, torch.ones_like(p.D_skip))
    assert torch.equal(p.conv_b, torch.zeros_like(p.conv_b))
    sp = tm.softplus(p.dt_bias).numpy()
    assert sp.min() >= 1e-3 * (1 - 1e-5) and sp.max() <= 1e-1 * (1 + 1e-5)
    assert sp.min() < 2e-3 and sp.max() > 5e-2
    for name in ("in_proj", "conv_w", "x_proj", "dt_proj", "out_proj"):
        got = float(getattr(p, name).std())
        want = float(np.asarray(ref[name]).std())
        assert abs(got / want - 1) < 0.02, (name, got, want)
        assert abs(float(getattr(p, name).mean())) < 0.1 * got, name
