"""The port's LM stack and serve path (falcon-mamba-7b's family) on
``device="cpu"``, against the reference on its own parameters.

``interop.lm_params_from_reference`` carries a JAX model across by name.
Tolerances: in float32 compute the logits, caches and decode steps agree
to 2e-5 (float32 sums in another order than XLA's; the port's scan is
the time-step loop, the reference's the chunked scan; measured ≤ 5.3e-6
on these shapes, one full-width layer included) and greedy tokens are
equal; in bfloat16 compute, where one product can round to the other
neighbour, logits agree within two bf16 ulps of their own magnitude
plus two ulps at the logits' typical magnitude of 1 (|d| <= 2^-6 +
2^-7·|logit|; measured: at most one ulp, on ~0.1 % of the logits).  The
port's own prefill + decode reproduce its forward to the reference's
serving contract (2e-4, ``tests/test_archs.py:88-114``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.configs.base import get_smoke_config as ref_smoke_config
from repro.data import SyntheticLM as RefSyntheticLM
from repro.launch import serve as ref_serve
from repro.models.model import build_model as ref_build_model
from repro.models.layers import cross_entropy as ref_cross_entropy
from repro.models.model import param_count as ref_param_count
from repro_torch import interop
from repro_torch.configs import base as cb
from repro_torch.data import SyntheticLM
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models.model import LM, build_model, param_count

CPU = "cpu"
TOL = 2e-5
SERVE_TOL = 2e-4
ARCH = "falcon_mamba_7b"
BF16_RTOL, BF16_ATOL = 2 ** -7, 2 ** -6
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _setup(compute=torch.float32, seed=0, **changes):
    rcfg = ref_smoke_config(ARCH).with_(compute_dtype=JDT[compute],
                                        **changes)
    pcfg = cb.get_smoke_config(ARCH).with_(compute_dtype=compute, **changes)
    rm = ref_build_model(rcfg)
    params, _ = rm.init(jax.random.PRNGKey(seed))
    return rm, params, interop.lm_params_from_reference(params, pcfg,
                                                        device=CPU)


@pytest.fixture(scope="module")
def f32():
    return _setup()


def _tokens(shape, seed=1, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _np(t):
    return np.asarray(t, np.float32) if not torch.is_tensor(t) else \
        t.float().numpy()


def _close(want, got, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_params_carry_over_by_name(f32):
    rm, params, pm = f32
    assert param_count(pm) == ref_param_count(params)
    np.testing.assert_array_equal(
        pm.stack.blocks[1].mamba.in_proj.numpy(),
        np.asarray(params["stack"]["pos0"]["mamba"]["in_proj"][1]))
    np.testing.assert_array_equal(pm.head.w.numpy(),
                                  np.asarray(params["head"]["w"]))
    bad = jax.tree.map(np.asarray, params)
    bad["head"]["w"] = bad["head"]["w"][:, :-1]
    with pytest.raises(ValueError, match="head.w"):
        interop.lm_params_from_reference(bad, pm.cfg, device=CPU)


def test_forward_matches_reference_f32(f32):
    rm, params, pm = f32
    toks = _tokens((2, 32))
    want, _ = jax.jit(rm.forward)(params, {"tokens": jnp.asarray(toks)})
    got, aux = pm.forward({"tokens": torch.from_numpy(toks)})
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(want, got)
    assert set(aux) == {"aux_loss", "z_loss", "drop_frac"}
    _close(want, pm.score({"tokens": torch.from_numpy(toks)}))


def test_prefill_and_decode_match_reference_f32(f32):
    """Prefill logits and caches, then teacher-forced decode steps, each
    from the reference's cache."""
    rm, params, pm = f32
    toks = _tokens((3, 24), seed=2)
    want, cache = jax.jit(lambda p, b: rm.prefill(p, b, max_len=24))(
        params, {"tokens": jnp.asarray(toks[:, :16])})
    got, pcache = pm.prefill({"tokens": torch.from_numpy(toks[:, :16])},
                             max_len=24)
    _close(want, got)
    ref_layers = interop.mamba_cache_from_reference(
        jax.tree.map(np.asarray, cache["pos0"]), device=CPU)
    assert len(ref_layers) == len(pcache) == pm.cfg.n_layers
    for r, p in zip(ref_layers, pcache):
        _close(r["h"], p["h"])
        _close(r["conv"], p["conv"])
    dec = jax.jit(rm.decode_step)
    for t in range(16, 24):
        start = interop.mamba_cache_from_reference(
            jax.tree.map(np.asarray, cache["pos0"]), device=CPU)
        tok = toks[:, t:t + 1]
        got, _ = pm.decode_step(start, torch.from_numpy(tok),
                                torch.full((3,), t))
        want, cache = dec(params, cache, jnp.asarray(tok),
                          jnp.full((3,), t, jnp.int32))
        _close(want, got)


def test_bf16_logits_match_reference(f32):
    rm, params, pm = _setup(torch.bfloat16, seed=3)
    toks = _tokens((2, 32), seed=4)
    want, _ = jax.jit(rm.forward)(params, {"tokens": jnp.asarray(toks)})
    got, _ = pm.forward({"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_RTOL,
                               atol=BF16_ATOL)
    want, cache = jax.jit(lambda p, b: rm.prefill(p, b, max_len=20))(
        params, {"tokens": jnp.asarray(toks[:, :16])})
    got, pcache = pm.prefill({"tokens": torch.from_numpy(toks[:, :16])})
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_RTOL,
                               atol=BF16_ATOL)
    want, _ = jax.jit(rm.decode_step)(params, cache,
                                      jnp.asarray(toks[:, 16:17]),
                                      jnp.full((2,), 16, jnp.int32))
    got, _ = pm.decode_step(pcache, torch.from_numpy(toks[:, 16:17]), None)
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_RTOL,
                               atol=BF16_ATOL)


def test_serve_greedy_tokens_match_reference(f32, monkeypatch, capsys):
    """Both ``serve.main``s on the same parameters in float32 compute
    generate the same greedy tokens and print the same summary shape."""
    rm, params, pm = f32
    argv = ["--arch", ARCH, "--smoke", "--batch", "3", "--prompt-len", "20",
            "--gen", "12", "--seed", "0"]
    monkeypatch.setattr(ref_serve, "get_smoke_config",
                        lambda a: ref_smoke_config(a).with_(
                            compute_dtype=jnp.float32))
    want = np.asarray(ref_serve.main(argv))
    pcfg = pm.cfg
    monkeypatch.setattr(serve, "get_smoke_config", lambda a: pcfg)
    ref_params = ref_build_model(rm.cfg).init(jax.random.PRNGKey(0))[0]
    monkeypatch.setattr(serve, "build_model",
                        lambda cfg, seed, device: interop.
                        lm_params_from_reference(ref_params, cfg,
                                                 device=device))
    got = serve.main(argv + ["--device", CPU])
    assert got.shape == (3, 12)
    np.testing.assert_array_equal(got.numpy(), want)
    out = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("falcon-mamba-7b: prefill(3x20)")
               for ln in out) == 2


def test_own_prefill_decode_equal_own_forward():
    """The reference's serving contract on the port's own seeded model:
    prefill(x[:, :t0]) then decode(x[:, t]) reproduce forward(x)."""
    cfg = cb.get_smoke_config(ARCH).with_(compute_dtype=torch.float32)
    model = build_model(cfg, seed=5, device=CPU)
    toks = torch.from_numpy(_tokens((2, 32), seed=6))
    full, _ = model.forward({"tokens": toks})
    logits, cache = model.prefill({"tokens": toks[:, :16]}, max_len=32)
    _close(full[:, 15], logits[:, 0], SERVE_TOL)
    for t in range(16, 32):
        logits, cache = model.decode_step(cache, toks[:, t:t + 1],
                                          torch.full((2,), t))
        _close(full[:, t], logits[:, 0], SERVE_TOL)


def test_decode_from_init_cache_equals_forward(f32):
    """``init_cache`` holds the zero state, the reference's layout split
    a layer: decoding from it token by token reproduces forward, whose
    causal conv pads with the same zeros."""
    rm, params, pm = f32
    want = jax.tree.map(np.asarray, rm.init_cache(2, 8)["pos0"])
    cache = pm.init_cache(2, 8)
    for got, w in zip(cache, interop.mamba_cache_from_reference(
            want, device=CPU), strict=True):
        assert torch.equal(got["h"], w["h"])
        assert torch.equal(got["conv"], w["conv"])
    toks = torch.from_numpy(_tokens((2, 6), seed=9))
    full, _ = pm.forward({"tokens": toks})
    for t in range(6):
        logits, cache = pm.decode_step(cache, toks[:, t:t + 1], None)
        _close(full[:, t], logits[:, 0], SERVE_TOL)


def test_serve_main_on_cpu_generates(capsys):
    gen = serve.main(["--arch", ARCH, "--smoke", "--batch", "2",
                      "--prompt-len", "8", "--gen", "5", "--device", CPU])
    assert gen.shape == (2, 5) and gen.dtype == torch.int64
    assert int(gen.max()) < cb.get_smoke_config(ARCH).vocab
    assert "falcon-mamba-7b: prefill(2x8)" in capsys.readouterr().out


@pytest.mark.parametrize("vocab,seq,batch,seed,step",
                         [(512, 32, 4, 0, 0), (65024, 2048, 4, 0, 0),
                          (1000, 17, 3, 7, 5), (16, 9, 2, 1, 2)])
def test_synthetic_lm_matches_reference(vocab, seq, batch, seed, step):
    want = RefSyntheticLM(vocab, seq, batch, seed=seed).batch(step)
    got = SyntheticLM(vocab, seq, batch, seed=seed).batch(step)
    assert set(got) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(8)
    logits = (3 * rng.standard_normal((2, 5, 16))).astype(np.float32)
    labels = rng.integers(0, 16, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.int32) if masked else None
    want = float(ref_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                   None if mask is None else
                                   jnp.asarray(mask)))
    got = float(L.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels),
                                None if mask is None else
                                torch.from_numpy(mask)))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


@pytest.mark.parametrize("arch", cb.PORTED_ARCHS)
def test_configs_match_reference(arch):
    for get_p, get_r in ((cb.get_config, ref_get_config),
                         (cb.get_smoke_config, ref_smoke_config)):
        p, r = get_p(arch), get_r(arch)
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_head", "d_ff", "vocab", "act", "qk_norm",
                  "rope_theta", "sliding_window", "causal", "tie_embeddings",
                  "norm_eps", "moe_every", "block_pattern", "modality",
                  "q_chunk", "kv_chunk", "dt_rank"):
            assert getattr(p, f) == getattr(r, f), f
        for sub in ("mamba", "moe"):
            assert (getattr(p, sub) is None) == (getattr(r, sub) is None)
            if getattr(p, sub) is not None:
                assert getattr(p, sub).__dict__ == getattr(r, sub).__dict__
        assert (p.param_dtype, p.compute_dtype) == (torch.float32,
                                                    torch.bfloat16)
    assert cb.get_config(ARCH).dt_rank == 256
    with pytest.raises(NotImplementedError, match="A.11"):
        cb.get_config("jamba_v01_52b")
    with pytest.raises(ValueError, match="unknown"):
        cb.get_config("no_such_model")
    with pytest.raises(NotImplementedError, match="A.11"):
        LM(cb.get_smoke_config(ARCH).with_(family="vision"), device=CPU)


def test_moe_config_defaults_match_reference():
    from repro.configs.base import MoeConfig as RefMoeConfig
    assert cb.MoeConfig().__dict__ == RefMoeConfig().__dict__


def test_one_full_width_layer_matches_reference():
    """falcon-mamba-7b's published widths (d_model 4096, d_inner 8192,
    dt_rank 256, N = 16), one layer and a 512-token head: prefill of
    (1, 16) and one decode step in float32 compute."""
    rcfg = ref_get_config(ARCH).with_(n_layers=1, vocab=512,
                                      compute_dtype=jnp.float32)
    pcfg = cb.get_config(ARCH).with_(n_layers=1, vocab=512,
                                     compute_dtype=torch.float32)
    rm = ref_build_model(rcfg)
    params = jax.tree.map(np.asarray, rm.init(jax.random.PRNGKey(0))[0])
    pm = interop.lm_params_from_reference(params, pcfg, device=CPU)
    assert param_count(pm) == 109_510_656
    blk = pm.stack.blocks[0].mamba
    assert blk.dt_proj.shape == (256, 8192) and blk.A_log.shape == (8192, 16)
    toks = _tokens((1, 17), seed=7)
    want, cache = jax.jit(lambda p, b: rm.prefill(p, b, max_len=17))(
        params, {"tokens": jnp.asarray(toks[:, :16])})
    got, pcache = pm.prefill({"tokens": torch.from_numpy(toks[:, :16])})
    _close(want, got)
    _close(cache["pos0"]["h"][0], pcache[0]["h"])
    _close(cache["pos0"]["conv"][0], pcache[0]["conv"])
    want, _ = jax.jit(rm.decode_step)(params, cache,
                                      jnp.asarray(toks[:, 16:]),
                                      jnp.full((1,), 16, jnp.int32))
    got, _ = pm.decode_step(pcache, torch.from_numpy(toks[:, 16:]), None)
    _close(want, got)
