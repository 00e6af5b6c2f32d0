"""The port's hybrid blocks (``mamba_ffn``, ``mamba_moe``) and
jamba-v0.1-52b's whole LM on ``device="cpu"``, against the reference on
the same numpy inputs and the reference's own parameters (carried over
by ``interop``).

Tolerances, as ``tests/test_torch_lm_dense.py`` states them: float32
compute to ``TOL`` = 2e-5; bfloat16 to 2^-7 relative plus 2^-6
absolute, the whole LM's blocks held against the reference compiled
with ``--xla_allow_excess_precision=false`` in one child process, each
from the reference's own input to it (``test_jamba_blocks_match_
reference_bf16`` says why block by block).  The
smoke config has one period of jamba's eight blocks (3 ``mamba_ffn``, 4
``mamba_moe``, 1 ``attn_ffn``), so every block kind of the hybrid, the
Mamba caches (``h``, ``conv``) and the attention cache meet in one
model; its MoE capacity drops choices, on both sides alike."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as ref_smoke_config
from repro.launch import serve as ref_serve
from repro.models import transformer as RT
from repro.models.model import build_model as ref_build_model
from repro.models.model import param_count as ref_param_count
from repro_torch import interop
from repro_torch.configs import base as cb
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.models.model import build_model, param_count

from _subproc import run_with_devices

CPU = "cpu"
ARCH = "jamba_v01_52b"
TOL = 2e-5
SERVE_TOL = 2e-4
BF16_RTOL, BF16_ATOL = 2 ** -7, 2 ** -6
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


def _close(want, got, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _close_dt(want, got, dtype):
    if dtype == torch.float32:
        _close(want, got)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_RTOL,
                                   atol=BF16_ATOL)


def _tokens(shape, seed=1, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _cfgs(compute, **changes):
    return (ref_smoke_config(ARCH).with_(compute_dtype=JDT[compute],
                                         **changes),
            cb.get_smoke_config(ARCH).with_(compute_dtype=compute,
                                            **changes))


def _caches(cache, cfg):
    return interop.lm_cache_from_reference(jax.tree.map(np.asarray, cache),
                                           cfg, device=CPU)


def _equal_caches(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for k in w:
            assert w[k].dtype == g[k].dtype and w[k].shape == g[k].shape
            _close(w[k], g[k])


def test_pattern_and_kinds_match_reference():
    rcfg, pcfg = _cfgs(torch.float32)
    assert T.pattern_for(pcfg) == RT.pattern_for(rcfg)
    assert T.n_periods(pcfg) == RT.n_periods(rcfg) == 1
    full = cb.get_config(ARCH)
    kinds = T._kinds(full)
    assert len(kinds) == 32 and kinds[4::8] == ["attn_ffn"] * 4
    assert kinds.count("mamba_moe") == 16 and kinds.count("mamba_ffn") == 12


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["mamba_ffn", "mamba_moe"])
def test_hybrid_block_matches_reference(kind, dtype):
    """One block, its output and its MoE aux sums, from the reference's
    ``_block_init`` parameters (op by op on both sides)."""
    rcfg, pcfg = _cfgs(dtype)
    p, _ = RT._block_init(jax.random.PRNGKey(3), rcfg, kind)
    blk = T.Block(pcfg, kind, device=CPU)
    blk.load_state_dict({path: interop._tensor(np.asarray(leaf))
                         for path, leaf in interop._leaves(p)}, strict=True)
    assert hasattr(blk, "ffn") == (kind == "mamba_ffn")
    assert hasattr(blk, "moe") == (kind == "mamba_moe")
    x = np.random.default_rng(4).standard_normal((2, 16, 64)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(16), (2, 16)).astype(np.int32)
    want, waux = RT._block_apply(p, rcfg, kind,
                                 jnp.asarray(x).astype(JDT[dtype]),
                                 jnp.asarray(pos), None)
    got, gaux = T._block_apply(blk, pcfg, torch.from_numpy(x).to(dtype),
                               torch.from_numpy(pos), None)
    assert got.dtype == dtype
    _close_dt(want, got, dtype)
    assert (gaux is None) == (kind == "mamba_ffn")
    if gaux is not None:
        for k in gaux:
            assert abs(float(gaux[k]) - float(waux[k])) <= TOL * max(
                1.0, abs(float(waux[k]))), k


def _lm(compute=torch.float32, seed=0):
    rcfg, pcfg = _cfgs(compute)
    rm = ref_build_model(rcfg)
    params = jax.tree.map(np.asarray, rm.init(jax.random.PRNGKey(seed))[0])
    return rm, params, interop.lm_params_from_reference(params, pcfg,
                                                        device=CPU)


@pytest.fixture(scope="module")
def f32():
    return _lm()


def test_jamba_lm_matches_reference_f32(f32):
    """forward (logits and aux sums), prefill (logits and every layer's
    cache: Mamba ``h`` / ``conv`` and attention ``k`` / ``v``) and
    teacher-forced decode steps, each from the reference's cache, in
    float32 compute; the caches after the last step too."""
    rm, params, pm = f32
    assert param_count(pm) == ref_param_count(params)
    toks = _tokens((2, 32))
    want, waux = jax.jit(rm.forward)(params, {"tokens": jnp.asarray(toks)})
    got, gaux = pm.forward({"tokens": torch.from_numpy(toks)})
    _close(want, got)
    for k in waux:
        assert abs(float(gaux[k]) - float(waux[k])) <= TOL * max(
            1.0, abs(float(waux[k]))), k
    assert float(waux["drop_frac"]) > 0   # the smoke capacity drops

    want, cache = jax.jit(lambda p, b: rm.prefill(p, b, max_len=32))(
        params, {"tokens": jnp.asarray(toks[:, :24])})
    got, pcache = pm.prefill({"tokens": torch.from_numpy(toks[:, :24])},
                             max_len=32)
    _close(want, got)
    _equal_caches(_caches(cache, pm.cfg), pcache)
    assert [sorted(c) for c in pcache] == \
        [["k", "v"] if k == "attn_ffn" else ["conv", "h"]
         for k in T._kinds(pm.cfg)]
    dec = jax.jit(rm.decode_step)
    for t in range(24, 30):
        tok = toks[:, t:t + 1]
        got, new = pm.decode_step(_caches(cache, pm.cfg),
                                  torch.from_numpy(tok),
                                  torch.full((2,), t, dtype=torch.int32))
        want, cache = dec(params, cache, jnp.asarray(tok),
                          jnp.full((2,), t, jnp.int32))
        _close(want, got)
    _equal_caches(_caches(cache, pm.cfg), new)


BF16_SEED = 3
#: the reference's bf16 jamba, compiled with XLA's excess precision off:
#: each block's input and output along its own forward, and the logits
BF16_REF_CODE = """
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import get_smoke_config
from repro.models import transformer as T
from repro.models.model import build_model
cfg = get_smoke_config(%r).with_(compute_dtype=jnp.bfloat16)
rm = build_model(cfg)
params, _ = rm.init(jax.random.PRNGKey(%d))
toks = jnp.asarray(np.load(TOKS))
pos = jnp.broadcast_to(jnp.arange(toks.shape[1]), toks.shape)
out = {}
x = jax.jit(lambda p, t: rm._embed_inputs(p, {"tokens": t})[0])(params, toks)
for i, kind in enumerate(T.pattern_for(cfg)):
    p = jax.tree.map(lambda a: a[0], params["stack"]["pos%%d" %% i])
    out["in%%d" %% i] = x
    x = jax.jit(lambda p, x, kind=kind: T._block_apply(p, cfg, kind, x, pos,
                                                       None)[0])(p, x)
    out["out%%d" %% i] = x
out["head"] = jax.jit(rm._head)(params, x)
out["forward"] = jax.jit(rm.forward)(params, {"tokens": toks})[0]
np.savez(OUT, **{n: np.asarray(a.astype(jnp.float32)) for n, a in out.items()})
""" % (ARCH, BF16_SEED)


#: max |default program - program without excess precision| of the
#: reference's own bf16 forward logits (BF16_SEED, these tokens), measured
REF_BF16_SPREAD = 1.2045


def test_jamba_blocks_match_reference_bf16(tmp_path, monkeypatch):
    """bf16 compute, every block of the whole LM and its head, each fed
    the reference's own input to it, against the reference compiled
    without excess precision (a child process: XLA reads the flag once,
    at start).

    The whole bf16 forward is not held to the bf16 tolerance, by
    measurement: a one-ulp difference in a bf16 rounding (the scan sums
    in another order than the reference's chunked scan; a bf16 product
    can round to the other neighbour) moves the top-2 choice of tokens
    whose router probabilities are near ties, as they are at the smoke
    init, and a changed choice changes the token by a whole expert's
    output.  On these logits (BF16_SEED, 40 tokens) the reference's own
    default program differs from the one compiled with excess precision
    off by up to 1.2046, 12229 of 20480 logits past the tolerance; the
    port's whole forward differs from the latter by at most 0.754 (1712
    past it), and is asserted to stay below the reference's own spread
    (``REF_BF16_SPREAD``)."""
    toks = _tokens((2, 20), seed=4)
    np.save(tmp_path / "toks.npy", toks)
    monkeypatch.setenv("XLA_FLAGS", "--xla_allow_excess_precision=false "
                       + os.environ.get("XLA_FLAGS", ""))
    run_with_devices(BF16_REF_CODE.replace(
        "TOKS", repr(str(tmp_path / "toks.npy"))).replace(
        "OUT", repr(str(tmp_path / "ref.npz"))), n_devices=1, timeout=600)
    ref = dict(np.load(tmp_path / "ref.npz"))
    _, _, pm = _lm(torch.bfloat16, seed=BF16_SEED)
    cfg = pm.cfg
    h, pos, _ = pm._embed_inputs({"tokens": torch.from_numpy(toks)})
    np.testing.assert_array_equal(_np(h), ref["in0"])
    for i, blk in enumerate(pm.stack.blocks):
        x = torch.from_numpy(ref[f"in{i}"]).to(torch.bfloat16)
        got, _ = T._block_apply(blk, cfg, x, pos, None)
        assert got.dtype == torch.bfloat16
        _close_dt(ref[f"out{i}"], got, torch.bfloat16)
    last = torch.from_numpy(ref[f"out{len(pm.stack.blocks) - 1}"])
    _close_dt(ref["head"], pm._head(last.to(torch.bfloat16)), torch.bfloat16)
    got, _ = pm.forward({"tokens": torch.from_numpy(toks)})
    err = float((got.float() - torch.from_numpy(ref["forward"])).abs().max())
    assert err < REF_BF16_SPREAD, err


def test_serve_greedy_tokens_match_reference(f32, monkeypatch, capsys):
    """Both ``serve.main``s on the same parameters in float32 compute
    generate the same greedy tokens through jamba's Mamba, MoE and
    attention caches."""
    rm, params, _ = f32
    argv = ["--arch", ARCH, "--smoke", "--batch", "3", "--prompt-len", "20",
            "--gen", "10", "--seed", "0"]
    monkeypatch.setattr(ref_serve, "get_smoke_config",
                        lambda a: ref_smoke_config(a).with_(
                            compute_dtype=jnp.float32))
    want = np.asarray(ref_serve.main(argv))
    _, pcfg = _cfgs(torch.float32)
    monkeypatch.setattr(serve, "get_smoke_config", lambda a: pcfg)
    monkeypatch.setattr(serve, "build_model",
                        lambda cfg, seed, device: interop.
                        lm_params_from_reference(params, cfg,
                                                 device=device))
    got = serve.main(argv + ["--device", CPU])
    assert got.shape == (3, 10)
    np.testing.assert_array_equal(got.numpy(), want)
    out = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("jamba-v0.1-52b: prefill(3x20)")
               for ln in out) == 2


def test_own_prefill_decode_equal_own_forward():
    """The reference's serving contract (2e-4) on the port's own seeded
    jamba, with a capacity that drops nothing (factor E / k)."""
    import dataclasses
    cfg = cb.get_smoke_config(ARCH).with_(compute_dtype=torch.float32)
    cfg = cfg.with_(moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    model = build_model(cfg, seed=5, device=CPU)
    toks = torch.from_numpy(_tokens((2, 28), seed=6))
    full, aux = model.forward({"tokens": toks})
    assert float(aux["drop_frac"]) == 0.0
    logits, cache = model.prefill({"tokens": toks[:, :16]}, max_len=28)
    _close(full[:, 15], logits[:, 0], SERVE_TOL)
    for t in range(16, 28):
        logits, cache = model.decode_step(cache, toks[:, t:t + 1],
                                          torch.full((2,), t))
        _close(full[:, t], logits[:, 0], SERVE_TOL)
