"""The port's attention, RoPE, FFN and the whole LM of the dense and MoE
families on ``device="cpu"``, against the reference on the same numpy
inputs and the reference's own parameters (carried over by name).

Tolerances, as ``tests/test_torch_lm_serve.py`` states them: float32
compute to ``TOL`` = 2e-5 (float32 sums in another order than XLA's);
bfloat16 compute to 2^-7 relative plus 2^-6 absolute, where one product
can round to the other neighbour.  In bfloat16 the whole LM is held
against the reference compiled with ``--xla_allow_excess_precision=
false``, in a child process (XLA reads the flag once, at start): by
default XLA fuses elementwise chains and keeps some bf16 intermediates
in float32, so the compiled reference differs from its own op-by-op run
by rounding noise that grows with depth (measured 0.043 on logits up to
~4.1 over two smoke layers; the port and the default program are each
~0.05 from the float32 result).  The port rounds every op as the
reference's ops are written (``_ACTS["silu"]`` is jnp's
``x * (1 / (1 + exp(-x)))`` op for op) and matched that program bit for
bit on three of the six smoke configs' logits, within one or two ulps on
under 1.5 % of the others'.  RoPE's ``theta ** (-i / half)`` may
differ by an ulp between XLA's ``pow`` and torch's; the angle error
grows with the position, and at the positions here (<= 48) it stays far
inside ``TOL``.  Greedy tokens in float32 compute are equal, and every
cache (k, v and a ring's ``slot_pos``) matches the reference's."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.configs.base import get_smoke_config as ref_smoke_config
from repro.launch import serve as ref_serve
from repro.models import layers as RL
from repro.models.model import build_model as ref_build_model
from repro.models.model import param_count as ref_param_count
from repro_torch import interop
from repro_torch.configs import base as cb
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model import build_model, param_count

from _subproc import run_with_devices

CPU = "cpu"
TOL = 2e-5
BF16_RTOL, BF16_ATOL = 2 ** -7, 2 ** -6
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
ARCHS = ["granite_3_2b", "mixtral_8x22b", "qwen3_14b", "minitron_8b",
         "granite_34b", "moonshot_v1_16b_a3b"]


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else \
        np.asarray(t, np.float32)


def _close(want, got, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _close_dt(want, got, dtype):
    if dtype == torch.float32:
        _close(want, got)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_RTOL,
                                   atol=BF16_ATOL)


def _t(a, dtype=None):
    t = interop._tensor(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _j(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32)).astype(JDT[dtype])


def _load(module, tree):
    """A port module holding the reference's parameter dict by name."""
    module.load_state_dict({path: _t(leaf) for path, leaf in
                            interop._leaves(tree)}, strict=True)
    return module


def _tokens(shape, seed=1, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _cfgs(arch, compute, **changes):
    return (ref_smoke_config(arch).with_(compute_dtype=JDT[compute],
                                         **changes),
            cb.get_smoke_config(arch).with_(compute_dtype=compute,
                                            **changes))


# --- RoPE and the attention cores ------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_reference(dtype, theta):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 48, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(48), (2, 48)).astype(np.int32)
    want = RL.rope(_j(x, dtype), jnp.asarray(pos), theta)
    got = L.rope(_t(x, dtype), _t(pos), theta)
    assert got.dtype == dtype
    _close_dt(want, got, dtype)


# (Sq, Skv, causal, window, q_offset, q_chunk, kv_chunk)
FLASH_CASES = {
    "causal-ragged": (37, 37, True, 0, 0, 16, 8),
    "window-S>=W": (40, 40, True, 12, 0, 8, 8),
    "window-S<W": (12, 12, True, 16, 0, 8, 8),
    "window-ragged": (29, 29, True, 10, 0, 8, 16),
    "q_offset-window": (8, 40, True, 12, 32, 4, 8),
    "noncausal": (20, 20, False, 0, 0, 8, 8),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_matches_reference(case, dtype):
    sq, skv, causal, window, q_off, qc, kc = FLASH_CASES[case]
    rng = np.random.default_rng(len(case))
    q = rng.standard_normal((2, sq, 2, 3, 16)).astype(np.float32)
    k = rng.standard_normal((2, skv, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, skv, 2, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_off, q_chunk=qc,
              kv_chunk=kc)
    want = RL.flash_attention(_j(q, dtype), _j(k, dtype), _j(v, dtype), **kw)
    got = L.flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype), **kw)
    assert got.shape == want.shape and got.dtype == dtype
    _close_dt(want, got, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_matches_reference(dtype):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((3, 1, 2, 4, 16)).astype(np.float32)
    k = rng.standard_normal((3, 24, 2, 16)).astype(np.float32)
    v = rng.standard_normal((3, 24, 2, 16)).astype(np.float32)
    valid = rng.random((3, 24)) > 0.4
    valid[:, 0] = True
    want = RL.decode_attention(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                               jnp.asarray(valid))
    got = L.decode_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                             torch.from_numpy(valid))
    assert got.dtype == dtype
    _close_dt(want, got, dtype)


# --- the attention block: projections, qk-norm, RoPE, caches ---------------

def _attn_pair(arch, dtype, seed=0, **changes):
    rcfg, pcfg = _cfgs(arch, dtype, **changes)
    p, _ = RL.attn_init(jax.random.PRNGKey(seed), rcfg)
    return rcfg, pcfg, p, _load(L.Attention(pcfg, device=CPU), p)


@pytest.mark.parametrize("arch,dtype", [
    ("granite_3_2b", torch.float32), ("granite_3_2b", torch.bfloat16),
    ("qwen3_14b", torch.float32), ("granite_34b", torch.float32),
    ("mixtral_8x22b", torch.bfloat16)])
def test_attn_apply_matches_reference(arch, dtype):
    rcfg, pcfg, p, mod = _attn_pair(arch, dtype)
    x = np.random.default_rng(4).standard_normal((2, 40, 64)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(40), (2, 40)).astype(np.int32)
    want = RL.attn_apply(p, rcfg, _j(x, dtype), jnp.asarray(pos))
    got = L.attn_apply(mod, pcfg, _t(x, dtype), _t(pos))
    assert got.dtype == dtype
    _close_dt(want, got, dtype)


@pytest.mark.parametrize("layout", ["full", "ring", "ring-short"])
def test_attn_decode_matches_reference(layout):
    """Decode steps from the reference's own cache: the output, the new
    cache (k, v, slot_pos) and the input cache left untouched.  "ring"
    starts from a ring full of a prompt longer than the window,
    "ring-short" from one that is not full yet."""
    arch = "granite_3_2b" if layout == "full" else "mixtral_8x22b"
    rcfg, pcfg, p, mod = _attn_pair(arch, torch.float32, seed=1)
    B, start, steps = 2, 20 if layout == "ring" else 5, 14
    rng = np.random.default_rng(5)
    W = pcfg.sliding_window
    depth = 40 if layout == "full" else W
    cache = {"k": rng.standard_normal((B, depth, 2, 16)).astype(np.float32),
             "v": rng.standard_normal((B, depth, 2, 16)).astype(np.float32)}
    if layout != "full":
        sp = np.asarray(T._ring_positions(start, W, B)) if start >= W else \
            np.concatenate([np.broadcast_to(np.arange(start), (B, start)),
                            np.full((B, W - start), -1)], 1)
        cache["slot_pos"] = sp.astype(np.int32)
    rc = {k: jnp.asarray(v) for k, v in cache.items()}
    pc = interop.attn_cache_from_reference(cache, device=CPU)
    kept = {k: v.clone() for k, v in pc.items()}
    for t in range(start, start + steps):
        x = rng.standard_normal((B, 1, 64)).astype(np.float32)
        pos = np.full((B,), t, np.int32)
        pos[1] = max(t - 3, 0)   # rows at different positions
        want, rc = RL.attn_decode(p, rcfg, jnp.asarray(x), rc,
                                  jnp.asarray(pos))
        got, new = L.attn_decode(mod, pcfg, torch.from_numpy(x), pc,
                                 torch.from_numpy(pos))
        for k in pc:
            assert torch.equal(pc[k], kept[k]), f"input cache {k} changed"
        _close(want, got)
        assert set(new) == set(rc)
        _close(rc["k"], new["k"])
        _close(rc["v"], new["v"])
        if "slot_pos" in rc:
            assert new["slot_pos"].dtype == torch.int32
            np.testing.assert_array_equal(new["slot_pos"].numpy(),
                                          np.asarray(rc["slot_pos"]))
        pc = new
        kept = {k: v.clone() for k, v in pc.items()}


def test_ring_positions_match_reference():
    from repro.models.transformer import _ring_positions as ref_ring
    for S, W in ((16, 16), (17, 16), (40, 16), (6144, 4096), (8191, 4096)):
        np.testing.assert_array_equal(
            T._ring_positions(S, W, 2).numpy(), np.asarray(ref_ring(S, W, 2)))


# --- FFN --------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["silu", "relu2", "gelu"])
def test_ffn_matches_reference(act, dtype):
    rcfg, pcfg = _cfgs("granite_3_2b", dtype, act=act)
    p, _ = RL.ffn_init(jax.random.PRNGKey(2), rcfg)
    mod = _load(L.FFN(pcfg, device=CPU), p)
    assert hasattr(mod, "wg") == (act != "relu2")
    x = np.random.default_rng(6).standard_normal((2, 9, 64)).astype(
        np.float32)
    want = RL.ffn_apply(p, rcfg, _j(x, dtype))
    got = L.ffn_apply(mod, pcfg, _t(x, dtype))
    assert got.dtype == dtype
    _close_dt(want, got, dtype)


# --- the whole LM, each of the six smoke configs ---------------------------

def _lm(arch, compute=torch.float32, seed=0):
    rcfg, pcfg = _cfgs(arch, compute)
    rm = ref_build_model(rcfg)
    params = jax.tree.map(np.asarray, rm.init(jax.random.PRNGKey(seed))[0])
    return rm, params, interop.lm_params_from_reference(params, pcfg,
                                                        device=CPU)


def _equal_caches(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for k in w:
            if k == "slot_pos":
                assert torch.equal(w[k], g[k])
            else:
                assert w[k].dtype == g[k].dtype
                _close(w[k], g[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_matches_reference_f32(arch):
    """forward (logits and aux sums), prefill (logits and every layer's
    cache) and teacher-forced decode steps, each from the reference's
    cache, in float32 compute."""
    rm, params, pm = _lm(arch)
    assert param_count(pm) == ref_param_count(params)
    toks = _tokens((2, 40))
    want, waux = jax.jit(rm.forward)(params, {"tokens": jnp.asarray(toks)})
    got, gaux = pm.forward({"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32
    _close(want, got)
    assert set(gaux) == set(waux)
    for k in waux:
        assert abs(float(gaux[k]) - float(waux[k])) <= TOL * max(
            1.0, abs(float(waux[k]))), k
    if pm.cfg.family == "moe":
        assert float(waux["drop_frac"]) > 0   # the smoke capacity drops

    want, cache = jax.jit(lambda p, b: rm.prefill(p, b, max_len=40))(
        params, {"tokens": jnp.asarray(toks[:, :24])})
    got, pcache = pm.prefill({"tokens": torch.from_numpy(toks[:, :24])},
                             max_len=40)
    _close(want, got)
    ref_cache = interop.lm_cache_from_reference(
        jax.tree.map(np.asarray, cache), pm.cfg, device=CPU)
    _equal_caches(ref_cache, pcache)
    ring = pm.cfg.sliding_window and pm.cfg.sliding_window < 40
    assert ("slot_pos" in pcache[0]) == bool(ring)
    dec = jax.jit(rm.decode_step)
    for t in range(24, 32):
        start = interop.lm_cache_from_reference(
            jax.tree.map(np.asarray, cache), pm.cfg, device=CPU)
        tok = toks[:, t:t + 1]
        got, new = pm.decode_step(start, torch.from_numpy(tok),
                                  torch.full((2,), t, dtype=torch.int32))
        want, cache = dec(params, cache, jnp.asarray(tok),
                          jnp.full((2,), t, jnp.int32))
        _close(want, got)
    _equal_caches(interop.lm_cache_from_reference(
        jax.tree.map(np.asarray, cache), pm.cfg, device=CPU), new)


BF16_SEED = 3
#: the reference's bf16 forward, prefill and one decode step for every
#: smoke config, compiled with XLA's excess precision off
BF16_REF_CODE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import get_smoke_config
from repro.models.model import build_model
out = {}
toks = jnp.asarray(np.load(sys.argv[2]))
for arch in sys.argv[3:]:
    rm = build_model(get_smoke_config(arch).with_(compute_dtype=jnp.bfloat16))
    params, _ = rm.init(jax.random.PRNGKey(%d))
    prompt = {"tokens": toks[:, :20]}
    f, _ = jax.jit(rm.forward)(params, prompt)
    p, cache = jax.jit(lambda q, b: rm.prefill(q, b, max_len=24))(params,
                                                                  prompt)
    d, _ = jax.jit(rm.decode_step)(params, cache, toks[:, 20:],
                                   jnp.full((2,), 20, jnp.int32))
    for name, a in (("forward", f), ("prefill", p), ("decode", d)):
        out[arch + "/" + name] = np.asarray(a.astype(jnp.float32))
np.savez(sys.argv[1], **out)
""" % BF16_SEED


@pytest.fixture(scope="module")
def bf16_ref(tmp_path_factory, monkeypatch_module):
    """One child process computes every config's reference outputs; the
    flag must be set before XLA starts, so not in this process."""
    d = tmp_path_factory.mktemp("bf16_ref")
    np.save(d / "toks.npy", _tokens((2, 21), seed=4))
    monkeypatch_module.setenv("XLA_FLAGS", "--xla_allow_excess_precision="
                              "false " + os.environ.get("XLA_FLAGS", ""))
    run_with_devices(BF16_REF_CODE.replace(
        "sys.argv[1]", repr(str(d / "ref.npz"))).replace(
        "sys.argv[2]", repr(str(d / "toks.npy"))).replace(
        "sys.argv[3:]", repr(ARCHS)), n_devices=1, timeout=900)
    return dict(np.load(d / "ref.npz"))


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_matches_reference_bf16(arch, bf16_ref):
    """bf16 compute: forward, prefill of the same prompt and one decode
    step against the reference compiled without excess precision."""
    _, _, pm = _lm(arch, torch.bfloat16, seed=BF16_SEED)
    toks = torch.from_numpy(_tokens((2, 21), seed=4))
    got_f, _ = pm.forward({"tokens": toks[:, :20]})
    got_p, pcache = pm.prefill({"tokens": toks[:, :20]}, max_len=24)
    got_d, _ = pm.decode_step(pcache, toks[:, 20:],
                              torch.full((2,), 20, dtype=torch.int32))
    for name, got in (("forward", got_f), ("prefill", got_p),
                      ("decode", got_d)):
        assert got.dtype == torch.bfloat16
        _close_dt(bf16_ref[f"{arch}/{name}"], got, torch.bfloat16)


@pytest.mark.parametrize("arch", ["granite_3_2b", "mixtral_8x22b",
                                  "minitron_8b", "qwen3_14b",
                                  "moonshot_v1_16b_a3b"])
def test_serve_greedy_tokens_match_reference(arch, monkeypatch, capsys):
    """Both ``serve.main``s on the same parameters in float32 compute
    generate the same greedy tokens; mixtral's 20-token prompts and 12
    new tokens run past its smoke window of 16 (a ring cache); qwen3
    decodes through its qk-norm, moonshot through its capacity dispatch
    at the default capacity factor (choices past it dropped)."""
    argv = ["--arch", arch, "--smoke", "--batch", "3", "--prompt-len", "20",
            "--gen", "12", "--seed", "0"]
    monkeypatch.setattr(ref_serve, "get_smoke_config",
                        lambda a: ref_smoke_config(a).with_(
                            compute_dtype=jnp.float32))
    want = np.asarray(ref_serve.main(argv))
    rcfg, pcfg = _cfgs(arch, torch.float32)
    ref_params = ref_build_model(rcfg).init(jax.random.PRNGKey(0))[0]
    monkeypatch.setattr(serve, "get_smoke_config", lambda a: pcfg)
    monkeypatch.setattr(serve, "build_model",
                        lambda cfg, seed, device: interop.
                        lm_params_from_reference(ref_params, cfg,
                                                 device=device))
    got = serve.main(argv + ["--device", CPU])
    assert got.shape == (3, 12)
    np.testing.assert_array_equal(got.numpy(), want)
    name = pcfg.name
    out = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith(f"{name}: prefill(3x20)") for ln in out) == 2


def _no_drop(cfg):
    """A capacity of S slots an expert (factor E / k): nothing dropped."""
    if cfg.moe is None:
        return cfg
    m = cfg.moe
    return cfg.with_(moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))


@pytest.mark.parametrize("arch", ARCHS)
def test_own_prefill_decode_equal_own_forward(arch):
    """The reference's serving contract (2e-4, tests/test_archs.py:88-114)
    on the port's own seeded model, with a capacity that drops nothing
    (the capacity depends on the sequence length, so a forward and a
    prefill of other lengths drop other tokens by design)."""
    cfg = _no_drop(cb.get_smoke_config(arch).with_(
        compute_dtype=torch.float32))
    model = build_model(cfg, seed=5, device=CPU)
    toks = torch.from_numpy(_tokens((2, 36), seed=6))
    full, aux = model.forward({"tokens": toks})
    assert float(aux["drop_frac"]) == 0.0
    logits, cache = model.prefill({"tokens": toks[:, :18]}, max_len=36)
    _close(full[:, 17], logits[:, 0], 2e-4)
    for t in range(18, 36):
        logits, cache = model.decode_step(cache, toks[:, t:t + 1],
                                          torch.full((2,), t))
        _close(full[:, t], logits[:, 0], 2e-4)


def test_decode_from_init_cache_equals_forward():
    """``init_cache`` holds the reference's zeros and a ring's
    ``slot_pos`` of −1; decoding from it token by token, past the smoke
    window of 16, reproduces forward."""
    rm, params, pm = _lm("mixtral_8x22b")
    got = pm.init_cache(2, 24)
    _equal_caches(interop.lm_cache_from_reference(
        jax.tree.map(np.asarray, rm.init_cache(2, 24)), pm.cfg, device=CPU),
        got)
    assert int(got[0]["slot_pos"].max()) == -1
    pm.cfg = _no_drop(pm.cfg)
    toks = torch.from_numpy(_tokens((2, 20), seed=9))
    full, _ = pm.forward({"tokens": toks})
    cache = got
    for t in range(20):
        logits, cache = pm.decode_step(cache, toks[:, t:t + 1],
                                       torch.full((2,), t))
        _close(full[:, t], logits[:, 0], 2e-4)


def test_one_full_width_granite_layer_matches_reference():
    """granite-3-2b's published widths (d_model 2048, 32 heads / 8 kv
    heads, d_ff 8192), one layer and a 512-token head: forward over
    (1, 64), prefill of 48 tokens and one decode step, float32
    compute."""
    rcfg = ref_get_config("granite_3_2b").with_(n_layers=1, vocab=512,
                                                compute_dtype=jnp.float32)
    pcfg = cb.get_config("granite_3_2b").with_(n_layers=1, vocab=512,
                                               compute_dtype=torch.float32)
    rm = ref_build_model(rcfg)
    params = jax.tree.map(np.asarray, rm.init(jax.random.PRNGKey(0))[0])
    pm = interop.lm_params_from_reference(params, pcfg, device=CPU)
    assert param_count(pm) == ref_param_count(params) == 62_920_704
    blk = pm.stack.blocks[0]
    assert blk.attn.wk.w.shape == (2048, 512)
    assert blk.ffn.wg.w.shape == (2048, 8192)
    toks = _tokens((1, 64), seed=7)
    want, _ = jax.jit(rm.forward)(params, {"tokens": jnp.asarray(toks)})
    got, _ = pm.forward({"tokens": torch.from_numpy(toks)})
    _close(want, got)
    want, cache = jax.jit(lambda p, b: rm.prefill(p, b, max_len=64))(
        params, {"tokens": jnp.asarray(toks[:, :48])})
    got, pcache = pm.prefill({"tokens": torch.from_numpy(toks[:, :48])},
                             max_len=64)
    _close(want, got)
    _equal_caches(interop.lm_cache_from_reference(
        jax.tree.map(np.asarray, cache), pcfg, device=CPU), pcache)
    want, _ = jax.jit(rm.decode_step)(params, cache,
                                      jnp.asarray(toks[:, 48:49]),
                                      jnp.full((1,), 48, jnp.int32))
    got, _ = pm.decode_step(pcache, torch.from_numpy(toks[:, 48:49]),
                            torch.full((1,), 48, dtype=torch.int32))
    _close(want, got)


def test_one_full_width_qwen3_layer_matches_reference():
    """qwen3-14b's published attention widths (d_model 5120, 40 heads /
    8 kv heads of 128, qk-norm), one layer, its FFN cut to 512 and a
    512-token head: forward over (1, 40), prefill of 32 tokens, the
    cache, and one decode step through the qk-norm, float32 compute."""
    cut = dict(n_layers=1, d_ff=512, vocab=512)
    rcfg = ref_get_config("qwen3_14b").with_(compute_dtype=jnp.float32,
                                             **cut)
    pcfg = cb.get_config("qwen3_14b").with_(compute_dtype=torch.float32,
                                            **cut)
    assert pcfg.qk_norm and (pcfg.d_model, pcfg.n_heads, pcfg.n_kv_heads,
                             pcfg.d_head) == (5120, 40, 8, 128)
    rm = ref_build_model(rcfg)
    params = jax.tree.map(np.asarray, rm.init(jax.random.PRNGKey(0))[0])
    pm = interop.lm_params_from_reference(params, pcfg, device=CPU)
    assert param_count(pm) == ref_param_count(params) == 76_037_376
    blk = pm.stack.blocks[0]
    assert blk.attn.wq.w.shape == (5120, 5120)
    assert blk.attn.wk.w.shape == (5120, 1024)
    toks = _tokens((1, 40), seed=8)
    want, _ = jax.jit(rm.forward)(params, {"tokens": jnp.asarray(toks)})
    got, _ = pm.forward({"tokens": torch.from_numpy(toks)})
    _close(want, got)
    want, cache = jax.jit(lambda p, b: rm.prefill(p, b, max_len=40))(
        params, {"tokens": jnp.asarray(toks[:, :32])})
    got, pcache = pm.prefill({"tokens": torch.from_numpy(toks[:, :32])},
                             max_len=40)
    _close(want, got)
    _equal_caches(interop.lm_cache_from_reference(
        jax.tree.map(np.asarray, cache), pcfg, device=CPU), pcache)
    want, _ = jax.jit(rm.decode_step)(params, cache,
                                      jnp.asarray(toks[:, 32:33]),
                                      jnp.full((1,), 32, jnp.int32))
    got, _ = pm.decode_step(pcache, torch.from_numpy(toks[:, 32:33]),
                            torch.full((1,), 32, dtype=torch.int32))
    _close(want, got)


# --- every architecture --------------------------------------------------

@pytest.mark.parametrize("arch", cb.ARCH_IDS)
def test_every_arch_builds_and_runs_at_smoke_size(arch):
    """Each of the reference's ten architectures builds on the CPU from a
    seed and scores its smoke batch (tokens, audio frames or tokens with
    stub image embeddings) to finite logits over the padded vocabulary,
    padded ids never winning an argmax."""
    cfg = cb.get_smoke_config(arch)
    model = build_model(cfg, seed=0, device=CPU)
    rng = np.random.default_rng(1)
    if cfg.modality == "audio_frames":
        batch = {"frames": torch.from_numpy(rng.standard_normal(
            (2, 12, cfg.d_frontend)).astype(np.float32))}
    else:
        batch = {"tokens": torch.from_numpy(_tokens((2, 12), vocab=cfg.vocab))}
    if cfg.modality == "image+text":
        batch["img_embed"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_img_tokens, cfg.d_frontend)).astype(np.float32))
    logits = model.score(batch)
    assert logits.shape == (2, 12, RL.padded_vocab(cfg.vocab))
    assert bool(torch.isfinite(logits[..., :cfg.vocab].float()).all())
    assert int(logits.argmax(-1).max()) < cfg.vocab
