"""The port's cross-attention (``attn_apply(kv_src=)``, the static
``attn_decode``, ``precompute_cross_cache``) and llama-3.2-vision's whole
LM on ``device="cpu"``, against the reference on the same numpy inputs
and the reference's own parameters (carried over by ``interop``).

The reference initialises every cross-attention gate ``xgate`` to 0, so
``tanh(xgate)`` multiplies the cross-attention away: a test at that
init would pass with the image path miswired or missing.  Every test of
the whole LM here sets the gates to a nonzero value on both sides
(``GATE``) and checks that the image then moves the logits; one test
pins that at the init value it does not.

Tolerances, as ``tests/test_torch_lm_dense.py`` states them: float32
compute to ``TOL`` = 2e-5; bfloat16 to 2^-7 relative plus 2^-6
absolute, the whole LM's blocks held against the reference compiled
with ``--xla_allow_excess_precision=false`` in one child process, each
from the reference's own input to it (``test_vision_lm_matches_
reference_bf16`` says why block by block).  The
cross-attention tests take 20 image keys against a kv chunk of 8 (a
padded last tile) and against the default chunk, which is the key
length, not the query length."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as ref_smoke_config
from repro.launch import serve as ref_serve
from repro.models import layers as RL
from repro.models import transformer as RT
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
ARCH = "llama32_vision_11b"
TOL = 2e-5
SERVE_TOL = 2e-4
BF16_RTOL, BF16_ATOL = 2 ** -7, 2 ** -6
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
#: the cross-attention gates' value in every whole-LM test (tanh ~0.6)
GATE = 0.7


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


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32)).astype(JDT[dtype])


def _tokens(shape, seed=1, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _cfgs(compute, **changes):
    return (ref_smoke_config(ARCH).with_(compute_dtype=JDT[compute],
                                         **changes),
            cb.get_smoke_config(ARCH).with_(compute_dtype=compute,
                                            **changes))


def _attn_pair(dtype, seed=0, **changes):
    rcfg, pcfg = _cfgs(dtype, **changes)
    p, _ = RL.attn_init(jax.random.PRNGKey(seed), rcfg, cross=True)
    mod = L.Attention(pcfg, device=CPU)
    mod.load_state_dict({path: interop._tensor(np.asarray(leaf))
                         for path, leaf in interop._leaves(p)}, strict=True)
    return rcfg, pcfg, p, mod


# --- cross-attention ------------------------------------------------------

@pytest.mark.parametrize("dtype,kv_chunk", [
    (torch.float32, 0), (torch.float32, 8), (torch.bfloat16, 0),
    (torch.bfloat16, 8)])
def test_cross_attn_apply_matches_reference(dtype, kv_chunk):
    """12 text queries over 20 image keys, no RoPE, never causal; the kv
    chunk is the key length (0: auto) or 8, which leaves a padded last
    tile of 4 keys."""
    rcfg, pcfg, p, mod = _attn_pair(dtype, kv_chunk=kv_chunk)
    x, img = _normal((2, 12, 64), 4), _normal((2, 20, 64), 5)
    pos = np.broadcast_to(np.arange(12), (2, 12)).astype(np.int32)
    want = RL.attn_apply(p, rcfg, _j(x, dtype), jnp.asarray(pos),
                         kv_src=_j(img, dtype), causal=False)
    got = L.attn_apply(mod, pcfg, _t(x, dtype), torch.from_numpy(pos),
                       kv_src=_t(img, dtype), causal=False)
    assert got.dtype == dtype
    _close_dt(want, got, dtype)
    # the positions do not reach cross-attention: no RoPE on q or k
    again = L.attn_apply(mod, pcfg, _t(x, dtype), torch.from_numpy(pos) + 7,
                         kv_src=_t(img, dtype))
    assert torch.equal(again, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_static_cross_attn_decode_matches_reference(dtype):
    """One-token decode over a precomputed image cache: the output, and
    the cache handed back as it was (never written)."""
    rcfg, pcfg, p, mod = _attn_pair(dtype, seed=1)
    cache = {"k": _normal((3, 20, 2, 16), 6), "v": _normal((3, 20, 2, 16), 7)}
    x = _normal((3, 1, 64), 8)
    pos = np.array([5, 9, 30], np.int32)
    want, rc = RL.attn_decode(p, rcfg, _j(x, dtype),
                              {k: _j(v, dtype) for k, v in cache.items()},
                              jnp.asarray(pos), kv_src="static")
    pc = {k: _t(v, dtype) for k, v in cache.items()}
    kept = {k: v.clone() for k, v in pc.items()}
    got, new = L.attn_decode(mod, pcfg, _t(x, dtype), pc,
                             torch.from_numpy(pos), kv_src="static")
    assert got.dtype == dtype
    _close_dt(want, got, dtype)
    assert new is pc and all(torch.equal(pc[k], kept[k]) for k in pc)
    _close_dt(rc["k"], new["k"], dtype)


# --- the whole LM, gates nonzero -----------------------------------------

def _gated_params(params, gate=GATE):
    """The reference's parameter tree with every ``xgate`` set to
    ``gate`` (a copy; the reference's init sets them to 0)."""
    out = jax.tree.map(np.array, params)
    for blk in out["stack"].values():
        if "xgate" in blk:
            blk["xgate"] = np.full_like(blk["xgate"], gate)
    return out


def _lm(compute=torch.float32, seed=0, gate=GATE, **changes):
    rcfg, pcfg = _cfgs(compute, **changes)
    rm = ref_build_model(rcfg)
    params = _gated_params(rm.init(jax.random.PRNGKey(seed))[0], gate)
    return rm, params, interop.lm_params_from_reference(params, pcfg,
                                                        device=CPU)


@pytest.fixture(scope="module")
def f32():
    return _lm()


def _batch(b, s, cfg, seed=1):
    return {"tokens": _tokens((b, s), seed),
            "img_embed": _normal((b, cfg.n_img_tokens, cfg.d_frontend),
                                 seed + 10)}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


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


def test_pattern_and_params_match_reference(f32):
    rm, params, pm = f32
    assert T.pattern_for(pm.cfg) == RT.pattern_for(rm.cfg) == \
        ("attn_ffn",) * 3 + ("xattn_ffn", "attn_ffn")
    assert T._kinds(cb.get_config(ARCH)).count("xattn_ffn") == 8
    assert param_count(pm) == ref_param_count(params)
    assert pm.frontend.w.shape == (32, 64)
    assert float(pm.stack.blocks[3].xgate) == np.float32(GATE)
    assert not hasattr(pm.stack.blocks[2], "xgate")


def test_vision_lm_matches_reference_f32(f32):
    """forward, prefill (logits and every cache: the image K/V of the
    cross-attention layer, the others' K/V) and teacher-forced decode
    steps from the reference's cache, float32 compute, gates at GATE;
    the cross cache is the same after every step."""
    rm, params, pm = f32
    batch = _batch(2, 24, pm.cfg)
    want, _ = jax.jit(rm.forward)(params, _jb(batch))
    got, _ = pm.forward(_tb(batch))
    _close(want, got)
    other = dict(batch, img_embed=_normal(batch["img_embed"].shape, 99))
    moved = (pm.forward(_tb(other))[0] - got).abs().max()
    assert float(moved) > 1e-2, "the image does not reach the logits"

    prompt = dict(batch, tokens=batch["tokens"][:, :16])
    want, cache = jax.jit(lambda p, b: rm.prefill(p, b, max_len=24))(
        params, _jb(prompt))
    got, pcache = pm.prefill(_tb(prompt), max_len=24)
    _close(want, got)
    _equal_caches(_caches(cache, pm.cfg), pcache)
    assert pcache[3]["k"].shape == (2, 8, 2, 16)
    dec = jax.jit(rm.decode_step)
    for t in range(16, 22):
        tok = batch["tokens"][:, t:t + 1]
        start = _caches(cache, pm.cfg)
        got, new = pm.decode_step(start, torch.from_numpy(tok),
                                  torch.full((2,), t, dtype=torch.int32))
        want, cache = dec(params, cache, jnp.asarray(tok),
                          jnp.full((2,), t, jnp.int32))
        _close(want, got)
        assert new[3] is start[3]
    _equal_caches(_caches(cache, pm.cfg), new)


def test_gates_at_init_shut_the_image_out():
    """At the reference's init (every ``xgate`` 0) the image changes no
    logit, on either side: why the other tests set the gates."""
    rm, params, pm = _lm(gate=0.0)
    assert all(float(b.xgate) == 0.0 for b in pm.stack.blocks
               if hasattr(b, "xgate"))
    batch = _batch(1, 8, pm.cfg)
    other = dict(batch, img_embed=_normal(batch["img_embed"].shape, 99))
    assert torch.equal(pm.forward(_tb(batch))[0], pm.forward(_tb(other))[0])
    fresh = build_model(pm.cfg, seed=0, device=CPU)
    assert float(fresh.stack.blocks[3].xgate) == 0.0


def test_precompute_cross_cache_matches_reference(f32):
    rm, params, pm = f32
    img = _normal((2, 8, 64), 12)
    cache = rm.init_cache(2, 16)
    want = RT.precompute_cross_cache(params["stack"], rm.cfg, cache,
                                     jnp.asarray(img))
    start = pm.init_cache(2, 16)
    got = T.precompute_cross_cache(pm.stack, pm.cfg, start,
                                   torch.from_numpy(img))
    _equal_caches(_caches(want, pm.cfg), got)
    assert all(got[i] is start[i] for i in (0, 1, 2, 4))
    assert float(got[3]["k"].abs().max()) > 0


def test_cross_cache_has_no_kn_as_in_the_reference():
    """With qk-norm on, the reference normalises the cross keys in
    ``attn_apply`` but fills the decode cache with ``img @ wk`` without
    ``kn`` (ROADMAP queue C); the port does the same: the prefill cache
    and a decode step from it equal the reference's, and the cached keys
    are not the normalised ones."""
    rm, params, pm = _lm(seed=2, qk_norm=True)
    batch = _batch(2, 12, pm.cfg, seed=3)
    want, cache = jax.jit(lambda p, b: rm.prefill(p, b, max_len=14))(
        params, _jb(batch))
    got, pcache = pm.prefill(_tb(batch), max_len=14)
    _close(want, got)
    _equal_caches(_caches(cache, pm.cfg), pcache)
    blk = pm.stack.blocks[3].attn
    img = L.linear(pm.frontend.w, torch.from_numpy(batch["img_embed"]),
                   torch.float32)
    raw = L.linear(blk.wk.w, img, torch.float32).reshape(2, 8, 2, 16)
    _close(raw, pcache[3]["k"])
    normed = L.rmsnorm(blk.kn, raw, pm.cfg.norm_eps)
    assert float((normed - pcache[3]["k"]).abs().max()) > 1e-2
    tok = np.full((2, 1), 7, np.int32)
    want, _ = jax.jit(rm.decode_step)(params, cache, jnp.asarray(tok),
                                      jnp.full((2,), 12, jnp.int32))
    got, _ = pm.decode_step(pcache, torch.from_numpy(tok),
                            torch.full((2,), 12, dtype=torch.int32))
    _close(want, got)


BF16_SEED = 3
#: the reference's bf16 model, gates at GATE, compiled with XLA's excess
#: precision off: each block's input and output along its own forward,
#: the head, the whole forward, prefill (logits and the cross cache) and
#: one decode step
BF16_REF_CODE = """
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import get_smoke_config
from repro.models import transformer as T
from repro.models.model import build_model
cfg = get_smoke_config(%r).with_(compute_dtype=jnp.bfloat16)
rm = build_model(cfg)
params, _ = rm.init(jax.random.PRNGKey(%d))
for blk in params["stack"].values():
    if "xgate" in blk:
        blk["xgate"] = jnp.full_like(blk["xgate"], %r)
data = np.load(BATCH)
toks, img = jnp.asarray(data["tokens"]), jnp.asarray(data["img_embed"])
prompt = {"tokens": toks[:, :20], "img_embed": img}
pos = jnp.broadcast_to(jnp.arange(20), (2, 20))
out = {}
x, im = jax.jit(rm._embed_inputs)(params, prompt)
for i, kind in enumerate(T.pattern_for(cfg)):
    p = jax.tree.map(lambda a: a[0], params["stack"]["pos%%d" %% i])
    out["in%%d" %% i] = x
    x = jax.jit(lambda p, x, im, kind=kind: T._block_apply(
        p, cfg, kind, x, pos, im)[0])(p, x, im)
    out["out%%d" %% i] = x
out["img"] = im
out["head"] = jax.jit(rm._head)(params, x)
out["forward"], _ = jax.jit(rm.forward)(params, prompt)
out["prefill"], cache = jax.jit(lambda q, b: rm.prefill(q, b, max_len=24))(
    params, prompt)
out["cross_k"] = cache["pos3"]["k"][0]
out["decode"], _ = jax.jit(rm.decode_step)(params, cache, toks[:, 20:],
                                           jnp.full((2,), 20, jnp.int32))
np.savez(OUT, **{n: np.asarray(a.astype(jnp.float32)) for n, a in out.items()})
""" % (ARCH, BF16_SEED, GATE)
#: max |default program - program without excess precision| of the
#: reference's own bf16 logits (BF16_SEED, gates at GATE, this batch),
#: measured: the spread of the reference between two of its compiles
REF_BF16_SPREAD = {"forward": 0.0803, "prefill": 0.0547, "decode": 0.0469}


def test_vision_lm_matches_reference_bf16(tmp_path, monkeypatch):
    """bf16 compute, gates at GATE, against the reference compiled
    without excess precision (a child process: XLA reads the flag once,
    at start): every block fed the reference's own input to it, the
    head, and the cross-attention layer's prefill cache, each to the
    bf16 tolerance; the whole forward, prefill and one decode step
    within the reference's own spread between its default program and
    that one (``REF_BF16_SPREAD``).  Whole, the port is within the bf16
    tolerance on all but 5 of 20480 forward logits (max 0.0234), the
    reference's default program on all but 1962 (max 0.0803): one-ulp
    roundings (the attention's float32 sums in another order, a bf16
    product rounding to the other neighbour) grow over five layers and
    the head."""
    _, pcfg = _cfgs(torch.bfloat16)
    batch = _batch(2, 21, pcfg, seed=4)
    np.savez(tmp_path / "batch.npz", **batch)
    monkeypatch.setenv("XLA_FLAGS", "--xla_allow_excess_precision=false "
                       + os.environ.get("XLA_FLAGS", ""))
    run_with_devices(BF16_REF_CODE.replace(
        "BATCH", repr(str(tmp_path / "batch.npz"))).replace(
        "OUT", repr(str(tmp_path / "ref.npz"))), n_devices=1, timeout=600)
    ref = dict(np.load(tmp_path / "ref.npz"))
    _, _, pm = _lm(torch.bfloat16, seed=BF16_SEED)
    bf = torch.bfloat16
    tb = _tb(batch)
    prompt = dict(tb, tokens=tb["tokens"][:, :20])
    h, pos, img = pm._embed_inputs(prompt)
    np.testing.assert_array_equal(_np(h), ref["in0"])
    np.testing.assert_array_equal(_np(img), ref["img"])
    for i, blk in enumerate(pm.stack.blocks):
        got, _ = T._block_apply(blk, pm.cfg, _t(ref[f"in{i}"], bf), pos,
                                _t(ref["img"], bf))
        _close_dt(ref[f"out{i}"], got, bf)
    _close_dt(ref["head"], pm._head(_t(ref["out4"], bf)), bf)
    got_f, _ = pm.forward(prompt)
    got_p, pcache = pm.prefill(prompt, max_len=24)
    _close_dt(ref["cross_k"], pcache[3]["k"], bf)
    got_d, _ = pm.decode_step(pcache, tb["tokens"][:, 20:],
                              torch.full((2,), 20, dtype=torch.int32))
    for name, got in (("forward", got_f), ("prefill", got_p),
                      ("decode", got_d)):
        assert got.dtype == bf
        err = float(np.abs(_np(got) - ref[name]).max())
        assert err < REF_BF16_SPREAD[name], (name, err)


def test_serve_greedy_tokens_match_reference(f32, monkeypatch, capsys):
    """Both ``serve.main``s, gates at GATE on both sides, float32
    compute: the same greedy tokens from prompts with their image."""
    _, params, _ = f32
    argv = ["--arch", ARCH, "--smoke", "--batch", "3", "--prompt-len", "16",
            "--gen", "10", "--seed", "0"]
    monkeypatch.setattr(ref_serve, "get_smoke_config",
                        lambda a: ref_smoke_config(a).with_(
                            compute_dtype=jnp.float32))

    class Gated:
        """The reference's model with its init's gates set to GATE."""
        def __init__(self, cfg):
            self.model = ref_build_model(cfg)

        def init(self, key):
            p, a = self.model.init(key)
            return _gated_params(p), a

        def __getattr__(self, name):
            return getattr(self.model, name)

    monkeypatch.setattr(ref_serve, "build_model", Gated)
    want = np.asarray(ref_serve.main(argv))
    rcfg, pcfg = _cfgs(torch.float32)
    gated = _gated_params(ref_build_model(rcfg).init(
        jax.random.PRNGKey(0))[0])
    monkeypatch.setattr(serve, "get_smoke_config", lambda a: pcfg)
    monkeypatch.setattr(serve, "build_model",
                        lambda cfg, seed, device: interop.
                        lm_params_from_reference(gated, cfg, device=device))
    got = serve.main(argv + ["--device", CPU])
    assert got.shape == (3, 10)
    np.testing.assert_array_equal(got.numpy(), want)
    out = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("llama32-vision-11b: prefill(3x16)")
               for ln in out) == 2


def test_own_prefill_decode_equal_own_forward():
    """The reference's serving contract (2e-4) on the port's own seeded
    model with its gates set to GATE: prefill over the prompt and its
    image, then decode steps through the static cross cache."""
    cfg = cb.get_smoke_config(ARCH).with_(compute_dtype=torch.float32)
    model = build_model(cfg, seed=5, device=CPU)
    with torch.no_grad():
        model.stack.blocks[3].xgate.fill_(GATE)
    batch = _tb(_batch(2, 24, cfg, seed=6))
    full, _ = model.forward(batch)
    logits, cache = model.prefill(dict(batch, tokens=batch["tokens"][:, :12]),
                                  max_len=24)
    _close(full[:, 11], logits[:, 0], SERVE_TOL)
    for t in range(12, 24):
        logits, cache = model.decode_step(cache, batch["tokens"][:, t:t + 1],
                                          torch.full((2,), t))
        _close(full[:, t], logits[:, 0], SERVE_TOL)
