"""hubert-xlarge's encoder (audio frames through the stub frontend,
bidirectional attention, ``LM.score``), tied embeddings, and
``SyntheticLM``'s batches of every modality with ``local_slice`` and
``prefetch``, on ``device="cpu"`` against the reference on the same
numpy inputs and the reference's own parameters.

Tolerances, as ``tests/test_torch_lm_dense.py`` states them: float32
compute to ``TOL`` = 2e-5; bfloat16 to 2^-7 relative plus 2^-6
absolute, against the reference compiled with
``--xla_allow_excess_precision=false`` in one child process.  The
synthetic batches are equal array for array, bit for bit."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as ref_smoke_config
from repro.data import SyntheticLM as RefSyntheticLM
from repro.models.model import build_model as ref_build_model
from repro.models.model import param_count as ref_param_count
from repro_torch import interop
from repro_torch.configs import base as cb
from repro_torch.data import SyntheticLM
from repro_torch.launch import serve
from repro_torch.models.model import LM, param_count

from _subproc import run_with_devices

CPU = "cpu"
ARCH = "hubert_xlarge"
TOL = 2e-5
BF16_RTOL, BF16_ATOL = 2 ** -7, 2 ** -6
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


def _close(want, got, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _frames(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _lm(arch=ARCH, compute=torch.float32, seed=0, **changes):
    rcfg = ref_smoke_config(arch).with_(compute_dtype=JDT[compute],
                                        **changes)
    pcfg = cb.get_smoke_config(arch).with_(compute_dtype=compute, **changes)
    rm = ref_build_model(rcfg)
    params = jax.tree.map(np.asarray, rm.init(jax.random.PRNGKey(seed))[0])
    return rm, params, interop.lm_params_from_reference(params, pcfg,
                                                        device=CPU)


@pytest.fixture(scope="module")
def f32():
    return _lm()


# --- hubert: the encoder --------------------------------------------------

def test_hubert_score_matches_reference_f32(f32):
    """The frontend linear over the frames (no token embedding), the
    non-gated GELU MLP and bidirectional attention: score logits in
    float32 compute, padded ids masked."""
    rm, params, pm = f32
    assert param_count(pm) == ref_param_count(params)
    assert not hasattr(pm, "embed") and pm.frontend.w.shape == (64, 64)
    assert not hasattr(pm.stack.blocks[0].ffn, "wg")
    frames = _frames((2, 24, 64))
    want = jax.jit(rm.score)(params, {"frames": jnp.asarray(frames)})
    got = pm.score({"frames": torch.from_numpy(frames)})
    assert got.shape == (2, 24, 128)
    _close(want, got)
    assert int(got.argmax(-1).max()) < pm.cfg.vocab


def test_hubert_is_bidirectional_and_rows_independent(f32):
    """Changing the last frame of utterance 0 moves the logits at its
    first frame (a causal mask left on would not) and leaves utterance 1
    alone; utterance 0 scored alone equals its row of the batch."""
    _, _, pm = f32
    frames = torch.from_numpy(_frames((2, 24, 64), seed=2))
    base = pm.score({"frames": frames})
    other = frames.clone()
    other[0, -1] += 1.0
    moved = pm.score({"frames": other})
    assert float((moved[0, 0] - base[0, 0]).abs().max()) > 1e-4
    assert torch.equal(moved[1], base[1])
    _close(base[:1], pm.score({"frames": frames[:1]}))


BF16_SEED = 3
BF16_REF_CODE = """
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import get_smoke_config
from repro.models.model import build_model
rm = build_model(get_smoke_config(%r).with_(compute_dtype=jnp.bfloat16))
params, _ = rm.init(jax.random.PRNGKey(%d))
s = jax.jit(rm.score)(params, {"frames": jnp.asarray(np.load(FRAMES))})
np.save(OUT, np.asarray(s.astype(jnp.float32)))
""" % (ARCH, BF16_SEED)


def test_hubert_score_matches_reference_bf16(tmp_path, monkeypatch):
    """bf16 compute: score logits against the reference compiled
    without excess precision (a child process: XLA reads the flag once,
    at start)."""
    frames = _frames((2, 24, 64), seed=5)
    np.save(tmp_path / "frames.npy", frames)
    monkeypatch.setenv("XLA_FLAGS", "--xla_allow_excess_precision=false "
                       + os.environ.get("XLA_FLAGS", ""))
    run_with_devices(BF16_REF_CODE.replace(
        "FRAMES", repr(str(tmp_path / "frames.npy"))).replace(
        "OUT", repr(str(tmp_path / "ref.npy"))), n_devices=1, timeout=600)
    _, _, pm = _lm(compute=torch.bfloat16, seed=BF16_SEED)
    got = pm.score({"frames": torch.from_numpy(frames)})
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.load(tmp_path / "ref.npy"),
                               rtol=BF16_RTOL, atol=BF16_ATOL)


def test_hubert_is_scored_not_decoded(f32):
    """The serve entry point refuses the encoder before building it, as
    the reference's does; ``decode_step`` names the architecture."""
    _, _, pm = f32
    with pytest.raises(ValueError, match="hubert_xlarge is encoder-only"):
        serve.main(["--arch", ARCH, "--smoke", "--device", CPU])
    with pytest.raises(ValueError, match="hubert-xlarge is encoder-only"):
        pm.decode_step(pm.init_cache(1, 4), torch.zeros((1, 1)),
                       torch.zeros(1))


# --- tied embeddings --------------------------------------------------------

def test_tied_embeddings_match_reference():
    """granite-3-2b's smoke config with ``tie_embeddings``: no head, the
    logits ``h @ embed.table.T``; forward, prefill and a decode step in
    float32 compute."""
    rm, params, pm = _lm("granite_3_2b", seed=1, tie_embeddings=True)
    assert "head" not in params and not hasattr(pm, "head")
    assert param_count(pm) == ref_param_count(params)
    toks = np.random.default_rng(2).integers(0, 512, (2, 17)).astype(
        np.int32)
    want, _ = jax.jit(rm.forward)(params, {"tokens": jnp.asarray(toks)})
    got, _ = pm.forward({"tokens": torch.from_numpy(toks)})
    _close(want, got)
    want, cache = jax.jit(lambda p, b: rm.prefill(p, b, max_len=17))(
        params, {"tokens": jnp.asarray(toks[:, :16])})
    got, pcache = pm.prefill({"tokens": torch.from_numpy(toks[:, :16])},
                             max_len=17)
    _close(want, got)
    want, _ = jax.jit(rm.decode_step)(params, cache,
                                      jnp.asarray(toks[:, 16:]),
                                      jnp.full((2,), 16, jnp.int32))
    got, _ = pm.decode_step(pcache, torch.from_numpy(toks[:, 16:]),
                            torch.full((2,), 16, dtype=torch.int32))
    _close(want, got)
    with pytest.raises(ValueError, match="tied embeddings"):
        LM(cb.get_smoke_config(ARCH).with_(tie_embeddings=True), device=CPU)


# --- SyntheticLM ------------------------------------------------------------

MODALITIES = {"text": {}, "audio_frames": {"d_frontend": 24},
              "image+text": {"d_frontend": 12, "n_img_tokens": 5}}


@pytest.mark.parametrize("modality", list(MODALITIES))
def test_synthetic_batches_match_reference(modality):
    """``batch``, ``local_slice`` and ``prefetch``: the reference's
    arrays, keys, dtypes and values, bit for bit."""
    kw = dict(seed=7, modality=modality, **MODALITIES[modality])
    ref, got = RefSyntheticLM(97, 16, 4, **kw), SyntheticLM(97, 16, 4, **kw)

    def same(want, have):
        assert list(want) == list(have)
        for k in want:
            assert have[k].dtype == want[k].dtype
            np.testing.assert_array_equal(have[k], want[k])

    for step in (0, 3):
        same(ref.batch(step), got.batch(step))
    same(ref.local_slice(2, 1, 2), got.local_slice(2, 1, 2))
    want = list(ref.prefetch(5, 3, rank=3, world=4))
    have = list(got.prefetch(5, 3, rank=3, world=4))
    assert [s for s, _ in have] == [s for s, _ in want] == [5, 6, 7]
    for (_, w), (_, h) in zip(want, have):
        same(w, h)
    with pytest.raises(ValueError, match="does not split"):
        got.local_slice(0, 0, 3)


def test_full_width_hubert_layer_shapes():
    """hubert-xlarge's published widths, one layer, unallocated beyond
    ``torch.empty``: the frontend 1280 -> 1280, the non-gated MLP
    1280 -> 5120 -> 1280, 16 heads of 80, and the head over 504 ids
    padded to 512."""
    m = LM(cb.get_config(ARCH).with_(n_layers=1), device=CPU)
    blk = m.stack.blocks[0]
    assert m.frontend.w.shape == (1280, 1280) and not hasattr(m, "embed")
    assert blk.ffn.wi.w.shape == (1280, 5120) and not hasattr(blk.ffn, "wg")
    assert blk.attn.wk.w.shape == (1280, 16 * 80)
    assert m.head.w.shape == (1280, 512)
