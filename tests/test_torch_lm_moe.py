"""The port's MoE layer and the sliding-window ring cache on
``device="cpu"``, against the reference on the same numpy inputs and
its own parameters.

Tolerances: float32 to ``TOL`` = 2e-5 (output and the three aux
scalars); bfloat16 to 2^-7 relative plus 2^-6 absolute, which covers
the expert products' rounding in the two frameworks.  The combine is
held bit for bit on its own (``_combine``): a token's gated slot
outputs are added in the reference scatter's order, ascending expert,
from zero, rounded to the compute dtype after each add, for top-6 of
64 and top-2 of 8.  Routing is held exactly: ``jax.lax.top_k`` puts the
lower expert first on ties (rows of zeros give uniform router
probabilities), and so does the port's stable sort."""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as ref_smoke_config
from repro.models import moe as RM
from repro.models.model import build_model as ref_build_model
from repro_torch import interop
from repro_torch.configs import base as cb
from repro_torch.models import moe as M

from _torch_cases import COMBINE_ROUTINGS, combine_case

CPU = "cpu"
TOL = 2e-5
BF16_RTOL, BF16_ATOL = 2 ** -7, 2 ** -6
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


def _with_moe(cfg, **moe):
    return cfg.with_(moe=dataclasses.replace(cfg.moe, **moe))


def _pair(arch, dtype, seed=0, moe=None, **changes):
    rcfg = ref_smoke_config(arch).with_(compute_dtype=JDT[dtype], **changes)
    pcfg = cb.get_smoke_config(arch).with_(compute_dtype=dtype, **changes)
    if moe:
        rcfg, pcfg = _with_moe(rcfg, **moe), _with_moe(pcfg, **moe)
    p, _ = RM.moe_init(jax.random.PRNGKey(seed), rcfg)
    mod = M.MoE(pcfg, device=CPU)
    mod.load_state_dict({k: interop._tensor(np.asarray(v))
                         for k, v in p.items()}, strict=True)
    return rcfg, pcfg, p, mod


@pytest.mark.parametrize("S", [1, 2, 7, 24, 6144])
@pytest.mark.parametrize("arch,moe", [
    ("mixtral_8x22b", {}), ("moonshot_v1_16b_a3b", {}),
    ("moonshot_v1_16b_a3b", dict(num_experts=64, top_k=6)),
    ("mixtral_8x22b", dict(capacity_factor=2.0)),
    ("mixtral_8x22b", dict(capacity_factor=1.0, num_experts=8))])
def test_capacity_matches_reference(arch, moe, S):
    rcfg, pcfg = ref_smoke_config(arch), cb.get_smoke_config(arch)
    if moe:
        rcfg, pcfg = _with_moe(rcfg, **moe), _with_moe(pcfg, **moe)
    assert M._capacity(pcfg, S) == RM._capacity(rcfg, S)


def test_top_k_puts_the_lower_index_first_on_ties():
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2],
                      [0.0, 0.5, 0.5, 0.0]], np.float32)
    for k in (1, 2, 3):
        wv, wi = jax.lax.top_k(jnp.asarray(probs), k)
        gv, gi = M._top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


# (arch, MoeConfig changes, S, whether the case drops choices)
MOE_CASES = {
    "mixtral-drops": ("mixtral_8x22b", dict(capacity_factor=1.0), 24,
                      True),
    "mixtral-no-drop": ("mixtral_8x22b", dict(capacity_factor=2.0), 24,
                        False),
    "moonshot-drops": ("moonshot_v1_16b_a3b", {}, 40, True),
    "top6-of-64": ("moonshot_v1_16b_a3b", dict(num_experts=64, top_k=6),
                   40, True),
    "decode-1-token": ("mixtral_8x22b", {}, 1, False),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_reference(case, dtype):
    """Output, ``aux_loss``, ``z_loss`` and ``drop_frac``; the first row's
    first three tokens are zeros, whose router probabilities tie."""
    arch, moe, S, drops = MOE_CASES[case]
    rcfg, pcfg, p, mod = _pair(arch, dtype, seed=len(case), moe=moe)
    x = np.random.default_rng(len(case)).standard_normal(
        (2, S, pcfg.d_model)).astype(np.float32)
    x[0, :3] = 0.0
    xj = jnp.asarray(x).astype(JDT[dtype])
    # compiled in float32; op by op in bf16, where XLA's fusions would
    # keep intermediates in float32 (tests/test_torch_lm_dense.py)
    run = (jax.jit(RM.moe_apply, static_argnums=1)
           if dtype == torch.float32 else RM.moe_apply)
    want, waux = run(p, rcfg, xj)
    got, gaux = M.moe_apply(mod, pcfg, torch.from_numpy(x).to(dtype))
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_RTOL,
                                   atol=BF16_ATOL)
    assert set(gaux) == set(waux)
    for k in waux:
        assert gaux[k].dtype == torch.float32
        assert abs(float(gaux[k]) - float(waux[k])) <= TOL * max(
            1.0, abs(float(waux[k]))), k
    assert (float(waux["drop_frac"]) > 0) == drops


def _ref_combine(contrib, slot_tok, S):
    """The reference's combine, ``scatter_back`` of
    ``src/repro/models/moe.py:124-128``, on (B, E, C, D) slot outputs."""
    D = contrib.shape[-1]

    def scatter_back(cg, st):
        return jnp.zeros((S, D), cg.dtype).at[st.reshape(-1)].add(
            cg.reshape(-1, D))

    return jax.vmap(scatter_back)(contrib, slot_tok)


def _bits(a):
    """The raw bits of a bfloat16 or float32 array or tensor."""
    if torch.is_tensor(a):
        return a.view(torch.int16 if a.dtype == torch.bfloat16
                      else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("block", [False, True])
@pytest.mark.parametrize("E,K", COMBINE_ROUTINGS)
def test_combine_is_bit_equal_to_reference_scatter(E, K, block, dtype):
    """``_combine`` against the reference's scatter-add on the same slot
    outputs, bit for bit: tokens that keep fewer than K slots, and (row
    0, tokens 0 and 1, top-6) terms whose bfloat16 sum changes with the
    order and with a wider accumulator.  ``block`` gives the combine
    experts E/2 to E only, a rank's block under ``ep``."""
    B, S, D = 2, 24, 16
    C = max(int(-(-S * K * 1.25 // E)), 1)
    contrib, choice, pos, valid, slot_tok = combine_case(
        E + K + block, B, S, E, K, D, C)
    kept = valid.sum(-1)
    assert ((kept > 0) & (kept < K)).any()
    e0 = E // 2 if block else None
    lo = e0 or 0
    want = _ref_combine(jnp.asarray(contrib[:, lo:]).astype(JDT[dtype]),
                        jnp.asarray(slot_tok[:, lo:]), S)
    got = M._combine(torch.from_numpy(contrib[:, lo:]).to(dtype),
                     torch.from_numpy(choice), torch.from_numpy(pos),
                     torch.from_numpy(valid & (choice >= lo)), e0)
    assert got.dtype == dtype and got.shape == (B, S, D)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if K >= 3 and dtype == torch.bfloat16 and not block:
        # the case bites: ascending order, rounded after each add, gives
        # 0 and 2^-8 at tokens 0 and 1; one wider sum gives 2^-8 at
        # token 0, the descending order 0 at token 1
        def bf16_sum(terms):
            acc = torch.zeros((), dtype=dtype)
            for t in terms:
                acc = acc + torch.tensor(t, dtype=dtype)
            return float(acc)

        up = ((1.0, 2 ** -8, -1.0), (-1.0, 1.0, 2 ** -8))
        np.testing.assert_array_equal(_np(want)[0, :2, 0],
                                      [bf16_sum(t) for t in up])
        assert _np(want)[0, 0, 0] != sum(up[0])
        assert _np(want)[0, 1, 0] != bf16_sum(up[1][::-1])


def test_no_drop_capacity_keeps_every_choice():
    """``capacity_factor = E / k`` gives every expert S slots: nothing is
    dropped, whatever the routing (the setting ``chip_smoke.py``'s
    consistency phase uses)."""
    cfg = cb.get_smoke_config("moonshot_v1_16b_a3b").with_(
        compute_dtype=torch.float32)
    m = cfg.moe
    cfg = _with_moe(cfg, capacity_factor=m.num_experts / m.top_k)
    mod = M.MoE(cfg, device=CPU)
    M.moe_init(mod, cfg, torch.Generator().manual_seed(0))
    for S in (1, 5, 33):
        assert M._capacity(cfg, S) == S
        # every token routed to the same experts: the worst case
        x = torch.ones((2, S, cfg.d_model))
        _, aux = M.moe_apply(mod, cfg, x)
        assert float(aux["drop_frac"]) == 0.0


# --- the sliding-window ring cache ------------------------------------------

@pytest.mark.parametrize("S,max_len", [(10, 40), (16, 40), (33, 48),
                                       (12, 16)])
def test_ring_cache_prefill_and_decode_match_reference(S, max_len):
    """mixtral's smoke window is 16: prompts shorter than, equal to and
    past it prefill a ring (``max_len`` > 16) or a full cache (16), then
    decode past the window, each step's logits and cache (k, v,
    ``slot_pos``) against the reference's."""
    rcfg = ref_smoke_config("mixtral_8x22b").with_(compute_dtype=jnp.float32)
    pcfg = cb.get_smoke_config("mixtral_8x22b").with_(
        compute_dtype=torch.float32)
    rm = ref_build_model(rcfg)
    params = jax.tree.map(np.asarray, rm.init(jax.random.PRNGKey(2))[0])
    pm = interop.lm_params_from_reference(params, pcfg, device=CPU)
    toks = np.random.default_rng(S).integers(0, 512, (2, max_len)).astype(
        np.int32)
    want, cache = jax.jit(lambda q, b: rm.prefill(q, b, max_len=max_len))(
        params, {"tokens": jnp.asarray(toks[:, :S])})
    got, pcache = pm.prefill({"tokens": torch.from_numpy(toks[:, :S])},
                             max_len=max_len)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)
    assert ("slot_pos" in pcache[0]) == (max_len > 16)
    dec = jax.jit(rm.decode_step)
    for t in range(S, min(S + 6, max_len)):
        ref = interop.lm_cache_from_reference(
            jax.tree.map(np.asarray, cache), pcfg, device=CPU)
        for r, g in zip(ref, pcache, strict=True):
            assert set(r) == set(g)
            for k in r:
                if k == "slot_pos":
                    assert torch.equal(r[k], g[k])
                else:
                    np.testing.assert_allclose(g[k].numpy(), r[k].numpy(),
                                               rtol=TOL, atol=TOL)
        tok = toks[:, t:t + 1]
        want, cache = dec(params, cache, jnp.asarray(tok),
                          jnp.full((2,), t, jnp.int32))
        got, pcache = pm.decode_step(pcache, torch.from_numpy(tok),
                                     torch.full((2,), t, dtype=torch.int32))
        np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)


def test_example_serves_the_three_families_on_cpu(capsys):
    """``examples/torch_serve_decode.py --device cpu``: granite, mixtral
    (its 32-token prompts past the smoke window of 16) and falcon-mamba,
    12 greedy tokens each."""
    import runpy
    ex = runpy.run_path(str(pathlib.Path(__file__).resolve().parents[1] /
                            "examples" / "torch_serve_decode.py"))
    out = ex["main"](["--device", CPU])
    assert set(out) == {"granite_3_2b", "mixtral_8x22b", "falcon_mamba_7b"}
    for arch, toks in out.items():
        assert toks.shape == (4, 12) and toks.dtype == torch.int64, arch
        assert 0 <= int(toks.min()) and int(toks.max()) < 512, arch
    text = capsys.readouterr().out
    for name in ("granite-3-2b", "mixtral-8x22b", "falcon-mamba-7b"):
        assert f"{name}: prefill(4x32)" in text
