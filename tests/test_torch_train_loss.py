"""``LM.loss`` and every parameter's gradient against the reference's
``jax.value_and_grad(model.loss)`` on ``device="cpu"``, in float32
compute, on the same parameters (the reference's init tree, carried
over by ``interop``) and the same ``SyntheticLM`` batches.

Configs: the smoke configs of granite (dense), falcon-mamba (the scan,
through ``SelectiveScanFn``), mixtral (MoE aux and z losses, with drops),
hubert (audio frames with a mask), llama-3.2-vision (every ``xgate`` set
to 0.7 on both sides, so the image reaches the loss), a tied-embedding
granite, and the chunked cross-entropy forced (``loss_chunk`` 7, which
does not divide S = 16).  jamba is left out: its reference
compile alone takes ~18 s, and its blocks are falcon's and mixtral's.

Tolerance: each gradient leaf within ``1e-5 · max|leaf| + 1e-7`` of the
reference's, the loss and metrics within 1e-5 relative (float32 sums in
another order; measured ~1e-6 relative).  Each remat policy gives the
same loss and gradients bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as ref_smoke_config
from repro.data import SyntheticLM
from repro.models.model import build_model as ref_build_model
from repro_torch import interop
from repro_torch.configs import base as cb
from repro_torch.models import transformer as T

GRAD_TOL, GRAD_ATOL, LOSS_TOL = 1e-5, 1e-7, 1e-5
METRICS = ("nll", "aux_loss", "z_loss", "drop_frac", "loss")
XGATE = 0.7

#: label -> (arch, reference config overrides, batch rows, seq)
CASES = {
    "granite": ("granite_3_2b", {}, 2, 16),
    "falcon_mamba": ("falcon_mamba_7b", {}, 2, 16),
    "mixtral": ("mixtral_8x22b", {}, 2, 16),
    "hubert": ("hubert_xlarge", {}, 2, 16),
    "llama_vision": ("llama32_vision_11b", {}, 2, 16),
    "tied": ("granite_3_2b", {"tie_embeddings": True}, 2, 16),
    "chunked": ("granite_3_2b", {"loss_chunk": 7}, 2, 16),
}


def _set_xgates(tree, value):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _set_xgates(v, value)
        elif k == "xgate":
            out[k] = jnp.full_like(v, value)
        else:
            out[k] = v
    return out


def _configs(arch, over):
    rcfg = ref_smoke_config(arch).with_(compute_dtype=jnp.float32, **over)
    pcfg = cb.get_smoke_config(arch).with_(compute_dtype=torch.float32,
                                           **over)
    return rcfg, pcfg


def _batch(cfg, rows, seq, step=0):
    data = SyntheticLM(cfg.vocab, seq, rows, seed=5, modality=cfg.modality,
                       d_frontend=cfg.d_frontend,
                       n_img_tokens=cfg.n_img_tokens)
    return data.batch(step)


def _reference(label):
    arch, over, rows, seq = CASES[label]
    rcfg, pcfg = _configs(arch, over)
    model = ref_build_model(rcfg)
    params, _ = model.init(jax.random.PRNGKey(3))
    if rcfg.modality == "image+text":
        params = _set_xgates(params, XGATE)
    batch = _batch(rcfg, rows, seq)
    grad_fn = jax.jit(jax.value_and_grad(model.loss, has_aux=True))
    (loss, metrics), grads = grad_fn(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return pcfg, params, batch, float(loss), \
        {k: float(v) for k, v in metrics.items()}, grads


def _port_loss(pcfg, params, batch):
    model = interop.lm_params_from_reference(params, pcfg, device="cpu")
    model.requires_grad_(True)
    loss, metrics = model.loss({k: torch.from_numpy(v)
                                for k, v in batch.items()})
    loss.backward()
    return model, loss, metrics


@pytest.mark.parametrize("label", sorted(CASES))
def test_loss_and_every_gradient_match_reference(label):
    pcfg, params, batch, want_loss, want_m, grads = _reference(label)
    model, loss, metrics = _port_loss(pcfg, params, batch)
    assert abs(float(loss.detach()) - want_loss) <= LOSS_TOL * abs(want_loss)
    for k in METRICS:
        assert abs(float(metrics[k]) - want_m[k]) <= \
            LOSS_TOL * abs(want_m[k]) + 1e-7, (k, float(metrics[k]),
                                               want_m[k])
    want = interop._lm_leaves(grads, pcfg)
    named = dict(model.named_parameters())
    assert set(want) == set(named)
    for name, p in named.items():
        w = np.asarray(want[name], np.float64)
        assert p.grad is not None, name
        g = p.grad.double().numpy()
        err = np.abs(g - w).max()
        assert err <= GRAD_TOL * np.abs(w).max() + GRAD_ATOL, \
            (name, err, np.abs(w).max())
    if label == "mixtral":
        assert want_m["drop_frac"] > 0 and want_m["aux_loss"] > 0
    if label == "llama_vision":
        gates = [n for n in named if n.endswith("xgate")]
        assert gates and all(float(named[n].grad) != 0 for n in gates)


@pytest.mark.parametrize("arch", ["granite_3_2b", "falcon_mamba_7b"])
def test_remat_policies_give_equal_values(arch):
    """"none", "dots" and "full" recompute different activations in
    backward but give the same loss and gradients bit for bit."""
    pcfg = cb.get_smoke_config(arch).with_(compute_dtype=torch.float32)
    rcfg = ref_smoke_config(arch)
    params, _ = ref_build_model(rcfg).init(jax.random.PRNGKey(4))
    batch = _batch(pcfg, 2, 16, step=1)
    out = {}
    for policy in cb.REMAT_POLICIES:
        model, loss, _ = _port_loss(pcfg.with_(remat=policy), params, batch)
        out[policy] = (loss.detach(), {n: p.grad for n, p in
                                       model.named_parameters()})
    for policy in ("dots", "full"):
        assert torch.equal(out[policy][0], out["none"][0]), policy
        for n, g in out["none"][1].items():
            assert torch.equal(out[policy][1][n], g), (policy, n)


def test_remat_full_recomputes_each_period_once(monkeypatch):
    """Under "full" each block's forward runs twice in a training step
    (forward, then its period's recompute in backward); under "none"
    once; and never twice under no_grad."""
    calls = []
    real = T._block_apply

    def spy(blk, *a, **k):
        calls.append(blk.kind)
        return real(blk, *a, **k)

    monkeypatch.setattr(T, "_block_apply", spy)
    pcfg = cb.get_smoke_config("falcon_mamba_7b").with_(
        compute_dtype=torch.float32)
    params, _ = ref_build_model(ref_smoke_config("falcon_mamba_7b")).init(
        jax.random.PRNGKey(4))
    batch = _batch(pcfg, 2, 16)
    for policy, want in (("full", 2), ("none", 1)):
        calls.clear()
        _port_loss(pcfg.with_(remat=policy), params, batch)
        assert len(calls) == want * pcfg.n_layers, (policy, calls)
    model = interop.lm_params_from_reference(params, pcfg, device="cpu")
    calls.clear()
    with torch.no_grad():
        model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    assert len(calls) == pcfg.n_layers


def test_unknown_remat_policy_is_refused():
    pcfg = cb.get_smoke_config("granite_3_2b").with_(remat="most")
    params, _ = ref_build_model(ref_smoke_config("granite_3_2b")).init(
        jax.random.PRNGKey(4))
    model = interop.lm_params_from_reference(params, pcfg, device="cpu")
    with pytest.raises(ValueError, match="remat"):
        model.loss({k: torch.from_numpy(v)
                    for k, v in _batch(pcfg, 2, 16).items()})


@pytest.mark.parametrize("arch", cb.PORTED_ARCHS)
def test_loss_fields_match_reference_configs(arch):
    from repro.configs.base import get_config as ref_get_config
    for get_p, get_r in ((cb.get_config, ref_get_config),
                         (cb.get_smoke_config, ref_smoke_config)):
        p, r = get_p(arch), get_r(arch)
        assert (p.loss_chunk, p.remat) == (r.loss_chunk, r.remat)


def test_run_config_defaults_match_reference():
    from repro.configs.base import RunConfig as RefRunConfig
    assert cb.RunConfig().__dict__ == RefRunConfig().__dict__


@pytest.mark.parametrize("S,vocab,over,want", [
    (513, 32768, {}, 256), (512, 32768, {}, 0), (513, 32767, {}, 0),
    (2048, 65024, {}, 256), (16, 256, {"loss_chunk": 7}, 7),
    (4096, 65024, {"loss_chunk": -1}, 0)])
def test_loss_chunk_rule_matches_reference(S, vocab, over, want):
    from types import SimpleNamespace
    from repro.models.model import LM as RefLM
    from repro_torch.models.model import LM
    rcfg = ref_smoke_config("granite_3_2b").with_(vocab=vocab, **over)
    pcfg = cb.get_smoke_config("granite_3_2b").with_(vocab=vocab, **over)
    assert RefLM(rcfg)._loss_chunk(S) == want
    assert LM._loss_chunk(SimpleNamespace(cfg=pcfg), S) == want
