"""Shared by the tests of serving and scoring a sharded model
(``test_torch_serve_tp*.py``): the reference's ``prefill``,
``decode_step`` and ``score`` jitted under its sharding rules on
``(data, model)`` meshes of 4 forced host devices, as its dry-run lowers
them (``src/repro/launch/dryrun.py::lower_cell``), run once a module in
a child process; then the port's on 4 gloo processes (``mp.spawn``, as
``tests/_torch_dp.py`` starts them), each side running all of the
module's cases.

A case is ``(arch, data, model, prompt, max_len[, sp])``: the smoke
config of ``arch`` in float32 compute from the reference's initial
parameters (every cross-attention ``xgate`` set to ``XGATE`` on both
sides: at the reference's 0 the image adds nothing),
``make_rules(mesh, fsdp=True, seq_parallel=sp)`` over the mesh (``sp``
off by default, and a case without it keeps its key), a ``SyntheticLM`` batch of ``BATCH`` prompts of
``prompt`` tokens, a cache of ``max_len`` positions.  The reference
places its parameters by their specs, the batch by ``_batch_axis`` and
the prefilled cache by ``_cache_shardings``, then decodes ``STEPS``
greedy tokens; an encoder (``max_len`` 0) is scored instead.  Where
``_cache_shardings`` cannot place the cache (a sequence split that the
model axis does not divide: jit refuses an uneven split, ROADMAP queue
C), its decode takes the cache whole at the boundary and its rules
still split it inside.  The port's ranks prefill the same prompts and
are fed the reference's greedy tokens (teacher forcing: a near tie
cannot cascade), and rank 0 runs the same on the whole model (the world
of one).

Each port rank returns, per case: its logits (gathered, the global
batch's), the lengths of the residual stream its blocks took in the
prefill or the score (``_torch_tp.residual_lengths``), the world of one's on rank 0, a prefill and a decode step
counted under the cost counter (``check_counted`` holds them to the
dry-run's ``meta`` trace of rank 0), its cache shards after the
prefill and after the last step with their bytes beside
``launch.dryrun.device_bytes`` under ``_cache_spec`` of the whole
leaf, the collectives a decode step ran, the tokens of
``launch.serve.generate`` on the sharded model (its own greedy
tokens, not forced), whether ``init_cache`` builds the parts prefill
fills, and (an image model) how far ``precompute_cross_cache``'s
image cache is from prefill's.

Imported as ``_torch_tp_serve`` (the tests directory is on the path).
"""

from __future__ import annotations

import numpy as np
import torch

import _torch_dp as D
import _torch_tp as TP
from tests._subproc import run_with_devices

BATCH, SEED, STEPS = 4, 7, 6
#: every cross-attention gate, on both sides
XGATE = TP.XGATE
#: logits and cache entries, relative to the largest magnitude of the
#: reference's (at least 1): float32 rounding grows with the values and
#: the depth; on jamba's 8 smoke layers ``runs`` gives the world of one
#: 1.23e-5 from the reference's (2, 2) logits (max |logits| 3.6), the
#: sharded port 1.18e-5
TOL = 1e-5
#: greedy tokens are compared where the reference's top-2 margin
#: exceeds this
MARGIN = 1e-4
INPUTS = ("tokens", "frames", "img_embed")

REF = r"""
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.base import get_smoke_config
from repro.data import SyntheticLM
from repro.launch.dryrun import _batch_axis, _cache_shardings
from repro.models.model import build_model
from repro.parallel.compat import AXIS_TYPE_AUTO, make_mesh, set_mesh
from repro.parallel.sharding import make_rules, partition_params, use_rules

CASES, STEPS, B, SEED, XGATE = {cases!r}, {steps!r}, {batch!r}, {seed!r}, {xgate!r}
INPUTS = {inputs!r}
out = {{}}
{smoke}

def flat(tree, prefix):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                       for q in path)
        out[prefix + key] = np.asarray(leaf)

for key, arch, d, m, S, max_len, sp in CASES:
    cfg = smoke(arch)
    model = build_model(cfg)
    box = {{}}

    def init(k):
        p, box["axes"] = model.init(k)
        return p
    # jitted: op by op, jamba's init is slow
    params, axes = jax.jit(init)(jax.random.PRNGKey(0)), box["axes"]
    for blk in params["stack"].values():
        if "xgate" in blk:
            blk["xgate"] = jnp.full_like(blk["xgate"], XGATE)
    if not any(k.startswith(arch + "/init/") for k in out):
        flat(params, arch + "/init/")
    mesh = make_mesh((d, m), ("data", "model"),
                     axis_types=(AXIS_TYPE_AUTO,) * 2)
    rules = make_rules(mesh, fsdp=True, seq_parallel=sp,
                       kv_heads=cfg.n_kv_heads, d_head=cfg.d_head)
    data = SyntheticLM(cfg.vocab, S, B, seed=SEED, modality=cfg.modality,
                       d_frontend=cfg.d_frontend,
                       n_img_tokens=cfg.n_img_tokens)
    batch = {{k: jnp.asarray(v) for k, v in data.batch(0).items()
             if k in INPUTS}}
    bax = _batch_axis(mesh, B, rules)
    put = lambda x: jax.device_put(x, NamedSharding(
        mesh, P(bax, *(None,) * (x.ndim - 1))))
    with set_mesh(mesh):
        p = jax.device_put(params, partition_params(axes, rules))
        b = {{k: put(v) for k, v in batch.items()}}
        if not cfg.causal:
            def score(p, b):
                with use_rules(rules):
                    return model.score(p, b)
            out[key + "/logits"] = np.asarray(jax.jit(score)(p, b))
            continue

        def prefill(p, b):
            with use_rules(rules):
                return model.prefill(p, b, max_len=max_len)

        def decode(p, c, t, q):
            with use_rules(rules):
                return model.decode_step(p, c, t, q)

        logits, cache = jax.jit(prefill)(p, b)
        try:
            cache = jax.device_put(cache, _cache_shardings(cache, mesh,
                                                           rules))
            out[key + "/placed"] = np.array("")
        except ValueError as e:
            out[key + "/placed"] = np.array(str(e)[:400])
        flat(cache, key + "/cache0/")
        step = jax.jit(decode)
        lg, toks = [np.asarray(logits)], []
        for t in range(STEPS):
            tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
            toks.append(np.asarray(tok))
            logits, cache = step(p, cache, put(tok),
                                 put(jnp.full((B,), S + t, jnp.int32)))
            lg.append(np.asarray(logits))
        out[key + "/logits"] = np.stack(lg)
        out[key + "/tokens"] = np.stack(toks)
        flat(cache, key + "/cache1/")
np.savez({path!r}, **out)
print("REF-SERVE-OK")
"""


def _atol(want: np.ndarray) -> float:
    return TOL * max(1.0, float(np.abs(want).max()))


def parts(case) -> tuple:
    """``(arch, d, m, prompt, max_len, sp)`` of a case."""
    return (*case, False)[:6]


def key(case) -> str:
    arch, d, m, s, max_len, sp = parts(case)
    return f"{arch}/{d}x{m}/{s}/{max_len}" + ("/sp" if sp else "")


def runs(tmp, cases) -> tuple:
    """``(reference results, one dict a port rank)`` for ``cases``: the
    reference's child first (the port's ranks are fed its tokens), then
    the port's 4 ranks."""
    path = tmp / "ref.npz"
    out = run_with_devices(REF.format(
        cases=[(key(c), *parts(c)) for c in cases], steps=STEPS, batch=BATCH, seed=SEED,
        xgate=XGATE, inputs=INPUTS, path=str(path), smoke=TP.SMOKE_REF),
        D.WORLD, timeout=900)
    assert "REF-SERVE-OK" in out, out
    ranks = D.spawn(tmp, port_rank, list(cases), str(path))
    return dict(np.load(path)), ranks


# --- the port's ranks ---------------------------------------------------

def _inputs(cfg, prompt: int) -> dict:
    from repro_torch.data import SyntheticLM
    data = SyntheticLM(cfg.vocab, prompt, BATCH, seed=SEED,
                       modality=cfg.modality, d_frontend=cfg.d_frontend,
                       n_img_tokens=cfg.n_img_tokens)
    return {k: torch.from_numpy(v) for k, v in data.batch(0).items()
            if k in INPUTS}


def _generate(model, batch, case, tokens) -> tuple:
    """Prefill, then ``STEPS`` decode steps fed ``tokens``: the logits
    (STEPS + 1, B, 1, V), the caches after the prefill and the last
    step, and the collectives of each decode step."""
    from repro_torch.parallel.compat import CALLS
    arch, d, m, s, max_len, _ = parts(case)
    logits, cache = model.prefill(batch, max_len=max_len)
    first, lg, calls = cache, [logits], []
    for t in range(STEPS):
        pos = torch.full((BATCH,), s + t, dtype=torch.int32)
        CALLS.clear()
        logits, cache = model.decode_step(
            cache, torch.from_numpy(tokens[t]), pos)
        calls.append(sum(CALLS.values()))
        lg.append(logits)
    return torch.stack(lg).numpy(), first, cache, calls


def port_rank(rank, cases, ref_path):
    """Every case on this rank, and the world of one's on rank 0."""
    from repro_torch import interop
    from repro_torch.launch import dryrun, serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.parallel.tensor_parallel import shard_model
    ref = dict(np.load(ref_path))
    out = {}
    for case in cases:
        arch, d, m, s, max_len, sp = parts(case)
        k = key(case)
        cfg = TP.smoke(arch)
        mesh = make_host_mesh(data=d, model=m)
        rules = make_rules(mesh, fsdp=True, seq_parallel=sp,
                           kv_heads=cfg.n_kv_heads, d_head=cfg.d_head)
        init = D.nest(ref, f"{arch}/init/")
        model = interop.lm_params_from_reference(init, cfg, device="cpu")
        par = shard_model(model, rules)
        out[f"{k}/coords"] = np.array([par.dp_rank, par.tp_rank])
        batch = _inputs(cfg, s)
        out.update(_counted(k, model, batch, sp, s, cfg.causal))
        whole = interop.lm_params_from_reference(init, cfg, device="cpu") \
            if rank == 0 else None
        with torch.inference_mode():
            if not cfg.causal:
                with TP.residual_lengths() as lengths:
                    out[f"{k}/logits"] = model.score(batch).numpy()
                out[f"{k}/resid"] = np.array(sorted(lengths))
                if whole is not None:
                    out[f"{k}/one"] = whole.score(batch).numpy()
                continue
            tokens = ref[f"{k}/tokens"]
            with TP.residual_lengths() as lengths:
                model.prefill(batch, max_len=max_len)
            out[f"{k}/resid"] = np.array(sorted(lengths))
            lg, c0, c1, calls = _generate(model, batch, case, tokens)
            out[f"{k}/logits"] = lg
            out[f"{k}/calls"] = np.array(calls)
            shapes = T.init_cache(cfg, BATCH, max(max_len, s),
                                  device="meta")
            for ph, cache in (("cache0", c0), ("cache1", c1)):
                for i, (layer, meta) in enumerate(zip(cache, shapes,
                                                      strict=True)):
                    for n, t in layer.items():
                        out[f"{k}/{ph}/{i}/{n}"] = t.numpy().copy()
                        spec = dryrun._cache_spec(n, meta[n], mesh, rules)
                        out[f"{k}/bytes/{ph}/{i}/{n}"] = np.array(
                            [t.numel() * t.element_size(),
                             dryrun.device_bytes(meta[n], spec, mesh)])
            init = model.init_cache(BATCH, max(max_len, s))
            out[f"{k}/init_like_prefill"] = np.array(all(
                a.keys() == b.keys() and all(
                    a[n].shape == b[n].shape and a[n].dtype == b[n].dtype
                    for n in a) for a, b in zip(init, c0, strict=True)))
            if cfg.modality == "image+text":
                img = model._embed_inputs(model._rows(batch))[2]
                pc = T.precompute_cross_cache(model.stack, cfg, init, img,
                                              par)
                out[f"{k}/precompute_gap"] = np.array(max(
                    float((pc[i][n] - c0[i][n]).abs().max())
                    for i, blk in enumerate(model.stack.blocks)
                    if blk.kind.startswith("xattn") for n in ("k", "v")))
            gen = serve.generate(model, batch, STEPS + 1)
            out[f"{k}/generate"] = gen.tokens.numpy()
            if whole is not None:
                out[f"{k}/one"] = _generate(whole, batch, case, tokens)[0]
    return out


def _counted(k: str, model, batch: dict, sp: bool, s: int,
             causal: bool) -> dict:
    """A prefill of ``s`` positions (a score for an encoder) and, from
    its cache, one decode step, each under the cost counter
    (``_torch_tp.counted``)."""
    from repro_torch.configs.base import RunConfig
    run = RunConfig(fsdp=True, seq_parallel=sp)
    out, ret = TP.counted(f"{k}/counted/prefill", model, "prefill", batch,
                          run, seq_len=s)
    if causal:
        step = {"tokens": torch.zeros((BATCH, 1), dtype=torch.int32),
                "pos": torch.full((BATCH,), s, dtype=torch.int32)}
        out.update(TP.counted(f"{k}/counted/decode", model, "decode", step,
                              run, cache=ret[1])[0])
    return out


# --- the checks ---------------------------------------------------------

def check_counted(ranks: list, case) -> None:
    """Every rank's counted prefill (or score) and decode step equal to
    the dry-run's ``meta`` trace of rank 0 of the same cells: a prefill
    of the prompt, a decode step against a cache of its length."""
    from repro_torch.configs.base import RunConfig
    arch, d, m, s, _, sp = parts(case)
    run = RunConfig(fsdp=True, seq_parallel=sp)
    kinds = ["prefill"] + (["decode"] if TP.smoke(arch).causal
                           else [])
    for kind in kinds:
        TP.check_counted(ranks, f"{key(case)}/counted/{kind}",
                         TP.meta_cell(arch, kind, BATCH, s, d, m, run),
                         d * m)


def _rank_part(cfg, kind: str, name: str, t: np.ndarray, dc: int, d: int,
               mc: int, m: int) -> np.ndarray:
    """Data coordinate ``dc`` of ``d`` and model coordinate ``mc`` of
    ``m``'s part of the whole cache leaf ``t`` under the reference's
    ``_cache_shardings``: its rows (when ``d`` divides them), then its
    kv heads, or its block of slots zero-padded to ``m`` blocks (a
    cross-attention cache's slots are its image tokens), or its Mamba
    channels."""
    if t.shape[0] % d == 0:
        b = t.shape[0] // d
        t = t[dc * b:(dc + 1) * b]
    K = cfg.n_kv_heads
    if name in ("k", "v"):
        if K % m == 0:
            return t[:, :, mc * K // m:(mc + 1) * K // m]
        c = -(-t.shape[1] // m)
        pad = np.zeros((t.shape[0], c * m - t.shape[1], *t.shape[2:]),
                       t.dtype)
        return np.concatenate([t, pad], 1)[:, mc * c:(mc + 1) * c]
    if name == "h":
        c = t.shape[1] // m
        return t[:, mc * c:(mc + 1) * c]
    if name == "conv":
        c = t.shape[2] // m
        return t[:, :, mc * c:(mc + 1) * c]
    return t                                 # slot_pos: whole


def check_logits(ref: dict, ranks: list, case) -> None:
    """Every rank's logits (prefill, then each teacher-forced step; an
    encoder's scores) over the real vocabulary within ``TOL`` of the
    reference's (``_atol``; the padded ids below -1e8 on both), its
    greedy tokens equal wherever the reference's top-2 margin exceeds
    ``MARGIN``, and the world of one's within ``TOL`` of rank 0's."""
    k = key(case)
    V = TP.smoke(case[0]).vocab
    whole = ref[f"{k}/logits"]
    want = whole[..., :V]
    assert (whole[..., V:] < -1e8).all(), case
    atol = _atol(want)
    top2 = np.sort(want, -1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > MARGIN
    assert sure.mean() > 0.5, (case, sure.mean())
    for r, got in enumerate(ranks):
        g = got[f"{k}/logits"]
        assert g.shape == whole.shape, (case, r)
        assert (g[..., V:] < -1e8).all(), (case, r)
        np.testing.assert_allclose(g[..., :V], want, rtol=0, atol=atol,
                                   err_msg=(case, r))
        np.testing.assert_array_equal(g[..., :V].argmax(-1)[sure],
                                      want.argmax(-1)[sure],
                                      err_msg=(case, r))
    np.testing.assert_allclose(ranks[0][f"{k}/one"][..., :V],
                               ranks[0][f"{k}/logits"][..., :V], rtol=0,
                               atol=atol, err_msg=case)


def check_generate(ref: dict, ranks: list, case) -> None:
    """``launch.serve.generate`` on the sharded model: the same tokens
    on every rank, and in each row the reference's greedy tokens up to
    the first step whose top-2 margin is within ``MARGIN`` (a near tie
    may go either way, and the rest of the row follows it)."""
    k = key(case)
    V = TP.smoke(case[0]).vocab
    want = ref[f"{k}/logits"][:, :, -1, :V]             # (steps, B, V)
    top2 = np.sort(want, -1)[..., -2:]
    sure = np.cumprod((top2[..., 1] - top2[..., 0]) > MARGIN, 0).T
    greedy = want.argmax(-1).T                           # (B, steps)
    got = ranks[0][f"{k}/generate"]
    assert got.shape == greedy.shape, (case, got.shape)
    for r, other in enumerate(ranks):
        np.testing.assert_array_equal(other[f"{k}/generate"], got,
                                      err_msg=(case, r))
    assert sure[:, 0].all(), case
    np.testing.assert_array_equal(got[sure == 1], greedy[sure == 1],
                                  err_msg=case)


def check_cache(ref: dict, ranks: list, case) -> None:
    """Every rank's cache shard, after the prefill and after the last
    step, equal (within ``TOL``, ``_atol``) to its part of the
    reference's cache
    (``_rank_part``; a padded slot holds zeros), and its bytes equal to
    ``dryrun.device_bytes`` under ``_cache_spec``."""
    from repro_torch import interop
    from repro_torch.models.transformer import _kinds
    arch, d, m, _, _, _ = parts(case)
    k = key(case)
    cfg = TP.smoke(arch)
    kinds = _kinds(cfg)
    for ph in ("cache0", "cache1"):
        whole = interop.lm_cache_from_reference(
            D.nest(ref, f"{k}/{ph}/"), cfg, device="cpu")
        for r, got in enumerate(ranks):
            dc, mc = (int(c) for c in got[f"{k}/coords"])
            assert r == dc * m + mc, (case, r)
            for i, layer in enumerate(whole):
                names = sorted(n.split("/")[-1] for n in got
                               if n.startswith(f"{k}/{ph}/{i}/"))
                assert names == sorted(layer), (case, ph, i, names)
                for n, t in layer.items():
                    want = _rank_part(cfg, kinds[i], n, t.numpy(), dc, d,
                                      mc, m)
                    g = got[f"{k}/{ph}/{i}/{n}"]
                    assert g.shape == want.shape, (case, ph, r, i, n,
                                                   g.shape, want.shape)
                    np.testing.assert_allclose(
                        g, want, rtol=0, atol=_atol(t.numpy()),
                        err_msg=(case, ph, r, i, n))
                    nbytes, spec_bytes = got[f"{k}/bytes/{ph}/{i}/{n}"]
                    assert nbytes == spec_bytes, (case, ph, r, i, n, nbytes,
                                                  spec_bytes)


def check_residual(ranks: list, case) -> None:
    """Every block of every rank took ``ceil(prompt / tp)`` positions
    of the residual stream in its prefill or score under sequence
    parallelism (the whole prompt without)."""
    arch, d, m, s, _, sp = parts(case)
    want = -(-s // m) if sp else s
    for r, got in enumerate(ranks):
        assert got[f"{key(case)}/resid"].tolist() == [want], (case, r)
