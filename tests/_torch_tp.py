"""Shared by the tests of the port's training past data parallelism
(``test_torch_train_tp*.py``): the reference's training step on
``(data, model)`` meshes of 4 forced host devices, run once a module in
a child process, and the port's on 4 gloo processes (``mp.spawn``, as
``tests/_torch_dp.py`` starts them), each side running all of the
module's cases.

A case is ``(arch, data, model, fsdp, mode)``: the smoke config of
``arch`` in float32 compute, the mesh ``make_host_mesh(data, model)``,
``make_rules(mesh, fsdp=fsdp)`` and ``RunConfig(dp_reduce=mode)``, 3
steps of ``_torch_dp``'s run on its ``SyntheticLM`` batches from the
reference's initial parameters.  The reference builds its mesh as
``_torch_dp.REF`` does (``repro.parallel.compat.make_mesh`` with Auto
axes).  Its manual modes (``ring``, ``bidir_ring``, ``aer_topk``) raise
for both MoE layouts under this JAX (ROADMAP queue C), so the MoE
modules hold those against the reference's ``psum`` (``ring``) and the
port's own ``(2, 1)`` mesh (``aer_topk``).  Each batch carries the
arch's modality (audio frames, image embeddings), and every
cross-attention ``xgate`` starts at ``XGATE`` on both sides (the
reference's 0 would shut the image out).

Each port rank returns, for every case: its losses and wire words a
step, the parameters after the last step gathered whole
(``tensor_parallel.unshard_params``), and its own copies (or FSDP
shards) of the parameters no spec splits over the model axis (the norm
scales, the router, the embedding where the vocabulary does not
split), which must be bit-equal across the ranks of a model group: a
wrong *f* or *g* leaves their gradients partial.

Imported as ``_torch_tp`` (the tests directory is on the path).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import _torch_dp as D
from tests._subproc import run_with_devices

STEPS = D.STEPS
RUN = D.RUN
LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
#: each step's gradient norm, relative: AdamW and the clip ignore a
#: constant scale on a leaf's gradient (a reduction that divides by the
#: wrong count leaves losses and parameters where they were), the norm
#: does not; every case reads within 9e-7
GNORM_RTOL = 1e-5
#: every cross-attention gate's initial value, on both sides
XGATE = 0.7

REF = r"""
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import RunConfig, get_smoke_config
from repro.data import SyntheticLM
from repro.models.model import build_model
from repro.parallel.compat import AXIS_TYPE_AUTO, make_mesh
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.parallel.sharding import make_rules, partition_params
from repro.core import sparse_collectives as sc
from repro.optim import adamw
from repro.runtime.train_loop import TrainState, make_train_step

CASES, STEPS, RUN = {cases!r}, {steps!r}, {run!r}
INIT = dict(np.load({init!r}))
out = {{}}

def initial(model, arch, rules, mode):
    # the first child's initial parameters (the port's too), in a state
    # placed by the parameter specs as the dry-run's lower_cell places
    # it: the step's outputs keep that placement, so it compiles once
    box = {{}}

    def init(k):
        p, box["axes"] = model.init(k)
        return p
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map_with_path(
        lambda path, _: jnp.asarray(INIT[arch + "/init/" + "/".join(
            str(getattr(q, "key", getattr(q, "idx", q))) for q in path)]),
        shapes)
    psh = partition_params(box["axes"], rules)
    rep = NamedSharding(rules.mesh, P())
    aer = sc.init_aer_states(params) if mode == "aer_topk" else None
    state = TrainState(params=params, opt=adamw.init(params), aer=aer,
                       step=jnp.zeros((), jnp.int32))
    return jax.device_put(state, TrainState(
        params=psh, opt=adamw.AdamWState(step=rep, mu=psh, nu=psh),
        aer=None if aer is None else jax.tree.map(lambda _: rep, aer),
        step=rep))

def flat(tree, prefix):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                       for q in path)
        out[prefix + key] = np.asarray(leaf)

for arch, d, m, fsdp, mode in CASES:
    cfg = get_smoke_config(arch).with_(compute_dtype=jnp.float32)
    model = build_model(cfg)
    mesh = make_mesh((d, m), ("data", "model"),
                     axis_types=(AXIS_TYPE_AUTO,) * 2)
    rules = make_rules(mesh, fsdp=fsdp, kv_heads=cfg.n_kv_heads,
                       d_head=cfg.d_head)
    data = SyntheticLM(cfg.vocab, {seq!r}, {batch!r}, seed={seed!r},
                       modality=cfg.modality, d_frontend=cfg.d_frontend,
                       n_img_tokens=cfg.n_img_tokens)
    run = RunConfig(dp_reduce=mode, **RUN)
    state = initial(model, arch, rules, mode)
    step = make_train_step(model, run, rules)
    key = f"{{arch}}/{{d}}x{{m}}/{{int(fsdp)}}/{{mode}}"
    losses, words, gnorms = [], [], []
    for s in range(STEPS):
        b = {{k: jnp.asarray(v) for k, v in data.batch(s).items()}}
        state, met = step(state, b)
        losses.append(float(met["loss"]))
        words.append(float(met["wire_words"]))
        gnorms.append(float(met["grad_norm"]))
    out[key + "/loss"] = np.array(losses)
    out[key + "/words"] = np.array(words)
    out[key + "/gnorm"] = np.array(gnorms)
    flat(state.params, key + "/params/")
np.savez({path!r}, **out)
print("REF-TP-OK")
"""


def key(case) -> str:
    arch, d, m, fsdp, mode = case
    return f"{arch}/{d}x{m}/{int(fsdp)}/{mode}"


def _reference(cases, init, path) -> dict:
    out = run_with_devices(REF.format(
        cases=list(cases), steps=STEPS, run=RUN, init=str(init),
        seq=D.SEQ, batch=D.BATCH, seed=D.SEED, path=str(path)), D.WORLD,
        timeout=900)
    assert "REF-TP-OK" in out, out
    return dict(np.load(path))


def runs(tmp, ref_cases, port_cases, *, ckpt: str | None = None) -> tuple:
    """``(reference results, one dict a port rank)``: the reference's
    child runs ``ref_cases`` while the port's 4 ranks run ``port_cases``
    (and the checkpoint round trip after the case keyed ``ckpt``), from
    the reference's initial parameters, which a first child writes (its
    init jitted: op by op, jamba's is slow) and both sides load."""
    init = tmp / "init.npz"
    archs = sorted({c[0] for c in port_cases} | {c[0] for c in ref_cases})
    run_with_devices(_INIT.format(archs=archs, xgate=XGATE,
                                  path=str(init)), 1, timeout=300)
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(_reference, ref_cases, init, tmp / "ref.npz")
        ranks = D.spawn(tmp, port_rank, list(port_cases), str(init), ckpt,
                        str(tmp / "ckpt"))
        return ref.result(), ranks


_INIT = r"""
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import get_smoke_config
from repro.models.model import build_model
out = {{}}
for arch in {archs!r}:
    cfg = get_smoke_config(arch).with_(compute_dtype=jnp.float32)
    model = build_model(cfg)
    params = jax.jit(lambda k: model.init(k)[0])(jax.random.PRNGKey(0))
    for blk in params["stack"].values():
        if "xgate" in blk:
            blk["xgate"] = jnp.full_like(blk["xgate"], {xgate!r})
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        k = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                     for q in path)
        out[arch + "/init/" + k] = np.asarray(leaf)
np.savez({path!r}, **out)
"""


# --- the port's ranks ---------------------------------------------------

def _whole(model) -> set:
    """Names of the parameters no spec splits over the model axis (the
    same on every rank of a model group)."""
    par = model.parallel
    return {k for k, s in par.splits.items() if s.tp_dim is None}


def _setup(arch, d, m, fsdp, mode, init, rules=True):
    """A model from the reference's initial parameters, its state and
    step on ``make_host_mesh(d, m)`` (every rank creates the mesh's
    groups; ``(None, mesh)`` on a rank off the mesh)."""
    from repro_torch import interop
    from repro_torch.configs.base import RunConfig, get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.runtime import train_loop as tl
    cfg = get_smoke_config(arch).with_(compute_dtype=torch.float32)
    mesh = make_host_mesh(data=d, model=m)
    if torch.distributed.get_rank() >= mesh.size:
        return None, mesh
    r = make_rules(mesh, fsdp=fsdp, kv_heads=cfg.n_kv_heads,
                   d_head=cfg.d_head) if rules else None
    model = interop.lm_params_from_reference(
        D.nest(init, f"{arch}/init/"), cfg, device="cpu")
    run = RunConfig(dp_reduce=mode, **RUN)
    state = tl.init_state(model, run, r)
    return (cfg, r, model, state, tl.make_train_step(model, run, r)), mesh


def port_rank(rank, cases, init_path, ckpt=None, ckpt_dir=None):
    """Every case on this rank (ranks off a case's mesh sit it out), and
    the checkpoint round trip after the case keyed ``ckpt``."""
    from repro_torch.data import SyntheticLM
    from repro_torch.parallel import tensor_parallel as tpar
    init = dict(np.load(init_path))
    out = {}
    for case in cases:
        built, _ = _setup(*case, init)
        if built is None:
            continue
        cfg, rules, model, state, step = built
        data = SyntheticLM(cfg.vocab, D.SEQ, D.BATCH, seed=D.SEED,
                           modality=cfg.modality, d_frontend=cfg.d_frontend,
                           n_img_tokens=cfg.n_img_tokens)
        losses, words, gnorms = [], [], []
        for s in range(STEPS):
            b = {k: torch.from_numpy(v) for k, v in data.batch(s).items()}
            state, met = step(state, b)
            losses.append(float(met["loss"]))
            words.append(float(met["wire_words"]))
            gnorms.append(float(met["grad_norm"]))
        k = key(case)
        out[f"{k}/loss"] = np.array(losses)
        out[f"{k}/words"] = np.array(words)
        out[f"{k}/gnorm"] = np.array(gnorms)
        for name, t in tpar.unshard_params(model).items():
            out[f"{k}/params/{name}"] = t.detach().numpy().copy()
        for name in _whole(model):
            out[f"{k}/whole/{name}"] = state.params[name].detach().numpy() \
                .copy()
        if k == ckpt:
            out.update(_round_trip(rank, case, model, rules, state, init,
                                   ckpt_dir))
    return out


def _leaves(state) -> dict:
    from repro_torch.checkpoint.checkpointer import _flatten_with_paths
    return dict(_flatten_with_paths(state))


def _round_trip(rank, case, model, rules, state, init, root) -> dict:
    """Save ``state`` (sharded) whole; restore it on ``case``'s mesh and
    on a world of one (rank 0), save that and restore it on ``case``'s
    mesh again: each restored leaf bit-equal to the saved one.  A save
    of the shards without their shardings is refused."""
    import os
    import torch.distributed as dist
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.parallel import tensor_parallel as tpar
    from repro_torch.runtime import train_loop as tl
    arch, d, m, fsdp, mode = case
    sh = tl.state_shardings(state, model.param_axes(), rules)
    first, again = os.path.join(root, "mesh"), os.path.join(root, "one")
    Checkpointer(first, group=dist.group.WORLD).save(
        STEPS, state, blocking=True, shardings=sh)
    saved = {k: t.detach().clone() for k, t in _leaves(state).items()}
    specs = _leaves_sh(sh)
    whole = {k: tpar.unshard_param(t, specs[k], tpar.whole_shape(
        t.shape, specs[k])) for k, t in saved.items()}

    def restored_on_mesh(directory):
        (_, r, m2, s2, _), _ = _setup(*case, init)
        Checkpointer(directory, group=dist.group.WORLD).restore(
            STEPS, s2, shardings=tl.state_shardings(s2, m2.param_axes(), r))
        got = _leaves(s2)
        return np.array(got.keys() == saved.keys() and all(
            torch.equal(got[k], saved[k]) for k in saved))

    out = {"ckpt/mesh": restored_on_mesh(first)}
    try:                     # shards without their shardings: refused
        Checkpointer(os.path.join(root, "no"), group=dist.group.WORLD) \
            .save(STEPS, state, blocking=True)
        out["ckpt/refused"] = np.array(False)
    except ValueError as e:
        out["ckpt/refused"] = np.array("shardings=" in str(e))
    built, mesh1 = _setup(arch, 1, 1, fsdp, mode, init, rules=False)
    if built is not None:                   # rank 0: a world of one
        from repro_torch.parallel.sharding import make_rules
        _, _, m1, s1, _ = built
        r1 = make_rules(mesh1, fsdp=fsdp, kv_heads=m1.cfg.n_kv_heads,
                        d_head=m1.cfg.d_head)
        Checkpointer(first).restore(
            STEPS, s1, shardings=tl.state_shardings(s1, m1.param_axes(), r1))
        got = _leaves(s1)
        out["ckpt/one"] = np.array(got.keys() == whole.keys() and all(
            torch.equal(got[k], whole[k]) for k in whole))
        Checkpointer(again).save(STEPS, s1, blocking=True)
    dist.barrier()
    out["ckpt/back"] = restored_on_mesh(again)
    return out


def _leaves_sh(sh) -> dict:
    from repro_torch.checkpoint.checkpointer import (_flatten_with_paths,
                                                     _is_sharding)
    return dict(_flatten_with_paths(sh, leaf=_is_sharding))


def ref_want(ref: dict, case) -> dict:
    """The reference's run of ``case``: losses, wire words (its first
    device's) and parameters by the port's names."""
    from repro_torch import interop
    from repro_torch.configs.base import get_smoke_config
    k = key(case)
    return {"loss": ref[f"{k}/loss"], "words": ref[f"{k}/words"],
            "gnorm": ref[f"{k}/gnorm"], "params": {n: np.asarray(v) for n, v in interop._lm_leaves(
                D.nest(ref, f"{k}/params/"), get_smoke_config(case[0]))
                .items()}}


def port_want(ranks: list, case) -> dict:
    """The port's own run of ``case`` (rank 0's), in ``ref_want``'s
    form."""
    k = key(case)
    got = ranks[0]
    return {"loss": got[f"{k}/loss"], "words": got[f"{k}/words"],
            "gnorm": got[f"{k}/gnorm"], "params": {n[len(k) + 8:]: v for n, v in got.items()
                       if n.startswith(f"{k}/params/")}}


def check_case(want: dict, ranks: list, case, *, loss_tol=LOSS_TOL,
               param_tol=PARAM_TOL) -> None:
    """The port's ``case`` against ``want`` (``ref_want`` or
    ``port_want``): every rank's losses within ``loss_tol`` and its
    gradient norms within ``GNORM_RTOL``, its gathered parameters within
    ``param_tol`` (``aer_topk``: ``_torch_dp.AER_PARAM_TOL``), rank 0's wire words within 1e-3, and
    the parameters no spec splits over the model axis bit-equal across
    the ranks of each model group."""
    arch, d, m, fsdp, mode = case
    k = key(case)
    on = [r for r in ranks if f"{k}/loss" in r]
    assert len(on) == d * m, (case, len(on))
    for r, got in enumerate(on):
        np.testing.assert_allclose(got[f"{k}/loss"], want["loss"], rtol=0,
                                   atol=loss_tol, err_msg=(case, r))
        np.testing.assert_allclose(got[f"{k}/gnorm"], want["gnorm"],
                                   rtol=GNORM_RTOL, atol=0,
                                   err_msg=(case, r))
    np.testing.assert_allclose(on[0][f"{k}/words"], want["words"],
                               rtol=1e-3, err_msg=case)
    assert (mode == "aer_topk") == bool(on[0][f"{k}/words"].any())
    tol = D.AER_PARAM_TOL if mode == "aer_topk" else param_tol
    for r, got in enumerate(on):
        names = sorted(n[len(k) + 8:] for n in got
                       if n.startswith(f"{k}/params/"))
        assert names == sorted(want["params"]), (case, r)
        for n, w in want["params"].items():
            np.testing.assert_allclose(got[f"{k}/params/{n}"], w, rtol=0,
                                       atol=tol, err_msg=(case, r, n))
    for dc in range(d):                  # global ranks dc·m .. dc·m + m-1
        group = on[dc * m:(dc + 1) * m]
        names = [n for n in group[0] if n.startswith(f"{k}/whole/")]
        assert names, case
        for other in group[1:]:
            for n in names:
                np.testing.assert_array_equal(other[n], group[0][n],
                                              err_msg=(case, dc, n))
