"""Shared by the data-parallel training tests of the port
(``test_torch_train_dp*.py``): the reference's manual data parallelism
on 4 forced host devices, run once a module in a child process, and the
port's on 4 gloo processes (``mp.spawn``, a ``FileStore`` rendezvous in
the test's temporary directory).

The reference's own data-parallel tests (``tests/test_train_modes.py``,
``tests/test_elastic.py``) fail under this JAX because
``launch/mesh.py::make_host_mesh`` calls ``jax.make_mesh`` without axis
types, and JAX 0.9 makes those axes Explicit, which
``with_sharding_constraint`` refuses.  The snippet here builds the same
mesh through the reference's own ``parallel.compat.make_mesh`` with
Auto axes; nothing of the reference is edited.

Imported as ``_torch_dp`` (the tests directory is on the path), as
``_torch_cases`` is.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tests._subproc import run_with_devices

WORLD = 4
STEPS = 3
MODES = ("psum", "ring", "bidir_ring", "aer_topk")
#: the reference test's run (tests/test_train_modes.py), cut to STEPS
RUN = dict(learning_rate=1e-3, warmup_steps=2, total_steps=12,
           aer_frac=0.1, aer_budget=256, fsdp=False)
SEQ, BATCH, SEED = 16, 8, 7
#: reductions of the reference's own gradients held exactly
AER_ROUNDS = 2

REF = r"""
import jax, jax.numpy as jnp, numpy as np
from functools import partial
from jax.sharding import PartitionSpec as P
from repro.configs.base import RunConfig, get_smoke_config
from repro.core import sparse_collectives as sc
from repro.data import SyntheticLM
from repro.models.model import build_model
from repro.parallel.compat import AXIS_TYPE_AUTO, make_mesh, shard_map
from repro.parallel.sharding import make_rules
from repro.runtime.train_loop import init_state, make_train_step

arch, W, STEPS, MODES, RUN = {arch!r}, {world!r}, {steps!r}, {modes!r}, {run!r}
mesh = make_mesh((W, 1), ("data", "model"),
                 axis_types=(AXIS_TYPE_AUTO,) * 2)
out = {{}}

def flat(tree, prefix):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                       for q in path)
        out[prefix + key] = np.asarray(leaf)

cfg = get_smoke_config(arch).with_(compute_dtype=jnp.float32)
model = build_model(cfg)
rules = make_rules(mesh, fsdp=False, kv_heads=cfg.n_kv_heads,
                   d_head=cfg.d_head)
data = SyntheticLM(cfg.vocab, {seq!r}, {batch!r}, seed={seed!r})
for mode in MODES:
    run = RunConfig(dp_reduce=mode, **RUN)
    state = init_state(model, jax.random.PRNGKey(0), run)
    if mode == MODES[0]:
        flat(state.params, "init/")
    step = make_train_step(model, run, rules)
    losses, words = [], []
    for s in range(STEPS):
        b = {{k: jnp.asarray(v) for k, v in data.batch(s).items()}}
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        words.append(float(m["wire_words"]))
    out[f"{{mode}}/loss"] = np.array(losses)
    out[f"{{mode}}/words"] = np.array(words)
    flat(state.params, f"{{mode}}/params/")

# the reference's own per-device gradients at the initial parameters,
# through its aer_topk reduction, twice (the second with the first's
# residuals and the next batch)
state = init_state(model, jax.random.PRNGKey(0),
                   RunConfig(dp_reduce="aer_topk", **RUN))
is_st = lambda z: isinstance(z, sc.AerState)

@partial(shard_map, mesh=mesh, in_specs=(P(), P("data"), P("data")),
         out_specs=(P("data"), P(), P("data"), P("data")),
         check_vma=False, axis_names=frozenset({{"data"}}))
def reduce(params, res, batch):
    g = jax.grad(lambda p: model.loss(p, batch)[0])(params)
    st = jax.tree.map(lambda a: sc.AerState(a[0]), res)
    red, st, words = sc.reduce_gradients(
        g, st, "data", mode="aer_topk", frac=RUN["aer_frac"],
        budget=RUN["aer_budget"], interpret=True)
    return (jax.tree.map(lambda a: a[None], g), red,
            jax.tree.map(lambda s: s.residual[None], st, is_leaf=is_st),
            words[None])

res = jax.tree.map(lambda p: jnp.zeros((W,) + p.shape, p.dtype),
                   state.params)
for t in range({rounds!r}):
    b = {{k: jnp.asarray(v) for k, v in data.batch(t).items()}}
    g, red, res, words = jax.jit(reduce)(state.params, res, b)
    flat(g, f"aer{{t}}/grads/")
    flat(red, f"aer{{t}}/red/")
    flat(res, f"aer{{t}}/res/")
    out[f"aer{{t}}/words"] = np.asarray(words)
np.savez({path!r}, **out)
print("REF-DP-OK")
"""


def reference(arch: str, path) -> dict:
    """The reference's runs of ``arch``'s smoke config (float32 compute)
    in every mode and its ``AER_ROUNDS`` reductions, as flat arrays."""
    out = run_with_devices(REF.format(
        arch=arch, world=WORLD, steps=STEPS, modes=MODES, run=RUN,
        seq=SEQ, batch=BATCH, seed=SEED, rounds=AER_ROUNDS,
        path=str(path)), WORLD, timeout=900)
    assert "REF-DP-OK" in out, out
    return dict(np.load(path))


def nest(flat: dict, prefix: str) -> dict:
    """The nested dict under ``prefix`` of ``/``-joined flat keys."""
    out = {}
    for key, v in flat.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = out
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return out


def map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def residual_keys(tree: dict) -> dict:
    """The reference's residual tree -> ``ReferenceLeaves`` keys."""
    out = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                out[f"{prefix}{k}"] = v
    walk(tree, "")
    return out


# --- the port's ranks ---------------------------------------------------

def _worker(rank, world, store_path, out_dir, fn, args):
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        out = fn(rank, *args)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **(out or {}))
    finally:
        dist.destroy_process_group()


def spawn(tmp_path, fn, *args, world: int = WORLD) -> list:
    """Run ``fn(rank, *args)`` on ``world`` gloo ranks; each rank's dict
    of arrays comes back, in rank order."""
    d = tmp_path / f"ranks_{fn.__name__}_{world}"
    d.mkdir()
    mp.spawn(_worker, args=(world, str(d / "store"), str(d), fn, args),
             nprocs=world, join=True)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(world)]


def _port_setup(arch: str, ref_path: str):
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import make_rules
    ref = dict(np.load(ref_path))
    cfg = get_smoke_config(arch).with_(compute_dtype=torch.float32)
    mesh = make_host_mesh(data=WORLD, model=1)
    rules = make_rules(mesh, fsdp=False, kv_heads=cfg.n_kv_heads,
                       d_head=cfg.d_head)
    return ref, cfg, mesh, rules


def parity_rank(rank, arch, ref_path):
    """Every mode for ``STEPS`` steps from the reference's initial
    parameters on its batches (losses, wire words and, on rank 0, the
    parameters), then ``AER_ROUNDS`` aer_topk reductions of the
    reference's own per-device gradients (reduced gradients, residuals
    and wire words of every rank)."""
    from repro_torch import interop
    from repro_torch.configs.base import RunConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.runtime import train_loop as tl
    ref, cfg, mesh, rules = _port_setup(arch, ref_path)
    init = nest(ref, "init/")
    data = SyntheticLM(cfg.vocab, SEQ, BATCH, seed=SEED)
    out = {}
    for mode in MODES:
        model = interop.lm_params_from_reference(init, cfg, device="cpu")
        run = RunConfig(dp_reduce=mode, **RUN)
        state = tl.init_state(model, run)
        step = tl.make_train_step(model, run, rules)
        losses, words = [], []
        for s in range(STEPS):
            b = {k: torch.from_numpy(v) for k, v in data.batch(s).items()}
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            words.append(float(m["wire_words"]))
        out[f"{mode}/loss"] = np.array(losses)
        out[f"{mode}/words"] = np.array(words)
        if rank == 0:
            for k, p in state.params.items():
                out[f"{mode}/params/{k}"] = p.detach().numpy()
    model = interop.lm_params_from_reference(init, cfg, device="cpu")
    leaves = tl.ReferenceLeaves(model)
    aer = leaves.zeros({k: p.detach()
                        for k, p in model.named_parameters()})
    for t in range(AER_ROUNDS):
        mine = map_tree(lambda a: a[rank], nest(ref, f"aer{t}/grads/"))
        grads = {k: torch.from_numpy(np.array(v)) for k, v in
                 interop._lm_leaves(mine, cfg).items()}
        red, aer, words = leaves.aer_reduce(
            grads, aer, mesh.dp_group, frac=RUN["aer_frac"],
            budget=RUN["aer_budget"])
        out[f"aer{t}/words"] = words.numpy()
        # copies: the next round writes the residuals in place
        for k, v in red.items():
            out[f"aer{t}/red/{k}"] = v.numpy().copy()
        for k, st in aer.items():
            out[f"aer{t}/res/{k}"] = st.residual.numpy().copy()
    return out


#: an aer_topk run's parameters: where a gradient entry sits on its
#: block's threshold, a rounding difference can ship it a step earlier
#: or later, which moves that parameter by up to ~2 lr a step (AdamW's
#: first steps are about ±lr): 2 lr over STEPS steps
AER_PARAM_TOL = 2 * RUN["learning_rate"] * STEPS


def check_run(arch, ref: dict, ranks: list, mode: str, loss_tol: float,
              param_tol: float, words_rtol: float) -> None:
    """The port's run in ``mode`` against the reference's: the losses of
    every rank within ``loss_tol``; the parameters within ``param_tol``
    (``aer_topk``: ``AER_PARAM_TOL``); the wire words a step within
    ``words_rtol`` (0 in the dense modes)."""
    from repro_torch import interop
    from repro_torch.configs.base import get_smoke_config
    cfg = get_smoke_config(arch)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"{mode}/loss"], ref[f"{mode}/loss"],
                                   rtol=0, atol=loss_tol, err_msg=(mode, r))
    # the reference reports its first device's count
    np.testing.assert_allclose(ranks[0][f"{mode}/words"],
                               ref[f"{mode}/words"], rtol=words_rtol,
                               err_msg=mode)
    assert (mode == "aer_topk") == bool(ranks[0][f"{mode}/words"].any())
    want = interop._lm_leaves(nest(ref, f"{mode}/params/"), cfg)
    tol = AER_PARAM_TOL if mode == "aer_topk" else param_tol
    for k, w in want.items():
        np.testing.assert_allclose(ranks[0][f"{mode}/params/{k}"],
                                   np.asarray(w), rtol=0, atol=tol,
                                   err_msg=(mode, k))


def check_reduction(arch, ref: dict, ranks: list) -> None:
    """The port's ``aer_topk`` reductions of the reference's own
    per-device gradients: every rank's reduced gradients, residuals
    (in the stacked layout) and wire words exactly the reference's."""
    from repro_torch import interop
    from repro_torch.configs.base import get_smoke_config
    cfg = get_smoke_config(arch)
    for t in range(AER_ROUNDS):
        want_red = interop._lm_leaves(nest(ref, f"aer{t}/red/"), cfg)
        res = nest(ref, f"aer{t}/res/")
        for r, got in enumerate(ranks):
            assert int(got[f"aer{t}/words"]) == int(
                ref[f"aer{t}/words"][r]), (t, r)
            for k, w in want_red.items():
                np.testing.assert_array_equal(got[f"aer{t}/red/{k}"],
                                              np.asarray(w),
                                              err_msg=(t, r, k))
            want_res = residual_keys(map_tree(lambda a: a[r], res))
            assert sorted(want_res) == sorted(
                k[len(f"aer{t}/res/"):] for k in got
                if k.startswith(f"aer{t}/res/")), (t, r)
            for k, w in want_res.items():
                np.testing.assert_array_equal(got[f"aer{t}/res/{k}"], w,
                                              err_msg=(t, r, k))
