"""The port's collectives over 8 ranks on the CPU: ``torch.distributed``
with the gloo backend, one ``mp.spawn`` of 8 processes a test, rendezvous
through a ``FileStore`` in the test's temporary directory.  Eight is the
reference's own width (``tests/test_collectives.py`` forces 8 host
devices).

The ring schedules and the dense baselines equal the numpy sum / mean of
the ranks' inputs to 1e-5 (the reference's tolerance: the ring adds in
another order than numpy).  The event-sparse all-reduce, over three
steps of error feedback on a two-leaf gradient tree, equals the
reference's ``reduce_gradients(mode="aer_topk")`` run on 8 forced host
devices (its Pallas kernels in interpret mode): residuals and wire words
exactly, the reduced mean exactly too (every peer adds its decoded
tensor in rank order on both sides).
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tests._subproc import run_with_devices

WORLD = 8
RING_SHAPES = ((8, 64), (8, 37), (8, 1), (8, 1024))
#: the AER tree: leaf shapes on one rank (the reference shards a leading
#: axis of 8); "b.w" pads to 3 blocks of 1024
AER_TREE = {"a": (4096,), "b": {"w": (300, 7)}}
AER_STEPS, AER_FRAC, AER_BUDGET = 3, 0.05, 32


def _worker(rank, store_path, out_dir, fn_name, args):
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)
    try:
        out = globals()[fn_name](rank, *args)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, fn_name, *args):
    mp.spawn(_worker, args=(str(tmp_path / "store"), str(tmp_path),
                            fn_name, args), nprocs=WORLD, join=True)
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(WORLD)]


# --- ring schedules and dense baselines ----------------------------------

def _ring_rank(rank):
    from repro_torch.core import halfduplex as hd
    from repro_torch.core import sparse_collectives as sc
    from repro_torch.parallel.compat import axis_index, axis_size
    assert axis_size() == WORLD and axis_index() == rank
    rng = np.random.default_rng(0)
    out = {}
    for shape in RING_SHAPES:
        x = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)[rank])
        k = shape[1]
        out[f"uni{k}"] = hd.ring_allreduce(x).numpy()
        out[f"bi{k}"] = hd.ring_allreduce(x, bidirectional=True).numpy()
        for sched in ("psum", "ring", "bidir_ring"):
            out[f"{sched}{k}"] = sc.dense_allreduce(x, schedule=sched).numpy()
    # every rank holds [0..7]: reduce-scatter leaves 8 * i on rank i,
    # in either direction
    ar = torch.arange(8.0)
    out["rs"] = hd.ring_reduce_scatter(ar).numpy()
    out["rs_rev"] = hd.ring_reduce_scatter(ar, reverse=True).numpy()
    own = torch.tensor([rank, 100 + rank], dtype=torch.int32)
    out["ag"] = hd.ring_all_gather(own).numpy()
    out["ag_rev"] = hd.ring_all_gather(own, reverse=True).numpy()
    # a 2-d tensor keeps its shape and dtype
    m = torch.full((3, 5), float(rank), dtype=torch.float64)
    out["mat"] = hd.ring_allreduce(m, bidirectional=True).numpy()
    return out


def test_ring_schedules_equal_numpy_sum(tmp_path):
    ranks = _spawn(tmp_path, "_ring_rank")
    rng = np.random.default_rng(0)
    for shape in RING_SHAPES:
        x = rng.standard_normal(shape).astype(np.float32)
        k = shape[1]
        for r, got in enumerate(ranks):
            for key in (f"uni{k}", f"bi{k}"):
                assert got[key].shape == (k,), key
                np.testing.assert_allclose(got[key], x.sum(0), rtol=1e-5,
                                           atol=1e-5, err_msg=key)
            for sched in ("psum", "ring", "bidir_ring"):
                np.testing.assert_allclose(got[f"{sched}{k}"], x.mean(0),
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=sched)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["rs"], [8.0 * r])
        np.testing.assert_array_equal(got["rs_rev"], [8.0 * r])
        want = np.array([[i, 100 + i] for i in range(WORLD)]).reshape(-1)
        np.testing.assert_array_equal(got["ag"], want)
        np.testing.assert_array_equal(got["ag_rev"], want)
        assert got["mat"].dtype == np.float64
        np.testing.assert_array_equal(got["mat"], np.full((3, 5), 28.0))


# --- the event-sparse all-reduce against the reference -------------------

def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}.")]
    return [prefix[:-1]]


def _leaf_shapes():
    flat = {"a": AER_TREE["a"], "b.w": AER_TREE["b"]["w"]}
    assert sorted(flat) == _leaf_names(AER_TREE)
    return flat


def _aer_inputs():
    rng = np.random.default_rng(7)
    return {f"g{t}/{n}": rng.standard_normal((WORLD,) + s).astype(
        np.float32) for t in range(AER_STEPS)
        for n, s in _leaf_shapes().items()}


REF_AER = r"""
import jax, jax.numpy as jnp, numpy as np
from functools import partial
from jax.sharding import PartitionSpec as P
from repro.core import sparse_collectives as sc
from repro.parallel.compat import AXIS_TYPE_AUTO, make_mesh, shard_map

inp = dict(np.load({inp!r}))
mesh = make_mesh((8,), ("data",), axis_types=(AXIS_TYPE_AUTO,))
spec = {{"a": P("data"), "b": {{"w": P("data")}}}}
is_st = lambda z: isinstance(z, sc.AerState)

@partial(shard_map, check_vma=False, mesh=mesh, in_specs=(spec, spec),
         out_specs=(spec, spec, P("data")))
def step(g, res):
    g = jax.tree.map(lambda a: a[0], g)
    st = jax.tree.map(lambda a: sc.AerState(a[0]), res)
    red, st, words = sc.reduce_gradients(
        g, st, "data", mode="aer_topk", frac={frac!r}, budget={budget!r},
        interpret=True)
    return (jax.tree.map(lambda a: a[None], red),
            jax.tree.map(lambda s: s.residual[None], st, is_leaf=is_st),
            words[None])

res = {{"a": jnp.zeros((8, 4096)), "b": {{"w": jnp.zeros((8, 300, 7))}}}}
out = {{}}
for t in range({steps!r}):
    g = {{"a": inp[f"g{{t}}/a"], "b": {{"w": inp[f"g{{t}}/b.w"]}}}}
    red, res, words = step(g, res)
    for name, r, s in (("a", red["a"], res["a"]),
                       ("b.w", red["b"]["w"], res["b"]["w"])):
        out[f"red{{t}}/{{name}}"] = np.asarray(r)
        out[f"res{{t}}/{{name}}"] = np.asarray(s)
    out[f"words{{t}}"] = np.asarray(words)
np.savez({out!r}, **out)
print("REF-AER-OK")
"""


def _aer_rank(rank, inp_path):
    from repro_torch.core import sparse_collectives as sc
    from repro_torch.kernels import ops as K
    from _torch_cases import clear_of_tau
    inp = dict(np.load(inp_path))
    shapes = _leaf_shapes()
    res = sc.init_aer_states({"a": torch.zeros(shapes["a"]),
                              "b": {"w": torch.zeros(shapes["b.w"])}})
    out = {}
    for t in range(AER_STEPS):
        g = {n: torch.from_numpy(inp[f"g{t}/{n}"][rank]) for n in shapes}
        tree = {"a": g["a"], "b": {"w": g["b.w"]}}
        # no entry within one ulp of its block's threshold, so the
        # selection cannot hinge on the threshold's last bit
        clear = True
        for leaf, st in ((g["a"], res["a"]), (g["b.w"], res["b"]["w"])):
            tiles, _ = K.pad_to_blocks(leaf + st.residual)
            clear &= clear_of_tau(tiles, K.tau_from_fraction(tiles,
                                                             AER_FRAC))
        red, res, words = sc.reduce_gradients(
            tree, res, mode="aer_topk", frac=AER_FRAC, budget=AER_BUDGET)
        assert words.dtype == torch.int32
        out[f"clear{t}"] = np.array(clear)
        out[f"words{t}"] = words.numpy()
        for n, r, s in (("a", red["a"], res["a"]),
                        ("b.w", red["b"]["w"], res["b"]["w"])):
            out[f"red{t}/{n}"] = r.numpy()
            out[f"res{t}/{n}"] = s.residual.numpy()
    return out


def test_aer_allreduce_matches_reference(tmp_path):
    inp_path = str(tmp_path / "inputs.npz")
    np.savez(inp_path, **_aer_inputs())
    ref_path = str(tmp_path / "reference.npz")
    log = run_with_devices(REF_AER.format(
        inp=inp_path, out=ref_path, frac=AER_FRAC, budget=AER_BUDGET,
        steps=AER_STEPS), WORLD)
    assert "REF-AER-OK" in log
    want = dict(np.load(ref_path))
    ranks = _spawn(tmp_path, "_aer_rank", inp_path)
    shipped = 0
    for t in range(AER_STEPS):
        for r, got in enumerate(ranks):
            assert bool(got[f"clear{t}"]), (t, r)
            assert int(got[f"words{t}"]) == int(want[f"words{t}"][r])
            for n in _leaf_shapes():
                np.testing.assert_array_equal(got[f"res{t}/{n}"],
                                              want[f"res{t}/{n}"][r])
                np.testing.assert_array_equal(got[f"red{t}/{n}"],
                                              want[f"red{t}/{n}"][r])
                # every rank holds the same reduced tensor
                np.testing.assert_array_equal(got[f"red{t}/{n}"],
                                              ranks[0][f"red{t}/{n}"])
            shipped += int(got[f"words{t}"])
    # the budget binds: 7 blocks a rank, at most 32 words each
    assert 0 < shipped <= AER_STEPS * WORLD * 7 * AER_BUDGET


@pytest.mark.parametrize("mode", ["psum", "ring", "bidir_ring"])
def test_reduce_gradients_dense_modes_world_of_one(mode, tmp_path):
    """One rank (gloo, in this process's own spawn): the dense modes hand
    back the gradients (mean over one rank), the states untouched and 0
    words; ``aer_topk`` conserves exactly."""
    mp.spawn(_one_rank, args=(str(tmp_path / "store1"), mode), nprocs=1,
             join=True)


def _one_rank(rank, store_path, mode):
    from repro_torch.core import sparse_collectives as sc
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 1),
                            rank=0, world_size=1)
    try:
        g = {"x": torch.arange(5.0), "y": {"z": torch.ones(2, 3)}}
        st = sc.init_aer_states(g)
        out, st2, words = sc.reduce_gradients(g, st, mode=mode)
        assert st2 is st and int(words) == 0
        assert torch.equal(out["x"], g["x"]) and \
            torch.equal(out["y"]["z"], g["y"]["z"])
        red, st3, w = sc.reduce_gradients(g, st, mode="aer_topk", frac=0.5,
                                          budget=2)
        for k in ("x",):
            assert torch.equal(red[k] + st3[k].residual, g[k])
        assert torch.equal(red["y"]["z"] + st3["y"]["z"].residual,
                           g["y"]["z"])
        assert int(w) == 4          # two words a leaf
        with pytest.raises(ValueError, match="unknown mode"):
            sc.reduce_gradients(g, st, mode="allgather")
    finally:
        dist.destroy_process_group()
