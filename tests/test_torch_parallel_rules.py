"""The port's sharding rules (``repro_torch.parallel.sharding``) against
the reference's ``parallel/sharding.py`` on abstract meshes (the
reference's ``jax.sharding.AbstractMesh``, the port's ``Mesh`` without
process groups; no forced devices): the parameter and activation tables
and every spec for fsdp on and off, the heads_kv / kv_seq fallback,
sequence parallelism and overrides; ``shard_activation``; ``LM.
param_axes()`` against the reference's ``init`` axes for every smoke
config; ``state_shardings`` against the reference's specs."""

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.base import ARCH_IDS
from repro.configs.base import RunConfig as RefRunConfig
from repro.configs.base import get_smoke_config as ref_smoke_config
from repro.models.model import build_model as ref_build_model
from repro.models.transformer import n_periods, pattern_for
from repro.parallel import sharding as rs
from repro.runtime.train_loop import init_state as ref_init_state
from repro.runtime.train_loop import state_shardings as ref_state_shardings
from repro_torch.configs.base import RunConfig, get_smoke_config
from repro_torch.models.model import build_model
from repro_torch.parallel import sharding as ps
from repro_torch.parallel.compat import Mesh
from repro_torch.runtime import train_loop as tl

MESHES = (((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((4, 2), ("data", "model")), ((2, 2, 4), ("pod", "data", "model")),
          ((8,), ("data",)))
#: (kv_heads, d_head): both fit a tp of 4; the weights fit and the
#: cache heads do not (kv_seq fallback); neither fits
KV = ((8, 128), (1, 128), (3, 3))
OVERRIDES = (None, {"embed": "model", "ff": None, "act:batch": None,
                    "act:seq_sp": "model", "act:new": ("pod", "data")})
AXES = (("embed", "heads_q"), ("heads_kv", "embed"), ("vocab", "embed"),
        ("none", "mamba_inner"), ("experts", "embed", "ff"), (),
        ("layers", "embed"), (None, "embed"), ("batch", "seq_sp", "embed"),
        ("batch", None, "kv_seq", "heads_kv"), ("unknown",))


def _meshes(shape, names):
    return (AbstractMesh(shape, names),
            Mesh(dict(zip(names, shape, strict=True))))


@pytest.mark.parametrize("overrides", OVERRIDES)
@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("shape,names", MESHES)
def test_make_rules_match_reference(shape, names, kv, overrides):
    rmesh, pmesh = _meshes(shape, names)
    for fsdp in (True, False):
        for sp in (True, False):
            kw = dict(fsdp=fsdp, seq_parallel=sp, kv_heads=kv[0],
                      d_head=kv[1], overrides=overrides)
            r, p = rs.make_rules(rmesh, **kw), ps.make_rules(pmesh, **kw)
            assert p.param_map == r.param_map
            assert p.act_map == r.act_map
            for axes in AXES:
                assert p.param_spec(axes) == r.param_spec(axes), axes
                assert p.act_spec(axes) == r.act_spec(axes), axes
                assert tuple(r.param_spec(axes)) == p.param_spec(axes)
                # the reference builds no NamedSharding that uses a
                # mesh axis twice (experts and ff both on "model") or
                # one the mesh lacks
                used = [a for e in r.param_spec(axes) for a in (
                    e if isinstance(e, tuple) else (e,)) if a is not None]
                if len(used) == len(set(used)) and set(used) <= set(names):
                    assert p.param_sharding(axes).spec == \
                        r.param_sharding(axes).spec


def test_partition_spec_is_a_tuple():
    s = ps.PartitionSpec(("pod", "data"), None)
    assert s == (("pod", "data"), None) and isinstance(s, tuple)
    assert ps.PartitionSpec() == jax.sharding.PartitionSpec()
    m = Mesh({"pod": 2, "data": 4, "model": 2})
    assert ps.NamedSharding(m, s).shards == 8
    assert ps.NamedSharding(m, ps.PartitionSpec(None, "model")).shards == 2
    assert ps.NamedSharding(m, ps.PartitionSpec()).shards == 1


def test_shard_activation_noop_and_rank_check():
    x = torch.zeros(2, 3, 4)
    assert ps.shard_activation(x, ("batch",)) is x        # no rules: no-op
    rules = ps.make_rules(Mesh({"data": 2, "model": 1}))
    rrules = rs.make_rules(AbstractMesh((2, 1), ("data", "model")))
    with ps.use_rules(rules):
        assert ps.current_rules() is rules
        assert ps.shard_activation(x, ("batch", "seq_sp", "embed")) is x
        with pytest.raises(ValueError, match="rank 3"):
            ps.shard_activation(x, ("batch", "embed"))
        with ps.use_rules(None):
            assert ps.shard_activation(x, ("batch",)) is x
    assert ps.current_rules() is None
    # the reference raises on the same mismatch
    with rs.use_rules(rrules):
        with pytest.raises(ValueError, match="rank 3"):
            rs.shard_activation(jax.numpy.zeros((2, 3, 4)),
                                ("batch", "embed"))


def _ref_axes(arch):
    holder = {}

    def init(k):
        p, a = ref_build_model(ref_smoke_config(arch)).init(k)
        holder["a"] = a
        return p
    jax.eval_shape(init, jax.random.PRNGKey(0))
    return holder["a"]


def _leaves(t, prefix=""):
    if not isinstance(t, dict):
        yield prefix[:-1], t
        return
    for k in sorted(t):
        yield from _leaves(t[k], f"{prefix}{k}.")


def _per_layer(tree, arch, fn, top_fn=lambda leaf: leaf):
    """The reference's tree (axes or shardings) by the port's parameter
    names, ``fn`` applied to each stacked leaf (drops its layers axis),
    ``top_fn`` to the others."""
    cfg = ref_smoke_config(arch)
    out = {f"{top}.{path}": top_fn(leaf) for top in tree if top != "stack"
           for path, leaf in _leaves(tree[top])}
    pat = pattern_for(cfg)
    for i in range(len(pat)):
        for path, leaf in _leaves(tree["stack"][f"pos{i}"]):
            for p in range(n_periods(cfg)):
                out[f"stack.blocks.{p * len(pat) + i}.{path}"] = fn(leaf)
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_match_reference(arch):
    ref = _ref_axes(arch)

    def drop_layers(axes):
        assert axes[0] == "layers"
        return axes[1:]
    want = _per_layer(ref, arch, drop_layers)
    model = build_model(get_smoke_config(arch), device="cpu")
    got = model.param_axes()
    assert list(got) == [n for n, _ in model.named_parameters()]
    assert got == want


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "granite_3_2b",
                                  "mixtral_8x22b"])
def test_state_shardings_match_reference(arch, fsdp):
    shape, names = (2, 4), ("data", "model")
    rmesh, pmesh = _meshes(shape, names)
    rcfg = ref_smoke_config(arch)
    rrules = rs.make_rules(rmesh, fsdp=fsdp, kv_heads=rcfg.n_kv_heads,
                           d_head=rcfg.d_head)
    prules = ps.make_rules(pmesh, fsdp=fsdp, kv_heads=rcfg.n_kv_heads,
                           d_head=rcfg.d_head)
    rstate = jax.eval_shape(lambda k: ref_init_state(
        ref_build_model(rcfg), k, RefRunConfig(dp_reduce="aer_topk")),
        jax.random.PRNGKey(0))
    ref = ref_state_shardings(rstate, _ref_axes(arch), rrules)
    model = build_model(get_smoke_config(arch), device="cpu")
    state = tl.init_state(model, RunConfig(dp_reduce="aer_topk"))
    got = tl.state_shardings(state, model.param_axes(), prules)

    def spec(sh):
        return tuple(sh.spec)

    def drop_layers(sh):
        assert sh.spec[0] is None        # the "layers" axis maps to None
        return tuple(sh.spec)[1:]
    for mine, theirs in ((got.params, ref.params),
                         (got.opt.mu, ref.opt.mu), (got.opt.nu, ref.opt.nu)):
        want = _per_layer(theirs, arch, drop_layers, spec)
        assert {k: spec(v) for k, v in mine.items()} == want
    assert spec(got.step) == spec(ref.step) == ()
    assert spec(got.opt.step) == spec(ref.opt.step) == ()
    ref_aer = [spec(s) for s in jax.tree.leaves(ref.aer)]
    assert set(ref_aer) == {()}
    assert len(ref_aer) == len(got.aer)
    assert all(spec(a.residual) == () for a in got.aer.values())
    assert tl.state_shardings(tl.init_state(model, RunConfig()),
                              model.param_axes(), prules).aer is None
