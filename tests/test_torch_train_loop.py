"""The trainer of the port on ``device="cpu"``: ``make_train_step``
against the reference's (three steps from the reference's state and
batches, granite and falcon-mamba smoke configs in float32 compute), the
gradients and the AdamW update held apart, ``grad_accum`` 2 with its
last-microbatch metrics, and the ports of the reference's
``tests/test_checkpoint_fault.py`` (``TestCheckpointer``,
``TestFaultTolerance``): bit-identical replay after failures, a failure
before any checkpoint, the straggler EMA, the restart bound; then the
in-place trap of the checkpointer and ``launch.train.main``.

Tolerances: each metric within 1e-5 relative (+1e-7) of the reference's
each step (float32 sums in another order; the losses agree bit for bit
on these configs, the gradient norm within ~1e-7).  Parameters after a
step are NOT held tight where a gradient is near 0: at step 1
``mhat / sqrt(vhat)`` is ±1, so a one-ulp gradient of the other sign
moves a parameter by 2·lr (the reference's own
``tests/test_train_modes.py`` says so).  The update is held apart
instead, fed the reference's gradients: within 1e-6."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as RefRunConfig
from repro.configs.base import get_smoke_config as ref_smoke_config
from repro.data import SyntheticLM
from repro.models.model import build_model as ref_build_model
from repro.optim import adamw as radamw
from repro.runtime.train_loop import init_state as ref_init_state
from repro.runtime.train_loop import make_train_step as ref_make_step
from repro_torch import interop
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import RunConfig, get_smoke_config
from repro_torch.launch import train
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.runtime import train_loop as tl
from repro_torch.runtime.fault import (FailureInjector, SimulatedFailure,
                                       StragglerMonitor, run_with_restarts)

METRIC_TOL = 1e-5
CPU = "cpu"


def _run_cfg(**kw):
    return dict(learning_rate=1e-3, warmup_steps=2, total_steps=30, **kw)


def _f32(arch):
    return (ref_smoke_config(arch).with_(compute_dtype=jnp.float32),
            get_smoke_config(arch).with_(compute_dtype=torch.float32))


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _close(got, want, what):
    assert abs(got - want) <= METRIC_TOL * abs(want) + 1e-7, (what, got,
                                                              want)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ["granite_3_2b", "falcon_mamba_7b"])
def test_steps_match_reference(arch, accum):
    """Three steps (two with ``grad_accum`` 2) from the reference's state
    on its batches: every metric each step."""
    rcfg, pcfg = _f32(arch)
    rmodel = ref_build_model(rcfg)
    rrun = RefRunConfig(**_run_cfg(grad_accum=accum))
    rstate = ref_init_state(rmodel, jax.random.PRNGKey(0), rrun)
    model, pstate = interop.train_state_from_reference(rstate, pcfg,
                                                       device=CPU)
    rstep = ref_make_step(rmodel, rrun)
    pstep = tl.make_train_step(model, RunConfig(**_run_cfg(
        grad_accum=accum)))
    data = SyntheticLM(rcfg.vocab, 16, 4, seed=2)
    for s in range(3 if accum == 1 else 2):
        b = data.batch(s)
        rstate, rm = rstep(rstate, {k: jnp.asarray(v) for k, v in b.items()})
        pstate, pm = pstep(pstate, _torch_batch(b))
        assert set(pm) == set(tl.METRIC_KEYS)
        for k in tl.METRIC_KEYS:
            assert pm[k].dtype == torch.float32 and pm[k].dim() == 0, k
            _close(float(pm[k]), float(rm[k]), (s, k))
        assert int(pstate.step) == int(rstate.step) == s + 1
        assert int(pstate.opt.step) == int(rstate.opt.step)


def test_grad_accum_reports_last_microbatch_metrics():
    """With ``grad_accum`` 2 the step's metrics are the second
    microbatch's, as the reference reports them (its loss is averaged
    over both for the gradient, not for the metrics)."""
    _, pcfg = _f32("falcon_mamba_7b")
    model = build_model(pcfg, seed=3, device=CPU)
    batch = _torch_batch(SyntheticLM(pcfg.vocab, 16, 4, seed=2).batch(0))
    with torch.no_grad():
        _, last = model.loss({k: v[2:] for k, v in batch.items()})
        _, first = model.loss({k: v[:2] for k, v in batch.items()})
    run = RunConfig(**_run_cfg(grad_accum=2))
    state = tl.init_state(model, run)
    _, m = tl.make_train_step(model, run)(state, batch)
    for k in ("nll", "loss"):
        assert torch.equal(m[k], last[k].float()), k
        assert not torch.equal(m[k], first[k].float()), k


def test_gradients_and_update_held_apart():
    """The gradients of one step against ``jax.grad``; then the AdamW
    update fed the reference's gradients against the reference's."""
    rcfg, pcfg = _f32("granite_3_2b")
    rmodel = ref_build_model(rcfg)
    rrun = RefRunConfig(**_run_cfg())
    rstate = ref_init_state(rmodel, jax.random.PRNGKey(1), rrun)
    model, pstate = interop.train_state_from_reference(rstate, pcfg,
                                                       device=CPU)
    b = SyntheticLM(rcfg.vocab, 16, 4, seed=2).batch(0)
    rgrads = jax.jit(jax.grad(lambda p, bb: rmodel.loss(p, bb)[0]))(
        rstate.params, {k: jnp.asarray(v) for k, v in b.items()})
    tl._loss_with_accum(model, _torch_batch(b), 1)
    want = interop._lm_leaves(rgrads, pcfg)
    for name, p in pstate.params.items():
        w = np.asarray(want[name])
        assert np.abs(p.grad.numpy() - w).max() <= \
            1e-5 * np.abs(w).max() + 1e-7, name
    lr = 1e-3
    new_r, _, gn_r = radamw.update(rgrads, rstate.opt, rstate.params, lr=lr)
    with torch.no_grad():
        grads = {k: torch.from_numpy(np.array(want[k]))
                 for k in pstate.params}
        new_p, _, gn_p = adamw.update(grads, pstate.opt, pstate.params,
                                      lr=lr)
    assert abs(float(gn_p) - float(gn_r)) <= 2 * np.spacing(np.float32(gn_r))
    want_p = interop._lm_leaves(new_r, pcfg)
    for name, p in new_p.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(want_p[name]), rtol=0,
                                   atol=1e-6)


def test_state_holds_the_models_parameters():
    _, pcfg = _f32("granite_3_2b")
    model = build_model(pcfg, seed=0, device=CPU)
    state = tl.init_state(model, RunConfig())
    own = dict(model.named_parameters())
    assert all(state.params[k] is p and p.requires_grad
               for k, p in own.items())
    assert state.aer is None and int(state.step) == 0
    step = tl.make_train_step(model, RunConfig(**_run_cfg()))
    other = build_model(pcfg, seed=0, device=CPU)
    foreign = tl.init_state(other, RunConfig())
    batch = _torch_batch(SyntheticLM(pcfg.vocab, 16, 4, seed=2).batch(0))
    with pytest.raises(ValueError, match="own parameters"):
        step(foreign, batch)
    aer = tl.init_state(build_model(pcfg, seed=0, device=CPU),
                        RunConfig(dp_reduce="aer_topk"))
    # one residual a reference leaf (the stack's stacked over periods)
    assert set(aer.aer) == set(tl.ReferenceLeaves(model).members)
    assert set(aer.aer) >= {"embed.table", "stack.pos0.attn.wq.w"}


def test_data_parallel_paths_wait_for_a11c():
    """The data-parallel step, ``state_shardings`` and ``--mesh-data``
    came with A.11c, a model axis and FSDP with A.11d
    (``tests/test_torch_train_dp*.py`` and ``test_torch_train_tp*.py``
    run them on gloo ranks).  Here, in one process: every rank's shards
    of a (2, 2) FSDP mesh put back together give each whole leaf, and
    Mamba's ``in_proj`` shard holds the same channels of ``x`` and ``z``;
    on an abstract mesh (sequence-parallel rules too, which the step
    runs since A.11e, ``tests/test_torch_train_sp*.py``) the step is rank
    0's, the dry-run's program, whose collectives only a cost counter
    records (without one they raise); ``--mesh-data`` past the world is
    refused."""
    from repro_torch.parallel.compat import Mesh
    from repro_torch.parallel.sharding import make_rules, mesh_axes
    from repro_torch.parallel.tensor_parallel import shard_param
    _, pcfg = _f32("granite_3_2b")
    model = build_model(pcfg, seed=0, device=CPU)
    mesh = Mesh({"data": 2, "model": 2})
    rules = make_rules(mesh, fsdp=True, kv_heads=pcfg.n_kv_heads,
                       d_head=pcfg.d_head)
    split = 0
    for name, axes in model.param_axes().items():
        sh = rules.param_sharding(axes)
        whole = dict(model.named_parameters())[name].detach()
        parts = {r: shard_param(whole, sh.spec, mesh, r) for r in range(4)}
        axes_of = [mesh_axes((e,)) for e in sh.spec]
        # concatenate along each split dimension, model inside data
        rows = [parts[2 * d + m] for d in range(2) for m in range(2)]
        dm = next((i for i, a in enumerate(axes_of) if a == {"model"}),
                  None)
        dd = next((i for i, a in enumerate(axes_of) if a == {"data"}),
                  None)
        if dm is not None:
            rows = [torch.cat(rows[i:i + 2], dm) for i in (0, 2)]
        else:
            rows = rows[::2]
        back = torch.cat(rows, dd) if dd is not None else rows[0]
        assert torch.equal(back, whole), name
        split += sh.shards > 1
    assert split == len(model.param_axes())      # FSDP splits every leaf
    _, fcfg = _f32("falcon_mamba_7b")
    falcon = build_model(fcfg, seed=0, device=CPU)
    w = falcon.stack.blocks[0].mamba.in_proj.detach()
    frules = make_rules(Mesh({"data": 1, "model": 2}))
    sh = frules.param_sharding(falcon.param_axes()[
        "stack.blocks.0.mamba.in_proj"])
    d_in = w.shape[1] // 2
    assert sh.groups == (1, 2)
    assert torch.equal(shard_param(w, sh.spec, frules.mesh, 1, sh.groups),
                       torch.cat([w[:, d_in // 2:d_in],
                                  w[:, d_in + d_in // 2:]], 1))
    batch = {k: torch.zeros((2, 8), dtype=torch.int32)
             for k in ("tokens", "labels")}
    for mesh, kw in (({"data": 1, "model": 2}, {"seq_parallel": True}),
                     ({"data": 2, "model": 1}, {"fsdp": False})):
        rank0 = build_model(pcfg, seed=0, device=CPU)
        r = make_rules(Mesh(mesh), **kw)
        step = tl.make_train_step(rank0, RunConfig(), rules=r)
        par = rank0.parallel
        assert (par.rank, par.tp_rank, par.dp_rank) == (0, 0, 0)
        assert (par.tp, par.dp) == (mesh["model"], mesh["data"])
        with pytest.raises(RuntimeError, match="Counter"):
            step(tl.init_state(rank0, RunConfig(), r), batch)
    state = tl.init_state(model, RunConfig())
    sh = tl.state_shardings(state, model.param_axes(), make_rules(
        Mesh({"data": 2, "model": 1}), fsdp=False))
    assert all(s.shards == 1 for s in sh.params.values())
    with pytest.raises(ValueError, match="needs 2 processes"):
        train.main(["--arch", "granite_3_2b", "--smoke", "--device", "cpu",
                    "--mesh-data", "2"])


# --- the reference's tests/test_checkpoint_fault.py, carried over --------

@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config("granite_3_2b")
    run_cfg = RunConfig(learning_rate=1e-3, warmup_steps=2, total_steps=30)
    data = SyntheticLM(cfg.vocab, 16, 4, seed=2)

    class TorchData:
        def batch(self, s):
            return _torch_batch(data.batch(s))

    return cfg, run_cfg, TorchData()


def _fresh(cfg, run_cfg, seed=0):
    """A model drawn from ``seed``, its state and its step: the state's
    parameters are the model's, so every run takes a model of its own."""
    model = build_model(cfg, seed=seed, device=CPU)
    return tl.init_state(model, run_cfg), tl.make_train_step(model, run_cfg)


class TestCheckpointer:
    def test_save_restore_roundtrip(self, setup, tmp_path):
        cfg, run_cfg, _ = setup
        state, _ = _fresh(cfg, run_cfg)
        ck = Checkpointer(str(tmp_path))
        ck.save(3, state, blocking=True)
        assert ck.latest_step() == 3
        saved = {k: p.detach().clone() for k, p in state.params.items()}
        restored = ck.restore(3, state)
        for k, p in restored.params.items():
            assert torch.equal(p, saved[k])
        with open(tmp_path / "step_00000003" / "manifest.json") as f:
            man = json.load(f)
        assert "params/embed.table" in man["keys"]
        assert {"opt/step", "step", "opt/mu/ln_f.scale",
                "opt/nu/head.w"} <= set(man["keys"])
        assert man["dtypes"]["step"] == "int32"

    def test_save_copies_before_in_place_updates(self, setup, tmp_path):
        """The optimiser updates the state in place right after an async
        save returns; the checkpoint must still hold the saved values."""
        cfg, run_cfg, data = setup
        state, step = _fresh(cfg, run_cfg)
        ck = Checkpointer(str(tmp_path))
        saved = {k: p.detach().clone() for k, p in state.params.items()}
        ck.save(1, state)
        state, _ = step(state, data.batch(0))
        with torch.no_grad():
            for p in state.params.values():
                p.add_(1.0)
        ck.wait()
        restored = ck.restore(1, state)
        for k, p in restored.params.items():
            assert torch.equal(p, saved[k]), k
        assert int(restored.step) == 0
        assert all(not v.any() for v in restored.opt.mu.values())

    def test_async_save_and_gc_keeps_n(self, setup, tmp_path):
        cfg, run_cfg, _ = setup
        state, _ = _fresh(cfg, run_cfg, seed=1)
        ck = Checkpointer(str(tmp_path), keep=2)
        for s in (1, 2, 3, 4):
            ck.save(s, state)
        ck.wait()
        ck._gc()
        assert ck.all_steps() == [3, 4]

    def test_atomic_no_partial_on_existing(self, setup, tmp_path):
        cfg, run_cfg, _ = setup
        state, _ = _fresh(cfg, run_cfg, seed=1)
        ck = Checkpointer(str(tmp_path))
        ck.save(1, state, blocking=True)
        # a tmp dir left behind (simulated crash) is never listed
        os.makedirs(tmp_path / ".tmp_step_9_123", exist_ok=True)
        assert ck.all_steps() == [1]

    def test_elastic_reshard_restore_waits_for_a11c(self, setup, tmp_path):
        """``restore(shardings=)`` came with A.11c (replicated leaves
        load whole) and A.11d: a spec that splits a leaf cuts it to this
        process's shard (rank 0 outside a process group), each restored
        leaf bit-equal to that shard of the saved one; a leaf without a
        sharding is refused."""
        from repro_torch.parallel.compat import Mesh
        from repro_torch.parallel.sharding import make_rules
        from repro_torch.parallel.tensor_parallel import shard_param
        cfg, run_cfg, _ = setup
        state, _ = _fresh(cfg, run_cfg)
        ck = Checkpointer(str(tmp_path))
        ck.save(1, state, blocking=True)
        model = build_model(cfg, seed=1, device=CPU)
        other = tl.init_state(model, run_cfg)
        mesh = Mesh({"data": 2, "model": 1})
        rep = tl.state_shardings(other, model.param_axes(),
                                 make_rules(mesh, fsdp=False))
        ck.restore(1, other, shardings=rep)
        assert all(torch.equal(p, other.params[k])
                   for k, p in state.params.items())
        sharded = tl.state_shardings(other, model.param_axes(),
                                     make_rules(mesh, fsdp=True))

        def cut(t, sh):
            return shard_param(t.detach(), sh.spec, mesh, 0, sh.groups)

        target = tl.TrainState(
            params={k: torch.empty_like(cut(p, sharded.params[k]))
                    for k, p in other.params.items()},
            opt=adamw.AdamWState(
                step=torch.zeros((), dtype=torch.int32),
                mu={k: torch.empty_like(cut(v, sharded.opt.mu[k]))
                    for k, v in other.opt.mu.items()},
                nu={k: torch.empty_like(cut(v, sharded.opt.nu[k]))
                    for k, v in other.opt.nu.items()}),
            aer=None, step=torch.zeros((), dtype=torch.int32))
        ck.restore(1, target, shardings=sharded)
        assert any(sh.shards > 1 for sh in sharded.params.values())
        for k, p in state.params.items():
            assert torch.equal(target.params[k], cut(p, sharded.params[k]))
            assert target.params[k].shape != p.shape or \
                sharded.params[k].shards == 1, k
        with pytest.raises(ValueError, match="no sharding"):
            ck.restore(1, state, shardings={})

    def test_restore_checks_shapes(self, setup, tmp_path):
        cfg, run_cfg, _ = setup
        state, _ = _fresh(cfg, run_cfg)
        ck = Checkpointer(str(tmp_path))
        ck.save(1, state, blocking=True)
        wide, _ = _fresh(cfg.with_(d_ff=cfg.d_ff * 2), run_cfg)
        with pytest.raises(ValueError, match="shape"):
            ck.restore(1, wide)


class TestFaultTolerance:
    def test_restart_replay_is_bitwise_identical(self, setup, tmp_path):
        cfg, run_cfg, data = setup
        s0, step = _fresh(cfg, run_cfg)
        clean, _ = run_with_restarts(
            n_steps=20, state=s0, train_step=step, data=data,
            ckpt=Checkpointer(str(tmp_path / "a")), checkpoint_every=5)
        s0, step = _fresh(cfg, run_cfg)
        faulty, info = run_with_restarts(
            n_steps=20, state=s0, train_step=step, data=data,
            ckpt=Checkpointer(str(tmp_path / "b")), checkpoint_every=5,
            injector=FailureInjector(frozenset({7, 13, 18})))
        assert info["restarts"] == 3
        assert int(faulty.step) == int(clean.step) == 20
        for k, p in clean.params.items():
            assert torch.equal(p, faulty.params[k]), k
            assert torch.equal(clean.opt.nu[k], faulty.opt.nu[k]), k

    def test_failure_before_checkpoint_is_fatal(self, setup, tmp_path):
        cfg, run_cfg, data = setup
        s0, step = _fresh(cfg, run_cfg)
        with pytest.raises(SimulatedFailure):
            run_with_restarts(
                n_steps=10, state=s0, train_step=step, data=data,
                ckpt=Checkpointer(str(tmp_path)), checkpoint_every=0,
                injector=FailureInjector(frozenset({2})))

    def test_straggler_monitor_flags_outliers(self):
        mon = StragglerMonitor(threshold=2.0, alpha=0.5)
        for s in range(10):
            assert not mon.record(s, 1.0)
        assert mon.record(10, 5.0)          # 5x the EMA
        assert len(mon.events) == 1
        assert mon.ema == pytest.approx(1.0)  # outlier didn't poison EMA

    def test_max_restarts_bound(self, setup, tmp_path):
        cfg, run_cfg, data = setup
        s0, step = _fresh(cfg, run_cfg)

        class AlwaysFail:
            def check(self, step):
                raise SimulatedFailure("flaky node")

        with pytest.raises(SimulatedFailure):
            run_with_restarts(
                n_steps=10, state=s0, train_step=step, data=data,
                ckpt=Checkpointer(str(tmp_path)), checkpoint_every=1,
                injector=AlwaysFail(), max_restarts=3)


# --- the entry point --------------------------------------------------------

def test_launch_train_main_runs_restarts_and_learns(tmp_path, capsys):
    """``python -m repro_torch.launch.train --smoke --device cpu``: 20
    steps with a checkpoint every 10 and a failure at step 13 restart
    once, and the loss of the last 5 steps is below that of the first 5
    (bit-identical replay is ``TestFaultTolerance``'s)."""
    losses = {}
    state, info = train.main(
        ["--arch", "falcon_mamba_7b", "--smoke", "--device", "cpu",
         "--steps", "20", "--batch", "4", "--seq", "32", "--lr", "3e-3",
         "--checkpoint-every", "10", "--fail-at", "13", "--log-every",
         "10", "--checkpoint-dir", str(tmp_path)],
        on_metrics=lambda s, m: losses.__setitem__(s, float(m["loss"])))
    assert info["restarts"] == 1 and int(state.step) == 20
    assert sorted(losses) == list(range(1, 21))
    assert np.mean([losses[s] for s in range(16, 21)]) < \
        np.mean([losses[s] for s in range(1, 6)])
    out = capsys.readouterr().out
    assert "falcon-mamba-7b" in out and "restarts=1" in out
    assert info["model"].cfg.n_layers == info["cfg"].n_layers


def test_launch_train_layers_cut_is_stated(capsys, tmp_path):
    state, info = train.main(["--arch", "granite_3_2b", "--smoke", "--device",
                              "cpu", "--steps", "2", "--batch", "2", "--seq",
                              "16", "--layers", "1", "--checkpoint-dir",
                              str(tmp_path)])
    assert info["cfg"].n_layers == 1
    assert "depth cut from 2 to 1 layers" in capsys.readouterr().out


def test_quickstart_example_trains_and_serves_on_cpu():
    """``examples/torch_quickstart.py`` trains a smoke model and serves
    from it with no autograd graph."""
    import pathlib
    import runpy
    root = pathlib.Path(__file__).resolve().parents[1] / "examples"
    quick = runpy.run_path(str(root / "torch_quickstart.py"))
    losses, tokens = quick["main"](["granite_3_2b", "--device", CPU,
                                    "--steps", "6"])
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert tokens.shape == (2, 8) and not tokens.requires_grad


def test_train_state_from_reference_carries_every_leaf():
    """``interop.train_state_from_reference`` on an ``aer_topk`` state:
    parameters by name with gradients on, zero float32 moments and AER
    residuals for every parameter, int32 host step counters."""
    rcfg, pcfg = _f32("falcon_mamba_7b")
    rstate = ref_init_state(ref_build_model(rcfg), jax.random.PRNGKey(2),
                            RefRunConfig(dp_reduce="aer_topk"))
    model, state = interop.train_state_from_reference(rstate, pcfg,
                                                      device=CPU)
    own = dict(model.named_parameters())
    want = interop._lm_leaves(rstate.params, pcfg)
    assert set(state.params) == set(own) == set(want)
    for k, p in own.items():
        assert state.params[k] is p and p.requires_grad
        np.testing.assert_array_equal(p.detach().numpy(),
                                      np.asarray(want[k]))
        for t in (state.opt.mu[k], state.opt.nu[k]):
            assert t.dtype == torch.float32 and t.shape == p.shape
            assert not t.any()
    # the residuals in the data-parallel step's layout: one a reference
    # leaf, the stack's stacked over periods as the reference holds them
    members = tl.ReferenceLeaves(model).members
    assert set(state.aer) == set(members)
    for k, names in members.items():
        t = state.aer[k].residual
        shape = own[k].shape if names is None else \
            (len(names), *own[names[0]].shape)
        assert t.dtype == torch.float32 and t.shape == shape
        assert not t.any()
    assert state.step.dtype == state.opt.step.dtype == torch.int32
    assert int(state.step) == int(state.opt.step) == 0
