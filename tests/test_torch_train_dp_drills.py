"""The port's data-parallel drills on gloo ranks of the CPU
(``tests/_torch_dp.py``), the port's counterparts of the reference's
``tests/test_train_modes.py`` and ``tests/test_elastic.py`` (which fail
under this JAX, ROADMAP queue C) and of its launcher's ``--mesh-data``:

- ``aer_topk`` tracks ``psum``: 12 steps of granite-3-2b's smoke config
  on 4 ranks, the last losses within the reference's 0.35;
- elastic: 8 steps on 4 ranks, a checkpoint, a new fleet of 2 ranks
  restores it onto its own mesh through ``state_shardings`` (bit-equal
  to what was saved), trains 8 more steps, and ends with finite losses
  no more than 0.5 above the first (the reference's bounds);
- restarts under a group: ``launch.train.main`` on 2 ranks with
  failures injected at steps 4 and 7 (bit-equal to a clean run under
  ``bidir_ring``; under ``aer_topk`` every rank restores rank 0's
  residuals, as the reference does);
- the launcher under ``torchrun`` (2 processes, ``--mesh-data 2
  --device cpu``), printing from rank 0 only;
- the refusals, and what took their place: rows that do not split over
  the ranks and ``--mesh-data`` other than the world's size are
  refused; an abstract mesh gives rank 0's step, whose collectives
  raise without a cost counter to record them; sequence parallelism
  (ROADMAP A.11e) trains; a model
  axis past 1 and a spec that splits a parameter (FSDP) now train (a
  step's loss equal to the data-only step's on the same rows), a whole
  checkpoint restores onto FSDP shards (each leaf bit-equal to its
  shard), jamba's hybrid block kinds build a step on a model axis, a
  sharded model scores (its logits within 1e-5 of the whole
  model's), and query heads that do not split over the model axis (3
  on 2 ranks) train, every rank running all of them (loss within 1e-5
  and gradient norm within 1e-5 relative of the world of one's).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_dp as D

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACK_STEPS = 12
#: the reference's bound on aer_topk's last loss against psum's
TRACK_TOL = 0.35


def _granite(run_kw, seed=0):
    from repro_torch.configs.base import RunConfig, get_smoke_config
    from repro_torch.models.model import build_model
    cfg = get_smoke_config("granite_3_2b")
    return cfg, RunConfig(**run_kw), build_model(cfg, seed=seed,
                                                 device="cpu")


def _rules(cfg, data, model=1, fsdp=False):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import make_rules
    mesh = make_host_mesh(data=data, model=model)
    return mesh, make_rules(mesh, fsdp=fsdp, kv_heads=cfg.n_kv_heads,
                            d_head=cfg.d_head)


def _batches(cfg, seed):
    from repro_torch.data import SyntheticLM
    data = SyntheticLM(cfg.vocab, 16, 8, seed=seed)
    return lambda s: {k: torch.from_numpy(v)
                      for k, v in data.batch(s).items()}


def _track_rank(rank):
    from repro_torch.runtime import train_loop as tl
    out = {}
    for mode in ("psum", "aer_topk"):
        cfg, run, model = _granite(dict(
            learning_rate=1e-3, warmup_steps=2, total_steps=TRACK_STEPS,
            dp_reduce=mode, aer_frac=0.1, aer_budget=256, fsdp=False))
        _, rules = _rules(cfg, D.WORLD)
        state = tl.init_state(model, run)
        step = tl.make_train_step(model, run, rules)
        batch = _batches(cfg, 7)
        losses = []
        for s in range(TRACK_STEPS):
            state, m = step(state, batch(s))
            losses.append(float(m["loss"]))
        out[mode] = np.array(losses)
    return out


def test_aer_topk_tracks_psum(tmp_path):
    ranks = D.spawn(tmp_path, _track_rank)
    for got in ranks:
        np.testing.assert_array_equal(got["psum"], ranks[0]["psum"])
        np.testing.assert_array_equal(got["aer_topk"], ranks[0]["aer_topk"])
    l_psum, l_aer = ranks[0]["psum"], ranks[0]["aer_topk"]
    assert np.isfinite(l_aer).all() and np.isfinite(l_psum).all()
    assert abs(l_aer[-1] - l_psum[-1]) < TRACK_TOL, (l_aer, l_psum)


ELASTIC_RUN = dict(learning_rate=1e-3, warmup_steps=2, total_steps=16,
                   dp_reduce="bidir_ring", fsdp=False)


def _elastic_first(rank, ckpt_dir):
    """4 ranks: 8 steps, then a checkpoint at step 8."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.runtime import train_loop as tl
    cfg, run, model = _granite(ELASTIC_RUN)
    mesh, rules = _rules(cfg, 4)
    state = tl.init_state(model, run)
    step = tl.make_train_step(model, run, rules)
    batch = _batches(cfg, 11)
    losses = []
    for s in range(8):
        state, m = step(state, batch(s))
        losses.append(float(m["loss"]))
    Checkpointer(ckpt_dir, group=mesh.dp_group).save(8, state,
                                                      blocking=True)
    out = {"losses": np.array(losses)}
    for k, p in state.params.items():
        out[f"params/{k}"] = p.detach().numpy().copy()
        out[f"mu/{k}"] = state.opt.mu[k].numpy().copy()
        out[f"nu/{k}"] = state.opt.nu[k].numpy().copy()
    return out


def _elastic_second(rank, ckpt_dir, saved_path):
    """A new fleet of 2 ranks: restore step 8 onto its mesh, compare,
    train 8 more steps."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.runtime import train_loop as tl
    cfg, run, model = _granite(ELASTIC_RUN, seed=99)
    mesh, rules = _rules(cfg, 2)
    fresh = tl.init_state(model, run)
    ck = Checkpointer(ckpt_dir, group=mesh.dp_group)
    assert ck.latest_step() == 8
    restored = ck.restore(8, fresh, shardings=tl.state_shardings(
        fresh, model.param_axes(), rules))
    assert int(restored.step) == int(restored.opt.step) == 8
    saved = dict(np.load(saved_path))
    equal = all(np.array_equal(restored.params[k].detach().numpy(),
                               saved[f"params/{k}"])
                and np.array_equal(restored.opt.mu[k].numpy(),
                                   saved[f"mu/{k}"])
                and np.array_equal(restored.opt.nu[k].numpy(),
                                   saved[f"nu/{k}"])
                for k in restored.params)
    step = tl.make_train_step(model, run, rules)
    batch = _batches(cfg, 11)
    losses = []
    for s in range(8, 16):
        restored, m = step(restored, batch(s))
        losses.append(float(m["loss"]))
    return {"equal": np.array(equal), "losses": np.array(losses),
            "step": np.array(int(restored.step))}


def test_elastic_resume_on_smaller_mesh(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    first = D.spawn(tmp_path, _elastic_first, ckpt)
    saved = tmp_path / "saved.npz"
    np.savez(saved, **first[0])
    second = D.spawn(tmp_path, _elastic_second, ckpt, str(saved), world=2)
    for got in second:
        assert bool(got["equal"])
        assert int(got["step"]) == 16
        np.testing.assert_array_equal(got["losses"], second[0]["losses"])
    losses = np.concatenate([first[0]["losses"], second[0]["losses"]])
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] + 0.5, losses


DRILL_ARGV = ["--arch", "granite_3_2b", "--smoke", "--device", "cpu",
              "--mesh-data", "2", "--steps", "10", "--batch", "4",
              "--seq", "16", "--checkpoint-every", "3", "--log-every", "0"]


def _restart_rank(rank, root):
    from repro_torch.launch import train
    out = {}
    for mode in ("bidir_ring", "aer_topk"):
        for name, extra in (("clean", []), ("drill", ["--fail-at", "4,7"])):
            state, info = train.main(DRILL_ARGV + extra + [
                "--dp-reduce", mode,
                "--checkpoint-dir", os.path.join(root, mode, name)])
            out[f"{mode}/{name}/restarts"] = np.array(info["restarts"])
            for k, p in state.params.items():
                out[f"{mode}/{name}/params/{k}"] = p.detach().numpy().copy()
    return out


def test_restarts_under_a_group(tmp_path):
    """Failures at steps 4 and 7 on both ranks: 2 restarts each.  Under
    ``bidir_ring`` the run ends bit-equal to a clean one.  Under
    ``aer_topk`` the ranks stay equal to each other but not to the clean
    run: the residuals are the reference's replicated leaves
    (``state_shardings``), so the checkpoint holds rank 0's and a restore
    hands them to every rank, as the reference's restore does with its
    first device's (ROADMAP queue C)."""
    ranks = D.spawn(tmp_path, _restart_rank, str(tmp_path), world=2)
    for got in ranks:
        for mode in ("bidir_ring", "aer_topk"):
            assert int(got[f"{mode}/clean/restarts"]) == 0
            assert int(got[f"{mode}/drill/restarts"]) == 2
        keys = [k for k in got if "/params/" in k]
        for k in keys:
            np.testing.assert_array_equal(got[k], ranks[0][k], err_msg=k)
            if k.startswith("bidir_ring/drill/"):
                np.testing.assert_array_equal(
                    got[k], got[k.replace("/drill/", "/clean/")], err_msg=k)
    assert any(not np.array_equal(ranks[0][k], ranks[0][k.replace(
        "/drill/", "/clean/")]) for k in ranks[0]
        if k.startswith("aer_topk/drill/params/"))


def test_launcher_under_torchrun(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "granite_3_2b", "--smoke", "--device", "cpu",
         "--mesh-data", "2", "--steps", "3", "--batch", "4", "--seq", "16",
         "--dp-reduce", "aer_topk", "--log-every", "1",
         "--checkpoint-dir", str(tmp_path / "ckpt")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    assert out.count("mesh: {'data': 2, 'model': 1} dp_reduce=aer_topk "
                     "backend=gloo") == 1, out
    assert out.count("step 3: ") == 1 and out.count("done in") == 1, out
    words = float(out.split("step 3: ")[1].split("wire_words=")[1].split()[0])
    assert words > 0, out


def _refusal_rank(rank, root):
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs.base import RunConfig, get_smoke_config
    from repro_torch.launch import train
    from repro_torch.models.model import build_model
    from repro_torch.parallel.compat import Mesh
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.parallel.tensor_parallel import shard_param
    from repro_torch.runtime import train_loop as tl
    cfg, run, model = _granite(dict(dp_reduce="psum"))
    said = {}

    def refused(name, exc, match, fn):
        try:
            fn()
        except exc as e:
            said[name] = np.array(match in str(e))
        else:
            said[name] = np.array(False)

    _, rules = _rules(cfg, 2)
    step = tl.make_train_step(model, run, rules)
    state = tl.init_state(model, run)
    batch = _batches(cfg, 1)(0)
    refused("rows", ValueError, "does not split into 2 data-parallel",
            lambda: step(state, {k: v[:3] for k, v in batch.items()}))
    ck = Checkpointer(os.path.join(root, "ck"), group=_rules(cfg, 2)[0]
                      .dp_group)
    ck.save(0, state, blocking=True)
    saved = {k: p.detach().clone() for k, p in state.params.items()}
    f32 = cfg.with_(compute_dtype=torch.float32)

    def one_step(rules):
        """A fresh model's step in float32 compute on ``rules``: its
        loss, and the model and state (this rank's shards)."""
        m = build_model(f32, seed=0, device="cpu")
        st = tl.init_state(m, run, rules)
        _, met = tl.make_train_step(m, run, rules)(st, batch)
        return m, st, float(met["loss"])

    base = one_step(_rules(cfg, 2)[1])[2]
    _, tp_rules = _rules(cfg, 1, model=2)
    tp_model, _, loss = one_step(tp_rules)
    said["model_axis"] = np.array(abs(loss - base) < 1e-5 and
                                  tp_model.head.w.shape[1] == cfg.vocab // 2)
    sharded = build_model(f32, seed=0, device="cpu")
    tl.make_train_step(sharded, run, tp_rules)
    with torch.no_grad():
        got = sharded.forward(batch)[0]
        want = build_model(f32, seed=0, device="cpu").forward(batch)[0]
    said["serve_sharded"] = np.array(
        got.shape == want.shape and
        float((got - want).abs().max()) < 1e-5)
    mesh, fsdp_rules = _rules(cfg, 2, fsdp=True)
    fsdp_model, fsdp_state, loss = one_step(fsdp_rules)
    said["fsdp"] = np.array(abs(loss - base) < 1e-5 and
                            fsdp_model.head.w.shape[0] == cfg.d_model // 2)
    sharded = tl.state_shardings(fsdp_state, fsdp_model.param_axes(),
                                 fsdp_rules)
    ck.restore(0, fsdp_state, shardings=sharded)
    said["restore"] = np.array(all(torch.equal(
        fsdp_state.params[k], shard_param(saved[k], sh.spec, mesh, rank,
                                          sh.groups))
        for k, sh in sharded.params.items()))
    # an abstract mesh: rank 0's step (the dry-run's program), whose
    # collectives need a cost counter to record them
    abstract = make_rules(Mesh({"data": 2, "model": 1}), fsdp=False)
    rank0 = build_model(f32, seed=0, device="cpu")
    rank0_step = tl.make_train_step(rank0, run, abstract)
    refused("abstract", RuntimeError, "launch.cost.Counter",
            lambda: rank0_step(tl.init_state(rank0, run, abstract), batch))
    said["abstract"] &= np.array(rank0.parallel.rank == 0)
    refused("mesh_data", ValueError, "needs 3 processes",
            lambda: train.setup(["--arch", "granite_3_2b", "--smoke",
                                 "--device", "cpu", "--mesh-data", "3"]))
    mesh, _ = _rules(cfg, 1, model=2)
    sp_model, _, loss = one_step(make_rules(
        mesh, seq_parallel=True, kv_heads=cfg.n_kv_heads,
        d_head=cfg.d_head))
    said["seq_parallel"] = np.array(abs(loss - base) < 1e-5 and
                                    sp_model.parallel.seq_split)
    # query heads that do not split over the model axis (3 on 2 ranks):
    # every rank runs all of them on its gathered query block
    uneven = f32.with_(n_heads=3, n_kv_heads=1)

    def step_of(rules):
        m = build_model(uneven, seed=0, device="cpu")
        st = tl.init_state(m, run, rules)
        return tl.make_train_step(m, run, rules)(st, batch)[1]
    got, want = step_of(_rules(uneven, 1, model=2)[1]), step_of(None)
    said["whole_heads"] = np.array(
        abs(float(got["loss"]) - float(want["loss"])) < 1e-5 and
        abs(float(got["grad_norm"]) / float(want["grad_norm"]) - 1) < 1e-5)
    jamba = get_smoke_config("jamba_v01_52b")
    hybrid = build_model(jamba, device="cpu")
    tl.make_train_step(hybrid, RunConfig(), make_rules(
        mesh, kv_heads=jamba.n_kv_heads, d_head=jamba.d_head))
    said["kinds"] = np.array(hybrid.parallel.tp == 2 and
                             hybrid.stack.blocks[0].mamba.D_skip.shape[0]
                             == jamba.mamba.expand * jamba.d_model // 2)
    return said


def test_refusals(tmp_path):
    ranks = D.spawn(tmp_path, _refusal_rank, str(tmp_path), world=2)
    for got in ranks:
        assert sorted(got) == sorted(["rows", "model_axis", "fsdp",
                                      "restore", "abstract", "mesh_data",
                                      "seq_parallel", "kinds",
                                      "serve_sharded", "whole_heads"])
        assert all(bool(v) for v in got.values()), {k: bool(v) for k, v in got.items()}


@pytest.mark.parametrize("dp", [1, 4])
def test_rules_on_data_only_mesh_are_replicated(dp, tmp_path):
    """``state_shardings`` on a data-only mesh without FSDP: every leaf
    replicated, so a restore loads it whole."""
    from repro_torch.parallel.compat import Mesh
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.runtime import train_loop as tl
    cfg, run, model = _granite(dict(dp_reduce="aer_topk"))
    rules = make_rules(Mesh({"data": dp, "model": 1}), fsdp=False)
    sh = tl.state_shardings(tl.init_state(model, run), model.param_axes(),
                            rules)
    leaves = [*sh.params.values(), *sh.opt.mu.values(),
              *sh.opt.nu.values(), sh.step, sh.opt.step,
              *(a.residual for a in sh.aer.values())]
    assert all(s.shards == 1 for s in leaves)
