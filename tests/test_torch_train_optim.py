"""``optim.adamw`` of the port: the reference's unit tests
(``tests/test_optim.py``) carried over, and the port against the
reference on identical trees, on the CPU.

Bit for bit where the ops are the same: the AdamW update fed the same
gradients without clipping (the float32 ``pow`` of the bias corrections
agrees with XLA's on every step tried, 1..2000), the moments, the
learning rate wherever ``cos`` agrees.  Where an op rounds apart, the
test names it: ``cos`` of the schedule (XLA's and PyTorch's float32
``cos`` differ by one ulp on ~5 % of inputs, and ``1 + cos`` near -1
magnifies that into a few ulps of the rate) and the global norm's sums
(PyTorch and XLA add a leaf's squares in different orders: within 2
ulps)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as radamw
from repro_torch.optim import adamw


def tree(val=1.0):
    return {"a": torch.full((4,), val), "b.w": torch.full((2, 3), val)}


class TestAdamW:
    def test_first_step_matches_closed_form(self):
        """With bias correction, step 1 update = lr * g/(|g| + eps) + wd."""
        params = tree(1.0)
        state = adamw.init(params)
        lr, wd = 0.1, 0.0
        new, state, gnorm = adamw.update(tree(0.5), state, params, lr=lr,
                                         weight_decay=wd, grad_clip=0.0)
        for leaf in new.values():
            np.testing.assert_allclose(leaf.numpy(), 1.0 - lr, rtol=1e-5)

    def test_weight_decay_pulls_to_zero(self):
        params = tree(1.0)
        state = adamw.init(params)
        new, _, _ = adamw.update(tree(0.0), state, params, lr=0.1,
                                 weight_decay=0.5, grad_clip=0.0)
        for leaf in new.values():
            assert bool((leaf < 1.0).all())

    def test_grad_clip_bounds_global_norm(self):
        clipped, norm = adamw.clip_by_global_norm(tree(100.0), 1.0)
        assert float(norm) > 1.0
        assert float(adamw.global_norm(clipped)) == pytest.approx(1.0,
                                                                  rel=1e-5)

    def test_moments_are_fp32_regardless_of_param_dtype(self):
        params = {"w": torch.ones((4,), dtype=torch.bfloat16)}
        state = adamw.init(params)
        assert state.mu["w"].dtype == torch.float32
        new, state, _ = adamw.update(
            {"w": torch.ones((4,), dtype=torch.bfloat16)}, state, params,
            lr=0.1)
        assert new["w"].dtype == torch.bfloat16   # params keep their dtype
        assert state.nu["w"].dtype == torch.float32

    def test_step_counter_increments(self):
        params = tree()
        state = adamw.init(params)
        _, state, _ = adamw.update(tree(0.1), state, params, lr=0.1)
        _, state, _ = adamw.update(tree(0.1), state, params, lr=0.1)
        assert int(state.step) == 2

    def test_update_is_in_place(self):
        """The returned trees are the tensors passed in (a card-sized
        state has no room for a second copy)."""
        params = tree(1.0)
        state = adamw.init(params)
        grads = tree(3.0)
        ids = {k: (p.data_ptr(), state.mu[k].data_ptr(),
                   state.nu[k].data_ptr()) for k, p in params.items()}
        new, state2, _ = adamw.update(grads, state, params, lr=0.1)
        for k, p in new.items():
            assert p is params[k]
            assert ids[k] == (p.data_ptr(), state2.mu[k].data_ptr(),
                              state2.nu[k].data_ptr())
        # clipping scaled the gradients in place: norm 1 now
        assert float(adamw.global_norm(grads)) == pytest.approx(1.0,
                                                                rel=1e-5)


class TestSchedule:
    def test_warmup_then_cosine(self):
        def lr(s):
            return float(adamw.warmup_cosine(s, base_lr=1.0,
                                             warmup_steps=10,
                                             total_steps=100))
        lr0, lr5, lr10, lr100 = lr(0), lr(5), lr(10), lr(100)
        assert lr0 == 0.0
        assert lr5 == pytest.approx(0.5)
        assert lr10 == pytest.approx(1.0)
        assert lr100 == pytest.approx(0.1)   # final_frac
        assert lr0 <= lr5 <= lr10

    @pytest.mark.parametrize("warmup,total", [(10, 100), (1, 30),
                                              (100, 1000), (0, 7)])
    def test_matches_reference(self, warmup, total):
        """Bit for bit wherever the two ``cos`` agree on the step's
        angle; elsewhere within what one ulp of ``cos`` becomes."""
        base = 3e-4
        for s in range(0, total + 5):
            want = np.float32(radamw.warmup_cosine(
                jnp.int32(s), base_lr=base, warmup_steps=warmup,
                total_steps=total))
            got = adamw.warmup_cosine(torch.tensor(s, dtype=torch.int32),
                                      base_lr=base, warmup_steps=warmup,
                                      total_steps=total).numpy()
            assert got.dtype == np.float32
            t = np.float32(np.clip((np.float32(s) - warmup)
                                   / max(total - warmup, 1), 0.0, 1.0))
            angle = np.float32(np.float32(math.pi) * t)
            cos_j = np.asarray(jnp.cos(jnp.float32(angle)))
            cos_t = torch.cos(torch.tensor(angle)).numpy()
            if s < warmup or cos_j == cos_t:
                assert want.view(np.int32) == got.view(np.int32), s
            else:
                ulp = np.spacing(np.abs(cos_j))
                assert abs(int(cos_j.view(np.int32))
                           - int(cos_t.view(np.int32))) == 1, s
                assert abs(float(got) - float(want)) <= \
                    base * 0.45 * ulp + 2 * np.spacing(want), s


def _trees(seed, shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"embed.table": (16, 8), "stack.blocks.0.attn.wq.w": (8, 12),
          "ln_f.scale": (8,)}


class TestAgainstReference:
    def test_update_bit_for_bit_without_clipping(self):
        """Five steps on the same gradients, ``grad_clip=0``: parameters,
        moments and step equal bit for bit."""
        p0 = _trees(1, SHAPES)
        rp = {k: jnp.asarray(v) for k, v in p0.items()}
        tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
        rs, ts = radamw.init(rp), adamw.init(tp)
        for i in range(5):
            g = _trees(10 + i, SHAPES, 0.3)
            lr = radamw.warmup_cosine(rs.step, base_lr=1e-2,
                                      warmup_steps=2, total_steps=10)
            rp, rs, _ = radamw.update({k: jnp.asarray(v)
                                       for k, v in g.items()}, rs, rp,
                                      lr=lr, grad_clip=0.0)
            tp, ts, _ = adamw.update({k: torch.from_numpy(v)
                                      for k, v in g.items()}, ts, tp,
                                     lr=float(lr), grad_clip=0.0)
            for k in SHAPES:
                for want, got in ((rp[k], tp[k]), (rs.mu[k], ts.mu[k]),
                                  (rs.nu[k], ts.nu[k])):
                    np.testing.assert_array_equal(np.asarray(want),
                                                  got.numpy())
            assert int(rs.step) == int(ts.step)

    def test_update_with_clipping_and_norms(self):
        """With clipping the norm's sums differ in order (within 2 ulps);
        the clipped update then stays within 1e-6 of the reference's."""
        p0 = _trees(2, SHAPES)
        rp = {k: jnp.asarray(v) for k, v in p0.items()}
        tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
        rs, ts = radamw.init(rp), adamw.init(tp)
        for i in range(3):
            g = _trees(20 + i, SHAPES, 2.0)
            rn = float(radamw.global_norm({k: jnp.asarray(v)
                                           for k, v in g.items()}))
            tn = float(adamw.global_norm({k: torch.from_numpy(v)
                                          for k, v in g.items()}))
            assert abs(rn - tn) <= 2 * np.spacing(np.float32(rn))
            rp, rs, rg = radamw.update({k: jnp.asarray(v)
                                        for k, v in g.items()}, rs, rp,
                                       lr=1e-2)
            tp, ts, tg = adamw.update({k: torch.from_numpy(v)
                                       for k, v in g.items()}, ts, tp,
                                      lr=1e-2)
            assert abs(float(rg) - float(tg)) <= \
                2 * np.spacing(np.float32(rg))
            for k in SHAPES:
                np.testing.assert_allclose(tp[k].numpy(), np.asarray(rp[k]),
                                           rtol=1e-6, atol=1e-7)

    def test_clip_by_global_norm_matches_reference(self):
        g = _trees(3, SHAPES, 50.0)
        rc, rn = radamw.clip_by_global_norm({k: jnp.asarray(v)
                                             for k, v in g.items()}, 1.0)
        tc, tn = adamw.clip_by_global_norm({k: torch.from_numpy(v)
                                            for k, v in g.items()}, 1.0)
        assert abs(float(rn) - float(tn)) <= 2 * np.spacing(np.float32(rn))
        for k in SHAPES:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(rc[k]),
                                       rtol=3e-7, atol=0)

    def test_init_matches_reference(self):
        p0 = _trees(4, SHAPES)
        rs = radamw.init({k: jnp.asarray(v) for k, v in p0.items()})
        ts = adamw.init({k: torch.from_numpy(v) for k, v in p0.items()})
        assert int(rs.step) == int(ts.step) == 0
        assert ts.step.dtype == torch.int32
        for k in SHAPES:
            assert ts.mu[k].dtype == ts.nu[k].dtype == torch.float32
            assert not ts.mu[k].any() and not ts.nu[k].any()
            assert tuple(ts.mu[k].shape) == rs.mu[k].shape
