"""Data-parallel training of the port against the reference's, for
falcon-mamba-7b's smoke config in float32 compute: 4 gloo ranks of the
port against the reference's manual data parallelism on 4 forced host
devices, from the reference's initial parameters on the same
``SyntheticLM`` batches (``tests/_torch_dp.py``).

- every mode (``psum``, ``ring``, ``bidir_ring``, ``aer_topk``): the
  losses of 3 steps on every rank within ``LOSS_TOL`` of the
  reference's, and the parameters after them within ``PARAM_TOL``
  (``aer_topk``: ``_torch_dp.AER_PARAM_TOL``, 6e-3), all inside the
  reference's own cross-schedule bounds (8e-3 on the loss, 5e-2 on the
  parameters, ``tests/test_train_modes.py``).  The gradients differ
  from the reference's by float32 rounding, which AdamW's first steps
  amplify where a gradient is near 0 (``tests/test_torch_train_loop.py``
  says so), and under ``aer_topk`` can move an entry that sits on its
  block's threshold into or out of a step's events.  Measured: loss
  9.5e-7, dense parameters 5.9e-7, ``aer_topk`` parameters
  8.7e-4.  ``aer_topk``'s wire words a step within ``WORDS_RTOL`` of
  the reference's (equal when measured), 0 in the dense modes;
- ``aer_topk`` on the reference's own per-device gradients, twice (the
  second with the first's residuals): every rank's reduced gradients,
  residuals and wire words EXACTLY the reference's.  The residuals are
  in the reference's stacked layout, so a per-layer tiling of the
  norm scales (64 entries a layer here), ``D_skip`` or ``dt_bias`` (128)
  would fail this.

granite-3-2b is held the same way in ``test_torch_train_dp.py``; the
drills are in ``test_torch_train_dp_drills.py``.
"""

import pytest

import _torch_dp as D

ARCH = "falcon_mamba_7b"
LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
WORDS_RTOL = 1e-3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    ref = D.reference(ARCH, tmp / "ref.npz")
    return ref, D.spawn(tmp, D.parity_rank, ARCH, str(tmp / "ref.npz"))


@pytest.mark.parametrize("mode", D.MODES)
def test_mode_matches_reference(runs, mode):
    D.check_run(ARCH, *runs, mode, loss_tol=LOSS_TOL, param_tol=PARAM_TOL,
                words_rtol=WORDS_RTOL)


def test_aer_reduction_of_reference_gradients_is_exact(runs):
    D.check_reduction(ARCH, *runs)
