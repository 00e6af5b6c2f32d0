"""``network.reset_links``, the batched ``protocol_sim.reset_link``,
against the reference's, field for field (value and dtype)."""

import jax
import numpy as np
import pytest
import torch

from repro.core import network as ref_network
from repro_torch.core import network
from repro_torch.core.protocol_sim import LinkState


def _leaves(state):
    """``(path, array)`` of a LinkState of either package, in field order."""
    for name, v in zip(state._fields, state):
        if hasattr(v, "_fields"):
            for sub, a in _leaves(v):
                yield f"{name}.{sub}", a
        else:
            yield name, v


@pytest.mark.parametrize("initial_tx", [[1], [0], [1, 0, 1, 1],
                                        [0] * 7, np.array([1, 0] * 16)])
def test_reset_links_matches_reference(initial_tx):
    want = jax.tree.map(np.asarray, ref_network.reset_links(initial_tx))
    got = network.reset_links(initial_tx, device="cpu")
    assert isinstance(got, LinkState)
    w, g = list(_leaves(want)), list(_leaves(got))
    assert [p for p, _ in w] == [p for p, _ in g]
    for (path, a), (_, t) in zip(w, g):
        assert t.dtype == torch.int32 and a.dtype == np.int32, path
        assert t.shape == (len(initial_tx),), path
        np.testing.assert_array_equal(t.numpy(), a, err_msg=path)


def test_reset_links_is_exported_and_checks_its_shape():
    assert "reset_links" in network.__all__
    with pytest.raises(ValueError, match=r"\(L,\)"):
        network.reset_links([[1, 0]], device="cpu")
