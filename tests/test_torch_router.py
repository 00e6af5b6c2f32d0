"""The port's routing layer (its own numpy copy) builds the same tables
as the reference: BFS and weighted next hops, step tables, cycle
checks, multicast trees and the engines' replication tables."""

import dataclasses

import numpy as np
import pytest

from repro.core import network as net
from repro.core import router as jr
from repro.core.link import PAPER_TIMING, SERIAL_LVDS_TIMING
from repro.core.link import link_timing_arrays, per_link_timing
from repro_torch import interop
from repro_torch.core import link as tl
from repro_torch.core import network as tnet
from repro_torch.core import router as tr

TOPOS = [("line", 5), ("ring", 6), ("ring", 2), ("mesh", (2, 3)),
         ("mesh", (3, 3))]


def _topos(kind, n):
    if kind == "mesh":
        return jr.mesh2d_topology(*n), tr.mesh2d_topology(*n)
    build = {"line": "line_topology", "ring": "ring_topology"}[kind]
    return getattr(jr, build)(n), getattr(tr, build)(n)


def _tables_equal(a, b):
    for f in ("next_link", "out_side", "hops"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("kind,n", TOPOS)
def test_tables_equal(kind, n):
    jt, tt = _topos(kind, n)
    np.testing.assert_array_equal(jt.links, tt.links)
    _tables_equal(jr.RoutingTable.build(jt), tr.RoutingTable.build(tt))
    cost = np.random.default_rng(3).integers(1, 5, jt.n_links)
    _tables_equal(jr.RoutingTable.build_weighted(jt, cost),
                  tr.RoutingTable.build_weighted(tt, cost))
    jrt, trt = jr.RoutingTable.build(jt), tr.RoutingTable.build(tt)
    for a, b in zip(jr.route_step_tables(jt, jrt),
                    tr.route_step_tables(tt, trt)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(net._unicast_routes(jt, jrt),
                    tnet._unicast_routes(tt, trt)):
        np.testing.assert_array_equal(a, b)


def test_route_cycles_on_broken_override():
    jt, tt = _topos("ring", 5)
    rt = jr.RoutingTable.build(jt)
    nl, os_ = rt.next_link.copy(), rt.out_side.copy()
    # chip 1 -> 3 sent back toward 0, and 0 -> 3 toward 1: a 2-cycle
    nl[1, 3], os_[1, 3] = 0, 1
    nl[0, 3], os_[0, 3] = 0, 0
    broken_j = jr.RoutingTable(nl, os_, rt.hops)
    broken_t = interop.from_reference(
        routing=(nl, os_, rt.hops)).routing
    a = jr.find_route_cycles(jt, broken_j)
    b = tr.find_route_cycles(tt, broken_t)
    assert len(a) > 0
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind,n,src,members", [
    ("ring", 8, 0, [2, 3, 5, 6]), ("mesh", (3, 3), 4, [0, 2, 6, 8]),
    ("line", 5, 2, [0, 4])])
def test_multicast_trees_and_replication(kind, n, src, members):
    jt, tt = _topos(kind, n)
    jrt, trt = jr.RoutingTable.build(jt), tr.RoutingTable.build(tt)
    a = jr.MulticastTree.build(jt, jrt, src, np.asarray(members))
    b = tr.MulticastTree.build(tt, trt, src, np.asarray(members))
    for f in ("edges", "parent", "deliver", "subtree"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert (a.fanout, a.max_out_degree) == (b.fanout, b.max_out_degree)
    np.testing.assert_array_equal(jr.find_tree_cycles(jt, [a]),
                                  tr.find_tree_cycles(tt, [b]))
    for x, y in zip(net._routes_with_trees(jt, jrt, [a, a]),
                    tnet._routes_with_trees(tt, trt, [b, b])):
        np.testing.assert_array_equal(x, y)


def test_addressing_and_tag_expansion():
    ja, ta = jr.AddressSpec(chip_bits=4), tr.AddressSpec(chip_bits=4)
    chips = np.arange(10)
    np.testing.assert_array_equal(ja.pack(chips, chips * 3),
                                  ta.pack(chips, chips * 3))
    words = ta.pack_multicast(chips % 3, chips)
    np.testing.assert_array_equal(ja.pack_multicast(chips % 3, chips), words)
    for x, y in zip(ja.unpack(words), ta.unpack(words)):
        np.testing.assert_array_equal(x, y)
    members = np.random.default_rng(5).random((3, 6)) < 0.5
    jm, tm = jr.MulticastTable(members), tr.MulticastTable(members)
    src = np.array([0, 1, 2, 5], np.int32)
    t = np.array([0, 4, 9, 9], np.int32)
    tag = np.array([0, 1, 2, 1], np.int32)
    for x, y in zip(jm.expand_stream(src, t, tag),
                    tm.expand_stream(src, t, tag)):
        np.testing.assert_array_equal(x, y)


def test_timing_arrays_and_interop():
    mixed_j = per_link_timing([PAPER_TIMING, SERIAL_LVDS_TIMING],
                              [0, 1, 0, 1])
    conv = interop.from_reference(timing=dataclasses.asdict(mixed_j))
    mixed_t = tl.per_link_timing([tl.PAPER_TIMING, tl.SERIAL_LVDS_TIMING],
                                 [0, 1, 0, 1])
    for a, b, c in zip(link_timing_arrays(mixed_j, 4),
                       tl.link_timing_arrays(conv.timing, 4),
                       tl.link_timing_arrays(mixed_t, 4)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert conv.traffic is None and conv.routing is None
