"""The port's fabric registry against the reference's, fabric by fabric.

The port keeps its own copy of ``core/routing.py``; every registered
topology must give the same link numbering, routes, hop counts, router
incidence, rate classes and mean degree as the reference at the shapes of
the reference's contract suite (``test_topology.py:24-33``).
"""

import numpy as np
import pytest

from repro.core import routing as J
from repro_torch.core import routing as T

SHAPES = [("mesh", 4, 4, None), ("mesh", 6, 3, None), ("torus", 4, 4, None),
          ("torus", 5, 3, None), ("systolic", 4, 4, None),
          ("systolic", 8, 8, None), ("het", 4, 4, "fast2slow1")]


@pytest.mark.parametrize("name,w,h,variant", SHAPES,
                         ids=[f"{s[0]}-{s[1]}x{s[2]}" for s in SHAPES])
def test_fabric_matches_reference(name, w, h, variant):
    key = name if variant is None else f"{name}:{variant}"
    t, j = T.build_topology(key, w, h), J.build_topology(key, w, h)
    assert type(t).__name__ == type(j).__name__
    assert t.links == j.links and t.n_links == j.n_links
    assert np.array_equal(t.rate_class, j.rate_class)
    assert t.mean_degree() == j.mean_degree()
    for src in range(t.n_cores):
        assert t.links_of_router(src) == j.links_of_router(src)
        assert t.neighbours(src) == j.neighbours(src)
        for dst in range(t.n_cores):
            assert t.route(src, dst) == j.route(src, dst)
            assert t.hops(src, dst) == j.hops(src, dst)
    pairs = [(0, t.n_cores - 1), (1, 2)]
    assert np.array_equal(t.path_matrix(pairs), j.path_matrix(pairs))


@pytest.mark.parametrize("spec", [4, (6, 3), "4x4", "mesh:8x8", "torus:8x8",
                                  "systolic:8x8", "het:4x4:fast2slow1"])
def test_spec_grammar_matches_reference(spec):
    assert T.parse_topology_spec(spec) == J.parse_topology_spec(spec)
    assert T.topology_spec(*T.parse_topology_spec(spec)) \
        == J.topology_spec(*J.parse_topology_spec(spec))


def test_registry_matches_reference():
    builtins = {"mesh", "torus", "systolic", "het"}
    assert set(T.available_topologies()) == builtins
    assert set(J.available_topologies()) >= builtins
    for name in builtins:
        assert T.get_topology(name).__name__ == J.get_topology(name).__name__
    assert T.mesh_mean_degree(6, 3) == J.mesh_mean_degree(6, 3)
