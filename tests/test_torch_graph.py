"""The port's ``build_lm_graph`` against the JAX reference's, on the CPU.

Every registered architecture, full and smoke, at three shapes: the
builder's defaults (seq 512, batch 8), a long sequence on three layers
(seq 8,192 passes the 4,096-token window of h2o-danube-3-4b and
mixtral-8x7b) and a short one on one layer (seq 8 under the smoke
window of 16).  The two graphs must be equal node for node (name, kind,
FLOPs, bytes, stage, attributes such as the expert index) and edge for
edge (ends and bytes), with equal topological orders and stage counts.
Both builders do the same float arithmetic, so equality is exact.
"""

import pytest

from repro.configs.base import get_config as ref_config
from repro.configs.base import list_archs
from repro.core.graph import build_lm_graph as ref_build
from repro_torch.configs import get_config
from repro_torch.core.graph import build_lm_graph

SHAPES = {"defaults": {}, "long": dict(seq=8192, batch=1, max_layers=3),
          "short": dict(seq=8, batch=2, max_layers=1)}


def _graph(g):
    nodes = [(n.node_id, n.name, n.op_type, n.flops, n.out_bytes, n.stage,
              n.attrs) for n in g.nodes]
    edges = [(e.src, e.dst, e.bytes) for e in g.edges]
    return g.name, nodes, edges, g.topo_order(), g.n_stages


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", list_archs())
def test_lm_graph_matches_reference(arch, smoke, shape):
    kw = SHAPES[shape]
    ref = ref_build(ref_config(arch, smoke=smoke), **kw)
    port = build_lm_graph(get_config(arch, smoke=smoke), **kw)
    assert _graph(port) == _graph(ref)
    assert port.total_flops() == ref.total_flops()
    # the graph holds the kinds of the layers it was cut to
    cfg = get_config(arch, smoke=smoke)
    layers = range(min(cfg.n_layers, kw.get("max_layers", cfg.n_layers)))
    kinds = {n.op_type for n in port.nodes}
    assert ("moe_expert" in kinds) == any(map(cfg.is_moe_layer, layers))
    assert ("ssm_scan" in kinds) == any(cfg.layer_kind(i) == "mamba"
                                        for i in layers)
