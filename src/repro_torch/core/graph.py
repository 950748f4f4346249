"""Computation-graph IR for SLOTH workloads.

Nodes are DNN operators (conv / gemm / pool / attention / moe / ssm ...)
annotated with FLOPs and output bytes; edges carry data volumes.  This is the
graph SL-Compiler analyses for probe insertion and the mapper partitions onto
the core mesh.  Builders are provided for the paper's five evaluation
workloads (DarkNet-19, GoogLeNet, VGG-16, ResNet-50, BinaryTree) and for the
assigned LM architectures (built from an ArchConfig).
"""

from __future__ import annotations

import dataclasses

# Operator categories used by SL-Compiler's probe planner.
COMPUTE_OPS = frozenset(
    {"conv", "gemm", "attention", "moe_expert", "ssm_scan", "pool", "norm",
     "elemwise", "embed", "router"}
)
IO_OPS = frozenset({"input", "output"})


@dataclasses.dataclass
class OpNode:
    node_id: int
    name: str
    op_type: str          # one of COMPUTE_OPS | IO_OPS
    flops: float          # forward FLOPs of the operator
    out_bytes: float      # bytes produced (activation volume)
    stage: int            # execution stage (layer index) for grouping
    attrs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Edge:
    src: int
    dst: int
    bytes: float


class CompGraph:
    """A DAG of DNN operators."""

    def __init__(self, name: str):
        self.name = name
        self.nodes: list[OpNode] = []
        self.edges: list[Edge] = []
        self._out: dict[int, list[Edge]] = {}
        self._in: dict[int, list[Edge]] = {}

    # -- construction -----------------------------------------------------
    def add_node(self, name, op_type, flops, out_bytes, stage, **attrs):
        nid = len(self.nodes)
        self.nodes.append(OpNode(nid, name, op_type, float(flops),
                                 float(out_bytes), int(stage), attrs))
        self._out[nid] = []
        self._in[nid] = []
        return nid

    def add_edge(self, src: int, dst: int, bytes: float | None = None):
        if bytes is None:
            bytes = self.nodes[src].out_bytes
        e = Edge(src, dst, float(bytes))
        self.edges.append(e)
        self._out[src].append(e)
        self._in[dst].append(e)
        return e

    # -- queries ----------------------------------------------------------
    def out_edges(self, nid: int) -> list[Edge]:
        return self._out[nid]

    def in_edges(self, nid: int) -> list[Edge]:
        return self._in[nid]

    def topo_order(self) -> list[int]:
        indeg = {n.node_id: len(self._in[n.node_id]) for n in self.nodes}
        frontier = [nid for nid, d in indeg.items() if d == 0]
        order: list[int] = []
        while frontier:
            nid = frontier.pop()
            order.append(nid)
            for e in self._out[nid]:
                indeg[e.dst] -= 1
                if indeg[e.dst] == 0:
                    frontier.append(e.dst)
        if len(order) != len(self.nodes):
            raise ValueError(f"graph {self.name} has a cycle")
        return order

    @property
    def n_stages(self) -> int:
        return 1 + max(n.stage for n in self.nodes)

    def total_flops(self) -> float:
        return sum(n.flops for n in self.nodes)

    def __repr__(self):
        return (f"CompGraph({self.name!r}, nodes={len(self.nodes)}, "
                f"edges={len(self.edges)}, stages={self.n_stages})")


# ---------------------------------------------------------------------------
# CNN builders (paper workloads).  All are batch-64 inference graphs by
# default, matching the paper's throughput-oriented setting.
# ---------------------------------------------------------------------------

_BYTES = 2  # activations in bf16/fp16 on-chip


def _conv(g, name, stage, prev, hw, cin, cout, k, batch, stride=1):
    h = w = hw // stride
    flops = 2.0 * k * k * cin * cout * h * w * batch
    out_b = h * w * cout * batch * _BYTES
    nid = g.add_node(name, "conv", flops, out_b, stage,
                     hw=h, cin=cin, cout=cout, k=k)
    if prev is not None:
        g.add_edge(prev, nid)
    return nid, h


def _pool(g, name, stage, prev, hw, c, batch, stride=2):
    h = hw // stride
    flops = hw * hw * c * batch  # one op per input element
    out_b = h * h * c * batch * _BYTES
    nid = g.add_node(name, "pool", flops, out_b, stage, hw=h, c=c)
    g.add_edge(prev, nid)
    return nid, h


def _fc(g, name, stage, prev, fan_in, fan_out, batch):
    flops = 2.0 * fan_in * fan_out * batch
    out_b = fan_out * batch * _BYTES
    nid = g.add_node(name, "gemm", flops, out_b, stage, fan_in=fan_in,
                     fan_out=fan_out)
    g.add_edge(prev, nid)
    return nid


def build_vgg16(batch: int = 64) -> CompGraph:
    g = CompGraph("vgg16")
    cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
           512, 512, 512, "M", 512, 512, 512, "M"]
    inp = g.add_node("input", "input", 0, 224 * 224 * 3 * batch * _BYTES, 0)
    prev, hw, cin, stage = inp, 224, 3, 1
    for i, c in enumerate(cfg):
        if c == "M":
            prev, hw = _pool(g, f"pool{stage}", stage, prev, hw, cin, batch)
        else:
            prev, hw = _conv(g, f"conv{i}", stage, prev, hw, cin, c, 3, batch)
            cin = c
        stage += 1
    prev = _fc(g, "fc6", stage, prev, 7 * 7 * 512, 4096, batch)
    prev = _fc(g, "fc7", stage + 1, prev, 4096, 4096, batch)
    prev = _fc(g, "fc8", stage + 2, prev, 4096, 1000, batch)
    out = g.add_node("output", "output", 0, 1000 * batch * _BYTES, stage + 3)
    g.add_edge(prev, out)
    return g


def build_darknet19(batch: int = 64) -> CompGraph:
    g = CompGraph("darknet19")
    # (cout, k) sequences with maxpools, per the DarkNet-19 table.
    blocks = [
        [(32, 3)], "M", [(64, 3)], "M",
        [(128, 3), (64, 1), (128, 3)], "M",
        [(256, 3), (128, 1), (256, 3)], "M",
        [(512, 3), (256, 1), (512, 3), (256, 1), (512, 3)], "M",
        [(1024, 3), (512, 1), (1024, 3), (512, 1), (1024, 3)],
    ]
    inp = g.add_node("input", "input", 0, 224 * 224 * 3 * batch * _BYTES, 0)
    prev, hw, cin, stage = inp, 224, 3, 1
    idx = 0
    for blk in blocks:
        if blk == "M":
            prev, hw = _pool(g, f"pool{stage}", stage, prev, hw, cin, batch)
            stage += 1
            continue
        for cout, k in blk:
            prev, hw = _conv(g, f"conv{idx}", stage, prev, hw, cin, cout, k,
                             batch)
            cin = cout
            stage += 1
            idx += 1
    prev, _ = _conv(g, "conv_cls", stage, prev, hw, cin, 1000, 1, batch)
    out = g.add_node("output", "output", 0, 1000 * batch * _BYTES, stage + 1)
    g.add_edge(prev, out)
    return g


def build_resnet50(batch: int = 64) -> CompGraph:
    g = CompGraph("resnet50")
    inp = g.add_node("input", "input", 0, 224 * 224 * 3 * batch * _BYTES, 0)
    prev, hw = _conv(g, "conv1", 1, inp, 224, 3, 64, 7, batch, stride=2)
    prev, hw = _pool(g, "pool1", 2, prev, hw, 64, batch)
    stage = 3
    cin = 64
    # (n_blocks, mid_channels, out_channels, first_stride)
    stages = [(3, 64, 256, 1), (4, 128, 512, 2), (6, 256, 1024, 2),
              (3, 512, 2048, 2)]
    for si, (nblk, mid, cout, stride0) in enumerate(stages):
        for b in range(nblk):
            stride = stride0 if b == 0 else 1
            skip_src = prev
            p, hw2 = _conv(g, f"s{si}b{b}_c1", stage, prev, hw, cin, mid, 1,
                           batch, stride=stride)
            p, hw2 = _conv(g, f"s{si}b{b}_c2", stage + 1, p, hw2, mid, mid, 3,
                           batch)
            p, hw2 = _conv(g, f"s{si}b{b}_c3", stage + 2, p, hw2, mid, cout,
                           1, batch)
            if b == 0:  # projection shortcut
                sp, _ = _conv(g, f"s{si}b{b}_proj", stage, skip_src, hw, cin,
                              cout, 1, batch, stride=stride)
                skip_src = sp
            add = g.add_node(f"s{si}b{b}_add", "elemwise",
                             hw2 * hw2 * cout * batch,
                             hw2 * hw2 * cout * batch * _BYTES, stage + 3)
            g.add_edge(p, add)
            g.add_edge(skip_src, add)
            prev, hw, cin = add, hw2, cout
            stage += 4
    prev = _fc(g, "fc", stage, prev, 2048, 1000, batch)
    out = g.add_node("output", "output", 0, 1000 * batch * _BYTES, stage + 1)
    g.add_edge(prev, out)
    return g


# GoogLeNet inception channel table: (1x1, 3x3red, 3x3, 5x5red, 5x5, pool_proj)
_INCEPTION = {
    "3a": (64, 96, 128, 16, 32, 32), "3b": (128, 128, 192, 32, 96, 64),
    "4a": (192, 96, 208, 16, 48, 64), "4b": (160, 112, 224, 24, 64, 64),
    "4c": (128, 128, 256, 24, 64, 64), "4d": (112, 144, 288, 32, 64, 64),
    "4e": (256, 160, 320, 32, 128, 128), "5a": (256, 160, 320, 32, 128, 128),
    "5b": (384, 192, 384, 48, 128, 128),
}


def build_googlenet(batch: int = 64) -> CompGraph:
    g = CompGraph("googlenet")
    inp = g.add_node("input", "input", 0, 224 * 224 * 3 * batch * _BYTES, 0)
    prev, hw = _conv(g, "conv1", 1, inp, 224, 3, 64, 7, batch, stride=2)
    prev, hw = _pool(g, "pool1", 2, prev, hw, 64, batch)
    prev, hw = _conv(g, "conv2a", 3, prev, hw, 64, 64, 1, batch)
    prev, hw = _conv(g, "conv2b", 4, prev, hw, 64, 192, 3, batch)
    prev, hw = _pool(g, "pool2", 5, prev, hw, 192, batch)
    cin, stage = 192, 6
    for name, (c1, c3r, c3, c5r, c5, cp) in _INCEPTION.items():
        # four parallel branches — this is the branching structure that makes
        # GoogLeNet interesting for propagation analysis.
        b1, _ = _conv(g, f"in{name}_1x1", stage, prev, hw, cin, c1, 1, batch)
        b3r, _ = _conv(g, f"in{name}_3r", stage, prev, hw, cin, c3r, 1, batch)
        b3, _ = _conv(g, f"in{name}_3x3", stage + 1, b3r, hw, c3r, c3, 3,
                      batch)
        b5r, _ = _conv(g, f"in{name}_5r", stage, prev, hw, cin, c5r, 1, batch)
        b5, _ = _conv(g, f"in{name}_5x5", stage + 1, b5r, hw, c5r, c5, 5,
                      batch)
        bp, _ = _pool(g, f"in{name}_pool", stage, prev, hw, cin, batch,
                      stride=1)
        bpp, _ = _conv(g, f"in{name}_pp", stage + 1, bp, hw, cin, cp, 1,
                       batch)
        cout = c1 + c3 + c5 + cp
        cat = g.add_node(f"in{name}_cat", "elemwise",
                         hw * hw * cout * batch,
                         hw * hw * cout * batch * _BYTES, stage + 2)
        for b in (b1, b3, b5, bpp):
            g.add_edge(b, cat)
        prev, cin = cat, cout
        stage += 3
        if name in ("3b", "4e"):
            prev, hw = _pool(g, f"pool_{name}", stage, prev, hw, cin, batch)
            stage += 1
    prev = _fc(g, "fc", stage, prev, 1024, 1000, batch)
    out = g.add_node("output", "output", 0, 1000 * batch * _BYTES, stage + 1)
    g.add_edge(prev, out)
    return g


def build_binary_tree(depth: int = 5, dim: int = 256,
                      batch: int = 64) -> CompGraph:
    """Synthetic binary-tree microbenchmark: each node is a matrix op."""
    g = CompGraph("binary_tree")
    flops = 2.0 * dim * dim * dim
    out_b = dim * dim * _BYTES * batch // 64
    roots = [g.add_node("leaf%d" % i, "gemm", flops, out_b, 0)
             for i in range(2 ** depth)]
    stage = 1
    while len(roots) > 1:
        nxt = []
        for i in range(0, len(roots), 2):
            nid = g.add_node(f"n{stage}_{i // 2}", "gemm", flops, out_b,
                             stage)
            g.add_edge(roots[i], nid)
            g.add_edge(roots[i + 1], nid)
            nxt.append(nid)
        roots = nxt
        stage += 1
    out = g.add_node("output", "output", 0, out_b, stage)
    g.add_edge(roots[0], out)
    return g


# ---------------------------------------------------------------------------
# LM-architecture builder (ties SLOTH to the assigned architectures).
# ---------------------------------------------------------------------------

def build_lm_graph(cfg, seq: int = 512, batch: int = 8,
                   max_layers: int | None = None) -> CompGraph:
    """Build an operator graph for one of the assigned LM architectures.

    ``cfg`` is a ``repro_torch.configs.base.ArchConfig``.  Per layer we emit the
    block's operators (attention / MoE / SSM) with edges carrying activation
    volumes, so SLOTH sees the same dataflow the accelerator would run.
    """
    g = CompGraph(f"lm:{cfg.name}")
    d = cfg.d_model
    tok_bytes = seq * batch * d * _BYTES
    inp = g.add_node("embed", "embed", 2.0 * seq * batch * d,
                     tok_bytes, 0)
    prev = inp
    n_layers = cfg.n_layers if max_layers is None else min(cfg.n_layers,
                                                           max_layers)
    stage = 1
    for li in range(n_layers):
        kind = cfg.layer_kind(li)
        norm = g.add_node(f"l{li}_norm", "norm", 5.0 * seq * batch * d,
                          tok_bytes, stage)
        g.add_edge(prev, norm)
        if kind == "mamba":
            d_inner = cfg.ssm_expand * d
            proj = g.add_node(f"l{li}_inproj", "gemm",
                              2.0 * seq * batch * d * 2 * d_inner,
                              2 * tok_bytes, stage)
            g.add_edge(norm, proj)
            scan = g.add_node(f"l{li}_ssd", "ssm_scan",
                              6.0 * seq * batch * d_inner * cfg.ssm_state,
                              tok_bytes, stage + 1)
            g.add_edge(proj, scan)
            mix = g.add_node(f"l{li}_outproj", "gemm",
                             2.0 * seq * batch * d_inner * d, tok_bytes,
                             stage + 1)
            g.add_edge(scan, mix)
        else:
            h_dim = cfg.head_dim * cfg.n_heads
            kv_dim = cfg.head_dim * cfg.n_kv_heads
            qkv = g.add_node(f"l{li}_qkv", "gemm",
                             2.0 * seq * batch * d * (h_dim + 2 * kv_dim),
                             tok_bytes, stage)
            g.add_edge(norm, qkv)
            w = cfg.window if cfg.window else seq
            attn_ctx = min(seq, w)
            attn = g.add_node(f"l{li}_attn", "attention",
                              4.0 * seq * attn_ctx * batch * h_dim,
                              tok_bytes, stage + 1)
            g.add_edge(qkv, attn)
            mix = g.add_node(f"l{li}_oproj", "gemm",
                             2.0 * seq * batch * h_dim * d, tok_bytes,
                             stage + 1)
            g.add_edge(attn, mix)
        res1 = g.add_node(f"l{li}_res1", "elemwise", seq * batch * d,
                          tok_bytes, stage + 2)
        g.add_edge(mix, res1)
        g.add_edge(prev, res1)
        # FFN / MoE
        norm2 = g.add_node(f"l{li}_norm2", "norm", 5.0 * seq * batch * d,
                           tok_bytes, stage + 2)
        g.add_edge(res1, norm2)
        if cfg.is_moe_layer(li):
            router = g.add_node(f"l{li}_router", "router",
                                2.0 * seq * batch * d * cfg.n_experts,
                                seq * batch * cfg.n_experts * _BYTES,
                                stage + 3)
            g.add_edge(norm2, router)
            # each expert processes ~(top_k / n_experts) of the tokens
            frac = cfg.top_k / cfg.n_experts
            eflops = 3 * 2.0 * seq * batch * frac * d * cfg.d_ff
            agg = g.add_node(f"l{li}_moe_agg", "elemwise",
                             seq * batch * d * cfg.top_k, tok_bytes,
                             stage + 4)
            for ei in range(cfg.n_experts):
                ex = g.add_node(f"l{li}_e{ei}", "moe_expert", eflops,
                                tok_bytes * frac, stage + 3, expert=ei)
                g.add_edge(router, ex, bytes=tok_bytes * frac)
                g.add_edge(ex, agg, bytes=tok_bytes * frac)
            ffn_out = agg
        else:
            n_mats = 3 if cfg.mlp == "swiglu" else 2
            up = g.add_node(f"l{li}_ffn", "gemm",
                            n_mats * 2.0 * seq * batch * d * cfg.d_ff,
                            tok_bytes, stage + 3)
            g.add_edge(norm2, up)
            ffn_out = up
        res2 = g.add_node(f"l{li}_res2", "elemwise", seq * batch * d,
                          tok_bytes, stage + 4)
        g.add_edge(ffn_out, res2)
        g.add_edge(res1, res2)
        prev = res2
        stage += 5
    head = g.add_node("lm_head", "gemm", 2.0 * seq * batch * d * cfg.vocab,
                      seq * batch * min(cfg.vocab, 4096) * _BYTES, stage)
    g.add_edge(prev, head)
    out = g.add_node("output", "output", 0, 0, stage + 1)
    g.add_edge(head, out)
    return g


WORKLOAD_BUILDERS = {
    "darknet19": build_darknet19,
    "googlenet": build_googlenet,
    "vgg16": build_vgg16,
    "resnet50": build_resnet50,
    "binary_tree": build_binary_tree,
}


def build_workload(name: str, **kw) -> CompGraph:
    if name in WORKLOAD_BUILDERS:
        return WORKLOAD_BUILDERS[name](**kw)
    raise KeyError(f"unknown workload {name!r}; "
                   f"options: {sorted(WORKLOAD_BUILDERS)}")
