"""Event-driven simulator of a many-core DNN accelerator.

This is the paper's evaluation platform (§IV-A): a discrete-event model of a
2D-mesh many-core accelerator executing a mapped dataflow graph, with

* per-core compute capacity  P_core ~ Normal(mu_c, sigma_c^2),
* per-hop link transfer time with multiplicative Gamma(shape, scale) jitter
  (T_link ~ Gamma), matching the paper's statistical hardware model,
* store-and-forward XY routing with per-link occupancy (contention) and
  hardware backpressure: a consumer cannot start until its inputs arrive, so
  one slow core/link stalls the dependent region of the chip,
* fail-slow injection on cores, links or routers (a router slows all its
  adjacent links), active during a [t0, t0+dur) window.  A single run may
  carry failures of *different kinds at once* (mixed-kind scenarios):
  core and link windows live in separate per-resource tables, so they
  coexist independently, and overlapping windows on one resource compound
  multiplicatively,
* probe-cost accounting so SL-Compiler's instrumentation overhead (Fig 10)
  is measurable.

Execution order is event-driven (heapq): dataflow-triggered, cores process
ready tasks serially — the paper's data-driven execution model.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from .failures import FailSlow
from .mapping import MappedGraph
from .routing import Topology

OP_TYPE_IDS = {"conv": 0, "gemm": 1, "pool": 2, "elemwise": 3, "norm": 4,
               "attention": 5, "moe_expert": 6, "ssm_scan": 7, "router": 8,
               "embed": 9, "input": 10, "output": 11}


@dataclasses.dataclass
class SimConfig:
    mu_c: float = 1e12          # mean core capacity, FLOP/s
    sigma_frac: float = 0.03    # static per-core capacity spread
    jitter_frac: float = 0.01   # per-task temporal noise
    link_bw: float = 64e9       # per-link bandwidth, B/s
    gamma_shape: float = 16.0   # link-latency Gamma shape (mean kept at 1)
    hop_latency: float = 50e-9  # per-hop router latency, s
    probe_cost: float = 10e-9   # one probe record (≈10 cycles @ 1 GHz)
    seed: int = 0


@dataclasses.dataclass
class ProbePlan:
    """What the inserted probes record (produced by SL-Compiler)."""
    comp: bool = True           # Exec/Comp probes on compute tasks
    comm: bool = True           # Route/Comm probes on messages
    level: str = "stage"        # 'stage': 1 record/task, 'inst': 4/task
    surround: bool = True       # Pre+Post (2 clock reads) vs single

    def records_per_task(self) -> int:
        return 4 if self.level == "inst" else 1

    def cost_per_record(self, probe_cost: float) -> float:
        return (2 if self.surround else 1) * probe_cost


@dataclasses.dataclass
class SimResult:
    total_time: float
    # compute trace (one row per record)
    comp: dict[str, np.ndarray]
    # communication trace (one row per flow)
    comm: dict[str, np.ndarray]
    n_raw_records: int

    def raw_trace_bytes(self) -> int:
        """Storage for the uncompressed trace (the paper's 'raw format':
        index, timestamps, operands...).  ~48B per compute record and ~56B
        per communication record."""
        return 48 * len(self.comp["core"]) + 56 * len(self.comm["src"])


def calibrate(graph_total_flops: float, n_cores: int,
              target_time: float = 8.0) -> float:
    """Pick mu_c so the healthy run takes ≈target_time simulated seconds,
    keeping U(1,10s) failure windows meaningful across workloads.  0.85 is
    the measured average core utilisation under the Gemini-like mapping
    (execution is compute-dominated; waits overlap with other tasks)."""
    return graph_total_flops / (0.85 * n_cores * target_time)


class _CoreState:
    __slots__ = ("free_at", "pending")

    def __init__(self):
        self.free_at = 0.0
        self.pending: list = []   # heap of (stage, node_id, part, task_id)


def simulate(mapped: MappedGraph, cfg: SimConfig,
             failures: list[FailSlow] | None = None,
             probes: ProbePlan | None = None) -> SimResult:
    mesh: Topology = mapped.mesh
    rng = np.random.default_rng(cfg.seed)
    failures = failures or []

    # --- static hardware state -------------------------------------------
    # Per-core baseline capacity scales with the fabric's rate class
    # (all-ones on homogeneous fabrics — multiplying by exact 1.0 keeps
    # the historical mesh capacity draws bit-identical).
    rate = np.asarray(getattr(mesh, "rate_class", 1.0), dtype=np.float64)
    cap = cfg.mu_c * rate * (1.0 + cfg.sigma_frac * rng.standard_normal(
        mesh.n_cores))
    cap = np.maximum(cap, 0.05 * cfg.mu_c * rate)
    link_bw = np.full(mesh.n_links, cfg.link_bw)

    # Each resource carries a *list* of slowdown windows: simultaneous
    # fail-slow failures may overlap on one resource (e.g. two routers
    # slowing a shared link, or two windows on the same core), and
    # overlapping active windows compound multiplicatively.
    core_fail: dict[int, list[tuple[float, float, float]]] = {}
    link_fail: dict[int, list[tuple[float, float, float]]] = {}
    for f in failures:
        win = (f.t0, f.t0 + f.duration, f.slowdown)
        if f.kind == "core":
            core_fail.setdefault(f.location, []).append(win)
        elif f.kind == "link":
            link_fail.setdefault(f.location, []).append(win)
        elif f.kind == "router":
            for lid in mesh.links_of_router(f.location):
                link_fail.setdefault(lid, []).append(win)
        else:
            raise ValueError(f.kind)

    def _active_slowdown(windows, t: float) -> float:
        s = 1.0
        for t0, t1, slow in windows:
            if t0 <= t < t1:
                s *= slow
        return s

    def core_capacity(c: int, t: float) -> float:
        ws = core_fail.get(c)
        if ws:
            return cap[c] / _active_slowdown(ws, t)
        return cap[c]

    def link_rate(lid: int, t: float) -> float:
        ws = link_fail.get(lid)
        if ws:
            return link_bw[lid] / _active_slowdown(ws, t)
        return link_bw[lid]

    # --- task graph bookkeeping -------------------------------------------
    tasks = mapped.tasks
    n_tasks = len(tasks)
    in_count = np.zeros(n_tasks, dtype=np.int64)
    out_flows: dict[int, list[int]] = {t.task_id: [] for t in tasks}
    for fi, fl in enumerate(mapped.flows):
        in_count[fl.dst_task] += 1
        out_flows[fl.src_task].append(fi)

    probe_task_cost = 0.0
    probe_msg_cost = 0.0
    n_probe_records = 0
    if probes is not None:
        per_rec = probes.cost_per_record(cfg.probe_cost)
        if probes.comp:
            probe_task_cost = probes.records_per_task() * per_rec
        if probes.comm:
            probe_msg_cost = per_rec

    cores = [_CoreState() for _ in range(mesh.n_cores)]
    link_free = np.zeros(mesh.n_links)

    # trace buffers
    tc_core, tc_node, tc_part, tc_stage, tc_op, tc_flops = \
        [], [], [], [], [], []
    tc_start, tc_end = [], []
    tm_src, tm_dst, tm_stage, tm_bytes, tm_dep, tm_arr, tm_hops = \
        [], [], [], [], [], [], []
    tm_svc = []   # queue-free service time (what per-packet minima estimate)

    heap: list = []
    seq = 0

    def push(t, kind, payload):
        nonlocal seq
        heapq.heappush(heap, (t, seq, kind, payload))
        seq += 1

    def try_start(c: int, now: float):
        st = cores[c]
        if st.free_at > now or not st.pending:
            return
        _, _, _, tid = heapq.heappop(st.pending)
        task = tasks[tid]
        t0 = max(now, st.free_at)
        capacity = core_capacity(c, t0)
        jitter = 1.0 + cfg.jitter_frac * abs(rng.standard_normal())
        dur = task.flops * jitter / capacity if task.flops > 0 else 0.0
        dur += probe_task_cost
        st.free_at = t0 + dur
        if task.flops > 0:
            n = probes.records_per_task() if probes else 1
            for k in range(n):
                tc_core.append(c)
                tc_node.append(task.node_id)
                tc_part.append(task.part)
                tc_stage.append(task.stage)
                tc_op.append(OP_TYPE_IDS.get(task.op_type, 3))
                tc_flops.append(task.flops / n)
                tc_start.append(t0 + dur * k / n)
                tc_end.append(t0 + dur * (k + 1) / n)
        push(t0 + dur, "done", tid)

    def ready(tid: int, t: float):
        task = tasks[tid]
        st = cores[task.core]
        heapq.heappush(st.pending, (task.stage, task.node_id, task.part, tid))
        try_start(task.core, max(t, st.free_at))

    for t in tasks:
        if in_count[t.task_id] == 0:
            ready(t.task_id, 0.0)

    global_nprobe = 0
    while heap:
        now, _, kind, payload = heapq.heappop(heap)
        if kind == "done":
            task = tasks[payload]
            try_start(task.core, now)
            for fi in out_flows[payload]:
                fl = mapped.flows[fi]
                t_dep = now + probe_msg_cost
                if fl.src_core == fl.dst_core:
                    t_arr, hops, svc = t_dep, 0, 0.0
                else:
                    path = mesh.route(fl.src_core, fl.dst_core)
                    hops = len(path)
                    t_cur = t_dep
                    svc = 0.0
                    g_jit = rng.gamma(cfg.gamma_shape,
                                      1.0 / cfg.gamma_shape)
                    for lid in path:
                        t_s = max(t_cur, link_free[lid])
                        dt = (fl.bytes * g_jit / link_rate(lid, t_s)
                              + cfg.hop_latency)
                        svc += dt
                        link_free[lid] = t_s + dt
                        t_cur = t_s + dt
                    t_arr = t_cur
                if probes is None or probes.comm:
                    tm_src.append(fl.src_core)
                    tm_dst.append(fl.dst_core)
                    tm_stage.append(fl.stage)
                    tm_bytes.append(fl.bytes)
                    tm_dep.append(t_dep)
                    tm_arr.append(t_arr)
                    tm_hops.append(hops)
                    tm_svc.append(svc)
                push(t_arr, "arrive", fi)
        else:  # arrive
            fl = mapped.flows[payload]
            in_count[fl.dst_task] -= 1
            if in_count[fl.dst_task] == 0:
                ready(fl.dst_task, now)

    total = 0.0
    if tc_end:
        total = max(total, max(tc_end))
    if tm_arr:
        total = max(total, max(tm_arr))

    comp = {
        "core": np.asarray(tc_core, dtype=np.int32),
        "node": np.asarray(tc_node, dtype=np.int32),
        "part": np.asarray(tc_part, dtype=np.int32),
        "stage": np.asarray(tc_stage, dtype=np.int32),
        "op": np.asarray(tc_op, dtype=np.int32),
        "flops": np.asarray(tc_flops, dtype=np.float64),
        "t_start": np.asarray(tc_start, dtype=np.float64),
        "t_end": np.asarray(tc_end, dtype=np.float64),
    }
    comm = {
        "src": np.asarray(tm_src, dtype=np.int32),
        "dst": np.asarray(tm_dst, dtype=np.int32),
        "stage": np.asarray(tm_stage, dtype=np.int32),
        "bytes": np.asarray(tm_bytes, dtype=np.float64),
        "t_depart": np.asarray(tm_dep, dtype=np.float64),
        "t_arrive": np.asarray(tm_arr, dtype=np.float64),
        "hops": np.asarray(tm_hops, dtype=np.int32),
        "service": np.asarray(tm_svc, dtype=np.float64),
    }
    return SimResult(total_time=total, comp=comp, comm=comm,
                     n_raw_records=len(tc_core) + len(tm_src))


# --- mitigation re-simulation --------------------------------------------

def clip_failures(failures: list[FailSlow] | None,
                  from_time: float) -> list[FailSlow]:
    """Remaining failure windows at ``from_time``, re-based to t=0.

    A mitigated deployment restarts its clock: a window ``[t0, t0+dur)``
    becomes ``[max(t0 - from_time, 0), end - from_time)`` and is dropped
    entirely once it has already elapsed.  ``from_time=0`` is the identity.
    """
    out: list[FailSlow] = []
    for f in failures or []:
        end = f.t0 + f.duration
        if end <= from_time:
            continue
        t0 = max(f.t0 - from_time, 0.0)
        out.append(dataclasses.replace(f, t0=t0, duration=end - from_time - t0))
    return out


def simulate_mitigated(mapped: MappedGraph, cfg: SimConfig,
                       failures: list[FailSlow] | None = None,
                       probes: ProbePlan | None = None,
                       from_time: float = 0.0) -> SimResult:
    """Re-simulate a mitigated mapping over the *remaining* failure window.

    ``mapped`` is the post-mitigation deployment (remapped tasks and/or a
    :class:`~repro_torch.core.routing.DetourMesh`); ``from_time`` is the stream
    time at which mitigation engaged (0.0 models a post-hoc restart).  The
    still-active slowdown windows are clipped and re-based so a mitigation
    that merely sidesteps an expired failure gets no spurious credit.
    """
    return simulate(mapped, cfg, failures=clip_failures(failures, from_time),
                    probes=probes)
