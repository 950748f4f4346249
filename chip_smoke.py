#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # from the repository root, one card

1. builds every CUDA source in ``src/repro_torch/csrc`` (one ``nvcc`` each,
   started together) into ``build/``;
2. holds each kernel against its plain torch version on the card: the
   Fail-Slow Sketch insert (random run streams, forced eviction, the
   promotion/steal branches, a per-record stream; integer state and drain
   exact, float statistics bit-equal) and the fused FailRank step (s within
   1e-5, L exact);
3. drives the main path, ``Sloth.detect`` with the batched recorder on the
   card, for resnet50 on an 8×8 mesh (core 6, link 20, no fault) with the
   launch counts set to 0 just before and read just after, plus
   ``failrank_dense`` on the core fault's MCG through the FailRank kernel;
   every verdict must equal the JAX reference's (pinned below, since this
   script may not import it), the sketch kernel must launch twice per
   ``detect`` and both drains must be non-empty;
4. records the same trace on the plain CPU path and requires identical
   patterns and byte accounting, and times each kernel (CUDA events) beside
   its plain version and its bound;
5. repeats the verdict checks for resnet50 on a 4×4 mesh.

Every phase prints one JSON object per line.  The line before the last is
the per-kernel summary; the last is ``{"ok": true, "device": ...}``.  Any
failed check exits non-zero; without a card the script exits 2.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peaks from NVIDIA's data sheet (dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

#: Verdicts of the JAX reference (``repro``, recorder_impl="batched", seed 0,
#: t0=1 s, duration 8 s, slowdown 10×): (flagged, kind, location,
#: FailRank iterations).
REFERENCE = {
    (8, ("core", 6)): (True, "core", 6, 27),
    (8, ("link", 20)): (True, "link", 20, 27),
    (8, None): (False, None, None, 26),
    (4, ("core", 6)): (True, "core", 6, 25),
    (4, ("link", 5)): (True, "link", 5, 25),
    (4, None): (False, None, None, 24),
}


class CheckFailed(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream, after
    one warm-up call, by CUDA events."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def max_abs_err(got: dict, exp: dict) -> float:
    """Integer entries must be equal; returns the largest float gap."""
    err = 0.0
    for k in exp:
        a, b = got[k].cpu(), exp[k].cpu()
        require(a.dtype == b.dtype and a.shape == b.shape, f"{k} layout")
        if a.dtype.is_floating_point:
            err = max(err, float((a - b).abs().max()) if a.numel() else 0.0)
        else:
            require(bool((a == b).all()), f"{k} differs")
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def random_runs(seed, n, n_keys, max_rep=12):
    from repro_torch.core.sketch import split_key
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, size=n).astype(np.int64) * 0x9E3779B9
    lo, hi = split_key(keys)
    return (lo, hi, rng.integers(1, max_rep, size=n).astype(np.int32),
            rng.random(n).astype(np.float32),
            (rng.random(n) * 3).astype(np.float32),
            np.cumsum(rng.random(n)).astype(np.float32),
            (rng.random(n) * 0.01).astype(np.float32))


def sketch_case(p, runs, dev):
    """Kernel vs plain version, both on the card; returns max float gap
    over state and drain (integers must be equal)."""
    import torch

    from repro_torch.kernels.sketch_update import ops, ref
    args = [torch.from_numpy(x).to(dev) for x in runs]
    n = len(runs[0])
    st_k, dr_k = ops.insert_runs_cuda(ref.make_state(p, dev),
                                      ref.make_drain(n, dev), *args, H=p.H)
    st_p, dr_p = ref.insert_runs_plain(ref.make_state(p, dev),
                                       ref.make_drain(n, dev), *args, H=p.H)
    torch.cuda.synchronize()
    return max(max_abs_err(st_k, st_p), max_abs_err(dr_k, dr_p)), \
        int(dr_k["d_n"])


def check_sketch_kernel(dev):
    import torch

    from repro_torch.core.sketch import SketchParams, split_key
    from repro_torch.kernels.sketch_update import ops, ref
    cases = []
    for seed, d, m, H, L, n, keys in ((0, 2, 64, 4, 16, 300, 20),
                                      (1, 1, 8, 2, 2, 300, 20),
                                      (2, 3, 16, 8, 4, 300, 20),
                                      (5, 2, 256, 4, 8, 400, 60),
                                      (3, 2, 1024, 8, 1024, 600, 200)):
        p = SketchParams(d=d, m=m, H=H, L=L)
        err, drained = sketch_case(p, random_runs(seed, n, keys), dev)
        require(err == 0.0, f"sketch kernel float gap {err} ({p})")
        cases.append({"params": [d, m, H, L], "runs": n, "drained": drained,
                      "max_abs_err": err})
    # promotion / steal / decrement on one bucket
    p = SketchParams(d=1, m=1, H=4, L=4)
    lo, hi = split_key(np.array([7, 7, 9, 9, 5], dtype=np.int64))
    durs = np.full(5, 0.25, np.float32)
    runs = (lo, hi, np.array([2, 5, 3, 9, 3], np.int32), durs, durs * 2,
            (np.arange(5) * 10).astype(np.float32),
            np.full(5, 0.5, np.float32))
    err, _ = sketch_case(p, runs, dev)
    require(err == 0.0, "promotion/steal case")
    cases.append({"params": [1, 1, 4, 4], "runs": 5, "case": "steal",
                  "max_abs_err": err})
    # per-record stream with a drain (each record a run of one)
    p = SketchParams(d=2, m=64, H=2, L=4)
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 40, size=500).astype(np.int64) * 31337
    lo, hi = split_key(keys)
    dur = rng.random(500).astype(np.float32)
    recs = [torch.from_numpy(x).to(dev) for x in
            (lo, hi, dur, dur * 2, np.arange(500, dtype=np.float32))]
    st_k, dr_k = ops.insert(ref.make_state(p, dev), *recs, params=p,
                            drain=ref.make_drain(500, dev))
    st_p, dr_p = ref.insert_plain(ref.make_state(p, dev),
                                  ref.make_drain(500, dev), *recs, H=p.H)
    err = max(max_abs_err(st_k, st_p), max_abs_err(dr_k, dr_p))
    require(err == 0.0, "per-record stream")
    cases.append({"params": [2, 64, 2, 4], "records": 500,
                  "drained": int(dr_k["d_n"]), "max_abs_err": err})
    return cases


def check_failrank_kernel(dev):
    import torch

    from repro_torch.kernels.failrank_step.ops import failrank_step_cuda
    from repro_torch.kernels.failrank_step.ref import failrank_step_ref
    n = 260
    rng = np.random.default_rng(n)
    w = rng.random((n, n)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    x = [torch.from_numpy(a).to(dev) for a in
         (w, rng.random((n, n)).astype(np.float32),
          rng.random(n).astype(np.float32), rng.random(n).astype(np.float32))]
    s_k, l_k = failrank_step_cuda(*x)
    s_p, l_p = failrank_step_ref(*x)
    torch.cuda.synchronize()
    es = float((s_k - s_p).abs().max())
    el = float((l_k - l_p).abs().max())
    require(es <= 1e-5 and el == 0.0, f"failrank step gaps s={es} L={el}")
    return {"n": n, "s_max_abs_err": es, "l_max_abs_err": el}


# ---------------------------------------------------------------------------
# phases 3-5: the main path
# ---------------------------------------------------------------------------

def fault_list(mesh_n):
    return [f for (m, f) in REFERENCE if m == mesh_n]


def drive(sloth, mesh_n, lib):
    """Three ``detect`` calls; checks each verdict against the reference
    and the sketch kernel's two launches per call."""
    from repro_torch.core.failures import FailSlow
    verdicts = {}
    for f in fault_list(mesh_n):
        before = lib.LAUNCHES["sketch_insert_runs"]
        t0 = time.perf_counter()
        v = sloth.detect([FailSlow(*f, 1.0, 8.0, 10.0)] if f else None,
                         seed=0)
        secs = time.perf_counter() - t0
        k1 = lib.LAUNCHES["sketch_insert_runs"] - before
        flagged, kind, loc, iters = REFERENCE[(mesh_n, f)]
        r = v.recorder
        emit({"phase": "verdict", "mesh": f"{mesh_n}x{mesh_n}",
              "fault": f, "flagged": v.flagged, "kind": v.kind,
              "location": v.location, "iterations": v.failrank.iterations,
              "reference": {"flagged": flagged, "kind": kind,
                            "location": loc, "iterations": iters},
              "ranking": [[k, l, s] for k, l, s in v.ranking],
              "sketch_launches": k1, "n_comp_drained": r.n_comp_drained,
              "n_comm_drained": r.n_comm_drained,
              "compression_ratio": r.compression_ratio,
              "detect_s": secs})
        require((v.flagged, v.kind, v.location) == (flagged, kind, loc),
                f"{mesh_n}x{mesh_n} {f}: verdict differs from reference")
        require(abs(v.failrank.iterations - iters) <= 1,
                f"{mesh_n}x{mesh_n} {f}: FailRank iterations "
                f"{v.failrank.iterations} vs reference {iters}")
        require(k1 == 2, f"sketch kernel launched {k1} times in detect")
        verdicts[f] = v
    return verdicts


def same_recording(a, b):
    for side in ("comp", "comm"):
        pa, pb = getattr(a, side + "_patterns"), getattr(b, side + "_patterns")
        require([(q.key, q.count, q.arrival) for q in pa]
                == [(q.key, q.count, q.arrival) for q in pb],
                f"{side} patterns differ between card and CPU")
    for f in ("sketch_comp_bytes", "sketch_comm_bytes", "n_comp_drained",
              "n_comm_drained", "n_comp_records", "n_comm_records"):
        require(getattr(a, f) == getattr(b, f), f"{f} differs")


def sketch_inputs(sloth, sim, dev):
    """The two sketches' run tensors exactly as ``record`` builds them
    (at its default packetisation)."""
    import torch

    from repro_torch.core.probes import PACKET_BYTES
    from repro_torch.core.recorder import comm_runs, comp_runs
    from repro_torch.core.sketch import split_key
    out = {}
    for side, runs in (("comp", comp_runs(sim.comp,
                                          sloth.cfg.instr_per_task)),
                       ("comm", comm_runs(sim.comm, PACKET_BYTES, 64,
                                          sloth.sim_cfg.hop_latency))):
        lo, hi = split_key(np.asarray(runs[0], dtype=np.int64))
        out[side] = [torch.from_numpy(np.ascontiguousarray(x, dtype=dt))
                     .to(dev) for x, dt in zip(
                         (lo, hi, *runs[1:]),
                         (np.int32, np.int32, np.int32, np.float32,
                          np.float32, np.float32, np.float32))]
    return out


def time_stages(sloth, sim):
    """Wall time of ``record`` and of each stage of ``analyse_recorded``
    for one trace (host clock, synchronised)."""
    import torch

    from repro_torch.core.detection import detect_cores, detect_links
    from repro_torch.core.failrank import failrank
    from repro_torch.core.mcg import build_mcg
    from repro_torch.core.recorder import record
    cfg, mesh = sloth.cfg, sloth.mesh
    ms = {}
    t0 = time.perf_counter()
    rec = record(sim, cfg.sketch, instr_per_task=cfg.instr_per_task,
                 hop_latency=sloth.sim_cfg.hop_latency,
                 impl=cfg.recorder_impl, device=sloth.device)
    torch.cuda.synchronize()
    ms["record"] = (time.perf_counter() - t0) * 1e3
    T = sim.total_time
    core_z, link_ratio = cfg.flag_thresholds(mesh)
    t0 = time.perf_counter()
    cores = detect_cores(rec.comp_patterns, T, cfg.n_windows, core_z,
                         rate_scale=getattr(mesh, "rate_class", None))
    ms["detect_cores"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    links = detect_links(rec.comm_patterns, mesh, T, cfg.n_windows,
                         sloth.sim_cfg.hop_latency, link_ratio)
    ms["detect_links"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    mcg = build_mcg(rec.comm_patterns, mesh, T, cores, links, cfg.n_windows)
    ms["build_mcg"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    failrank(mcg, cfg.failrank, device=sloth.device)
    ms["failrank"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    sloth.analyse_recorded(rec, T)
    ms["analyse_recorded_total"] = (time.perf_counter() - t0) * 1e3
    return ms


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    from repro_torch.core.failrank import failrank
    from repro_torch.core.failures import FailSlow
    from repro_torch.core.graph import build_workload
    from repro_torch.core.recorder import record
    from repro_torch.core.routing import Mesh2D
    from repro_torch.core.sloth import Sloth, SlothConfig
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _lib as lib
    from repro_torch.kernels.failrank_step import ops as fr_ops
    from repro_torch.kernels.failrank_step.ref import failrank_step_ref
    from repro_torch.kernels.sketch_update import ops as sk_ops
    from repro_torch.kernels.sketch_update import ref as sk_ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    card = smi.strip().splitlines()[0]
    print(card, flush=True)
    dev = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0)})

    # ---- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    secs = lib.build_all()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "per_source": secs,
          "ptxas": {n: [ln.strip() for ln in lib.build_log(n).splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n in secs}})

    # ---- 2. kernels against their plain versions -------------------------
    emit({"phase": "sketch_kernel_vs_plain", "cases": check_sketch_kernel(dev)})
    emit({"phase": "failrank_kernel_vs_plain", **check_failrank_kernel(dev)})

    # ---- 3. the main path: resnet50 on 8×8 -------------------------------
    cfg = SlothConfig(recorder_impl="batched")
    t0 = time.perf_counter()
    sloth8 = Sloth(build_workload("resnet50"), Mesh2D(8), cfg)
    setup_s = time.perf_counter() - t0
    require(sloth8.device == dev, f"default device {sloth8.device}")
    lib.reset_launches()
    verdicts = drive(sloth8, 8, lib)
    mcg = verdicts[("core", 6)].mcg
    _, s_dense, _, dense_it = fr_ops.failrank_dense(mcg, cfg.failrank)
    launches = dict(lib.LAUNCHES)
    coo = verdicts[("core", 6)].failrank
    dense_err = float(np.abs(s_dense - coo.raw_node_scores).max())
    emit({"phase": "failrank_dense", "mesh": "8x8", "nodes": mcg.n_nodes,
          "edges": int(len(mcg.edge_src)), "iterations": dense_it,
          "coo_iterations": coo.iterations, "s_max_abs_err_vs_coo":
          dense_err})
    emit({"phase": "main_path_launches", "launches": launches,
          "setup_s": setup_s})
    require(dense_err <= 1e-4, f"dense vs COO s gap {dense_err}")
    require(launches["sketch_insert_runs"] == 6, "sketch kernel launches")
    require(dense_it >= 1 and launches["failrank_step"] == dense_it,
            "failrank kernel launches")
    for f, v in verdicts.items():
        require(v.recorder.n_comp_drained > 0
                and v.recorder.n_comm_drained > 0, f"empty drain for {f}")

    # ---- 4. the same trace on the plain CPU path; times ------------------
    core6 = [FailSlow("core", 6, 1.0, 8.0, 10.0)]
    sim = sloth8.run(core6, seed=0)
    rec_cpu = {}
    cpu_ms = host_ms(lambda: rec_cpu.setdefault("r", record(
        sim, cfg.sketch, instr_per_task=cfg.instr_per_task,
        hop_latency=sloth8.sim_cfg.hop_latency, impl="batched",
        device="cpu")))
    same_recording(verdicts[("core", 6)].recorder, rec_cpu["r"])
    emit({"phase": "cpu_recording_identical", "mesh": "8x8",
          "record_cpu_ms": cpu_ms})
    emit({"phase": "stage_ms", "mesh": "8x8", "fault": ["core", 6],
          "simulate_ms": host_ms(lambda: sloth8.run(core6, seed=0)),
          **time_stages(sloth8, sim)})

    p = cfg.sketch
    inputs = sketch_inputs(sloth8, sim, dev)
    k1 = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "err": 0.0, "runs": {}}
    for side, args in inputs.items():
        n = args[0].shape[0]
        st0, dr0 = sk_ref.make_state(p, dev), sk_ref.make_drain(n, dev)

        def kernel(args=args, st0=st0, dr0=dr0):
            # the wrapper copies the state and drain, then launches
            return sk_ops.insert_runs_cuda(st0, dr0, *args, H=p.H)
        ms = cuda_ms(kernel, reps=5)
        st_k, dr_k = kernel()
        cpu_args = [a.cpu() for a in args]
        out = {}
        plain = host_ms(lambda: out.setdefault("r", sk_ref.insert_runs_plain(
            sk_ref.make_state(p), sk_ref.make_drain(n), *cpu_args, H=p.H)))
        st_p, dr_p = out["r"]
        err = max(max_abs_err(st_k, st_p), max_abs_err(dr_k, dr_p))
        drained = int(dr_k["d_n"])
        state_b = sum(t.numel() * t.element_size() for t in st_k.values())
        nbytes = (sum(a.numel() * a.element_size() for a in args)
                  + 2 * state_b + drained * 40 + 8)
        k1["ms"] += ms
        k1["plain_ms"] += plain
        k1["bytes"] += nbytes
        k1["err"] = max(k1["err"], err)
        k1["runs"][side] = {"runs": n, "drained": drained, "ms": ms,
                            "plain_cpu_ms": plain, "bytes": nbytes}
    require(k1["err"] == 0.0, f"sketch kernel vs plain at main-path shapes: "
                              f"{k1['err']}")
    emit({"phase": "sketch_kernel_main_path_shapes", **k1["runs"],
          "max_abs_err": k1["err"]})

    w, l = (torch.from_numpy(x).to(dev) for x in fr_ops.mcg_dense(mcg))
    s0 = torch.as_tensor(mcg.s0, dtype=torch.float32, device=dev)
    s_k, l_k = fr_ops.failrank_step_cuda(w, l, s0, s0)
    s_p, l_p = failrank_step_ref(w, l, s0, s0)
    k2_err = max(float((s_k - s_p).abs().max()),
                 float((l_k - l_p).abs().max()))
    require(k2_err <= 1e-5, f"failrank step on the MCG: {k2_err}")
    k2_ms = cuda_ms(lambda: fr_ops.failrank_step_cuda(w, l, s0, s0), 200)
    k2_plain = cuda_ms(lambda: failrank_step_ref(w, l, s0, s0), 200)
    n = mcg.n_nodes
    k2_bytes = 3 * n * n * 4 + 3 * n * 4
    k2_flops = 5 * n * n + 3 * n

    # ---- 5. resnet50 on 4×4 (the quickstart configuration) ---------------
    sloth4 = Sloth(build_workload("resnet50"), Mesh2D(4), cfg)
    lib.reset_launches()
    drive(sloth4, 4, lib)
    emit({"phase": "main_path_launches", "mesh": "4x4",
          "launches": dict(lib.LAUNCHES)})
    require(lib.LAUNCHES["sketch_insert_runs"] == 6, "4x4 sketch launches")
    again = failrank(mcg, cfg.failrank)
    require(again.iterations == coo.iterations and np.array_equal(
        again.raw_node_scores, coo.raw_node_scores),
        "COO FailRank is not run-to-run identical on the card")

    k1_bound = k1["bytes"] / HBM_BYTES_PER_S * 1e3
    k2_bound = max(k2_bytes / HBM_BYTES_PER_S,
                   k2_flops / FP32_FLOP_PER_S) * 1e3
    emit({"kernels": [
        {"name": "sketch_insert_runs", "route": "cuda",
         "source": "src/repro_torch/csrc/sketch_insert.cu",
         "replaces": "src/repro/kernels/sketch_update/kernel.py:158",
         "launches": launches["sketch_insert_runs"],
         "max_abs_err": k1["err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"], "plain_device": "cpu",
         "bound_ms": k1_bound, "bound_by": "bytes", "library_ms": None,
         "shape": "resnet50 8x8, comp + comm sketches of one detect"},
        {"name": "failrank_step", "route": "cuda",
         "source": "src/repro_torch/csrc/failrank_step.cu",
         "replaces": "src/repro/kernels/failrank_step/kernel.py:42",
         "launches": launches["failrank_step"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain, "plain_device": "cuda",
         "bound_ms": k2_bound,
         "bound_by": "bytes" if k2_bytes / HBM_BYTES_PER_S
         >= k2_flops / FP32_FLOP_PER_S else "operations",
         "library_ms": None, "shape": f"n={n}, one step"},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
