"""Scenario-campaign sweep: the paper's aggregate metrics, on the card by
default.

Runs a grid of fail-slow scenarios (workload × mesh × failure kind ×
severity × n_failures × replicate) through every requested detector
(``--detectors``: SLOTH and/or the five baselines, all judged on the same
traces by the same router-aware rule) and prints per-cell, per-detector
and campaign-level accuracy / FPR / top-k localisation / recall@k /
compression / probe overhead, with Wilson confidence intervals and
wall-time telemetry.

    python -m repro_torch.launch.campaign                  # full grid
    python -m repro_torch.launch.campaign --tiny --device cpu
    python -m repro_torch.launch.campaign --tiny --workload resnet50 \\
        --mesh 8x8 --severities 10 --all-detectors --recorder-impl batched \\
        --streaming 4 --mitigation remap --mitigation reroute --workers 0

The flags and gates are those of the reference's sweep, plus
``--device`` (default: the card; ``cpu`` runs the kernels' plain
versions) and ``--workload`` (repeatable; replaces the grid's workloads).

``--kinds`` accepts the base kinds, ``mixed`` and ``core+link``-style
composites; ``--severities`` accepts plain slowdown factors and
``linspace:LO:HI:N`` sweep specs; ``--mesh`` / ``--topology`` entries
share one fabric-spec grammar (``W``, ``WxH``, ``name:WxH[:variant]``).

``--recorder-impl`` selects the SL-Recorder sketch path: ``ref`` (per-run
numpy oracle, the default), ``batched`` (the packed-state path: the
sketch kernel on the card) or ``both`` — which runs the campaign once per
impl and requires scenario-for-scenario identical verdicts and
compression ratios.  The batched path keeps Stage-2 statistics in float32
against the oracle's float64, so run ``both`` on decisively failing grids.

``--streaming N`` runs SLOTH incrementally over each trace split into N
chunks; as a gate, a second, post-hoc campaign is run and every streamed
verdict must equal its one-shot counterpart, and the latency invariants
must hold (``none`` scenarios carry no latency, flagged streamed
positives a finite one, unflagged ones ``inf``).

``--mitigation NAME`` (repeatable) closes the detect → mitigate loop; the
``none`` control is always added.  Gates: the control recovers exactly
0.0 on every scenario, and on core scenarios at least one correct acted-on
verdict recovers throughput.

Every gate raises ``SystemExit`` with a message when it fails.
:func:`main` returns the campaigns it ran, by label.
"""

from __future__ import annotations

import argparse
import time

from ..core.campaign import CampaignGrid, _sev_str, run_campaign
from ..core.detectors import DEFAULT_DETECTORS, available_detectors
from ..core.recorder import RECORDER_IMPLS
from ..core.sloth import SlothConfig
from ..device import resolve_device
from ..mitigate.policy import available_policies


def make_grid(args) -> CampaignGrid:
    n_failures = tuple(args.n_failures) if args.n_failures else (1,)
    kinds = (tuple(args.kinds) if args.kinds
             else ("core", "link", "router", "none"))
    meshes = tuple(args.mesh or ()) + tuple(args.topology or ())
    if args.tiny:
        return CampaignGrid(workloads=tuple(args.workload or ("darknet19",)),
                            meshes=meshes if meshes else (4,),
                            kinds=kinds,
                            severities=(tuple(args.severities)
                                        if args.severities else (8.0,)),
                            n_failures=n_failures,
                            reps=1, campaign_seed=args.seed)
    return CampaignGrid(
        workloads=tuple(args.workload or ("darknet19", "googlenet",
                                          "binary_tree")),
        meshes=meshes if meshes else (4, 6),
        kinds=kinds,
        severities=(tuple(args.severities) if args.severities
                    else (5.0, 10.0)),
        n_failures=n_failures,
        reps=2,
        campaign_seed=args.seed,
    )


def judged(d):
    """The judged fields of one detector outcome (what the gates compare)."""
    return (d.detector, d.flagged, d.pred_kind, d.pred_location,
            d.matched, d.truth_rank, d.truth_ranks)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true",
                    help="minimal smoke grid (4 scenarios)")
    ap.add_argument("--seed", type=int, default=0, help="campaign seed")
    ap.add_argument("--workers", type=int, default=None,
                    help="pool width (default: cpu count)")
    ap.add_argument("--executor", choices=("thread", "process"),
                    default="thread",
                    help="scenario dispatch (bit-identical results either "
                         "way)")
    ap.add_argument("--workload", action="append", default=None,
                    metavar="NAME", help="workload axis entry (repeatable; "
                    "default: the grid's own)")
    ap.add_argument("--n-failures", type=int, action="append", default=None,
                    metavar="K", help="simultaneous-failure axis entry "
                    "(repeatable)")
    ap.add_argument("--mesh", action="append", default=None, metavar="WxH",
                    help="mesh axis entry, 'W' or 'WxH' (repeatable)")
    ap.add_argument("--topology", action="append", default=None,
                    metavar="SPEC",
                    help="fabric axis entry, 'name:WxH[:variant]' "
                         "(repeatable; combines with --mesh)")
    ap.add_argument("--kinds", action="append", default=None, metavar="K",
                    help="failure-kind axis entry: core | link | router | "
                         "none | mixed | 'core+link'-style composite "
                         "(repeatable; default: all four base kinds)")
    ap.add_argument("--severities", action="append", default=None,
                    metavar="S", help="severity axis entry: a slowdown "
                    "factor or 'linspace:LO:HI:N' (repeatable)")
    ap.add_argument("--detectors", action="append", default=None,
                    metavar="NAME", choices=available_detectors(),
                    help="detector to run on every scenario (repeatable; "
                         "default: sloth)")
    ap.add_argument("--all-detectors", action="store_true",
                    help="every built-in detector (SLOTH + five baselines)")
    ap.add_argument("--streaming", type=int, default=0, metavar="N",
                    help="run SLOTH over N trace chunks per scenario and "
                         "require streamed == post-hoc verdicts")
    ap.add_argument("--mitigation", action="append", default=None,
                    metavar="NAME", choices=available_policies(),
                    help="mitigation policy (repeatable; 'none' is added)")
    ap.add_argument("--recorder-impl", default="ref",
                    choices=RECORDER_IMPLS + ("both",),
                    help="SL-Recorder sketch path: ref, batched, or both "
                         "(run twice, require identical verdicts)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda:0; 'cpu' runs the "
                         "kernels' plain versions)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Parse ``argv``, run the campaign(s) and their gates, print the
    tables; returns the :class:`~repro_torch.core.campaign.CampaignResult`
    of each campaign run, by label: ``"campaign"`` (the requested one),
    ``"posthoc"`` (the streaming gate's), ``"batched"`` and
    ``"batched_posthoc"`` (``--recorder-impl both``)."""
    args = parse(argv)
    device = resolve_device(args.device)
    detectors = (DEFAULT_DETECTORS if args.all_detectors
                 else tuple(args.detectors) if args.detectors
                 else ("sloth",))
    # the 'none' control rides along whenever mitigation is requested, so
    # the recovered-throughput table always has its zero baseline
    pols = (tuple(dict.fromkeys(tuple(args.mitigation) + ("none",)))
            if args.mitigation else ())
    grid = make_grid(args)
    n = grid.n_scenarios()
    print(f"campaign: {len(grid.workloads)} workloads × "
          f"{len(grid.meshes)} meshes × {len(grid.kinds)} kinds × "
          f"{len(grid.severities)} severities × "
          f"{len(grid.n_failures)} n_failures × {grid.reps} reps "
          f"= {n} scenarios (seed {grid.campaign_seed}, "
          f"executor {args.executor}, detectors {', '.join(detectors)}, "
          f"recorder {args.recorder_impl}, device {device}"
          + (f", streaming {args.streaming} chunks" if args.streaming
             else "")
          + (f", mitigation {', '.join(pols)}" if pols else "") + ")")

    done = []

    def progress(o):
        done.append(o)
        if len(done) % 10 == 0 or len(done) == n:
            print(f"  ... {len(done)}/{n} scenarios", flush=True)

    def campaign(campaign_cfg, **kw):
        return run_campaign(grid, workers=args.workers,
                            executor=args.executor, detectors=detectors,
                            cfg=campaign_cfg, device=device, **kw)

    cfg = (None if args.recorder_impl in ("ref", "both")
           else SlothConfig(recorder_impl=args.recorder_impl))
    t0 = time.perf_counter()  # lint: allow-wallclock (reported only)
    res = campaign(cfg, progress=progress, streaming=args.streaming,
                   mitigation=pols)
    wall = time.perf_counter() - t0  # lint: allow-wallclock
    results = {"campaign": res}

    def check_streaming(streamed, label, campaign_cfg):
        """Streamed verdicts must equal a post-hoc campaign's, and
        detection latencies must obey the streaming semantics."""
        posthoc = campaign(campaign_cfg)
        for s, p in zip(streamed.outcomes, posthoc.outcomes):
            for ds, dp in zip(s.detector_results, p.detector_results):
                if judged(ds) != judged(dp):
                    raise SystemExit(
                        f"streaming equivalence FAILED ({label}): "
                        f"scenario {s.scenario_id} "
                        f"streamed={judged(ds)} post-hoc={judged(dp)}")
                lat = ds.detection_latency
                if s.kind == "none":
                    if lat is not None:
                        raise SystemExit(
                            f"latency invariant FAILED ({label}): "
                            f"scenario {s.scenario_id} is failure-free "
                            f"but has latency {lat}")
                elif ds.detector == "sloth":
                    if lat is None:
                        raise SystemExit(
                            f"latency invariant FAILED ({label}): "
                            f"streamed positive scenario "
                            f"{s.scenario_id} has no latency")
                    if ds.flagged != (lat != float("inf")):
                        raise SystemExit(
                            f"latency invariant FAILED ({label}): "
                            f"scenario {s.scenario_id} flagged="
                            f"{ds.flagged} but latency {lat}")
        print(f"streaming equivalence ({label}): chunked == post-hoc on "
              f"all {len(streamed.outcomes)} scenarios")
        return posthoc

    if args.streaming:
        results["posthoc"] = check_streaming(
            res, args.recorder_impl if args.recorder_impl != "both"
            else "ref", cfg)

    if pols:
        # mitigation smoke: the control recovers exactly nothing, and on
        # decisive core scenarios a correct acted-on verdict recovers
        # throughput
        for o in res.outcomes:
            for mo in o.mitigation_results:
                if mo.policy == "none" and mo.recovered_frac != 0.0:
                    raise SystemExit(
                        f"mitigation control FAILED: scenario "
                        f"{o.scenario_id} policy 'none' recovered "
                        f"{mo.recovered_frac} (must be exactly 0.0)")
        decisive = [mo for o in res.outcomes if o.kind == "core"
                    for mo in o.mitigation_results
                    if mo.policy != "none" and mo.correct and mo.acted]
        if decisive:
            recovered = [mo for mo in decisive if mo.recovered_frac > 0.0]
            if not recovered:
                raise SystemExit(
                    "mitigation smoke FAILED: no correct acted-on core "
                    "verdict recovered throughput under "
                    f"{', '.join(p for p in pols if p != 'none')}")
            print(f"mitigation smoke: control exactly 0.0 on all "
                  f"{len(res.outcomes)} scenarios; {len(recovered)}/"
                  f"{len(decisive)} acted core mitigations recovered "
                  f"throughput")

    if args.recorder_impl == "both":
        cfg_b = SlothConfig(recorder_impl="batched")
        res_b = results["batched"] = campaign(cfg_b,
                                              streaming=args.streaming)
        if args.streaming:
            results["batched_posthoc"] = check_streaming(res_b, "batched",
                                                         cfg_b)
        for a, b in zip(res.outcomes, res_b.outcomes):
            if a.compression_ratio != b.compression_ratio:
                raise SystemExit(
                    f"recorder parity FAILED: scenario {a.scenario_id} "
                    f"compression ref={a.compression_ratio} "
                    f"batched={b.compression_ratio}")
            for da, db in zip(a.detector_results, b.detector_results):
                ka = judged(da) + (da.detection_latency,)
                kb = judged(db) + (db.detection_latency,)
                if ka != kb:
                    raise SystemExit(
                        f"recorder parity FAILED: scenario "
                        f"{a.scenario_id} ref={ka} batched={kb}")
        print(f"\nrecorder parity: ref == batched on all "
              f"{len(res.outcomes)} scenarios (verdicts, ranks, "
              f"compression ratios"
              + (", detection latencies" if args.streaming else "") + ")")

    print("\n== per-cell (workload, fabric, kind, severity, n_failures) ==")
    for (wl, w, h, kind, sev, nf, topo), m in res.cells.items():
        if kind == "none":
            stat = (f"FPR {m.fpr.pct():6.2f}% "
                    f"({m.fpr.successes}/{m.fpr.trials})")
        else:
            stat = (f"acc {m.accuracy.pct():6.2f}% "
                    f"({m.accuracy.successes}/{m.accuracy.trials}) "
                    f"top3 {m.topk_rate(3)*100:6.2f}% "
                    f"recall@3 {m.recall_at(3)*100:6.2f}%")
        print(f"  {wl:12s} {topo}:{w}x{h} {kind:9s} x{_sev_str(sev):<8s} "
              f"k={nf} {stat}")

    if len(detectors) > 1:
        print("\n== per-detector (accuracy / FPR / top-3 / recall@3) ==")
        for name, m in res.detector_metrics.items():
            print(f"  {name:8s} acc {m.accuracy.pct():6.2f}% "
                  f"({m.accuracy.successes}/{m.accuracy.trials})  "
                  f"FPR {m.fpr.pct():6.2f}% "
                  f"({m.fpr.successes}/{m.fpr.trials})  "
                  f"top3 {m.topk_rate(3)*100:6.2f}%  "
                  f"recall@3 {m.recall_at(3)*100:6.2f}%")

    print("\n== campaign aggregate ==")
    print(res.summary())
    print(f"\nwall time: {wall:.1f}s ({wall / max(n, 1):.2f}s/scenario)")
    return results


if __name__ == "__main__":
    main()
