"""Straggler drill on the port: SLOTH watching a (simulated) 16×16 pod,
the twin of ``examples/straggler_drill.py``.

A slow chip and a degraded inter-chip link are injected into per-step
telemetry; the pod detector (its FailRank on ``--device``) localises both
and the mitigation policy plans the response (data-shard rebalance or
checkpoint+exclude restart).

    PYTHONPATH=src python examples/torch_straggler_drill.py           # cuda:0
    PYTHONPATH=src python examples/torch_straggler_drill.py --device cpu
"""

import argparse
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.failures import FailSlow  # noqa: E402
from repro_torch.distributed.telemetry import (  # noqa: E402
    MitigationPolicy, PodDetector, PodSimulator, PodTelemetryConfig)

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default=None,
                help="torch device (default: cuda:0; 'cpu' runs the "
                     "kernels' plain versions)")
args = ap.parse_args()

cfg = PodTelemetryConfig(mesh_w=16, mesh_h=16)
detector = PodDetector(cfg, device=args.device)
policy = MitigationPolicy(n_shards=16)

# yi-34b-class training step: ~0.8 TFLOP/chip/step, ~0.5 GB collectives
pod = PodSimulator(cfg, step_flops=8e11, collective_bytes=128e9, seed=0)

print("== phase 1: healthy pod ==")
v = detector.analyse(pod.run_steps(32))
print(f"flagged={v.flagged}  action={v.action}")

print("\n== phase 2: chip (14,7) thermally throttled 5x ==")
chip = 7 * 16 + 14
pod.inject(FailSlow("core", chip, 0.0, 1e9, 5.0))
v = detector.analyse(pod.run_steps(32))
print(f"flagged={v.flagged} kind={v.kind} loc={v.location} "
      f"(injected chip {chip}) severity={v.severity:.1f}")
print("mitigation:", policy.plan(v))

print("\n== phase 3: degraded ICI link ==")
pod2 = PodSimulator(cfg, step_flops=8e11, collective_bytes=128e9, seed=1)
pod2.inject(FailSlow("link", 77, 0.0, 1e9, 8.0))
v = detector.analyse(pod2.run_steps(32))
u, w = detector.mesh.links[77]
print(f"flagged={v.flagged} kind={v.kind} loc={v.location} "
      f"(injected link 77 = chip{u}->chip{w})")
print("mitigation:", policy.plan(v))
