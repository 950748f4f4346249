"""Quickstart on the port: detect an injected fail-slow failure with SLOTH
on the card, the twin of ``examples/quickstart.py``.

The recorder is the deployable one (``recorder_impl="batched"``): on the
card the Fail-Slow Sketch is filled by the sketch-insert kernel, one launch
for both sketches; its verdict and compression equal the reference
recorder's.

    PYTHONPATH=src python examples/torch_quickstart.py                # cuda:0
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.failures import FailSlow  # noqa: E402
from repro_torch.core.graph import build_workload  # noqa: E402
from repro_torch.core.routing import Mesh2D  # noqa: E402
from repro_torch.core.sloth import Sloth, SlothConfig  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default=None,
                help="torch device (default: cuda:0; 'cpu' runs the "
                     "kernels' plain versions)")
args = ap.parse_args()

# 1. a 4×4 many-core accelerator running ResNet-50 inference
mesh = Mesh2D(4)
graph = build_workload("resnet50")
sloth = Sloth(graph, mesh, cfg=SlothConfig(recorder_impl="batched"),
              device=args.device)
print(f"workload: {graph}")
print("probe plan generated by SL-Compiler:")
print(sloth.plan.describe())

# 2. inject a 10× fail-slow on core 6 between t=1s and t=9s
failure = FailSlow(kind="core", location=6, t0=1.0, duration=8.0,
                   slowdown=10.0)
_lib.reset_launches()
verdict = sloth.detect([failure], seed=0)
launches = {k: v for k, v in _lib.LAUNCHES.items() if v}

# 3. the verdict
print(f"\nflagged:   {verdict.flagged}")
print(f"root cause: {verdict.kind} {verdict.location} "
      f"(injected: {failure.kind} {failure.location})")
print(f"top-3 ranking: {[(k, l, round(s, 3)) for k, l, s in verdict.ranking[:3]]}")
print(f"FailRank iterations: {verdict.failrank.iterations}")
print(f"trace compression: {verdict.recorder.compression_ratio:.1f}x "
      f"({verdict.recorder.raw_bytes/1024:.0f} KiB -> "
      f"{verdict.recorder.sketch_bytes/1024:.0f} KiB)")
print(f"kernel launches on {sloth.device}: {launches}")
assert verdict.matches(failure), "detection failed!"
print("\nOK: root cause correctly localised.")
