"""End-to-end training driver on the port: train SmolLM-135M for a few
hundred steps with checkpointing, the twin of ``examples/train_smollm.py``.
The default runs the *reduced* config; pass --full for the 135M model.

    PYTHONPATH=src python examples/torch_train_smollm.py          # smoke, cuda:0
    PYTHONPATH=src python examples/torch_train_smollm.py --full   # 135M
    PYTHONPATH=src python examples/torch_train_smollm.py --device cpu

Checkpoints go under the temporary directory (``$TMPDIR``).
"""

import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse  # noqa: E402
import tempfile  # noqa: E402

from repro_torch.launch.train import main as train_main  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--full", action="store_true")
ap.add_argument("--steps", type=int, default=0)
ap.add_argument("--device", default=None,
                help="torch device (default: cuda:0; 'cpu' runs the "
                     "kernels' plain versions)")
args = ap.parse_args()

tmp = tempfile.gettempdir()
if args.full:
    steps = args.steps or 300
    argv = ["--arch", "smollm-135m", "--steps", str(steps),
            "--batch", "8", "--seq", "512", "--lr", "3e-4",
            "--ckpt-dir", os.path.join(tmp, "smollm_ckpt"),
            "--ckpt-every", "50"]
else:
    steps = args.steps or 200
    argv = ["--arch", "smollm-135m", "--smoke", "--steps", str(steps),
            "--batch", "8", "--seq", "128", "--lr", "1e-3",
            "--ckpt-dir", os.path.join(tmp, "smollm_smoke_ckpt"),
            "--ckpt-every", "50"]
if args.device is not None:
    argv += ["--device", args.device]

losses = train_main(argv)
print(f"\nfinal loss {losses[-1]:.4f} (start {losses[0]:.4f}) — "
      "resume any time with the same command plus --resume")
