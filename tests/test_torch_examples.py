"""The port's example twins (``examples/torch_*.py``) on the CPU against
the reference examples they mirror.

Each twin runs in a subprocess with ``--device cpu``, with the reference
example's own small flags (``train_smollm --steps 3``, ``campaign_sweep
--tiny``), and must leave neither ``jax`` nor ``repro`` in ``sys.modules``.
Where the reference example prints a verdict, the twin prints the same
lines at the same seed: quickstart's whole report (flagged, kind,
location, top-3 ranking, FailRank iterations, compression) and the
campaign's per-cell table and aggregate.  The serving and training twins
draw their weights from a seeded ``torch.Generator`` (not the reference's
``jax.random``), so there the request and step counts are compared and
the losses are held near ln(vocab).  The straggler drill has a file of its
own (``test_torch_example_drill.py``).
"""

import math
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

#: One thread a process: the examples are small, and several run at once
#: under the test runner's workers.
THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}

#: Runs an example as ``__main__`` and prints, last, the modules of the
#: JAX stack or the reference package that it imported.
RUNNER = (
    "import runpy, sys\n"
    "path = sys.argv[1]\n"
    "sys.argv = sys.argv[1:]\n"
    "try:\n"
    "    runpy.run_path(path, run_name='__main__')\n"
    "finally:\n"
    "    print('IMPORTED', sorted(m for m in sys.modules\n"
    "                            if m.split('.')[0] in ('jax', 'repro')))\n")


def run_twin(name, *argv, tmp=None):
    """stdout lines of ``examples/<name>.py --device cpu``; asserts it
    exits 0 and imports neither jax nor the reference."""
    env = {**os.environ, **THREADS, "PYTHONPATH": str(REPO / "src")}
    if tmp is not None:
        env["TMPDIR"] = str(tmp)
    r = subprocess.run(
        [sys.executable, "-c", RUNNER, str(REPO / "examples" / f"{name}.py"),
         *argv, "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    assert lines[-1] == "IMPORTED []", lines[-1]
    return lines[:-1]


def run_reference(name, *argv):
    """stdout lines of the reference ``examples/<name>.py``."""
    env = {**os.environ, **THREADS, "PYTHONPATH": str(REPO / "src"),
           "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, str(REPO / "examples" / f"{name}.py"),
                        *argv], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout.splitlines()


def test_quickstart_twin_prints_the_reference_verdict():
    twin = run_twin("torch_quickstart")
    ref = run_reference("quickstart")
    launches = [ln for ln in twin if ln.startswith("kernel launches")]
    assert launches == ["kernel launches on cpu: {}"]
    assert [ln for ln in twin if ln not in launches] == ref
    assert "flagged:   True" in ref and "OK: root cause correctly " \
        "localised." in ref


def _block(lines, first, last):
    i = next(k for k, ln in enumerate(lines) if ln.startswith(first))
    j = next(k for k, ln in enumerate(lines) if ln.startswith(last))
    return lines[i:j]


def test_campaign_sweep_twin_prints_the_reference_tables():
    twin = run_twin("torch_campaign_sweep", "--tiny")
    ref = run_reference("campaign_sweep", "--tiny")
    block = _block(twin, "== per-cell", "wall time per scenario")
    assert block == _block(ref, "== per-cell", "wall time per scenario")
    assert "accuracy:  100.00% (3/3, CI [43.8, 100.0])" in block
    assert twin[0].startswith("campaign: 1 workloads") \
        and twin[0].endswith("device cpu)")


def test_serve_decode_twin_serves_every_request():
    twin = run_twin("torch_serve_decode")
    ref = run_reference("serve_decode")

    def summary(lines):
        served = next(ln for ln in lines if ln.startswith("served"))
        return served.split(" in ")[0]

    assert summary(twin) == summary(ref) \
        == "served 10 requests, 120 new tokens"
    reqs = [ln for ln in twin if ln.startswith("req ")]
    assert [ln.split(" -> ")[0] for ln in reqs] \
        == [ln.split(" -> ")[0] for ln in ref if ln.startswith("req ")]
    for ln in reqs:
        tokens = eval(ln.split(" -> ")[1])          # a printed list
        assert len(tokens) == 12 and all(0 <= t < 256 for t in tokens)


def test_train_smollm_twin_trains(tmp_path):
    twin = run_twin("torch_train_smollm", "--steps", "3", tmp=tmp_path)
    assert any(ln.startswith("done: 3 steps") for ln in twin)
    final = twin[-1].split()
    assert final[:2] == ["final", "loss"]
    last, start = float(final[2]), float(final[4].rstrip(")"))
    # random weights predict about uniformly over the smoke vocab
    assert abs(start - math.log(256)) < 0.1 and last < start
    assert list(tmp_path.iterdir()) == []      # no checkpoint in 3 steps
