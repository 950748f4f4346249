"""``examples/torch_straggler_drill.py`` on the CPU prints what the
reference's ``examples/straggler_drill.py`` prints: the three phases'
verdicts (healthy, chip 126 throttled 5×, link 77 degraded) and the
mitigation plans, line for line, and imports neither ``jax`` nor
``repro``.  The two drills run side by side (each ~20 s here)."""

import os
import subprocess
import sys

from test_torch_examples import REPO, RUNNER, THREADS


def test_straggler_drill_twin_prints_the_reference_verdicts():
    env = {**os.environ, **THREADS, "PYTHONPATH": str(REPO / "src"),
           "JAX_PLATFORMS": "cpu"}
    procs = [subprocess.Popen(argv, cwd=REPO, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for argv in (
                 [sys.executable, "-c", RUNNER,
                  str(REPO / "examples/torch_straggler_drill.py"),
                  "--device", "cpu"],
                 [sys.executable, str(REPO / "examples/straggler_drill.py")])]
    (twin, terr), (ref, rerr) = (p.communicate(timeout=600) for p in procs)
    assert [p.returncode for p in procs] == [0, 0], terr + rerr
    twin, ref = twin.splitlines(), ref.splitlines()
    assert twin[-1] == "IMPORTED []", twin[-1]
    assert twin[:-1] == ref
    assert "flagged=True kind=core loc=126 (injected chip 126) " \
        "severity=40.0" in ref
