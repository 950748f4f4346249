"""Scenario-campaign sweep on the port: reproduce the paper's aggregate
metrics, the twin of ``examples/campaign_sweep.py``.

The flags are the reference example's (``--tiny``, ``--seed``,
``--workers``, ``--executor``, ``--n-failures``, ``--mesh``,
``--topology``, ``--kinds``, ``--severities``, ``--detectors``,
``--all-detectors``, ``--streaming``, ``--mitigation``,
``--recorder-impl``) plus ``--workload`` and ``--device``; they are
``repro_torch.launch.campaign``'s own, so this hands its arguments to that
launcher, which runs the grid, its gates and prints the same tables.

    PYTHONPATH=src python examples/torch_campaign_sweep.py --tiny      # cuda:0
    PYTHONPATH=src python examples/torch_campaign_sweep.py --tiny \\
        --device cpu
    PYTHONPATH=src python examples/torch_campaign_sweep.py --tiny \\
        --recorder-impl both --streaming 4 --mitigation remap
"""

import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.campaign import main  # noqa: E402

if __name__ == "__main__":
    main(sys.argv[1:])
