"""SLOTH's grid A on the 8×8 torus: the pins of resnet50, binary_tree
recomputed from the JAX reference, held as
``chip_smoke.grid_outcome_gaps`` holds them (score and ranking
scores within ``rel=1e-5``, all else exact)."""

import pytest

from test_torch_sloth_grid import check_sub_grid

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

FABRIC = "torus:8x8"


@pytest.mark.parametrize("workload", ["resnet50", "binary_tree"])
def test_reference_recomputes_the_pins(workload):
    check_sub_grid("reference", "A", [workload], [FABRIC])
