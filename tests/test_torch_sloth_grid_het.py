"""SLOTH's grid A on the 8×8 heterogeneous mesh (``fast1slow1``): the pins
of darknet19, googlenet, vgg16 recomputed from the JAX reference, held as
``chip_smoke.grid_outcome_gaps`` holds them (score and ranking
scores within ``rel=1e-5``, all else exact)."""

import pytest

from test_torch_sloth_grid import check_sub_grid

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

FABRIC = "het:8x8"


@pytest.mark.parametrize("workload", ["darknet19", "googlenet", "vgg16"])
def test_reference_recomputes_the_pins(workload):
    check_sub_grid("reference", "A", [workload], [FABRIC])
