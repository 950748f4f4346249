"""SLOTH's grid A on the 8×8 torus: the pins of darknet19, googlenet, vgg16
recomputed from the JAX reference and the port on the CPU (its kernels'
plain versions) on googlenet's router scenario, held as
``chip_smoke.grid_outcome_gaps`` holds them (score and ranking
scores within ``rel=1e-5``, all else exact)."""

import pytest

from test_torch_sloth_grid import check_sub_grid

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

FABRIC = "torus:8x8"


@pytest.mark.parametrize("workload", ["darknet19", "googlenet", "vgg16"])
def test_reference_recomputes_the_pins(workload):
    check_sub_grid("reference", "A", [workload], [FABRIC])


def test_port_on_the_cpu_equals_the_pins():
    check_sub_grid("port", "A", ["googlenet"], [FABRIC], ["router"],
                   device="cpu")
