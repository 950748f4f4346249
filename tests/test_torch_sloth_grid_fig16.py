"""SLOTH's grid B, the Fig 16/17 meshes not in grid A (4×4, 6×6 and the
rectangular 8×4; resnet50 and darknet19, core and link faults, two
replicates): the pins recomputed from the JAX reference, and the port on the
CPU (its kernels' plain versions) on darknet19's core scenarios of each
mesh, held as ``chip_smoke.grid_outcome_gaps`` holds them (score
and ranking scores within ``rel=1e-5``, all else exact)."""

import pytest

from test_torch_sloth_grid import check_sub_grid

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


@pytest.mark.parametrize("mesh", ["4x4", "6x6", "8x4"])
@pytest.mark.parametrize("workload", ["resnet50", "darknet19"])
def test_reference_recomputes_the_pins(workload, mesh):
    check_sub_grid("reference", "B", [workload], [mesh])


@pytest.mark.parametrize("mesh", ["4x4", "6x6", "8x4"])
def test_port_on_the_cpu_equals_the_pins(mesh):
    check_sub_grid("port", "B", ["darknet19"], [mesh], ["core"],
                   device="cpu")
