"""Fig 13's L × H sketch geometries (L ∈ {128, 512, 2,048} × H ∈ {2, 8, 32}
at d = 2, m = 1,024) over the healthy darknet19 4×4 run: each pin recomputed
from the JAX reference's batched ``record``, and the port's recording on the
CPU (K1's plain version) equal to it: the compression ratio and every
decoded pattern exactly. The d × m geometries are in
``test_torch_sloth_grid.py``."""

import pytest

from test_torch_sloth_grid import (FIG13, compare_recording, fig13_records,
                                   load_pins)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


@pytest.mark.parametrize("index", range(9, 18))
def test_fig13_size_by_threshold_recording_equals_reference(index):
    geometry = FIG13[index]
    exp = load_pins()["fig13"]["recordings"][index]
    assert exp["params"] == list(geometry)
    assert compare_recording(fig13_records("reference", [geometry])[0],
                             exp) == []
    assert compare_recording(fig13_records("port", [geometry], "cpu")[0],
                             exp) == []
