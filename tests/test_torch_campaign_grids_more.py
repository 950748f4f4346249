"""More grids of the reference's CI smokes through the port, on the CPU:
the heterogeneous fabric, a ``core+link`` kind tuple and the
``quarantine`` policy, checked as ``test_torch_campaign_grids.py`` checks
its own (``check_grid``: outcomes, ``by_detector`` and ``by_mitigation``
equal to the reference's, for both recorder impls)."""

import pytest

from test_torch_campaign_grids import check_grid

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


@pytest.mark.parametrize("impl", ("ref", "batched"))
@pytest.mark.parametrize("name", ["het_4x4_fast2slow1", "core_plus_link",
                                  "quarantine"])
def test_ci_grid_matches_reference(name, impl):
    check_grid(name, impl)
