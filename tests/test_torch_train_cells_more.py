"""``test_torch_train_cells.py``'s two bf16 steps under each arch's
``train_4k`` plan for the other five archs: h2o-danube-3-4b (4
micro-batches, f32 moments), mixtral-8x7b and yi-34b (8, f32), dbrx-132b
and jamba-1.5-large-398b (8, bf16 moments), on their smoke configs against
the reference's jitted step under its own plan (mirrors
``test_substrate.py:126``)."""

import pytest

from test_torch_train_cells import MORE_STEP_ARCHS, check_cell_plan_steps

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


@pytest.mark.parametrize("arch", MORE_STEP_ARCHS)
def test_train_4k_plan_steps_match_reference_more(arch):
    check_cell_plan_steps(arch)
