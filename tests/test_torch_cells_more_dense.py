"""The serving step builders against the reference's for stablelm-1.6b
(MHA, LayerNorm) and yi-34b (GQA 4 at smoke width): the checks of
``test_torch_cells_more.py`` (a 2,112-token prompt through
``make_prefill_step``, 8 decode steps through ``make_decode_step``, f32
and bf16), split off to keep each file under ~40 s alone.
"""

import pytest

from test_torch_cells_more import DENSE_STEP_ARCHS, check_bf16, check_f32

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


@pytest.mark.parametrize("arch", DENSE_STEP_ARCHS)
def test_prefill_and_decode_steps_match_reference_f32(arch):
    check_f32(arch)


@pytest.mark.parametrize("arch", DENSE_STEP_ARCHS)
def test_prefill_and_decode_steps_match_reference_bf16(arch):
    check_bf16(arch)
