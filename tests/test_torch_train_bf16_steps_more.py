"""Three bf16 train steps of the MoE, M-RoPE and encoder-decoder configs
against the reference's, on the CPU.

``test_torch_train_bf16_steps.py``'s three-step test (mirrors
``test_substrate.py:126`` in the reference's working type) on the
mixtral-8x7b (the MoE's router in f32, experts in bf16), qwen2-vl-2b
(M-RoPE) and whisper-large-v3 (encoder and cross-attention over seeded
bf16 frames) smoke configs, at the same tolerances.
"""

import pytest

from test_torch_train_bf16_steps import MORE_STEP_ARCHS, check_three_steps

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


@pytest.mark.parametrize("arch", MORE_STEP_ARCHS)
def test_bf16_train_steps_match_reference(arch):
    check_three_steps(arch)
