"""First-step bf16 gradients of more configs against the reference's, on
the CPU.

``test_torch_train_bf16.py``'s first-step gradient test (mirrors
``test_models.py:57`` in the reference's working type) on the
h2o-danube-3-4b (sliding window, head dim 8 at its smoke size),
stablelm-1.6b (LayerNorm with biases, GQA 1), mixtral-8x7b (the MoE's
router and experts) and whisper-large-v3 (encoder, cross-attention, over
seeded bf16 frames) smoke configs at batch 2 × 32: within ``GRAD_ULPS``
bf16 ulps of each leaf's largest |entry|.
"""

import pytest

from test_torch_train_bf16 import MORE_GRAD_ARCHS, check_first_step_gradients

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


@pytest.mark.parametrize("arch,seq", MORE_GRAD_ARCHS)
def test_bf16_first_step_gradients_match_reference(arch, seq):
    check_first_step_gradients(arch, seq)
