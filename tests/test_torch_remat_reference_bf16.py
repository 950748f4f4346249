"""The port's rematerialised bf16 train step against the reference's, on
the CPU.

``make_train_step`` with the default plan, ``CellPlan()`` (remat, bf16
parameters with the leaves the reference keeps in f32, f32 moments), on
the smoke configs of ``test_torch_remat.FAMILIES``, three steps at batch
2 × 32 against the reference's jitted step with ``CellPlan(remat=True)``
on the same weights rounded by the leaf rule and the same batches: the
loss within rel ``LOSS_REL``, the grad norm within ``GNORM_REL_FIRST`` at
step 1 and ``GNORM_REL`` over the three, the tolerances of
``test_torch_train_bf16_steps.py``'s ``check_three_steps``, which holds
the plan without remat.
"""

import pytest

from repro_torch.configs import get_config
from test_torch_remat import BF16, FAMILIES, _train
from test_torch_remat_reference import _reference_steps
from test_torch_train_bf16_steps import GNORM_REL, GNORM_REL_FIRST, LOSS_REL

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_step_matches_reference_remat_step_bf16(arch):
    cfg = get_config(arch, smoke=True)
    _, ours = _train(cfg, BF16, True, n_steps=3)
    for i, ((loss, gnorm), (jloss, jgnorm)) in enumerate(
            zip(ours, _reference_steps(arch, BF16, 3))):
        assert float(loss) == pytest.approx(jloss, rel=LOSS_REL), i
        rel = GNORM_REL_FIRST if i == 0 else GNORM_REL
        assert float(gnorm) == pytest.approx(jgnorm, rel=rel), i
