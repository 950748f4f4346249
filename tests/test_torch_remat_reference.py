"""The port's rematerialised f32 train step against the reference's, on
the CPU.

``make_train_step`` with ``CellPlan(remat=True, param_dtype=f32)`` on the
smoke configs of ``test_torch_remat.FAMILIES`` (smollm-135m, mamba2-1.3b,
mixtral-8x7b, qwen2-vl-2b, whisper-large-v3 over seeded frames,
jamba-1.5-large-398b), three steps at batch 2 × 32 against the
reference's jitted step with the same plan on the same weights and
batches: losses and grad norms within rel 1e-5, as
``test_torch_train.py``'s ``_check_train_step`` holds the plan without
remat.
"""

import jax
import jax.numpy as jnp
import pytest

from repro.configs.base import get_config as j_get_config
from repro.launch import steps as JS
from repro.optim import adamw as JA
from repro_torch.configs import get_config
from repro_torch.convert import reference_params_numpy
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from test_torch_remat import BF16, F32, FAMILIES, OPT, _frames, _train
from test_torch_train_bf16 import both_bf16

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


def _reference_steps(arch, dtype, n_steps, batch=2, seq=32):
    """The reference's jitted step with ``CellPlan(remat=True)`` on the
    same weights (bf16 ones rounded by the leaf rule) and batches →
    [(loss, gnorm)]."""
    cfg, jcfg = get_config(arch, smoke=True), j_get_config(arch, smoke=True)
    if dtype == BF16:
        *_, jparams = both_bf16(arch)
    else:
        jparams = jax.tree.map(jnp.asarray, reference_params_numpy(cfg, 0))
    jframes, _ = _frames(cfg, batch, dtype)
    jopt_cfg = JA.AdamWConfig(**OPT)
    jstep = jax.jit(JS.make_train_step(jcfg, JS.CellPlan(
        grad_accum=1, remat=True,
        param_dtype=jnp.float32 if dtype == F32 else jnp.bfloat16),
        jopt_cfg))
    jstate = JA.init_state(jparams, jopt_cfg)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, batch=batch, seq=seq))
    out = []
    for i in range(n_steps):
        jparams, jstate, jloss, jgnorm = jstep(
            jparams, jstate, jnp.asarray(pipe.batch_at(i)),
            *(() if jframes is None else (jframes,)))
        out.append((float(jloss), float(jgnorm)))
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_step_matches_reference_remat_step_f32(arch):
    cfg = get_config(arch, smoke=True)
    _, ours = _train(cfg, F32, True, n_steps=3)
    for i, ((loss, gnorm), (jloss, jgnorm)) in enumerate(
            zip(ours, _reference_steps(arch, F32, 3))):
        assert float(loss) == pytest.approx(jloss, rel=1e-5), i
        assert float(gnorm) == pytest.approx(jgnorm, rel=1e-5), i
