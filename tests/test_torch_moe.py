"""The port's mixture of experts and M-RoPE against the JAX reference, on
the CPU.

* ``layers.moe`` against the reference's ``layers.moe`` (the layer under
  ``test_models.py``'s ``test_smoke_forward`` and
  ``test_prefill_decode_equivalence`` for mixtral, dbrx and jamba) at
  small widths, for (E, k) ∈ {(4, 2), (8, 2), (16, 4)}, each with a
  capacity that drops assignments and one that drops none: outputs and
  aux within 1e-5.  Every token's k-th router probability stands above its
  (k+1)-th by more than 1e-6, so a near tie fails here loudly rather than
  routing differently by chance.
* ``layers.apply_mrope`` against the reference's with distinct temporal,
  height and width ids (with equal ids M-RoPE is RoPE, so only distinct
  ids test the sections) at head dims 16 and 128, within 1e-4.
* One train step on the mixtral-8x7b and jamba-1.5-large-398b smoke
  configs (the MoE cases of ``test_models.py``'s ``test_smoke_train_step``)
  against the reference's jitted step, as ``test_torch_train.py`` holds
  the dense ones: every leaf's gradient (``router`` included), the loss
  with its 0.01 × aux term, and the grad norm.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.models import layers as TL
from test_torch_train import _check_train_step

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


def _moe_inputs(e, k, d=32, ff=48, b=2, s=24, seed=0):
    rng = np.random.default_rng([seed, e, k])
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    p = {"router": rng.standard_normal((d, e)) * d ** -0.5,
         "w_gate": rng.standard_normal((e, d, ff)) * d ** -0.5,
         "w_up": rng.standard_normal((e, d, ff)) * d ** -0.5,
         "w_down": rng.standard_normal((e, ff, d)) * ff ** -0.5}
    return x, {n: v.astype(np.float32) for n, v in p.items()}


@pytest.mark.parametrize("drops", [True, False])
@pytest.mark.parametrize("e,k", [(4, 2), (8, 2), (16, 4)])
@torch.no_grad()
def test_moe_matches_reference(e, k, drops):
    x, p = _moe_inputs(e, k)
    tokens = x.shape[0] * x.shape[1]
    # a capacity of T slots never drops (top-k experts are distinct); at
    # a quarter of the mean load some experts overflow
    cf = 0.25 if drops else e / k
    cfg = dataclasses.replace(get_config("mixtral-8x7b", smoke=True),
                              d_model=x.shape[-1], d_ff=48, n_experts=e,
                              top_k=k, capacity_factor=cf)
    jcfg = dataclasses.replace(j_get_config("mixtral-8x7b", smoke=True),
                               d_model=x.shape[-1], d_ff=48, n_experts=e,
                               top_k=k, capacity_factor=cf)
    tp = TL.ParamBlock({n: torch.from_numpy(v) for n, v in p.items()})
    tx = torch.from_numpy(x)

    route = TL.moe_route(cfg, tp, tx.reshape(tokens, -1))
    top = torch.sort(route.probs, dim=-1, descending=True).values
    assert float((top[:, k - 1] - top[:, k]).min()) > 1e-6
    assert TL.moe_capacity(cfg, tokens) == (tokens if not drops else 8)
    dropped = int((~route.keep).sum())
    assert (dropped > 0) == drops, dropped
    assert int(route.counts.sum()) == tokens * k

    y, aux = TL.moe(cfg, tp, tx)
    jy, jaux = JL.moe(jcfg, {n: jnp.asarray(v) for n, v in p.items()},
                      jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("d", [16, 128])
@torch.no_grad()
def test_mrope_matches_reference(d):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 7, 3, d)).astype(np.float32)
    pos3 = rng.integers(0, 4000, (2, 7, 3)).astype(np.int32)
    assert (pos3[..., 0] != pos3[..., 1]).all() \
        and (pos3[..., 1] != pos3[..., 2]).all()
    got = TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 1e6)
    exp = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-4,
                               rtol=1e-4)
    # each section rotates by its own id: every band's section is used
    assert set(TL.mrope_sections(d // 2).tolist()) == {0, 1, 2}
    # with the three ids equal, M-RoPE is RoPE
    same = np.repeat(pos3[..., :1], 3, axis=-1)
    np.testing.assert_allclose(
        TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(same),
                       1e6).numpy(),
        TL.apply_rope(torch.from_numpy(x), torch.from_numpy(same[..., 0]),
                      1e6).numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "jamba-1.5-large-398b"])
def test_moe_train_step_matches_reference(arch):
    _check_train_step(arch, 32)
