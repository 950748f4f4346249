"""The port's ``train_4k`` cells against the reference's grid and plan.

Mirrors ``src/repro/launch/steps.py``: ``SHAPES["train_4k"]``
(``:30-35``), ``default_plan`` (``:52-62``), ``skip_reason`` (``:66``) and
``make_train_step`` (``:90-130``, the micro-batches' f32 sums and the
moments' type), as ``build_cell`` (``:206-226``) puts a train cell
together: ``make_train_step(cfg, default_plan(cfg, "train_4k"))``.

* ``chip_smoke.TRAIN_CELLS`` (the card's cells): each cell's plan is the
  port's ``default_plan`` of the arch's full config, equal to the
  reference's (as ``test_torch_cells.py`` maps the types); a micro-batch
  of one sequence, ``SHAPES["train_4k"]["seq"]`` long; every config field
  but ``n_layers`` the full config's, a cut keeping whole periods; every
  arch of the reference's registry a cell or a stated reason.
* Two bf16 steps of the port's ``make_train_step`` under each arch's
  ``train_4k`` plan (of its full config: 8 micro-batches for yi-34b,
  mixtral-8x7b, dbrx-132b and jamba-1.5-large, bf16 moments for dbrx and
  jamba) on its smoke config, against the reference's jitted step under
  its own (mirrors ``test_substrate.py:126``, the train step): the loss
  and grad norm within ``test_torch_train_bf16_steps.py``'s bf16 rule.
  The first five archs here, the other five in
  ``test_torch_train_cells_more.py``.
* ``chip_smoke.PinWeights``, which draws the pins' weights on the card
  machine's host while the card checks the pins: the same trees as
  ``reference_params_numpy``, each distinct config drawn once.
"""

import importlib
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.configs.base import list_archs as j_list_archs
from repro.launch import steps as JS
from repro_torch.configs import get_config
from repro_torch.launch import steps as S
from repro_torch.models import transformer as T
from test_torch_train_bf16 import plan_steps
from test_torch_train_bf16_steps import GNORM_REL, GNORM_REL_FIRST, LOSS_REL

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}

#: The archs whose two smoke steps run here; the rest in
#: ``test_torch_train_cells_more.py``.
STEP_ARCHS = ["smollm-135m", "mamba2-1.3b", "qwen2-vl-2b", "stablelm-1.6b",
              "whisper-large-v3"]
MORE_STEP_ARCHS = ["h2o-danube-3-4b", "mixtral-8x7b", "yi-34b", "dbrx-132b",
                   "jamba-1.5-large-398b"]


def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports neither JAX nor the
    reference)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.pop(0)


def _same_plan(got, exp):
    assert got.grad_accum == exp.grad_accum
    assert got.remat == exp.remat
    assert got.param_dtype == DTYPES[exp.param_dtype]
    assert got.opt_state_dtype == DTYPES[exp.opt_state_dtype]


def test_train_cells_follow_the_reference_plan_and_shape():
    cs = _chip_smoke()
    seq = JS.SHAPES["train_4k"]["seq"]
    for cell in cs.TRAIN_CELLS:
        arch, n_layers, reckoned, runs = cell
        cfg, full, plan, batch, cell_seq = cs.train_cell_setup(cell)
        assert full == get_config(arch)
        assert plan == S.default_plan(full, "train_4k")
        _same_plan(plan, JS.default_plan(j_get_config(arch), "train_4k"))
        assert S.skip_reason(full, "train_4k") is None
        assert JS.skip_reason(j_get_config(arch), "train_4k") is None
        # one sequence a micro-batch, the reference's sequence
        assert batch == plan.grad_accum and cell_seq == seq
        # the published widths: only the depth may be cut, in periods
        for field in full.__dataclass_fields__:
            if field != "n_layers":
                assert getattr(cfg, field) == getattr(full, field), field
        assert cfg.n_layers == (full.n_layers if n_layers is None
                                else n_layers) <= full.n_layers
        assert cfg.n_layers % T.period_len(cfg) == 0
        assert reckoned < 80 and runs in (1, 2)
    # the plans the card's memory turns on
    plans = {c[0]: cs.train_cell_setup(c)[2] for c in cs.TRAIN_CELLS}
    assert plans["yi-34b"].grad_accum == plans["mixtral-8x7b"].grad_accum \
        == plans["dbrx-132b"].grad_accum == 8
    assert plans["dbrx-132b"].opt_state_dtype == torch.bfloat16
    assert {a for a, p in plans.items()
            if p.opt_state_dtype == torch.bfloat16} == {"dbrx-132b"}
    assert plans["smollm-135m"].grad_accum == 4
    # the archs new to training on the card run twice, and smollm-135m
    twice = {c[0] for c in cs.TRAIN_CELLS if c[3] == 2}
    assert twice == {"qwen2-vl-2b", "yi-34b", "dbrx-132b", "smollm-135m"}


def test_every_reference_arch_has_a_train_cell_or_a_reason():
    cs = _chip_smoke()
    cells = [c[0] for c in cs.TRAIN_CELLS]
    assert len(cells) == len(set(cells))
    assert set(cells).isdisjoint(cs.TRAIN_CELLS_LEFT_OUT)
    assert set(cells) | set(cs.TRAIN_CELLS_LEFT_OUT) == set(j_list_archs())
    assert all(cs.TRAIN_CELLS_LEFT_OUT.values())


def cell_plan_steps(arch):
    """Two bf16 steps of both packages under the ``train_4k`` plan of the
    arch's full config on its smoke config (:func:`plan_steps`)."""
    plan = S.default_plan(get_config(arch), "train_4k")
    jplan = JS.default_plan(j_get_config(arch), "train_4k")
    _same_plan(plan, jplan)
    return plan_steps(arch, plan, jplan, 2)


def check_cell_plan_steps(arch):
    ours, theirs = cell_plan_steps(arch)
    for i, ((loss, gnorm), (jloss, jgnorm)) in enumerate(zip(ours, theirs)):
        assert loss == pytest.approx(jloss, rel=LOSS_REL), i
        rel = GNORM_REL_FIRST if i == 0 else GNORM_REL
        assert gnorm == pytest.approx(jgnorm, rel=rel), i


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_4k_plan_steps_match_reference(arch):
    check_cell_plan_steps(arch)


@pytest.mark.parametrize("drawn_first", [False, True])
def test_pin_weights_draw_each_config_once(drawn_first, monkeypatch):
    """``chip_smoke.PinWeights`` (the pins' weights drawn by a background
    thread while the card checks the pins) hands out
    ``reference_params_numpy(cfg, 0)`` bit for bit and draws a config
    taken twice once, whether a take waits for its draw or every draw has
    ended first; a take past a config's last fails, and so does
    ``close`` with a tree never taken."""
    import numpy as np

    from repro_torch import convert
    cs = _chip_smoke()
    reference, drawn = convert.reference_params_numpy, []

    def draw(cfg, seed):
        drawn.append(cfg.name)
        return reference(cfg, seed)
    monkeypatch.setattr(convert, "reference_params_numpy", draw)
    cfgs = [get_config(a, smoke=True) for a in
            ("smollm-135m", "mamba2-1.3b", "smollm-135m")]
    pw = cs.PinWeights(cfgs)
    if drawn_first:
        pw._pool.shutdown(wait=True)
    for cfg in cfgs:
        got, want = _leaves(pw.take(cfg)), _leaves(reference(cfg, 0))
        assert len(got) == len(want)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert drawn == [cfgs[0].name, cfgs[1].name]
    with pytest.raises(cs.CheckFailed, match="no pin weights left"):
        pw.take(cfgs[0])
    pw.close()
    pw = cs.PinWeights(cfgs[:2])
    pw.take(cfgs[1])
    with pytest.raises(cs.CheckFailed, match="never taken: " + cfgs[0].name):
        pw.close()


def _leaves(tree):
    """The leaves of a nested dict of arrays, in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]
