"""The port's serving cells against the reference's grid and plan.

Mirrors ``src/repro/launch/steps.py``: ``SHAPES`` (``:30-35``),
``default_plan`` (``:52-62``) and ``skip_reason`` (``:66-70``), as
``build_cell`` puts a serving cell together: ``make_prefill_step`` /
``make_decode_step`` under ``default_plan(cfg, shape)``.

* ``chip_smoke.SERVE_CELLS`` (the card's cells): every ``(shape, arch)``
  of the reference's serving grid less ``skip_reason`` is a cell or a
  stated reason in ``SERVE_CELLS_LEFT_OUT``, not both; each cell's plan is
  the port's ``default_plan`` of the arch's full config, equal to the
  reference's; every config field but ``n_layers`` is the full config's,
  a cut keeping whole periods; a decode cell's steps end at the cache's
  last position.  The left-out cells' reckoned bytes are past the card's.
* ``chip_smoke.cell_cache``, which builds a decode cell's replicated cache
  a layer at a time from the sub-batches' prefilled caches (emptying each
  part's layer once copied): on smoke configs on the CPU, every layer's
  tensors equal the parts' rows replicated row by row (row r holds row
  r mod n), positions kept, an encoder-decoder's memory replicated the
  same way (``replicate_rows``), and a decode step on the replicated
  cache gives each row its source row's logits bit for bit.
"""

import dataclasses
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
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import steps as S
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import moe_capacity

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
#: The card's memory in bytes (H100 80GB).
CARD_BYTES = 80e9


def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports neither JAX nor the
    reference)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.pop(0)


def _reference_grid():
    return {(shape, arch) for shape, sh in JS.SHAPES.items()
            if sh["kind"] != "train" for arch in j_list_archs()
            if JS.skip_reason(j_get_config(arch), shape) is None}


def test_every_reference_serving_cell_is_a_cell_or_left_out():
    cs = _chip_smoke()
    grid = _reference_grid()
    assert len(grid) == 24      # 10 + 10 + long_500k's four
    cells = [(c[0], c[1]) for c in cs.SERVE_CELLS]
    assert len(cells) == len(set(cells)) == 20
    assert set(cells).isdisjoint(cs.SERVE_CELLS_LEFT_OUT)
    assert set(cells) | set(cs.SERVE_CELLS_LEFT_OUT) == grid
    assert all(isinstance(r, str) and r
               for r in cs.SERVE_CELLS_LEFT_OUT.values())
    assert set(cs.SERVE_CELLS_LEFT_OUT) == {
        ("prefill_32k", "jamba-1.5-large-398b"),
        ("decode_32k", "jamba-1.5-large-398b"),
        ("long_500k", "jamba-1.5-large-398b"),
        ("long_500k", "mixtral-8x7b")}


def test_left_out_cells_are_past_the_card():
    """jamba-1.5-large: one period (8 layers, the least the reference
    builds) is 44.2 G parameters past the embedding and the head, 88 GB in
    bf16; mixtral-8x7b's
    ``long_500k`` prefill, one call over 524,256 tokens, puts every token
    through ``moe`` at capacity 163,832: g and u are 37.6 GB each in bf16
    and g·u a third, at any depth."""
    jamba = get_config("jamba-1.5-large-398b")
    period = T.period_len(jamba)
    one = dataclasses.replace(jamba, n_layers=period)
    assert period == 8
    layers = one.param_count() - 2 * jamba.vocab * jamba.d_model
    assert round(layers / 1e9, 1) == 44.2
    assert layers * 2 > CARD_BYTES
    mix = get_config("mixtral-8x7b")
    tokens = S.SHAPES["long_500k"]["seq"] - 32
    cap = moe_capacity(mix, tokens)
    assert cap == 163832
    g = mix.n_experts * cap * mix.d_ff * 2
    assert round(g / 1e9, 1) == 37.6
    assert 3 * g > CARD_BYTES
    for (shape, arch), why in _chip_smoke().SERVE_CELLS_LEFT_OUT.items():
        assert ("88 GB" if arch.startswith("jamba") else "37.6 GB") in why


def _same_plan(got, exp):
    assert got.grad_accum == exp.grad_accum
    assert got.remat == exp.remat
    assert got.param_dtype == DTYPES[exp.param_dtype]
    assert got.opt_state_dtype == DTYPES[exp.opt_state_dtype]


def test_serve_cells_follow_the_reference_plan_and_shape():
    cs = _chip_smoke()
    for cell in cs.SERVE_CELLS:
        shape, arch, n_layers, batch, prompt, n_dec, sub, reckoned = cell
        cfg, full, plan, cell_batch, seq = cs.serve_cell_setup(cell)
        assert full == get_config(arch)
        assert plan == S.default_plan(full, shape)
        _same_plan(plan, JS.default_plan(j_get_config(arch), shape))
        assert S.skip_reason(full, shape) is None
        assert seq == JS.SHAPES[shape]["seq"] and cell_batch == batch
        # the published widths: only the depth may be cut, in periods
        for field in full.__dataclass_fields__:
            if field != "n_layers":
                assert getattr(cfg, field) == getattr(full, field), field
        assert cfg.n_layers == (full.n_layers if n_layers is None
                                else n_layers) <= full.n_layers
        assert cfg.n_layers % T.period_len(cfg) == 0
        # the card's rows divide the global batch; prompts and sub-batches
        assert JS.SHAPES[shape]["batch"] % batch == 0
        n = min(batch, cs.DECODE_PROMPTS) if n_dec else batch
        assert n % sub == 0 and batch % n == 0
        if JS.SHAPES[shape]["kind"] == "prefill":
            assert (prompt, n_dec) == (seq, 0)
        else:
            # the last decode step writes the cache's last position
            assert n_dec == 32 and prompt + n_dec == seq
        assert 0 < reckoned < CARD_BYTES / 1e9
    # the plans the depth cuts keep: yi-34b, mixtral-8x7b and dbrx-132b
    # plan as their full configs (over 20 G parameters; dbrx over 100 G)
    for arch in ("yi-34b", "mixtral-8x7b", "dbrx-132b"):
        cell = next(c for c in cs.SERVE_CELLS if c[1] == arch)
        cfg = cs.serve_cell_setup(cell)[0]
        assert cfg.n_layers < get_config(arch).n_layers
        assert cfg.param_count() < 20e9 < get_config(arch).param_count()


# ---------------------------------------------------------------------------
# cell_cache on the CPU
# ---------------------------------------------------------------------------

def _clone(cache):
    return [{k: v.clone() if isinstance(v, torch.Tensor) else v
             for k, v in layer.items()} for layer in cache]


@pytest.mark.parametrize("arch,batch,sub,n", [
    ("whisper-large-v3", 8, 2, 4),      # memory replicated too
    ("h2o-danube-3-4b", 6, 1, 3),       # a ring overrun by the prompt
    ("mamba2-1.3b", 4, 2, 4),           # conv and SSM state, batch == n
    ("qwen2-vl-2b", 8, 2, 2),           # one sub-batch, replicated
])
def test_cell_cache_replicates_the_sub_batches_row_by_row(arch, batch, sub,
                                                          n):
    cs = _chip_smoke()
    cfg = get_config(arch, smoke=True)
    plan = S.CellPlan(param_dtype=torch.float32)
    model = T.init_model(cfg, torch.Generator().manual_seed(0),
                         dtype=torch.float32)
    gen = torch.Generator().manual_seed(1)
    seq, prompt = 64, 40
    prompts = torch.randint(0, cfg.vocab, (n, prompt), generator=gen,
                            dtype=torch.int32)
    frames = cs.serve_cell_frames(cfg, n, torch.float32, "cpu")
    assert (frames is None) == (not cfg.enc_dec)
    prefill = S.make_prefill_step(cfg, plan, seq, sub)
    parts = [prefill(model, prompts[i:i + sub],
                     *(() if frames is None else (frames[i:i + sub],)))
             for i in range(0, n, sub)]
    before = [_clone(p[1]) for p in parts]
    cache = cs.cell_cache([p[1] for p in parts], batch)
    # every part's layers emptied once copied
    assert all(layer == {} for p in parts for layer in p[1])
    assert len(cache) == cfg.n_layers
    for li, layer in enumerate(cache):
        srcs = [b[li] for b in before]
        assert layer.keys() == srcs[0].keys()
        for key, t in layer.items():
            if key == "pos":
                assert t == srcs[0][key] == prompt
            elif key == "pos_tab":
                assert torch.equal(t, srcs[0][key])
            else:
                rows = torch.cat([s[key] for s in srcs])
                assert t.dtype == rows.dtype and t.shape[0] == batch
                for r in range(batch):
                    assert torch.equal(t[r], rows[r % n]), (li, key, r)
    memory = None
    if cfg.enc_dec:
        mems = torch.cat([p[2] for p in parts])
        memory = cs.replicate_rows(mems, batch)
        for r in range(batch):
            assert torch.equal(memory[r], mems[r % n])
    # a decode step: each row's logits are its source row's
    last = torch.cat([p[0] for p in parts])[:, -1]
    tok = cs.replicate_rows(last.argmax(-1, keepdim=True).to(torch.int32),
                            batch)
    _, logits, cache = S.make_decode_step(cfg, plan)(model, tok, cache,
                                                     prompt, memory)
    for r in range(n, batch):
        assert torch.equal(logits[r], logits[r % n]), r
    assert all(layer["pos"] == prompt + 1 for layer in cache)


def test_serve_cell_launch_counts_follow_the_model():
    """``serve_cell_want``: K3's bf16 prefill once per attention layer per
    prefill call and its decode once per attention layer per step; for
    whisper-large-v3 also its 32 encoder and 32 cross-attention prefills a
    call and 32 cross-attention decodes a step; K4 once per Mamba layer
    per call."""
    cs = _chip_smoke()
    want = {}
    for cell in cs.SERVE_CELLS:
        cfg = cs.serve_cell_setup(cell)[0]
        n = min(cell[3], cs.DECODE_PROMPTS) if cell[5] else cell[3]
        want[cell[:2]] = cs.serve_cell_want(cfg, cell, n)
    assert want[("prefill_32k", "whisper-large-v3")] == {
        "flash_attention_bf16": 96,
        "flash_attention_bf16_prefill": 96}
    # 2 prefill calls of 4 prompts, 32 steps
    assert want[("decode_32k", "whisper-large-v3")] == {
        "flash_attention_bf16": 2 * 96 + 32 * 64,
        "flash_attention_bf16_prefill": 2 * 96,
        "flash_attention_bf16_decode": 32 * 64}
    # 8 prefill calls of one prompt over 4 layers, 32 steps
    assert want[("decode_32k", "dbrx-132b")] == {
        "flash_attention_bf16": 8 * 4 + 32 * 4,
        "flash_attention_bf16_prefill": 8 * 4,
        "flash_attention_bf16_decode": 32 * 4}
    assert want[("prefill_32k", "yi-34b")] == {
        "flash_attention_bf16": 12, "flash_attention_bf16_prefill": 12}
    assert want[("decode_32k", "mamba2-1.3b")] == {"ssd_scan_bf16": 96}
    assert want[("decode_32k", "stablelm-1.6b")] == {
        "flash_attention_bf16": 4 * 24 + 32 * 24,
        "flash_attention_bf16_prefill": 4 * 24,
        "flash_attention_bf16_decode": 32 * 24}


@pytest.mark.parametrize("arch", ["whisper-large-v3", "jamba-1.5-large-398b",
                                  "h2o-danube-3-4b"])
def test_serve_cell_want_counts_the_model_s_kernel_calls(arch, monkeypatch):
    """``serve_cell_want`` against the calls the model makes: a decode
    cell's run on a smoke config on the CPU (sub-batched prefills, then
    decode steps, as ``serve_cell_run`` drives them) with every attention
    call classed by K3's dispatch rule (``uses_decode``) and every SSD
    scan counted."""
    cs = _chip_smoke()
    cfg = get_config(arch, smoke=True)
    counts = {"flash_attention_bf16_prefill": 0,
              "flash_attention_bf16_decode": 0, "ssd_scan_bf16": 0}
    attention, scan = L.gqa_attention, ssd_ops.ssd

    def counted_attention(q, k, v, **kw):
        kind = "decode" if fa_ops.uses_decode(q.shape[1], q.shape[2],
                                              k.shape[2]) else "prefill"
        counts[f"flash_attention_bf16_{kind}"] += 1
        return attention(q, k, v, **kw)

    def counted_scan(*a, **kw):
        counts["ssd_scan_bf16"] += 1
        return scan(*a, **kw)
    monkeypatch.setattr(L, "gqa_attention", counted_attention)
    monkeypatch.setattr(ssd_ops, "ssd", counted_scan)
    batch, n, sub, prompt, n_dec = 8, 4, 2, 24, 3
    cell = ("decode_32k", arch, None, batch, prompt, n_dec, sub, 1.0)
    plan = S.CellPlan(param_dtype=torch.float32)
    model = T.init_model(cfg, torch.Generator().manual_seed(0),
                         dtype=torch.float32)
    prompts = torch.randint(0, cfg.vocab, (n, prompt), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1))
    frames = cs.serve_cell_frames(cfg, n, torch.float32, "cpu")
    prefill = S.make_prefill_step(cfg, plan, prompt + n_dec, sub)
    parts = [prefill(model, prompts[i:i + sub],
                     *(() if frames is None else (frames[i:i + sub],)))
             for i in range(0, n, sub)]
    memory = cs.replicate_rows(torch.cat([p[2] for p in parts]), batch) \
        if cfg.enc_dec else None
    tok = cs.replicate_rows(torch.cat([p[0] for p in parts])[:, -1].argmax(
        -1, keepdim=True).to(torch.int32), batch)
    cache = cs.cell_cache([p[1] for p in parts], batch)
    step = S.make_decode_step(cfg, plan)
    for k in range(n_dec):
        tok, _, cache = step(model, tok, cache, prompt + k, memory)
    counts["flash_attention_bf16"] = counts["flash_attention_bf16_prefill"] \
        + counts["flash_attention_bf16_decode"]
    assert {k: v for k, v in counts.items() if v} == cs.serve_cell_want(
        cfg, cell, n)


def test_replicas_agree_up_to_a_dropped_assignment():
    """A MoE decode step's tokens compete for each expert's capacity across
    the batch (the reference's rule): mixtral-8x7b's smoke config with 8
    prompts replicated to 32 rows drops some replicas' assignments, after
    which their tokens may leave their source's.  ``replicas_agree`` holds
    each row to its source up to the first step at which either lost an
    assignment, and all the way without MoE; a token changed before that
    step fails it."""
    cs = _chip_smoke()
    cfg = get_config("mixtral-8x7b", smoke=True)
    plan = S.CellPlan(param_dtype=torch.float32)
    model = T.init_model(cfg, torch.Generator().manual_seed(0),
                         dtype=torch.float32)
    batch, n, prompt, n_dec = 32, 8, 24, 6
    prompts = torch.randint(0, cfg.vocab, (n, prompt), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(2))
    last, cache = S.make_prefill_step(cfg, plan, prompt + n_dec, n)(
        model, prompts)
    cache = cs.cell_cache([cache], batch)
    tok = cs.replicate_rows(last[:, -1].argmax(-1, keepdim=True).to(
        torch.int32), batch)
    step = S.make_decode_step(cfg, plan)
    toks, drops = [tok], []
    for k in range(n_dec):
        layers = []
        with cs.moe_drops(layers):
            tok, _, cache = step(model, tok, cache, prompt + k)
        assert len(layers) == cfg.n_layers
        drops.append(torch.stack(layers).any(0))
        toks.append(tok)
    toks, drops = torch.cat(toks, 1), torch.stack(drops)
    assert drops.any() and not drops.all()
    assert cs.replicas_agree(toks, n, drops)
    # a token of an undropped row changed: caught
    clean = int((~drops.any(0)).nonzero()[-1])
    assert clean >= n
    bad = toks.clone()
    bad[clean, -1] += 1
    assert not cs.replicas_agree(bad, n, drops)
    # without the drops every row is held whole
    assert cs.replicas_agree(cs.replicate_rows(toks[:n], batch), n)
    assert not cs.replicas_agree(bad, n)
