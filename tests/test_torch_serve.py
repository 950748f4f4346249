"""The port's serving path against the JAX reference, on the CPU.

For the smollm-135m, mamba2-1.3b, mixtral-8x7b (mixture of experts) and
qwen2-vl-2b (M-RoPE) smoke configs, the port's
``ServeEngine`` and the reference's, on the same weights
(``reference_params_numpy``) and the same 8 requests (the launcher's
request stream), give identical greedy ``out_tokens``.  Every logit row the
port's engine takes an argmax of has a top-1 margin above 1e-3, so a near
tie would fail here loudly rather than flip a token by chance.  (At the
smoke widths the init's logits spread only about 0.1, which gives near
ties; the test scales the output embedding by 50 so that they spread a
few units.)  Also:
``launch.serve.main`` end to end with ``--device cpu``.

Run as a script, this file prints the reference's pins that
``chip_smoke.py`` holds the card to (it may not import the reference),
the f32 ones (``PINS``) and the bf16 ones (``BF16_PINS``):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_serve.py [ARCH]

(one pin with an architecture's name, all of them without).
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.models import transformer as JT
from repro.serving import engine as JE
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, reference_params_numpy
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.serving import engine as E

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


def _requests(cfg, make, n=8, prompt_len=16, max_new=8, seed=0):
    """The launcher's request stream (``launch/serve.py``)."""
    rng = np.random.default_rng([seed, 0])
    out = []
    for i in range(n):
        k = int(rng.integers(2, prompt_len + 1))
        out.append(make(i, rng.integers(0, cfg.vocab, size=k)
                        .astype(np.int32), max_new=max_new))
    return out


def _margin(logits):
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    return float((top2[..., 0] - top2[..., 1]).min())


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-1.3b",
                                  "mixtral-8x7b", "qwen2-vl-2b"])
def test_serve_engine_matches_reference(arch, monkeypatch):
    cfg = get_config(arch, smoke=True)
    tree = reference_params_numpy(cfg, seed=1)
    tree["lm_head" if "lm_head" in tree else "embed"] *= 50.0
    margins = []

    def watch(fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            margins.append(_margin(out[0][:, -1]))
            return out
        return wrapped

    monkeypatch.setattr(E.T, "prefill", watch(T.prefill))
    monkeypatch.setattr(E.T, "decode_step", watch(T.decode_step))
    eng = E.ServeEngine(cfg, params_from_numpy(cfg, tree, device="cpu"),
                        E.EngineConfig(batch=4, cache_len=64, device="cpu"))
    for r in _requests(cfg, E.Request):
        eng.submit(r)
    done = eng.run()

    jeng = JE.ServeEngine(j_get_config(arch, smoke=True),
                          jax.tree.map(jnp.asarray, tree),
                          JE.EngineConfig(batch=4, cache_len=64))
    for r in _requests(cfg, JE.Request):
        jeng.submit(r)
    jdone = jeng.run()

    assert [r.rid for r in done] == [r.rid for r in jdone] == list(range(8))
    assert all(len(r.out_tokens) == 8 for r in done)
    assert [r.out_tokens for r in done] == [r.out_tokens for r in jdone]
    assert len(margins) == 2 * (1 + 8) and min(margins) > 1e-3, margins
    assert len(eng.prefill_times) == 2 and len(eng.decode_times) == 16


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-1.3b",
                                  "mixtral-8x7b", "qwen2-vl-2b"])
def test_serve_main_on_cpu(arch, capsys):
    steps = []
    done, stats = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--requests", "5", "--max-new", "3"],
                             step_hook=lambda kind, dt: steps.append(kind))
    assert [r.rid for r in done] == list(range(5))
    assert stats["requests"] == 5 and stats["tokens"] == 15
    assert stats["tok_per_s"] == pytest.approx(15 / stats["wall_s"])
    assert all(len(r.out_tokens) == 3 for r in done)
    assert steps == (["prefill"] + ["decode"] * 3) * 2
    out = capsys.readouterr().out
    assert "served 5 requests, 15 tokens" in out
    assert "mean prefill" in out and "p50 decode step" in out


def test_serve_main_serves_a_depth_cut():
    """``serve.main(..., cfg=)`` serves the given config in place of
    ``--arch``'s: the mixtral-8x7b smoke config cut to one layer, as
    ``chip_smoke.py`` cuts the full one to 8 of 32."""
    cfg = dataclasses.replace(get_config("mixtral-8x7b", smoke=True),
                              n_layers=1)
    calls = []

    def count(fn):
        def wrapped(*args, **kwargs):
            calls.append(len(args[1].layers))
            return fn(*args, **kwargs)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(E.T, "prefill", count(T.prefill))
        done, stats = serve.main(["--arch", "mixtral-8x7b", "--device",
                                  "cpu", "--requests", "2", "--max-new",
                                  "2"], cfg=cfg)
    assert stats["tokens"] == 4 and calls == [1]


# ---------------------------------------------------------------------------
# the reference's pins for chip_smoke.py
# ---------------------------------------------------------------------------

#: (arch, layers kept, prompt length, new tokens): the pinned runs.  Full
#: width; mamba2-1.3b keeps 4 of its 48 layers only to spare the card
#: machine's CPU 1.6 G normal draws for the weights, mixtral-8x7b 2 of its
#: 32 (3.16 G draws; its 2 × 48-token prefill routes 192 assignments over
#: 8 experts of capacity 32, so some are dropped).  qwen2-vl-2b is whole
#: (1.54 G draws).  whisper-large-v3 keeps 4 of its 32 encoder and 4 of
#: its 32 decoder layers: each decode step re-projects the 1,500 frames'
#: K/V in every decoder layer, which the reference's CPU run cannot afford
#: at full depth; its frames are :func:`pin_frames`.  h2o-danube-3-4b keeps
#: 2 of its 24 layers (0.56 G parameters: its embedding and head are a
#: quarter of a billion).
PIN_RUNS = (("smollm-135m", None, 48, 16), ("mamba2-1.3b", 4, 48, 16),
            ("mixtral-8x7b", 2, 48, 16), ("qwen2-vl-2b", None, 48, 16),
            ("whisper-large-v3", 4, 48, 16), ("h2o-danube-3-4b", 2, 48, 16))
PIN_SEED, PIN_PROMPT_SEED, PIN_FRAME_SEED = 0, 4, 5


def pin_config(arch, n_layers, get=get_config):
    """The config cut to ``n_layers`` (an encoder-decoder's encoder
    too)."""
    cfg = get(arch)
    if n_layers is None:
        return cfg
    return dataclasses.replace(cfg, n_layers=n_layers, **(
        {"n_enc_layers": n_layers} if cfg.enc_dec else {}))


def pin_prompts(cfg, prompt_len):
    """Two prompts of the pinned length from a fixed numpy seed."""
    rng = np.random.default_rng(PIN_PROMPT_SEED)
    return rng.integers(0, cfg.vocab, (2, prompt_len)).astype(np.int32)


def pin_frames(cfg, batch=2):
    """An encoder-decoder's frame embeddings for the pins: seeded normal
    draws × 0.02, as ``test_models.py`` makes them."""
    rng = np.random.default_rng(PIN_FRAME_SEED)
    return rng.standard_normal((batch, cfg.n_frames, cfg.d_model),
                               dtype=np.float32) * np.float32(0.02)


def _to_jax(tree, spec=None, dtype=jnp.bfloat16):
    """The numpy tree as jnp arrays, each numpy leaf dropped once it is
    converted, so that the host holds the weights about once (mixtral's
    two layers are 12.6 GB).  With ``spec``, ``transformer.param_spec``'s
    tree of ``Leaf``s, each leaf is rounded to ``dtype`` unless its
    ``Leaf`` keeps f32: the rule of the reference's
    ``init_model(dtype=)`` and of the port's ``params_from_numpy(dtype=)``."""
    out = {}
    for k in list(tree):
        if isinstance(tree[k], dict):
            out[k] = _to_jax(tree[k], None if spec is None else spec[k],
                             dtype)
            continue
        a = jnp.asarray(tree.pop(k))
        out[k] = a if spec is None or spec[k].keep_f32 else a.astype(dtype)
    return out


def reference_pin(arch, n_layers, prompt_len, n_new):
    """Greedy tokens, the prefill's top-5 last-position logits and the
    last decode step's from the JAX reference on
    ``reference_params_numpy(cfg, PIN_SEED)`` weights, with the smallest
    top-1 margin of every step."""
    cfg = pin_config(arch, n_layers)
    jcfg = pin_config(arch, n_layers, j_get_config)
    params = _to_jax(reference_params_numpy(cfg, PIN_SEED))
    toks = pin_prompts(cfg, prompt_len)
    frames = jnp.asarray(pin_frames(cfg)) if cfg.enc_dec else None
    cache = JT.init_cache(jcfg, 2, prompt_len + n_new, dtype=jnp.float32)
    last, cache, memory = jax.jit(
        lambda p, t, c, f: JT.prefill(jcfg, p, t, c, enc_frames=f))(
        params, jnp.asarray(toks), cache, frames)
    last = np.asarray(last[:, -1])
    top5 = np.argsort(-last, axis=-1, kind="stable")[:, :5]
    decode = jax.jit(lambda p, t, c, pos, mem: JT.decode_step(
        jcfg, p, t, c, pos, memory=mem))
    logits, new, margins = last, [], []
    for k in range(n_new):
        srt = np.sort(logits, axis=-1)
        margins.append(float((srt[:, -1] - srt[:, -2]).min()))
        nxt = logits.argmax(-1).astype(np.int32)
        new.append(nxt.tolist())
        out, cache = decode(params, jnp.asarray(nxt[:, None]), cache,
                            jnp.int32(prompt_len + k), memory)
        logits = np.asarray(out[:, -1])
    last_top5 = np.argsort(-logits, axis=-1, kind="stable")[:, :5]
    return {"arch": arch, "n_layers": cfg.n_layers,
            **({"n_enc_layers": cfg.n_enc_layers} if cfg.enc_dec else {}),
            "prompt_len": prompt_len,
            "tokens": np.array(new).T.tolist(), "top5_ids": top5.tolist(),
            "top5_logits": np.take_along_axis(last, top5, -1).tolist(),
            "last_top5_ids": last_top5.tolist(),
            "last_top5_logits": np.take_along_axis(logits, last_top5,
                                                   -1).tolist(),
            "min_margin": min(margins)}


#: The bf16 pins of ``chip_smoke.py`` (``BF16_PINS``): (arch, layers kept
#: or None, prompt length, steps).  yi-34b keeps 2 of its 60 layers at full
#: width (2.03 G parameters) to spare this machine's CPU, h2o-danube-3-4b 2
#: of its 24.
BF16_PIN_RUNS = (("smollm-135m", None, 48, 8), ("mamba2-1.3b", 4, 48, 8),
                 ("yi-34b", 2, 48, 8), ("h2o-danube-3-4b", 2, 48, 8))


def selected_pin_runs(argv):
    """The (f32, bf16) pin runs that ``python tests/test_torch_serve.py
    [ARCH]`` prints: all of them, or ARCH's alone."""
    return ([run for run in PIN_RUNS if argv in ([], [run[0]])],
            [run for run in BF16_PIN_RUNS if argv in ([], [run[0]])])


def reference_bf16_pin(arch, n_layers, prompt_len, n_steps):
    """The JAX reference in bf16 (``init_model(dtype=jnp.bfloat16)``'s
    types: ``reference_params_numpy(cfg, PIN_SEED)`` rounded by the per-leaf
    rule, a bf16 cache) on two seeded prompts: its greedy tokens and, at
    each of ``n_steps`` steps (the prefill's last position, then a decode
    step fed the previous greedy token), the top-5 ids and logits and the
    top-1/top-2 margin of each row.  The card decodes these tokens
    (teacher-forced) and holds its logits to them."""
    cfg = pin_config(arch, n_layers)
    jcfg = pin_config(arch, n_layers, j_get_config)
    params = _to_jax(reference_params_numpy(cfg, PIN_SEED), T.param_spec(cfg))
    toks = pin_prompts(cfg, prompt_len)
    cache = JT.init_cache(jcfg, 2, prompt_len + n_steps, dtype=jnp.bfloat16)
    last, cache, _ = jax.jit(lambda p, t, c: JT.prefill(jcfg, p, t, c))(
        params, jnp.asarray(toks), cache)
    decode = jax.jit(lambda p, t, c, pos: JT.decode_step(jcfg, p, t, c, pos))
    logits = np.asarray(last[:, -1].astype(jnp.float32))
    new, ids, vals, margins = [], [], [], []
    for k in range(n_steps):
        top = np.argsort(-logits, axis=-1, kind="stable")[:, :5]
        ids.append(top.tolist())
        vals.append(np.take_along_axis(logits, top, -1).tolist())
        srt = np.sort(logits, axis=-1)
        margins.append((srt[:, -1] - srt[:, -2]).tolist())
        nxt = logits.argmax(-1).astype(np.int32)
        new.append(nxt.tolist())
        if k + 1 < n_steps:
            out, cache = decode(params, jnp.asarray(nxt[:, None]), cache,
                                jnp.int32(prompt_len + k))
            logits = np.asarray(out[:, -1].astype(jnp.float32))
    return {"arch": arch, "n_layers": cfg.n_layers, "dtype": "bfloat16",
            "prompt_len": prompt_len, "tokens": np.array(new).T.tolist(),
            "top5_ids": ids, "top5_logits": vals, "margins": margins}


@pytest.mark.parametrize("argv,f32,bf16", [
    (["h2o-danube-3-4b"], [("h2o-danube-3-4b", 2, 48, 16)],
     [("h2o-danube-3-4b", 2, 48, 8)]),
    (["yi-34b"], [], [("yi-34b", 2, 48, 8)]),
    ([], list(PIN_RUNS), list(BF16_PIN_RUNS))])
def test_pin_script_prints_the_named_runs(argv, f32, bf16):
    """``python tests/test_torch_serve.py [ARCH]`` prints ARCH's pins (f32
    and bf16, h2o-danube-3-4b at full width with 2 of its 24 layers), or
    every pin."""
    assert selected_pin_runs(argv) == (f32, bf16)


def test_chip_smoke_holds_every_pin_run():
    """``chip_smoke.py``'s ``PINS`` and ``BF16_PINS`` hold one pin of each
    run here, at its depth, prompt length and number of steps."""
    import importlib
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        cs = importlib.import_module("chip_smoke")
    finally:
        sys.path.pop(0)
    pins = {p["arch"]: p for p in cs.PINS}
    assert sorted(pins) == sorted(run[0] for run in PIN_RUNS)
    for arch, n_layers, _, n_new in PIN_RUNS:
        assert pins[arch]["n_layers"] == pin_config(arch, n_layers).n_layers
        assert [len(t) for t in pins[arch]["tokens"]] == [n_new, n_new]
    pins = {p["arch"]: p for p in cs.BF16_PINS}
    assert sorted(pins) == sorted(run[0] for run in BF16_PIN_RUNS)
    for arch, n_layers, prompt_len, steps in BF16_PIN_RUNS:
        pin = pins[arch]
        assert pin["n_layers"] == pin_config(arch, n_layers).n_layers
        assert pin["prompt_len"] == prompt_len
        assert len(pin["top5_ids"]) == len(pin["margins"]) == steps


if __name__ == "__main__":
    # ``python tests/test_torch_serve.py ARCH`` prints ARCH's pins alone
    # (f32, then bf16)
    f32_runs, bf16_runs = selected_pin_runs(sys.argv[1:])
    for run in f32_runs:
        print(json.dumps(reference_pin(*run)), flush=True)
    for run in bf16_runs:
        print(json.dumps(reference_bf16_pin(*run)), flush=True)
    sys.exit(0)
