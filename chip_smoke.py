#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # from the repository root, one card

1. builds every CUDA source in ``src/repro_torch/csrc`` (one ``nvcc`` each,
   started together) into ``build/``;
2. holds each kernel against its plain torch version on the card: the
   Fail-Slow Sketch insert (random run streams, forced eviction, the
   promotion/steal branches, a per-record stream; integer state and drain
   exact, float statistics bit-equal) and the fused FailRank step (s within
   1e-5, L exact); then flash attention through both its entry points
   (f32 test shapes, a smollm-135m prefill of 4×512, decodes over a
   rolled, partly empty 1,024-slot cache and over the serve run's own
   fill, with and without a window, splits wholly empty or wholly outside
   the window, a cache that is not a multiple of the split, GQA ratios 1,
   3 and 8, head dims 16-128, both sides of the decode/prefill line;
   within 2e-5) and the SSD scan (the test shapes, chunks 16, 24 and 128
   with a ragged tail, and mamba2-1.3b's 4×512 prefill, from a zero and a
   non-zero state; within 2e-4); two runs of the attention decode and of
   the SSD scan at the serving shapes must be bit-identical;
3. drives the detection path, ``Sloth.detect`` with the batched recorder
   on the card, for resnet50 on an 8×8 mesh (core 6, link 20, no fault)
   with the launch counts set to 0 just before and read just after, plus
   ``failrank_dense`` on the core fault's MCG through the FailRank kernel;
   every verdict must equal the JAX reference's (pinned below, since this
   script may not import it), the sketch kernel must launch twice per
   ``detect`` and both drains must be non-empty;
4. records the same trace on the plain CPU path and requires identical
   patterns and byte accounting, and times K1 and K2 beside their plain
   versions and bounds;
5. repeats the verdict checks for resnet50 on a 4×4 mesh;
6. drives the serving path, ``repro_torch.launch.serve.main``, at full
   width and depth for smollm-135m (30 attention layers) and mamba2-1.3b
   (48 SSD layers), 8 requests of up to 512 tokens, 32 new tokens each,
   with the counts set to 0 before each: attention must launch once per
   layer per prefill and decode step (1,980: 60 through the prefill entry
   point, 1,920 through the split-key decode) and the SSD scan once per
   layer per prefill (96, none in decode);
7. holds greedy tokens and prefill logits to the JAX reference's pins
   (``tests/test_torch_serve.py`` run as a script prints them) on the same
   numpy weights: the tokens equal, the top-5 logits within 1e-3;
8. times flash attention and the SSD scan at the serving shapes beside
   their plain versions, their bounds and (attention) PyTorch's
   ``scaled_dot_product_attention``, with a profiler breakdown of each
   kernel call by the kernels it launches, and profiles a full-size prefill and
   decode steps of each model (device time by kernel, the device's idle
   share).  Kernel times are device time by CUDA events, with the calls
   queued behind a device-side spin so the host cannot pace them, and the
   back-to-back event time beside it (which includes the host's wrapper
   cost where the host is the slower side).

Every phase prints one JSON object per line.  The line before the last is
the per-kernel summary; the last is ``{"ok": true, "device": ...}``.  Any
failed check exits non-zero; without a card the script exits 2.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peaks from NVIDIA's data sheet (dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

#: Verdicts of the JAX reference (``repro``, recorder_impl="batched", seed 0,
#: t0=1 s, duration 8 s, slowdown 10×): (flagged, kind, location,
#: FailRank iterations).
REFERENCE = {
    (8, ("core", 6)): (True, "core", 6, 27),
    (8, ("link", 20)): (True, "link", 20, 27),
    (8, None): (False, None, None, 26),
    (4, ("core", 6)): (True, "core", 6, 25),
    (4, ("link", 5)): (True, "link", 5, 25),
    (4, None): (False, None, None, 24),
}


#: The JAX reference's greedy serving on ``reference_params_numpy(cfg, 0)``
#: weights, two prompts of 48 tokens from ``default_rng(4)``, 16 new tokens
#: (``python tests/test_torch_serve.py``, CPU, f32).  Full width; mamba2-1.3b
#: keeps 4 of its 48 layers only to spare this machine's CPU 1.6 G normal
#: draws.  Smallest top-1 margin of any pinned step: 0.0111 and 0.0098.
PIN_PROMPT_SEED, PIN_PROMPT_LEN = 4, 48
PINS = (
    {"arch": "smollm-135m", "n_layers": 30,
     "tokens": [[48556, 39997, 46394, 38563, 9961, 39997, 8440, 48556, 10622,
                 25736, 44201, 5894, 33477, 10622, 10622, 10622],
                [26033, 21246, 30959, 20206, 28629, 10066, 5322, 21246, 21246,
                 47786, 47894, 15775, 13418, 47514, 3933, 10058]],
     "top5_ids": [[48556, 15864, 39997, 13559, 28947],
                  [26033, 46264, 21482, 14945, 10080]],
     "top5_logits": [[2.090031862258911, 2.0024352073669434, 1.8586002588272095,
                      1.816209077835083, 1.7601797580718994],
                     [2.0649373531341553, 2.0108540058135986, 1.8268630504608154,
                      1.792569875717163, 1.7866501808166504]]},
    {"arch": "mamba2-1.3b", "n_layers": 4,
     "tokens": [[34293, 43426, 35941, 19833, 38728, 12822, 31680, 41508, 33001,
                 3278, 40391, 17293, 1820, 36751, 41172, 48189],
                [3581, 20871, 16916, 39207, 37639, 32631, 11239, 38727, 46570,
                 49609, 2778, 24593, 26846, 3064, 17103, 11203]],
     "top5_ids": [[34293, 48855, 5909, 11774, 10213],
                  [3581, 16536, 6454, 15599, 36950]],
     "top5_logits": [[3.914146900177002, 3.6612372398376465, 3.5545654296875,
                      3.4347569942474365, 3.3890557289123535],
                     [3.500068187713623, 3.434157609939575, 3.4254581928253174,
                      3.4220635890960693, 3.3890700340270996]]},
)

#: The serving runs of phase 6 (``launch/serve.py`` flags).
SERVE_FLAGS = ["--requests", "8", "--batch", "4", "--prompt-len", "512",
               "--cache-len", "1024", "--max-new", "32"]


class CheckFailed(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def device_us(prof, by_name=None) -> float:
    """Summed durations, in microseconds, of the device activities (kernels,
    copies) in a finished ``torch.profiler`` trace; ``by_name`` collects
    them per kernel name."""
    import torch
    total = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            total += us
            if by_name is not None:
                by_name[e.name] = by_name.get(e.name, 0.0) + us
    return total


#: Device clock for sizing the spin in ``timed`` (H100 SXM boost, 1.98 GHz);
#: a lower clock only makes the spin longer.
SPIN_CYCLES_PER_MS = 1.98e6


def timed(fn, reps: int) -> dict:
    """``fn``'s time per call by CUDA events around ``reps`` calls, after
    one warm-up call, two ways.  ``events_ms``: back to back, paced by the
    host where its wrapper is slower than the device work.  ``ms``: the
    same calls queued behind a device-side spin long enough for the host to
    queue all of them, so that no launch gap enters the interval (device
    time); ``ahead`` says the spin still held the stream when the host had
    queued the last call.  If it never did (a longer spin is tried twice),
    ``ms`` is ``events_ms``.  Keep ``reps`` times the launches per call
    well under the launch queue's depth (about a thousand)."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    events = start.elapsed_time(end) / reps
    spin_ms = 1.5 * reps * events + 1.0
    for _ in range(3):
        torch.cuda._sleep(int(spin_ms * SPIN_CYCLES_PER_MS))
        spun = torch.cuda.Event()
        spun.record()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ahead = not spun.query()
        torch.cuda.synchronize()
        if ahead:
            return {"ms": start.elapsed_time(end) / reps,
                    "events_ms": events, "ahead": True}
        spin_ms *= 4
    return {"ms": events, "events_ms": events, "ahead": False}


def launch_breakdown(fn, reps: int) -> dict:
    """Device ms per call of each kernel that ``fn`` launches, from a
    profiler trace of ``reps`` calls (after a warm-up call).  The profiler
    has lost kernel records before (PERF.md §6): these split a time that
    ``timed`` measured, they do not replace it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    by_name = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device_us(prof, by_name)
    return {name.split("(")[0][:60]: us / reps / 1e3
            for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])}


def host_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def max_abs_err(got: dict, exp: dict) -> float:
    """Integer entries must be equal; returns the largest float gap."""
    err = 0.0
    for k in exp:
        a, b = got[k].cpu(), exp[k].cpu()
        require(a.dtype == b.dtype and a.shape == b.shape, f"{k} layout")
        if a.dtype.is_floating_point:
            err = max(err, float((a - b).abs().max()) if a.numel() else 0.0)
        else:
            require(bool((a == b).all()), f"{k} differs")
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def random_runs(seed, n, n_keys, max_rep=12):
    from repro_torch.core.sketch import split_key
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, size=n).astype(np.int64) * 0x9E3779B9
    lo, hi = split_key(keys)
    return (lo, hi, rng.integers(1, max_rep, size=n).astype(np.int32),
            rng.random(n).astype(np.float32),
            (rng.random(n) * 3).astype(np.float32),
            np.cumsum(rng.random(n)).astype(np.float32),
            (rng.random(n) * 0.01).astype(np.float32))


def sketch_case(p, runs, dev):
    """Kernel vs plain version, both on the card; returns max float gap
    over state and drain (integers must be equal)."""
    import torch

    from repro_torch.kernels.sketch_update import ops, ref
    args = [torch.from_numpy(x).to(dev) for x in runs]
    n = len(runs[0])
    st_k, dr_k = ops.insert_runs_cuda(ref.make_state(p, dev),
                                      ref.make_drain(n, dev), *args, H=p.H)
    st_p, dr_p = ref.insert_runs_plain(ref.make_state(p, dev),
                                       ref.make_drain(n, dev), *args, H=p.H)
    torch.cuda.synchronize()
    return max(max_abs_err(st_k, st_p), max_abs_err(dr_k, dr_p)), \
        int(dr_k["d_n"])


def check_sketch_kernel(dev):
    import torch

    from repro_torch.core.sketch import SketchParams, split_key
    from repro_torch.kernels.sketch_update import ops, ref
    cases = []
    for seed, d, m, H, L, n, keys in ((0, 2, 64, 4, 16, 300, 20),
                                      (1, 1, 8, 2, 2, 300, 20),
                                      (2, 3, 16, 8, 4, 300, 20),
                                      (5, 2, 256, 4, 8, 400, 60),
                                      (3, 2, 1024, 8, 1024, 600, 200)):
        p = SketchParams(d=d, m=m, H=H, L=L)
        err, drained = sketch_case(p, random_runs(seed, n, keys), dev)
        require(err == 0.0, f"sketch kernel float gap {err} ({p})")
        cases.append({"params": [d, m, H, L], "runs": n, "drained": drained,
                      "max_abs_err": err})
    # promotion / steal / decrement on one bucket
    p = SketchParams(d=1, m=1, H=4, L=4)
    lo, hi = split_key(np.array([7, 7, 9, 9, 5], dtype=np.int64))
    durs = np.full(5, 0.25, np.float32)
    runs = (lo, hi, np.array([2, 5, 3, 9, 3], np.int32), durs, durs * 2,
            (np.arange(5) * 10).astype(np.float32),
            np.full(5, 0.5, np.float32))
    err, _ = sketch_case(p, runs, dev)
    require(err == 0.0, "promotion/steal case")
    cases.append({"params": [1, 1, 4, 4], "runs": 5, "case": "steal",
                  "max_abs_err": err})
    # per-record stream with a drain (each record a run of one)
    p = SketchParams(d=2, m=64, H=2, L=4)
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 40, size=500).astype(np.int64) * 31337
    lo, hi = split_key(keys)
    dur = rng.random(500).astype(np.float32)
    recs = [torch.from_numpy(x).to(dev) for x in
            (lo, hi, dur, dur * 2, np.arange(500, dtype=np.float32))]
    st_k, dr_k = ops.insert(ref.make_state(p, dev), *recs, params=p,
                            drain=ref.make_drain(500, dev))
    st_p, dr_p = ref.insert_plain(ref.make_state(p, dev),
                                  ref.make_drain(500, dev), *recs, H=p.H)
    err = max(max_abs_err(st_k, st_p), max_abs_err(dr_k, dr_p))
    require(err == 0.0, "per-record stream")
    cases.append({"params": [2, 64, 2, 4], "records": 500,
                  "drained": int(dr_k["d_n"]), "max_abs_err": err})
    return cases


def check_failrank_kernel(dev):
    import torch

    from repro_torch.kernels.failrank_step.ops import failrank_step_cuda
    from repro_torch.kernels.failrank_step.ref import failrank_step_ref
    n = 260
    rng = np.random.default_rng(n)
    w = rng.random((n, n)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    x = [torch.from_numpy(a).to(dev) for a in
         (w, rng.random((n, n)).astype(np.float32),
          rng.random(n).astype(np.float32), rng.random(n).astype(np.float32))]
    s_k, l_k = failrank_step_cuda(*x)
    s_p, l_p = failrank_step_ref(*x)
    torch.cuda.synchronize()
    es = float((s_k - s_p).abs().max())
    el = float((l_k - l_p).abs().max())
    require(es <= 1e-5 and el == 0.0, f"failrank step gaps s={es} L={el}")
    return {"n": n, "s_max_abs_err": es, "l_max_abs_err": el}


def allclose(got, exp, tol):
    """(max |got − exp|, whether |got − exp| ≤ tol + tol·|exp| everywhere)."""
    diff = (got.float() - exp.float()).abs()
    return float(diff.max()), bool((diff <= tol + tol * exp.abs()).all())


def attention_cases(dev):
    """(label, q, k, v, q_pos, k_pos, causal, window) in the model layout:
    the f32 shapes of ``test_kernels.py:294-313`` over ``arange``
    positions, then the serving shapes of smollm-135m."""
    import torch

    from repro_torch.kernels.flash_attention.ref import rolled_pos_tab
    rng = np.random.default_rng(7)

    def rand(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    def ar(n):
        return torch.arange(n, dtype=torch.int32, device=dev)

    cases = []
    for b, s, t, hq, hk, d, causal, win in (
            (2, 128, 128, 4, 2, 64, True, None),
            (1, 256, 256, 2, 2, 32, True, 64),
            (2, 100, 200, 4, 1, 16, False, None),
            (1, 1, 384, 8, 4, 64, True, None)):
        cases.append((f"q{[b, s, hq, d]} kv{[b, t, hk, d]}", rand(b, s, hq, d),
                      rand(b, t, hk, d), rand(b, t, hk, d), ar(s), ar(t),
                      causal, win))
    q, k, v = rand(4, 512, 9, 64), rand(4, 512, 3, 64), rand(4, 512, 3, 64)
    for win in (None, 128):
        cases.append(("prefill [4,512,9,64]", q, k, v, ar(512), ar(512), True,
                      win))
    q1, kc, vc = rand(4, 1, 9, 64), rand(4, 1024, 3, 64), rand(4, 1024, 3, 64)
    tab = decode_pos_tab(dev)
    for win in (None, 256):
        cases.append(("decode [4,1,9,64] over 1024 slots", q1, kc, vc,
                      torch.tensor([1299], dtype=torch.int32, device=dev),
                      tab, True, win))
        cases.append(("decode [4,1,9,64] at the serve fill", q1, kc, vc,
                      torch.tensor([543], dtype=torch.int32, device=dev),
                      serve_fill_tab(dev), True, win))
    # (label, B, S, Hq, Hkv, D, rolled_pos_tab arguments, window)
    for label, b, s, hq, hk, d, tab_args, win in (
            ("decode, split 64..127 wholly empty, GQA 8", 2, 1, 8, 1, 32,
             (256, 100, 611, list(range(64, 128))), None),
            ("decode, two splits wholly outside the window, GQA 1", 2, 1, 3,
             3, 16, (256, 100, 611, [5, 70]), 40),
            ("decode, 200 slots (not a multiple of 64)", 2, 1, 9, 3, 128,
             (200, 0, 149, []), None),
            ("decode, 16 rows (the dispatch line)", 2, 2, 16, 2, 64,
             (300, 0, 299, []), None),
            ("prefill, 17 rows (past the dispatch line)", 2, 17, 2, 2, 64,
             (70, 0, 69, [0, 1]), 30),
            ("prefill, 18 rows", 2, 3, 6, 1, 32, (300, 0, 299, []), 100)):
        t, last = tab_args[0], tab_args[2]
        cases.append((label, rand(b, s, hq, d), rand(b, t, hk, d),
                      rand(b, t, hk, d),
                      torch.arange(last + 1 - s, last + 1, dtype=torch.int32,
                                   device=dev),
                      torch.from_numpy(rolled_pos_tab(*tab_args)).to(dev),
                      True, win))
    return cases


def serve_fill_tab(dev):
    """The cache of the serve run's last decode step: positions 0..543 in
    slots 0..543 of 1,024, the rest empty."""
    import torch
    fill = torch.full((1024,), -1, dtype=torch.int32, device=dev)
    fill[:544] = torch.arange(544, dtype=torch.int32, device=dev)
    return fill


def decode_pos_tab(dev):
    """Positions 600..1299 through a 1,024-slot rolling cache (slots 0..275
    hold 1024..1299, 600..1023 themselves), slots 276..599 empty, and a
    few more cleared."""
    import torch

    from repro_torch.kernels.flash_attention.ref import rolled_pos_tab
    return torch.from_numpy(
        rolled_pos_tab(1024, 600, 1299, [5, 77, 700, 1023])).to(dev)


def check_attention_kernel(dev, lib):
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_cuda, uses_decode)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    out, worst = [], 0.0
    for label, q, k, v, qp, kp, causal, win in attention_cases(dev):
        entry = ("flash_attention_decode"
                 if uses_decode(q.shape[1], q.shape[2], k.shape[2])
                 else "flash_attention_prefill")
        before = lib.LAUNCHES[entry]
        got = flash_attention_cuda(q, k, v, q_pos=qp, k_pos=kp,
                                   causal=causal, window=win)
        require(lib.LAUNCHES[entry] == before + 1, f"{label}: not {entry}")
        exp = attention_ref(q, k, v, q_pos=qp, k_pos=kp, causal=causal,
                            window=win)
        err, ok = allclose(got, exp, 2e-5)
        require(ok, f"flash attention vs plain, {label} window {win}: {err}")
        worst = max(worst, err)
        out.append({"case": label, "entry": entry, "causal": causal,
                    "window": win, "max_abs_err": err})
    return out, worst


def check_bit_identical(dev):
    """Two runs of the attention decode (the serve fill) and of the SSD
    scan (mamba2-1.3b's prefill, from a non-zero state) must be equal bit
    for bit: no atomics, and every sum in an order fixed by the shapes."""
    import torch

    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
    from repro_torch.kernels.ssd_scan.ops import ssd_cuda
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev) for shape in ((4, 1, 9, 64), (4, 1024, 3, 64),
                                           (4, 1024, 3, 64)))
    qp = torch.tensor([543], dtype=torch.int32, device=dev)
    fill = serve_fill_tab(dev)
    a, b = (flash_attention_cuda(q, k, v, q_pos=qp, k_pos=fill)
            for _ in range(2))
    b_, s_, h, p, g, n, chunk = SSD_CASES[-1]
    args, st0 = ssd_inputs(dev, b_, s_, h, p, g, n, 13, True)
    (y1, s1), (y2, s2) = (ssd_cuda(*args, chunk=chunk, init_state=st0)
                          for _ in range(2))
    out = {"attention_decode": bool(torch.equal(a, b)),
           "ssd_scan": bool(torch.equal(y1, y2) and torch.equal(s1, s2))}
    require(all(out.values()), f"runs differ: {out}")
    return out


def ssd_inputs(dev, b, s, h, p, g, n, seed, with_state):
    """(x, dt, a, b, c) and a state (zero unless ``with_state``) on the
    card, from ``ssd_scan.ref.random_inputs``."""
    import torch

    from repro_torch.kernels.ssd_scan.ref import random_inputs
    *arrs, state = random_inputs(seed, b, s, h, p, g, n)
    if not with_state:
        state = np.zeros_like(state)
    return ([torch.from_numpy(a).to(dev) for a in arrs],
            torch.from_numpy(state).to(dev))


#: (B, S, H, P, G, N, chunk): ``test_kernels.py:320-354``, chunks 16, 24
#: and 128 with a ragged last chunk, 19 chunks (more than the state pass
#: keeps in flight), and mamba2-1.3b's serving prefill
#: (4 × 512 tokens, chunk 128; last, as phase 8 times it).
SSD_CASES = ((2, 96, 4, 32, 2, 16, 32), (1, 200, 2, 16, 1, 8, 64),
             (2, 64, 8, 8, 4, 8, 16), (2, 80, 4, 16, 2, 8, 32),
             (2, 100, 8, 64, 2, 128, 16), (1, 100, 4, 32, 4, 64, 24),
             (2, 300, 16, 64, 8, 128, 128), (1, 130, 2, 72, 1, 70, 128),
             (1, 300, 4, 16, 2, 16, 16), (4, 512, 64, 64, 8, 128, 128))


def check_ssd_kernel(dev):
    from repro_torch.kernels.ssd_scan.ops import ssd_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    out, worst = [], 0.0
    for i, (b, s, h, p, g, n, chunk) in enumerate(SSD_CASES):
        for with_state in (False, True):
            args, st0 = ssd_inputs(dev, b, s, h, p, g, n, i, with_state)
            init = st0 if with_state else None
            yk, sk = ssd_cuda(*args, chunk=chunk, init_state=init)
            yp, sp = ssd_ref(*args, chunk=chunk, init_state=init)
            ey, oky = allclose(yk, yp, 2e-4)
            es, oks = allclose(sk, sp, 2e-4)
            require(oky and oks, f"ssd scan vs plain {SSD_CASES[i]} "
                                 f"state={with_state}: y {ey}, state {es}")
            worst = max(worst, ey, es)
            out.append({"shape": list(SSD_CASES[i]), "init_state": with_state,
                        "y_max_abs_err": ey, "state_max_abs_err": es})
    return out, worst


# ---------------------------------------------------------------------------
# phases 3-5: the detection path
# ---------------------------------------------------------------------------

def fault_list(mesh_n):
    return [f for (m, f) in REFERENCE if m == mesh_n]


def drive(sloth, mesh_n, lib):
    """Three ``detect`` calls; checks each verdict against the reference
    and the sketch kernel's two launches per call."""
    from repro_torch.core.failures import FailSlow
    verdicts = {}
    for f in fault_list(mesh_n):
        before = lib.LAUNCHES["sketch_insert_runs"]
        t0 = time.perf_counter()
        v = sloth.detect([FailSlow(*f, 1.0, 8.0, 10.0)] if f else None,
                         seed=0)
        secs = time.perf_counter() - t0
        k1 = lib.LAUNCHES["sketch_insert_runs"] - before
        flagged, kind, loc, iters = REFERENCE[(mesh_n, f)]
        r = v.recorder
        emit({"phase": "verdict", "mesh": f"{mesh_n}x{mesh_n}",
              "fault": f, "flagged": v.flagged, "kind": v.kind,
              "location": v.location, "iterations": v.failrank.iterations,
              "reference": {"flagged": flagged, "kind": kind,
                            "location": loc, "iterations": iters},
              "ranking": [[k, l, s] for k, l, s in v.ranking],
              "sketch_launches": k1, "n_comp_drained": r.n_comp_drained,
              "n_comm_drained": r.n_comm_drained,
              "compression_ratio": r.compression_ratio,
              "detect_s": secs})
        require((v.flagged, v.kind, v.location) == (flagged, kind, loc),
                f"{mesh_n}x{mesh_n} {f}: verdict differs from reference")
        require(abs(v.failrank.iterations - iters) <= 1,
                f"{mesh_n}x{mesh_n} {f}: FailRank iterations "
                f"{v.failrank.iterations} vs reference {iters}")
        require(k1 == 2, f"sketch kernel launched {k1} times in detect")
        verdicts[f] = v
    return verdicts


def same_recording(a, b):
    for side in ("comp", "comm"):
        pa, pb = getattr(a, side + "_patterns"), getattr(b, side + "_patterns")
        require([(q.key, q.count, q.arrival) for q in pa]
                == [(q.key, q.count, q.arrival) for q in pb],
                f"{side} patterns differ between card and CPU")
    for f in ("sketch_comp_bytes", "sketch_comm_bytes", "n_comp_drained",
              "n_comm_drained", "n_comp_records", "n_comm_records"):
        require(getattr(a, f) == getattr(b, f), f"{f} differs")


def sketch_inputs(sloth, sim, dev):
    """The two sketches' run tensors exactly as ``record`` builds them
    (at its default packetisation)."""
    import torch

    from repro_torch.core.probes import PACKET_BYTES
    from repro_torch.core.recorder import comm_runs, comp_runs
    from repro_torch.core.sketch import split_key
    out = {}
    for side, runs in (("comp", comp_runs(sim.comp,
                                          sloth.cfg.instr_per_task)),
                       ("comm", comm_runs(sim.comm, PACKET_BYTES, 64,
                                          sloth.sim_cfg.hop_latency))):
        lo, hi = split_key(np.asarray(runs[0], dtype=np.int64))
        out[side] = [torch.from_numpy(np.ascontiguousarray(x, dtype=dt))
                     .to(dev) for x, dt in zip(
                         (lo, hi, *runs[1:]),
                         (np.int32, np.int32, np.int32, np.float32,
                          np.float32, np.float32, np.float32))]
    return out


def time_stages(sloth, sim):
    """Wall time of ``record`` and of each stage of ``analyse_recorded``
    for one trace (host clock, synchronised)."""
    import torch

    from repro_torch.core.detection import detect_cores, detect_links
    from repro_torch.core.failrank import failrank
    from repro_torch.core.mcg import build_mcg
    from repro_torch.core.recorder import record
    cfg, mesh = sloth.cfg, sloth.mesh
    ms = {}
    t0 = time.perf_counter()
    rec = record(sim, cfg.sketch, instr_per_task=cfg.instr_per_task,
                 hop_latency=sloth.sim_cfg.hop_latency,
                 impl=cfg.recorder_impl, device=sloth.device)
    torch.cuda.synchronize()
    ms["record"] = (time.perf_counter() - t0) * 1e3
    T = sim.total_time
    core_z, link_ratio = cfg.flag_thresholds(mesh)
    t0 = time.perf_counter()
    cores = detect_cores(rec.comp_patterns, T, cfg.n_windows, core_z,
                         rate_scale=getattr(mesh, "rate_class", None))
    ms["detect_cores"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    links = detect_links(rec.comm_patterns, mesh, T, cfg.n_windows,
                         sloth.sim_cfg.hop_latency, link_ratio)
    ms["detect_links"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    mcg = build_mcg(rec.comm_patterns, mesh, T, cores, links, cfg.n_windows)
    ms["build_mcg"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    failrank(mcg, cfg.failrank, device=sloth.device)
    ms["failrank"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    sloth.analyse_recorded(rec, T)
    ms["analyse_recorded_total"] = (time.perf_counter() - t0) * 1e3
    return ms


# ---------------------------------------------------------------------------
# phases 6-8: the serving path
# ---------------------------------------------------------------------------

def serve_run(arch, lib):
    """``launch.serve.main`` on the card at full size with the counts set
    to 0 just before; checks the requests and the launches per layer."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    cfg = get_config(arch)
    n_req, batch, max_new = 8, 4, 32
    n_batches = -(-n_req // batch)
    lib.reset_launches()
    t0 = time.perf_counter()
    done, stats = serve.main(["--arch", arch, *SERVE_FLAGS])
    wall = time.perf_counter() - t0
    launches = dict(lib.LAUNCHES)
    n_attn = cfg.n_attn_layers
    want = {"flash_attention": n_attn * n_batches * (1 + max_new),
            "flash_attention_prefill": n_attn * n_batches,
            "flash_attention_decode": n_attn * n_batches * max_new,
            "ssd_scan": (cfg.n_layers - n_attn) * n_batches}
    # the launcher's numbers: tok/s is all tokens over the engine.run wall
    # time; the p99 of 64 decode steps is close to their maximum
    summary = {"phase": "serve", "arch": arch, "layers": cfg.n_layers,
               **stats, "launches": launches, "expected_launches": want,
               "wall_s_with_init": wall}
    emit(summary)
    for key in ("prefill_ms_mean", "decode_ms_p50", "decode_ms_p99",
                "tok_per_s"):
        print(f"{arch} {key} {summary[key]}", flush=True)
    require([r.rid for r in done] == list(range(n_req)), f"{arch}: requests")
    require(all(len(r.out_tokens) == max_new
                and all(0 <= t < cfg.vocab for t in r.out_tokens)
                for r in done), f"{arch}: tokens per request")
    for name, n in want.items():
        require(launches[name] == n,
                f"{arch}: {name} launched {launches[name]} times, not {n}")
    return launches


def check_pin(pin, dev, lib):
    """The port on the card against one of the reference's pins, on the
    same numpy weights and prompts."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy, reference_params_numpy
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config(pin["arch"]),
                              n_layers=pin["n_layers"])
    model = params_from_numpy(cfg, reference_params_numpy(cfg, 0), dev)
    toks = np.random.default_rng(PIN_PROMPT_SEED).integers(
        0, cfg.vocab, (2, PIN_PROMPT_LEN)).astype(np.int32)
    n_new = len(pin["tokens"][0])
    lib.reset_launches()
    cache = T.init_cache(cfg, 2, PIN_PROMPT_LEN + n_new, device=dev)
    last, cache = T.prefill(cfg, model, torch.from_numpy(toks).to(dev),
                            cache)
    logits = last[:, -1]
    ids = torch.tensor(pin["top5_ids"], device=dev)
    err = float((logits.gather(-1, ids).cpu()
                 - torch.tensor(pin["top5_logits"])).abs().max())
    new = []
    for k in range(n_new):
        nxt = logits.argmax(-1)
        new.append(nxt.tolist())
        out, cache = T.decode_step(cfg, model, nxt[:, None], cache,
                                   PIN_PROMPT_LEN + k)
        logits = out[:, -1]
    tokens = np.array(new).T.tolist()
    emit({"phase": "reference_pin", "arch": pin["arch"],
          "layers": cfg.n_layers, "tokens_equal": tokens == pin["tokens"],
          "top5_logit_max_abs_err": err, "launches": dict(lib.LAUNCHES)})
    require(tokens == pin["tokens"], f"{pin['arch']}: greedy tokens differ "
                                     f"from the reference: {tokens}")
    require(err <= 1e-3, f"{pin['arch']}: prefill logits off by {err}")


#: The timing keys of a kernel's entry in the summary line.
KERNEL_TIME_KEYS = ("ms", "plain_ms", "library_ms", "events_ms",
                    "plain_events_ms", "library_events_ms", "timing",
                    "bound_ms", "bound_by")


def time_attention(q, k, v, q_pos, k_pos, reps):
    """Kernel, plain version and SDPA (same boolean mask) on one causal
    case.  Bound from bytes (q, the output, both position tables, and the
    K/V of only the slots some query can use) and from 4·D f32 operations
    per live (query, key) pair."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                         live_mask)
    mask = live_mask(q_pos, k_pos)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def kernel():
        return flash_attention_cuda(q, k, v, q_pos=q_pos, k_pos=k_pos)

    def plain():
        return attention_ref(q, k, v, q_pos=q_pos, k_pos=k_pos)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)

    err, _ = allclose(kernel(), plain(), 2e-5)
    lib_err, _ = allclose(library().transpose(1, 2), plain(), 2e-5)
    b, s, hq, d = q.shape
    live_slots = int(mask.any(0).sum())
    nbytes = (2 * q.numel() * 4 + (q_pos.numel() + k_pos.numel()) * 4
              + 2 * b * live_slots * k.shape[2] * d * 4)
    flops = 4 * d * b * hq * int(mask.sum())
    return {**times(kernel, plain, library, reps),
            **bound(nbytes, flops), "live_slots": live_slots,
            "kernel_breakdown_ms": launch_breakdown(kernel, reps),
            "max_abs_err": err, "library_max_abs_err_vs_plain": lib_err}


def times(kernel, plain, library, reps):
    """ms / plain_ms / library_ms (device time per call, ``timed``) and the
    same three back to back (``*events_ms``); ``timing`` names any that
    fell back to the back-to-back time."""
    out, paced = {}, []
    for key, fn in (("ms", kernel), ("plain_ms", plain),
                    ("library_ms", library)):
        if fn is None:
            out[key] = out[key.replace("ms", "events_ms")] = None
            continue
        t = timed(fn, reps)
        out[key] = t["ms"]
        out[key.replace("ms", "events_ms")] = t["events_ms"]
        if not t["ahead"]:
            paced.append(key)
    out["timing"] = timing_label(paced)
    return out


def timing_label(paced) -> str:
    return "cuda events, host held ahead" + (
        f"; back to back for {', '.join(paced)}" if paced else "")


def bound(nbytes, flops):
    """The least time: bytes over the memory rate or f32 operations over
    the peak rate, whichever is larger."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return {"bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "flops": flops}


def time_ssd(dev, reps):
    """Kernel and plain version at mamba2-1.3b's serving prefill (the
    serving path starts from a zero state); bound from bytes and from the
    f32 operations of the causal half of C·Bᵀ (once per group: the heads
    of a group share C and B), the intra-chunk product, the state update
    and the inter-chunk term."""
    from repro_torch.kernels.ssd_scan.ops import ssd_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    b, s, h, p, g, n, q = SSD_CASES[-1]
    args, st0 = ssd_inputs(dev, b, s, h, p, g, n, 99, False)

    def kernel():
        return ssd_cuda(*args, chunk=q, init_state=st0)

    def plain():
        return ssd_ref(*args, chunk=q, init_state=st0)

    (yk, sk), (yp, sp) = kernel(), plain()
    err = max(allclose(yk, yp, 2e-4)[0], allclose(sk, sp, 2e-4)[0])
    nbytes = sum(x.numel() * 4 for x in (*args, st0, yk, sk))
    pairs = sum(m * (m + 1) // 2 for m in
                [min(q, s - t0) for t0 in range(0, s, q)])
    flops = b * (g * 2 * pairs * n + h * (2 * pairs * p + 4 * s * p * n))
    return {**times(kernel, plain, None, reps), **bound(nbytes, flops),
            "kernel_breakdown_ms": launch_breakdown(kernel, reps),
            "max_abs_err": err}


def profile_serving(arch, dev):
    """A prefill of 4 × 512 tokens into a 1,024-slot cache and 8 decode
    steps at full size: host-clock ms without the profiler, then device
    time by kernel in a profiler trace of the same work."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config(arch)
    gen = torch.Generator(device=dev).manual_seed(1)
    model = T.init_model(cfg, gen)
    toks = torch.randint(0, cfg.vocab, (4, 512), device=dev, generator=gen,
                         dtype=torch.int32)
    n_dec = 8

    def prefill():
        cache = T.init_cache(cfg, 4, 1024, device=dev)
        last, cache = T.prefill(cfg, model, toks, cache)
        return last[:, -1].argmax(-1)[:, None], cache

    def decode(nxt, cache):
        for k in range(n_dec):
            logits, cache = T.decode_step(cfg, model, nxt, cache, 512 + k)
            nxt = logits[:, -1].argmax(-1)[:, None]

    decode(*prefill())                                  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = prefill()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    decode(*state)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = {"phase": "serve_profile", "arch": arch}
    for stage, work, wall, n in (("prefill", prefill, t1 - t0, 1),
                                 ("decode_step", lambda: decode(*state),
                                  t2 - t1, n_dec)):
        by_name = {}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            work()
            torch.cuda.synchronize()
        dev_ms = device_us(prof, by_name) / n / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        out[stage] = {"host_ms": wall / n * 1e3, "device_ms": dev_ms,
                      "device_idle_share": 1.0 - dev_ms / (wall / n * 1e3),
                      "top_kernels_ms": [[name[:80], us / n / 1e3]
                                         for name, us in top]}
    emit(out)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    from repro_torch.core.failrank import failrank
    from repro_torch.core.failures import FailSlow
    from repro_torch.core.graph import build_workload
    from repro_torch.core.recorder import record
    from repro_torch.core.routing import Mesh2D
    from repro_torch.core.sloth import Sloth, SlothConfig
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _lib as lib
    from repro_torch.kernels.failrank_step import ops as fr_ops
    from repro_torch.kernels.failrank_step.ref import failrank_step_ref
    from repro_torch.kernels.sketch_update import ops as sk_ops
    from repro_torch.kernels.sketch_update import ref as sk_ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    card = smi.strip().splitlines()[0]
    print(card, flush=True)
    dev = resolve_device(None)
    # full f32 products everywhere (the plain versions' einsums included)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0)})

    # ---- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    secs = lib.build_all()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "per_source": secs,
          "ptxas": {n: [ln.strip() for ln in lib.build_log(n).splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n in secs}})

    # ---- 2. kernels against their plain versions -------------------------
    emit({"phase": "sketch_kernel_vs_plain", "cases": check_sketch_kernel(dev)})
    emit({"phase": "failrank_kernel_vs_plain", **check_failrank_kernel(dev)})
    attn_cases, k3_err = check_attention_kernel(dev, lib)
    emit({"phase": "attention_kernel_vs_plain", "tol": 2e-5,
          "cases": attn_cases})
    ssd_cases, k4_err = check_ssd_kernel(dev)
    emit({"phase": "ssd_kernel_vs_plain", "tol": 2e-4, "cases": ssd_cases})
    emit({"phase": "bit_identical", **check_bit_identical(dev)})

    # ---- 3. the main path: resnet50 on 8×8 -------------------------------
    cfg = SlothConfig(recorder_impl="batched")
    t0 = time.perf_counter()
    sloth8 = Sloth(build_workload("resnet50"), Mesh2D(8), cfg)
    setup_s = time.perf_counter() - t0
    require(sloth8.device == dev, f"default device {sloth8.device}")
    lib.reset_launches()
    verdicts = drive(sloth8, 8, lib)
    mcg = verdicts[("core", 6)].mcg
    _, s_dense, _, dense_it = fr_ops.failrank_dense(mcg, cfg.failrank)
    launches = dict(lib.LAUNCHES)
    coo = verdicts[("core", 6)].failrank
    dense_err = float(np.abs(s_dense - coo.raw_node_scores).max())
    emit({"phase": "failrank_dense", "mesh": "8x8", "nodes": mcg.n_nodes,
          "edges": int(len(mcg.edge_src)), "iterations": dense_it,
          "coo_iterations": coo.iterations, "s_max_abs_err_vs_coo":
          dense_err})
    emit({"phase": "main_path_launches", "launches": launches,
          "setup_s": setup_s})
    require(dense_err <= 1e-4, f"dense vs COO s gap {dense_err}")
    require(launches["sketch_insert_runs"] == 6, "sketch kernel launches")
    require(dense_it >= 1 and launches["failrank_step"] == dense_it,
            "failrank kernel launches")
    for f, v in verdicts.items():
        require(v.recorder.n_comp_drained > 0
                and v.recorder.n_comm_drained > 0, f"empty drain for {f}")

    # ---- 4. the same trace on the plain CPU path; times ------------------
    core6 = [FailSlow("core", 6, 1.0, 8.0, 10.0)]
    sim = sloth8.run(core6, seed=0)
    rec_cpu = {}
    cpu_ms = host_ms(lambda: rec_cpu.setdefault("r", record(
        sim, cfg.sketch, instr_per_task=cfg.instr_per_task,
        hop_latency=sloth8.sim_cfg.hop_latency, impl="batched",
        device="cpu")))
    same_recording(verdicts[("core", 6)].recorder, rec_cpu["r"])
    emit({"phase": "cpu_recording_identical", "mesh": "8x8",
          "record_cpu_ms": cpu_ms})
    emit({"phase": "stage_ms", "mesh": "8x8", "fault": ["core", 6],
          "simulate_ms": host_ms(lambda: sloth8.run(core6, seed=0)),
          **time_stages(sloth8, sim)})

    p = cfg.sketch
    inputs = sketch_inputs(sloth8, sim, dev)
    k1 = {"ms": 0.0, "events_ms": 0.0, "plain_ms": 0.0, "bytes": 0,
          "err": 0.0, "runs": {}}
    for side, args in inputs.items():
        n = args[0].shape[0]
        st0, dr0 = sk_ref.make_state(p, dev), sk_ref.make_drain(n, dev)

        def kernel(args=args, st0=st0, dr0=dr0):
            # the wrapper copies the state and drain, then launches
            return sk_ops.insert_runs_cuda(st0, dr0, *args, H=p.H)
        t = timed(kernel, reps=5)
        st_k, dr_k = kernel()
        cpu_args = [a.cpu() for a in args]
        out = {}
        plain = host_ms(lambda: out.setdefault("r", sk_ref.insert_runs_plain(
            sk_ref.make_state(p), sk_ref.make_drain(n), *cpu_args, H=p.H)))
        st_p, dr_p = out["r"]
        err = max(max_abs_err(st_k, st_p), max_abs_err(dr_k, dr_p))
        drained = int(dr_k["d_n"])
        state_b = sum(t.numel() * t.element_size() for t in st_k.values())
        nbytes = (sum(a.numel() * a.element_size() for a in args)
                  + 2 * state_b + drained * 40 + 8)
        k1["ms"] += t["ms"]
        k1["events_ms"] += t["events_ms"]
        k1["timing"] = timing_label([] if t["ahead"] else ["ms"])
        k1["plain_ms"] += plain
        k1["bytes"] += nbytes
        k1["err"] = max(k1["err"], err)
        k1["runs"][side] = {"runs": n, "drained": drained, **t,
                            "plain_cpu_ms": plain, "bytes": nbytes}
    require(k1["err"] == 0.0, f"sketch kernel vs plain at main-path shapes: "
                              f"{k1['err']}")
    emit({"phase": "sketch_kernel_main_path_shapes", **k1["runs"],
          "max_abs_err": k1["err"]})

    w, l = (torch.from_numpy(x).to(dev) for x in fr_ops.mcg_dense(mcg))
    s0 = torch.as_tensor(mcg.s0, dtype=torch.float32, device=dev)
    s_k, l_k = fr_ops.failrank_step_cuda(w, l, s0, s0)
    s_p, l_p = failrank_step_ref(w, l, s0, s0)
    k2_err = max(float((s_k - s_p).abs().max()),
                 float((l_k - l_p).abs().max()))
    require(k2_err <= 1e-5, f"failrank step on the MCG: {k2_err}")
    k2_times = times(lambda: fr_ops.failrank_step_cuda(w, l, s0, s0),
                     lambda: failrank_step_ref(w, l, s0, s0), None, 100)
    n = mcg.n_nodes
    k2_bytes = 3 * n * n * 4 + 3 * n * 4
    k2_flops = 5 * n * n + 3 * n

    # ---- 5. resnet50 on 4×4 (the quickstart configuration) ---------------
    sloth4 = Sloth(build_workload("resnet50"), Mesh2D(4), cfg)
    lib.reset_launches()
    drive(sloth4, 4, lib)
    emit({"phase": "main_path_launches", "mesh": "4x4",
          "launches": dict(lib.LAUNCHES)})
    require(lib.LAUNCHES["sketch_insert_runs"] == 6, "4x4 sketch launches")
    again = failrank(mcg, cfg.failrank)
    require(again.iterations == coo.iterations and np.array_equal(
        again.raw_node_scores, coo.raw_node_scores),
        "COO FailRank is not run-to-run identical on the card")

    # ---- 6. the serving path at full size ----------------------------------
    serve_launches = {arch: serve_run(arch, lib)
                      for arch in ("smollm-135m", "mamba2-1.3b")}
    require(serve_launches["mamba2-1.3b"]["flash_attention"] == 0,
            "mamba2-1.3b launched attention")

    # ---- 7. against the JAX reference's pins -------------------------------
    for pin in PINS:
        check_pin(pin, dev, lib)

    # ---- 8. K3 and K4 at the serving shapes ---------------------------------
    rng = np.random.default_rng(11)

    def rand(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)
    pos = torch.arange(512, dtype=torch.int32, device=dev)
    k3 = time_attention(rand(4, 512, 9, 64), rand(4, 512, 3, 64),
                        rand(4, 512, 3, 64), pos, pos, reps=20)
    # decode as the serve run's last step sees the cache
    k3_dec = time_attention(
        rand(4, 1, 9, 64), rand(4, 1024, 3, 64), rand(4, 1024, 3, 64),
        torch.tensor([543], dtype=torch.int32, device=dev),
        serve_fill_tab(dev), reps=50)
    k4 = time_ssd(dev, reps=10)
    emit({"phase": "serving_kernel_times", "flash_attention_prefill": k3,
          "flash_attention_decode": k3_dec, "ssd_scan_prefill": k4})
    for arch in ("smollm-135m", "mamba2-1.3b"):
        profile_serving(arch, dev)

    k1_bound = k1["bytes"] / HBM_BYTES_PER_S * 1e3
    k2_bound = max(k2_bytes / HBM_BYTES_PER_S,
                   k2_flops / FP32_FLOP_PER_S) * 1e3
    emit({"kernels": [
        {"name": "sketch_insert_runs", "route": "cuda",
         "source": "src/repro_torch/csrc/sketch_insert.cu",
         "replaces": "src/repro/kernels/sketch_update/kernel.py:158",
         "launches": launches["sketch_insert_runs"],
         "max_abs_err": k1["err"], "ms": k1["ms"],
         "events_ms": k1["events_ms"], "timing": k1["timing"],
         "plain_ms": k1["plain_ms"], "plain_device": "cpu",
         "bound_ms": k1_bound, "bound_by": "bytes", "library_ms": None,
         "shape": "resnet50 8x8, comp + comm sketches of one detect"},
        {"name": "failrank_step", "route": "cuda",
         "source": "src/repro_torch/csrc/failrank_step.cu",
         "replaces": "src/repro/kernels/failrank_step/kernel.py:42",
         "launches": launches["failrank_step"], "max_abs_err": k2_err,
         **k2_times, "plain_device": "cuda", "bound_ms": k2_bound,
         "bound_by": "bytes" if k2_bytes / HBM_BYTES_PER_S
         >= k2_flops / FP32_FLOP_PER_S else "operations",
         "shape": f"n={n}, one step"},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:89",
         "launches": serve_launches["smollm-135m"]["flash_attention"],
         "launches_prefill":
             serve_launches["smollm-135m"]["flash_attention_prefill"],
         "launches_decode":
             serve_launches["smollm-135m"]["flash_attention_decode"],
         "max_abs_err": max(k3_err, k3["max_abs_err"],
                            k3_dec["max_abs_err"]),
         **{k: k3[k] for k in KERNEL_TIME_KEYS}, "plain_device": "cuda",
         "shape": "smollm-135m prefill, q [4,512,9,64], kv [4,512,3,64], "
                  "causal, one layer",
         "decode": {k: k3_dec[k] for k in KERNEL_TIME_KEYS}
         | {"live_slots": k3_dec["live_slots"], "shape": "q [4,1,9,64] at position 543 over a 1024-slot "
                     "cache holding 0..543 (the serve run's last decode "
                     "step), one layer"}},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan/kernel.py:83",
         "launches": serve_launches["mamba2-1.3b"]["ssd_scan"],
         "max_abs_err": max(k4_err, k4["max_abs_err"]),
         **{k: k4[k] for k in KERNEL_TIME_KEYS}, "plain_device": "cuda",
         "shape": "mamba2-1.3b prefill, x [4,512,64,64], b/c [4,512,8,128], "
                  "chunk 128, one layer"},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
