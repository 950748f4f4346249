"""Serving launcher: batched prefill + greedy decode of a random request
stream, on the card by default.

    python -m repro_torch.launch.serve --arch smollm-135m
    python -m repro_torch.launch.serve --arch mamba2-1.3b --smoke \
        --device cpu --requests 8 --max-new 8
    python -m repro_torch.launch.serve --arch whisper-large-v3 --smoke \
        --device cpu

Weights are random, drawn from ``--seed`` on the chosen device; the
request stream comes from ``np.random.default_rng([seed, 0])``, as on one
host of the reference.  An encoder-decoder (whisper) is served over zero
frame embeddings ``[batch, n_frames, d_model]``, the reference's stand-in
for its audio frontend.  Prints the served requests and tokens with tok/s,
the mean prefill time, and the decode step p50/p99 (from the engine's
separate ``decode_times`` series).

``--telemetry`` taps the engine's per-step hook: decode step timings
stream into the pod detector every ``--telemetry-window`` steps
(:class:`~repro_torch.distributed.telemetry.StepTelemetry`, on the same
device), and each flagged window's verdict is printed live.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.base import get_config
from ..device import resolve_device
from ..distributed.telemetry import PodTelemetryConfig, StepTelemetry
from ..models import transformer as T
from ..serving.engine import EngineConfig, Request, ServeEngine


def main(argv=None, step_hook=None, cfg=None):
    """Parse ``argv``, serve, print the summary; returns the completed
    requests and the summary's numbers (:func:`summary`, with the
    telemetry's windows and flags under ``--telemetry``).
    ``step_hook(kind, dt)`` is handed to the engine (after the telemetry
    tap, when there is one).  ``cfg``, a config to serve in place of
    ``--arch``'s, cuts a model that one card cannot hold to fewer layers
    (``dataclasses.replace(get_config(arch), n_layers=...)``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--telemetry", action="store_true",
                    help="stream decode step timings into the pod "
                         "detector (one verdict per window)")
    ap.add_argument("--telemetry-window", type=int, default=8,
                    help="decode steps per streaming-detector window")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda:0; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    if cfg is None:
        cfg = get_config(args.arch, smoke=args.smoke)
    dev = resolve_device(args.device)
    model = T.init_model(cfg, torch.Generator(device=dev)
                         .manual_seed(args.seed), dtype=torch.float32)
    telemetry = None
    hook = step_hook
    if args.telemetry:
        telemetry = StepTelemetry(
            PodTelemetryConfig(mesh_w=4, mesh_h=4,
                               window_steps=args.telemetry_window),
            n_shards=args.batch, warmup=1, seed=args.seed, host=0,
            device=dev)

        def hook(kind, dt):
            if kind == "decode":    # prefills are not per-step samples
                v = telemetry.record_step(dt)
                if v is not None and v.flagged:
                    print(f"[telemetry] FLAGGED {v.kind} {v.location} "
                          f"severity {v.severity:.1f} -> "
                          f"{telemetry.plans[-1]['action']}")
            if step_hook is not None:
                step_hook(kind, dt)

    engine = ServeEngine(cfg, model,
                         EngineConfig(batch=args.batch,
                                      cache_len=args.cache_len, device=dev),
                         step_hook=hook)
    for req in make_requests(cfg, args.requests, args.prompt_len,
                             args.max_new, args.seed):
        engine.submit(req)
    enc_frames = None
    if cfg.enc_dec:
        # the reference's stand-in for the audio frontend: zero frames
        enc_frames = torch.zeros(args.batch, cfg.n_frames, cfg.d_model,
                                 device=dev)
    t0 = time.perf_counter()  # lint: allow-wallclock (reported only)
    done = engine.run(enc_frames=enc_frames)
    wall = time.perf_counter() - t0  # lint: allow-wallclock
    stats = summary(engine, done, wall)
    print(f"served {stats['requests']} requests, {stats['tokens']} tokens, "
          f"{stats['wall_s']:.1f}s ({stats['tok_per_s']:.1f} tok/s)")
    if engine.prefill_times:
        print(f"mean prefill {stats['prefill_ms_mean']:.1f} ms "
              f"({len(engine.prefill_times)} batches)")
    if engine.decode_times:
        print(f"p50 decode step {stats['decode_ms_p50']:.1f} ms, "
              f"p99 {stats['decode_ms_p99']:.1f} ms")
    if telemetry is not None:
        telemetry.flush()
        stats["telemetry_windows"] = len(telemetry.verdicts)
        stats["telemetry_flagged"] = sum(v.flagged
                                         for v in telemetry.verdicts)
        print(f"[telemetry] {stats['telemetry_windows']} windows, "
              f"{stats['telemetry_flagged']} flagged")
    return done, stats


def make_requests(cfg, n, prompt_len, max_new, seed) -> list[Request]:
    """The launcher's request stream: ``n`` prompts of 2..``prompt_len``
    tokens from ``default_rng([seed, 0])``, ``max_new`` new tokens each."""
    rng = np.random.default_rng([seed, 0])
    out = []
    for i in range(n):
        k = int(rng.integers(2, prompt_len + 1))
        out.append(Request(i, rng.integers(0, cfg.vocab, size=k)
                           .astype(np.int32), max_new=max_new))
    return out


def summary(engine, done, wall) -> dict:
    """Requests and tokens served; ``tok_per_s``, all tokens over the whole
    ``engine.run`` wall time; the mean prefill and the decode step p50/p99
    in ms from the engine's series (None where a series is empty)."""
    tok = sum(len(r.out_tokens) for r in done)
    pre, dec = engine.prefill_times, engine.decode_times
    return {"requests": len(done), "tokens": tok, "wall_s": wall,
            "tok_per_s": tok / max(wall, 1e-9),
            "prefill_ms_mean": float(np.mean(pre)) * 1e3 if pre else None,
            "decode_ms_p50": float(np.median(dec)) * 1e3 if dec else None,
            "decode_ms_p99": (float(np.quantile(dec, 0.99)) * 1e3
                              if dec else None)}


if __name__ == "__main__":
    main()
