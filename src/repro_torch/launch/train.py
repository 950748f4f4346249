"""Training launcher: a training loop with checkpoints and pod telemetry,
on the card by default.

A port of the reference's ``launch/train.py`` with every flag it has, plus
``--device``:
  * deterministic resumable data pipeline (``data/pipeline.py``);
  * periodic atomic checkpoints of parameters, optimizer state and data
    state; ``--resume`` restarts from the latest one, onto ``--device``;
  * SLOTH pod telemetry (``--telemetry``): each step's measured wall time
    (``loss.item()`` inside the timed window, so it includes the device
    sync) streams into the pod detector every ``--telemetry-window`` steps
    (:class:`~repro_torch.distributed.telemetry.StepTelemetry`; this
    process is chip 0 of a 4×4 pod); each window's verdict and mitigation
    plan are logged, and an ``exclude_and_restart`` plan triggers an
    immediate checkpoint.  ``--inject-slow-at/--inject-slow-steps/
    --inject-slow-factor`` scale the *reported* timings of a step range
    (training itself is unperturbed); ``--expect-flagged`` exits non-zero
    unless a window was flagged.

Weights are random, drawn from ``--seed`` on the chosen device.  An
encoder-decoder (whisper) trains over zero frame embeddings
``[batch, n_frames, d_model]``, as the reference's launcher does; its
checkpoints carry the encoder's parameters and moments with the rest.
``main(argv)`` returns the losses.

    python -m repro_torch.launch.train --arch smollm-135m --steps 24 \\
        --batch 4 --seq 512 --telemetry
    python -m repro_torch.launch.train --arch smollm-135m --smoke \\
        --steps 24 --batch 2 --seq 32 --telemetry --telemetry-window 8 \\
        --inject-slow-at 10 --inject-slow-steps 6 --expect-flagged \\
        --device cpu
"""

from __future__ import annotations

import argparse
import time

import torch

from ..checkpoint import store
from ..configs.base import get_config
from ..data.pipeline import DataConfig, TokenPipeline
from ..device import resolve_device
from ..distributed.telemetry import PodTelemetryConfig, StepTelemetry
from ..models import transformer as T
from ..optim import adamw
from . import steps as steps_mod


def checkpoint_tree(model, opt_state) -> dict:
    """Parameters and optimizer state as one ``{name: tensor}`` tree, in
    the model's parameter order."""
    names = [n for n, _ in model.named_parameters()]
    tree = {f"params/{n}": p for n, p in model.named_parameters()}
    for key in ("m", "v"):
        tree.update({f"opt/{key}/{n}": t
                     for n, t in zip(names, opt_state[key])})
    tree["opt/step"] = torch.tensor(opt_state["step"])
    return tree


def load_checkpoint_tree(model, opt_state, tree) -> dict:
    """Copy a restored tree into the model's parameters and the optimizer
    state (in place); returns the state."""
    names = [n for n, _ in model.named_parameters()]
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(tree[f"params/{n}"])
        for key in ("m", "v"):
            for n, t in zip(names, opt_state[key]):
                t.copy_(tree[f"opt/{key}/{n}"])
    return {**opt_state, "step": int(tree["opt/step"])}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--telemetry", action="store_true",
                    help="run the SLOTH pod detector on step timings")
    ap.add_argument("--telemetry-window", type=int, default=8,
                    help="steps per streaming-detector window")
    ap.add_argument("--inject-slow-at", type=int, default=None,
                    metavar="STEP", help="scale the telemetry-reported "
                    "timing of this step onward (detection demo; training "
                    "itself is unperturbed)")
    ap.add_argument("--inject-slow-steps", type=int, default=8,
                    help="number of steps the injected slowdown lasts")
    ap.add_argument("--inject-slow-factor", type=float, default=10.0,
                    help="reported-timing multiplier for injected steps")
    ap.add_argument("--expect-flagged", action="store_true",
                    help="exit nonzero unless telemetry flagged a slow "
                    "window (CI smoke assertion)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda:0; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    dev = resolve_device(args.device)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=10,
                                total_steps=args.steps)
    model = T.init_model(cfg, torch.Generator(device=dev)
                         .manual_seed(args.seed), dtype=torch.float32)
    opt_state = adamw.init_state(list(model.parameters()), opt_cfg)

    data_cfg = DataConfig(vocab=cfg.vocab, batch=args.batch, seq=args.seq,
                          seed=args.seed)
    pipe = TokenPipeline(data_cfg)

    start_step = 0
    if args.resume and args.ckpt_dir:
        latest = store.latest_step(args.ckpt_dir)
        if latest is not None:
            tree, extra = store.restore(
                args.ckpt_dir, latest, checkpoint_tree(model, opt_state),
                device=dev)
            opt_state = load_checkpoint_tree(model, opt_state, tree)
            pipe = TokenPipeline.restore(data_cfg, extra["data"])
            start_step = latest
            print(f"[resume] step {latest}")

    plan = steps_mod.CellPlan(grad_accum=1, remat=False,
                              param_dtype=torch.float32)
    train_step = steps_mod.make_train_step(cfg, plan, opt_cfg)

    telemetry = None
    if args.telemetry:
        tele_cfg = PodTelemetryConfig(mesh_w=4, mesh_h=4,
                                      window_steps=args.telemetry_window)
        telemetry = StepTelemetry(tele_cfg, n_shards=4, warmup=1,
                                  seed=args.seed, host=0, device=dev)

    def save(step, loss):
        return store.save(args.ckpt_dir, step,
                          checkpoint_tree(model, opt_state),
                          extra={"data": pipe.state(), "loss": loss})

    def window_first(step):
        """First step of the telemetry window that ends at ``step``
        (windows are counted from the end of the warm-up)."""
        return step - (step - start_step - telemetry.warmup) \
            % telemetry.cfg.window_steps

    def report(first, last, verdict):
        """Print a window's verdict and plan; returns the plan."""
        tplan = telemetry.plans[-1]
        where = f"[telemetry] steps {first}-{last}"
        if not verdict.flagged:
            print(f"{where}: healthy window")
            return tplan
        print(f"{where}: FLAGGED {verdict.kind} {verdict.location} "
              f"severity {verdict.severity:.1f} -> {tplan['action']}")
        if tplan.get("exclude_cores") or tplan.get("avoid_links"):
            # registry-backed plan (remap/reroute on the pod mesh): the
            # resource edits the restart applies
            print(f"[telemetry] {tplan['policy']} plan: exclude cores "
                  f"{list(tplan.get('exclude_cores', ()))}, avoid links "
                  f"{list(tplan.get('avoid_links', ()))}")
        return tplan

    enc_frames = None
    if cfg.enc_dec:
        # the reference's stand-in for the audio frontend: zero frames
        enc_frames = torch.zeros(args.batch, cfg.n_frames, cfg.d_model,
                                 device=dev)

    losses = []
    t_begin = time.perf_counter()  # lint: allow-wallclock (telemetry)
    for step in range(start_step, args.steps):
        tokens = torch.from_numpy(next(pipe)).to(dev)
        t0 = time.perf_counter()  # lint: allow-wallclock (measured dt)
        opt_state, loss, gnorm = train_step(model, opt_state, tokens,
                                            enc_frames)
        loss = loss.item()            # waits for the step on the device
        losses.append(loss)
        dt = time.perf_counter() - t0  # lint: allow-wallclock
        if telemetry is not None:
            reported = dt
            if args.inject_slow_at is not None and \
                    args.inject_slow_at <= step \
                    < args.inject_slow_at + args.inject_slow_steps:
                reported *= args.inject_slow_factor
            verdict = telemetry.record_step(reported)
            if verdict is not None and report(
                    window_first(step), step, verdict)["action"] \
                    == "exclude_and_restart" and args.ckpt_dir:
                path = save(step + 1, loss)
                print(f"[telemetry] mitigation checkpoint {path}")
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} gnorm {float(gnorm):.3f}"
                  f" {dt*1e3:.3f} ms")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            print(f"[ckpt] {save(step + 1, loss)}")
    wall = time.perf_counter() - t_begin  # lint: allow-wallclock
    if telemetry is not None:
        # analyse any trailing partial window
        verdict = telemetry.flush()
        if verdict is not None:
            last = args.steps - 1
            report(window_first(last), last, verdict)
        n_flagged = sum(v.flagged for v in telemetry.verdicts)
        print(f"[telemetry] {len(telemetry.verdicts)} windows, "
              f"{n_flagged} flagged")
        if args.expect_flagged and not telemetry.flagged:
            raise SystemExit(
                "telemetry smoke FAILED: no window flagged the injected "
                "slowdown")
    if losses:
        print(f"done: {args.steps - start_step} steps in {wall:.1f}s; "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    else:
        print(f"nothing to do (resumed at {start_step} ≥ {args.steps})")
    return losses


if __name__ == "__main__":
    main()
