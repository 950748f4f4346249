"""Batched serving runtime: prefill + decode loop over a request batch.

A port of the reference's ``serving/engine.py``: uniform-batch prefill,
greedy decode with the rolling KV / SSM cache, a simple admission queue;
an encoder-decoder's frames are encoded once a batch, at its prefill.
The batching is the reference's, kept as it is: a short batch is padded by
replicating its last request, prompts are left-padded with token 0 and no
pad mask, and every batch runs ``max_new`` decode steps.  The cache is
built in ``EngineConfig.dtype``, f32 by default as in the reference; a
bf16 model (``init_model(dtype=torch.bfloat16)``) is served with
``EngineConfig(dtype=torch.bfloat16)``.  A model whose working type is
not the cache's gives attention mixed q and K/V, which raises: nothing is
cast quietly.

Per-step timings go to **separate** ``prefill_times`` / ``decode_times``
series; an optional
``step_hook(kind, dt)`` fires after each step (``kind`` is ``'prefill'``
or ``'decode'``).  On the card each step ends in
``torch.cuda.synchronize()`` before its clock is read.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models import transformer as T


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # [S] int32
    max_new: int = 16
    out_tokens: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class EngineConfig:
    batch: int = 4
    cache_len: int = 512
    dtype: torch.dtype = torch.float32
    device: object = None       # None → cuda:0


class ServeEngine:
    def __init__(self, cfg, model, ecfg: EngineConfig, step_hook=None):
        self.device = resolve_device(ecfg.device)
        if model.embed.device != self.device:
            raise ValueError(f"model is on {model.embed.device}, the engine "
                             f"on {self.device}")
        self.cfg = cfg
        self.model = model
        self.ecfg = ecfg
        self.queue: list[Request] = []
        self.prefill_times: list[float] = []
        self.decode_times: list[float] = []
        self.step_hook = step_hook             # fn(kind, dt) | None

    def submit(self, req: Request):
        self.queue.append(req)

    def _record(self, kind: str, dt: float) -> None:
        (self.prefill_times if kind == "prefill"
         else self.decode_times).append(dt)
        if self.step_hook is not None:
            self.step_hook(kind, dt)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _next_batch(self) -> list[Request]:
        batch = self.queue[:self.ecfg.batch]
        self.queue = self.queue[self.ecfg.batch:]
        return batch

    def run(self, enc_frames=None) -> list[Request]:
        """Serve everything in the queue; returns completed requests.  An
        encoder-decoder config takes ``enc_frames`` [batch, n_frames, d]
        on the engine's device: each batch's prefill encodes them and its
        decode steps attend over that memory."""
        cfg, model, ecfg = self.cfg, self.model, self.ecfg
        done: list[Request] = []
        while self.queue:
            batch = self._next_batch()
            # pad the batch to engine batch size (replicate last request)
            while len(batch) < ecfg.batch:
                batch.append(Request(-1, batch[-1].prompt, 0))
            s = max(len(r.prompt) for r in batch)
            toks = torch.from_numpy(np.stack(
                [np.pad(r.prompt, (s - len(r.prompt), 0)) for r in batch])
                .astype(np.int32)).to(self.device)
            t0 = time.perf_counter()  # lint: allow-wallclock (measured)
            cache = T.init_cache(cfg, ecfg.batch, ecfg.cache_len,
                                 device=self.device, dtype=ecfg.dtype)
            last, cache, memory = T.prefill(cfg, model, toks, cache,
                                            enc_frames)
            nxt = last[:, -1].argmax(dim=-1)[:, None]
            self._sync()
            self._record("prefill",
                         time.perf_counter() - t0)  # lint: allow-wallclock
            max_new = max(r.max_new for r in batch)
            for k in range(max_new):
                for r, t in zip(batch, nxt[:, 0].tolist()):
                    if r.rid >= 0 and len(r.out_tokens) < r.max_new:
                        r.out_tokens.append(int(t))
                t0 = time.perf_counter()  # lint: allow-wallclock
                logits, cache = T.decode_step(cfg, model, nxt, cache, s + k,
                                              memory)
                nxt = logits[:, -1].argmax(dim=-1)[:, None]
                self._sync()
                self._record("decode",
                             time.perf_counter() - t0)  # lint: allow-wallclock
            done.extend(r for r in batch if r.rid >= 0)
        return done
