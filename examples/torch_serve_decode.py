"""Serve a small model on the port with batched requests (prefill + greedy
decode), the twin of ``examples/serve_decode.py``.

The weights are random, drawn from a seeded ``torch.Generator`` on the
device (they differ from the reference's ``jax.random`` draws, so the
tokens differ; ``tests/test_torch_serve.py`` holds the engine to the
reference on shared weights).

    PYTHONPATH=src python examples/torch_serve_decode.py              # cuda:0
    PYTHONPATH=src python examples/torch_serve_decode.py --device cpu
"""

import argparse
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.engine import (EngineConfig, Request,  # noqa: E402
                                        ServeEngine)

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default=None,
                help="torch device (default: cuda:0; 'cpu' runs the "
                     "kernels' plain versions)")
args = ap.parse_args()

dev = resolve_device(args.device)
cfg = get_config("smollm-135m", smoke=True)
model = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                     dtype=torch.float32)
engine = ServeEngine(cfg, model,
                     EngineConfig(batch=4, cache_len=128, device=dev))

rng = np.random.default_rng(0)
t0 = time.perf_counter()
for i in range(10):
    prompt = rng.integers(0, cfg.vocab, size=int(rng.integers(4, 24)))
    engine.submit(Request(i, prompt.astype(np.int32), max_new=12))
done = engine.run()
wall = time.perf_counter() - t0

for r in sorted(done, key=lambda r: r.rid)[:4]:
    print(f"req {r.rid}: prompt[{len(r.prompt)}] -> {r.out_tokens}")
tok = sum(len(r.out_tokens) for r in done)
print(f"\nserved {len(done)} requests, {tok} new tokens in {wall:.1f}s "
      f"({tok / wall:.0f} tok/s, smoke config on {dev})")
print(f"mean decode step: {np.mean(engine.decode_times) * 1e3:.1f} ms "
      f"(mean prefill {np.mean(engine.prefill_times) * 1e3:.1f} ms)")
