"""Deterministic, shardable, checkpointable synthetic-token data pipeline.

A copy of the reference's ``data/pipeline.py``, numpy on the host: batch
``i`` is a pure function of ``(seed, i)`` through a splitmix64 integer
hash, so any host can materialise any step, a checkpoint stores only
``step``, and the batches are bit-identical to the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + _GOLDEN).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


@dataclasses.dataclass
class DataConfig:
    vocab: int
    batch: int          # global batch
    seq: int
    seed: int = 0


class TokenPipeline:
    """Iterator with explicit state=(step,) and host-shard slicing."""

    def __init__(self, cfg: DataConfig, shard: int = 0, n_shards: int = 1,
                 step: int = 0):
        if cfg.batch % n_shards:
            raise ValueError(f"batch {cfg.batch} does not split into "
                             f"{n_shards} shards")
        self.cfg = cfg
        self.shard = shard
        self.n_shards = n_shards
        self.step = step

    def batch_at(self, step: int) -> np.ndarray:
        """Global batch for ``step`` (any host can compute any shard)."""
        c = self.cfg
        base = (np.uint64(c.seed) << np.uint64(32)) + np.uint64(step)
        idx = np.arange(c.batch * c.seq, dtype=np.uint64) \
            + base * np.uint64(c.batch * c.seq)
        toks = _splitmix64(idx) % np.uint64(c.vocab)
        return toks.astype(np.int32).reshape(c.batch, c.seq)

    def shard_at(self, step: int) -> np.ndarray:
        b = self.cfg.batch // self.n_shards
        return self.batch_at(step)[self.shard * b:(self.shard + 1) * b]

    def __next__(self) -> np.ndarray:
        out = self.shard_at(self.step)
        self.step += 1
        return out

    # -- checkpointable state ------------------------------------------------
    def state(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    @classmethod
    def restore(cls, cfg: DataConfig, state: dict, shard=0, n_shards=1):
        if state["seed"] != cfg.seed:
            raise ValueError(f"data stream seed changed: checkpoint "
                             f"{state['seed']}, config {cfg.seed}")
        return cls(cfg, shard, n_shards, step=state["step"])
