"""H2O-Danube3-4B [arXiv:2401.16818 lineage]: llama+mistral mix with
sliding-window attention."""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="h2o-danube-3-4b", n_layers=24, d_model=3840, n_heads=32,
        n_kv_heads=8, d_ff=10240, vocab=32000, window=4096,
        mlp="swiglu", norm="rms", rope_theta=1e4, family="dense")


def smoke() -> ArchConfig:
    return ArchConfig(
        name="h2o-danube-3-4b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256, window=16, mlp="swiglu",
        norm="rms", family="dense")


register("h2o-danube-3-4b", full, smoke)
