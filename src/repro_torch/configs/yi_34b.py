"""Yi-34B [arXiv:2403.04652]: llama-architecture GQA dense model."""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="yi-34b", n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=20480, vocab=64000, mlp="swiglu", norm="rms",
        rope_theta=5e6, family="dense")


def smoke() -> ArchConfig:
    return ArchConfig(
        name="yi-34b-smoke", n_layers=3, d_model=64, n_heads=8,
        n_kv_heads=2, d_ff=192, vocab=256, mlp="swiglu", norm="rms",
        family="dense")


register("yi-34b", full, smoke)
