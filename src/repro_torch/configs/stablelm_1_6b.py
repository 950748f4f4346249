"""StableLM-2-1.6B [hf:stabilityai/stablelm-2-1_6b]: MHA (kv=heads),
LayerNorm."""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="stablelm-1.6b", n_layers=24, d_model=2048, n_heads=32,
        n_kv_heads=32, d_ff=5632, vocab=100352, mlp="swiglu", norm="ln",
        family="dense")


def smoke() -> ArchConfig:
    return ArchConfig(
        name="stablelm-1.6b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=160, vocab=256, mlp="swiglu", norm="ln",
        family="dense")


register("stablelm-1.6b", full, smoke)
