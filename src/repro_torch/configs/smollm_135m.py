"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M]: small llama-arch model."""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="smollm-135m", n_layers=30, d_model=576, n_heads=9,
        n_kv_heads=3, d_ff=1536, vocab=49152, mlp="swiglu", norm="rms",
        tie_embeddings=True, family="dense")


def smoke() -> ArchConfig:
    return ArchConfig(
        name="smollm-135m-smoke", n_layers=2, d_model=48, n_heads=3,
        n_kv_heads=1, d_ff=96, vocab=256, mlp="swiglu", norm="rms",
        tie_embeddings=True, family="dense")


register("smollm-135m", full, smoke)
