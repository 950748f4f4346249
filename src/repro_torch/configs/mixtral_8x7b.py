"""Mixtral-8x7B [arXiv:2401.04088]: 8-expert top-2 MoE with sliding-window
attention."""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x7b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, d_ff=14336, vocab=32000, window=4096,
        n_experts=8, top_k=2, moe_period=1, mlp="swiglu", norm="rms",
        rope_theta=1e6, family="moe")


def smoke() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x7b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256, window=16, n_experts=4,
        top_k=2, moe_period=1, mlp="swiglu", norm="rms", family="moe")


register("mixtral-8x7b", full, smoke)
