"""DBRX-132B [hf:databricks/dbrx-base]: 16-expert top-4 fine-grained MoE."""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="dbrx-132b", n_layers=40, d_model=6144, n_heads=48,
        n_kv_heads=8, d_ff=10752, vocab=100352, n_experts=16, top_k=4,
        moe_period=1, mlp="swiglu", norm="ln", rope_theta=5e5,
        family="moe")


def smoke() -> ArchConfig:
    return ArchConfig(
        name="dbrx-132b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=96, vocab=256, n_experts=4, top_k=2,
        moe_period=1, mlp="swiglu", norm="ln", family="moe")


register("dbrx-132b", full, smoke)
