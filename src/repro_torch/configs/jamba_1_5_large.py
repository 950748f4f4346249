"""Jamba-1.5-Large (398B) [arXiv:2403.19887]: Mamba+attention 1:7 interleave
with 16-expert top-2 MoE every other layer.  Attention layers carry no
positional encoding (the Mamba layers provide position)."""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="jamba-1.5-large-398b", n_layers=72, d_model=8192, n_heads=64,
        n_kv_heads=8, d_ff=24576, vocab=65536, pos="none",
        n_experts=16, top_k=2, moe_period=2, mlp="swiglu", norm="rms",
        attn_period=8, attn_offset=4, ssm_state=128, ssm_expand=2,
        ssm_groups=8, ssm_conv=4, ssm_head_dim=64, family="hybrid")


def smoke() -> ArchConfig:
    return ArchConfig(
        name="jamba-1.5-large-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256, pos="none", n_experts=4,
        top_k=2, moe_period=2, mlp="swiglu", norm="rms", attn_period=4,
        attn_offset=2, ssm_state=16, ssm_expand=2, ssm_groups=2,
        ssm_conv=4, ssm_head_dim=32, family="hybrid")


register("jamba-1.5-large-398b", full, smoke)
