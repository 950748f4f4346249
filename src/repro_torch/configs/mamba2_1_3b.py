"""Mamba2-1.3B [arXiv:2405.21060]: attention-free SSD (state-space duality)."""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="mamba2-1.3b", n_layers=48, d_model=2048, n_heads=0,
        n_kv_heads=0, d_ff=0, vocab=50280, pos="none", mlp="swiglu",
        norm="rms", ssm_state=128, ssm_expand=2, ssm_groups=8,
        ssm_conv=4, ssm_head_dim=64, family="ssm")


def smoke() -> ArchConfig:
    return ArchConfig(
        name="mamba2-1.3b-smoke", n_layers=2, d_model=64, n_heads=0,
        n_kv_heads=0, d_ff=0, vocab=256, pos="none", mlp="swiglu",
        norm="rms", ssm_state=16, ssm_expand=2, ssm_groups=2,
        ssm_conv=4, ssm_head_dim=32, family="ssm")


register("mamba2-1.3b", full, smoke)
