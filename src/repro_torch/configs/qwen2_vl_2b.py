"""Qwen2-VL-2B text backbone [arXiv:2409.12191]: M-RoPE, dynamic-resolution
vision frontend is a STUB (input_specs provides patch embeddings)."""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-2b", n_layers=28, d_model=1536, n_heads=12,
        n_kv_heads=2, d_ff=8960, vocab=151936, pos="mrope",
        mlp="swiglu", norm="rms", rope_theta=1e6, tie_embeddings=True,
        frontend="vision_stub", family="vlm")


def smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-2b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256, pos="mrope", mlp="swiglu",
        norm="rms", tie_embeddings=True, frontend="vision_stub",
        family="vlm")


register("qwen2-vl-2b", full, smoke)
