"""Whisper-large-v3 [arXiv:2212.04356]: encoder-decoder, conv/mel frontend is
a STUB (input_specs provides precomputed frame embeddings, 1500 frames)."""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="whisper-large-v3", n_layers=32, d_model=1280, n_heads=20,
        n_kv_heads=20, d_ff=5120, vocab=51866, pos="learned", mlp="gelu",
        norm="ln", enc_dec=True, n_enc_layers=32, frontend="audio_stub",
        n_frames=1500, family="audio")


def smoke() -> ArchConfig:
    return ArchConfig(
        name="whisper-large-v3-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=256, pos="learned", mlp="gelu",
        norm="ln", enc_dec=True, n_enc_layers=2, frontend="audio_stub",
        n_frames=32, family="audio")


register("whisper-large-v3", full, smoke)
