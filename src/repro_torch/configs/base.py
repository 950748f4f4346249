"""Architecture configuration for the LM-family models of the substrate.

Every architecture is an ``ArchConfig``; the model stack in
``repro_torch.models`` builds (init, prefill, decode) from it.  Each arch
module also defines a reduced ``smoke()`` config of the same family for CPU
tests.  These are the reference package's dataclasses, copied: the port
never imports them.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 → d_model // n_heads

    # block structure
    mlp: str = "swiglu"               # 'swiglu' | 'gelu'
    norm: str = "rms"                 # 'rms' | 'ln'
    pos: str = "rope"                 # 'rope' | 'mrope' | 'learned' | 'none'
    window: int | None = None         # sliding-window attention size
    rope_theta: float = 1e4

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_period: int = 1               # MoE every k-th layer
    capacity_factor: float = 1.25

    # SSM / hybrid
    attn_period: int = 0              # 0 → all attention; k → 1 attn per k
    attn_offset: int = 0              # which layer in the period is attention
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_head_dim: int = 64

    # encoder-decoder
    enc_dec: bool = False
    n_enc_layers: int = 0
    frontend: str = "none"            # 'none' | 'audio_stub' | 'vision_stub'
    n_frames: int = 1500              # frontend stub sequence length

    tie_embeddings: bool = False
    family: str = "dense"             # dense | moe | ssm | hybrid | vlm | audio

    # -- derived -----------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def layer_kind(self, li: int) -> str:
        if self.ssm_state == 0:
            return "attn"
        if self.attn_period == 0:
            return "mamba"
        return ("attn" if li % self.attn_period == self.attn_offset
                else "mamba")

    def is_moe_layer(self, li: int) -> bool:
        return self.n_experts > 0 and li % self.moe_period == \
            (self.moe_period - 1)

    @property
    def n_attn_layers(self) -> int:
        return sum(self.layer_kind(i) == "attn" for i in range(self.n_layers))

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k decode (window/state-bounded attention)."""
        return self.ssm_state > 0 or self.window is not None

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        total = v * d  # embed
        if not self.tie_embeddings:
            total += v * d
        if self.enc_dec:
            total += self.n_frames * d   # learned positions (stub frontend)
        for li in range(self.n_layers):
            total += 2 * d  # norms
            if self.layer_kind(li) == "attn":
                hq = self.n_heads * self.head_dim
                hk = self.n_kv_heads * self.head_dim
                total += d * (hq + 2 * hk) + hq * d
                if self.enc_dec:   # cross attention
                    total += d * (hq + 2 * hk) + hq * d + d
            else:
                di, n = self.d_inner, self.ssm_state
                total += d * (2 * di + 2 * self.ssm_groups * n
                              + self.ssm_heads)
                total += self.ssm_conv * (di + 2 * self.ssm_groups * n)
                total += di * d + 2 * self.ssm_heads
            if self.is_moe_layer(li):
                total += d * self.n_experts  # router
                total += self.n_experts * 3 * d * ff
            else:
                n_mats = 3 if self.mlp == "swiglu" else 2
                total += n_mats * d * ff
        if self.enc_dec:
            for _ in range(self.n_enc_layers):
                hq = self.n_heads * self.head_dim
                hk = self.n_kv_heads * self.head_dim
                total += 2 * d + d * (hq + 2 * hk) + hq * d + 2 * d * ff
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k experts only)."""
        if self.n_experts == 0:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        inactive = 0
        for li in range(self.n_layers):
            if self.is_moe_layer(li):
                inactive += (self.n_experts - self.top_k) * 3 * d * ff
        return self.param_count() - inactive


_REGISTRY: dict[str, "tuple"] = {}


def register(arch_id: str, full, smoke):
    _REGISTRY[arch_id] = (full, smoke)


def get_config(arch_id: str, smoke: bool = False) -> ArchConfig:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_REGISTRY)}")
    full, sm = _REGISTRY[arch_id]
    return sm() if smoke else full()


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    if _REGISTRY:
        return
    from . import (dbrx_132b, h2o_danube3_4b, jamba_1_5_large,   # noqa: F401
                   mamba2_1_3b, mixtral_8x7b, qwen2_vl_2b, smollm_135m,
                   stablelm_1_6b, whisper_large_v3, yi_34b)
