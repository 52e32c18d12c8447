"""ModelConfig schema + registry for the assigned architectures (a copy of
the JAX package's ``repro.configs.base``; ``param_count`` counts through the
port's ``models.transformer.count_params``)."""
from __future__ import annotations

import dataclasses
from typing import Callable

_REGISTRY: dict[str, Callable[[], "ModelConfig"]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> "ModelConfig":
    if name not in _REGISTRY:
        # import config modules lazily so the registry is populated
        import repro_torch.configs  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    layer_types: tuple[str, ...] = ()  # len == num_layers; default all "dense"
    activation: str = "swiglu"  # swiglu | geglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    pos_embed: str = "rope"  # rope | absolute
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # --- MLA (deepseek-v2) ---
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4
    # --- xLSTM ---
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    # --- encoder-decoder (whisper) / cross-attn (vlm) ---
    encoder_layers: int = 0
    encoder_seq: int = 1500  # whisper 30s -> 1500 frames (stub frontend)
    vision_seq: int = 0  # image patch embeddings per sample (stub frontend)
    # --- misc ---
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    cache_dtype: str = "bfloat16"  # "float8_e4m3fn" halves decode KV memory
    remat: str = "block"  # none | block — activation checkpoint per block
    attn_chunk_q: int = 1024  # chunked-attention thresholds (prefill memory)
    attn_chunk_kv: int = 1024  # == chunk_q enables causal diagonal-skip
    moe_seq_chunk: int = 4096  # tokens per MoE dispatch chunk
    xent_chunk: int = 512  # seq chunk for vocab-tiled cross-entropy

    # ------------------------------------------------------------------
    @property
    def head_dim_actual(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so TP sharding always divides
        (Megatron-style padding; logits for pad ids are masked to -inf)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def types(self) -> tuple[str, ...]:
        return self.layer_types or ("dense",) * self.num_layers

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic in sequence length? (SSM / recurrent / hybrid.)"""
        quad = {"dense", "moe", "mla_moe", "cross", "encdec_dec"}
        return all(t not in quad for t in self.types) or self.family in (
            "ssm",
            "hybrid",
        )

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline terms)."""
        from repro_torch.models.transformer import count_params
        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.transformer import count_params
        return count_params(self, active_only=True)

    def validate(self) -> None:
        assert len(self.types) == self.num_layers, (
            f"{self.name}: layer_types len {len(self.types)} != {self.num_layers}"
        )
        if self.num_experts:
            assert self.moe_top_k > 0 and self.moe_d_ff > 0
        if "mamba2" in self.types:
            assert self.ssm_state > 0
