"""Model and shape configurations for the PyTorch port.

A copy of ``repro.configs.base`` (the port imports nothing of ``repro``):
the same :class:`ModelConfig` fields, so a config built here describes
exactly the model the JAX package builds from the same values.  Only the
architectures whose code path the port already serves are registered;
asking for another raises ``KeyError`` naming the ROADMAP item that ports
its family.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Any


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0              # 0 -> d_model // n_heads
    act: str = "swiglu"            # swiglu | geglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- Mixture of Experts -------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    n_dense_layers: int = 0
    capacity_factor: float = 1.25

    # --- Multi-head Latent Attention ----------------------------------------
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mtp_depth: int = 0

    # --- SSM (Mamba-2 / SSD) -------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- Hybrid: shared attention block every N ssm layers -------------------
    attn_every: int = 0

    # --- RWKV-6 ---------------------------------------------------------------
    rwkv: bool = False
    rwkv_head_dim: int = 64
    rwkv_lora_decay: int = 64
    rwkv_lora_mix: int = 32

    # --- Encoder-decoder ------------------------------------------------------
    enc_layers: int = 0

    # --- Modality frontend stubs ---------------------------------------------
    frontend: str = "none"
    n_patches: int = 0
    n_frames: int = 0

    # --- Attention execution knobs -------------------------------------------
    attn_chunk_q: int = 512
    attn_chunk_k: int = 1024
    sliding_window: int = 0        # 0 => full attention
    max_seq: int = 540_672

    # --- Misc ------------------------------------------------------------------
    dtype: str = "bfloat16"
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """True if long-context (500k) decode is supported (SSM/hybrid)."""
        return self.family in ("ssm", "hybrid")

    @property
    def n_moe_layers(self) -> int:
        if self.n_experts == 0:
            return 0
        return self.n_layers - self.n_dense_layers

    def with_(self, **kw: Any) -> "ModelConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


# Input shapes (assigned, shared by all 10 LM-family architectures), as the
# reference's ``SHAPES``.
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch x shape) cell is runnable, and why not if skipped:
    ``long_500k`` needs sub-quadratic attention (the reference's rule and
    reason, word for word)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, (
            f"{cfg.name} is full-attention (family={cfg.family}); 500k-token "
            "decode requires sub-quadratic attention (see DESIGN.md)"
        )
    return True, ""


# Architectures the port serves, and where the others are queued.
ARCHS = ("gemma-2b", "starcoder2-3b", "gpt2-1.5b", "llama2-7b", "zamba2-7b",
         "rwkv6-1.6b", "moonshot-v1-16b-a3b", "deepseek-v3-671b", "seamless-m4t-large-v2",
         "phi-3-vision-4.2b")

NOT_YET_PORTED = {
    "phi3-medium-14b": "ROADMAP A8 (more dense configs)",
    "qwen2-72b": "ROADMAP A8 (more dense configs; needs A14 to shard it)",
}

_MODULE_FOR = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def _module(name: str):
    if name in NOT_YET_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet: {NOT_YET_PORTED[name]}")
    if name not in _MODULE_FOR:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULE_FOR)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[name]}")


def get(name: str) -> ModelConfig:
    """Full ModelConfig for an architecture id."""
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    """Tiny same-family config for CPU tests."""
    return _module(name).reduced()
