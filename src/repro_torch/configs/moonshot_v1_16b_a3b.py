"""Moonshot/Moonlight-16B-A3B [moe] — 64 experts, top-6, 2 shared experts.

48L d_model=2048 16H (GQA kv=16) d_ff=1408 (per-expert) vocab=163840.
[hf:moonshotai/Moonlight-16B-A3B; hf]

The ``d_ff=1408`` in the assignment is the per-expert (MoE) FFN width; the
single leading dense layer uses the model's dense FFN width (11264, from the
HF config).  Layer 0 is dense, layers 1..47 are MoE.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=11264,
    vocab_size=163840,
    act="swiglu",
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    n_dense_layers=1,
    rope_theta=5e4,
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        n_experts=8,
        top_k=2,
        n_shared_experts=1,
        moe_d_ff=32,
        n_dense_layers=1,
        attn_chunk_q=16,
        attn_chunk_k=32,
        max_seq=128,
    )
