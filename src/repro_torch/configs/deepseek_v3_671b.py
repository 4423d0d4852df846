"""DeepSeek-V3-671B [moe] — MLA, 1 shared + 256 routed top-8, MTP.

61L d_model=7168 128H d_ff=2048 (per-expert) vocab=129280.
[arXiv:2412.19437; hf]

MLA (multi-head latent attention): queries via a rank-1536 LoRA, KV via a
rank-512 compression; per-head dims: 128 nope + 64 rope for Q/K, 128 for V.
First 3 layers are dense (d_ff=18432); layers 3..60 are MoE with 256 routed
experts (top-8) + 1 shared expert (moe_d_ff=2048 each).  One MTP
(multi-token-prediction) depth per the paper.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,
    vocab_size=129280,
    act="swiglu",
    n_experts=256,
    top_k=8,
    n_shared_experts=1,
    moe_d_ff=2048,
    n_dense_layers=3,
    mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    mtp_depth=1,
    source="arXiv:2412.19437; hf",
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
        q_lora_rank=32,
        kv_lora_rank=16,
        qk_nope_dim=16,
        qk_rope_dim=8,
        v_head_dim=16,
        mtp_depth=1,
        attn_chunk_q=16,
        attn_chunk_k=32,
        max_seq=128,
    )
