"""Gemma-2B [dense] — GeGLU, head_dim=256, MQA.

18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=256000. [arXiv:2403.08295; hf]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab_size=256000,
    head_dim=256,
    act="geglu",
    tie_embeddings=True,
    source="arXiv:2403.08295; hf",
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        attn_chunk_q=16,
        attn_chunk_k=32,
        max_seq=128,
    )
