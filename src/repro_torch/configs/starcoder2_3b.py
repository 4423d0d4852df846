"""StarCoder2-3B [dense] — GQA, RoPE.

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152. [arXiv:2402.19173; hf]
StarCoder2-3b uses standard (non-gated) GELU MLP and biases; sliding-window
attention (4096) per the paper.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    act="gelu",
    qkv_bias=True,
    rope_theta=1e5,
    sliding_window=4096,
    source="arXiv:2402.19173; hf",
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        sliding_window=32,
        attn_chunk_q=16,
        attn_chunk_k=32,
        max_seq=128,
    )
