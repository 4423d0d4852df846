"""GPT-2 1.5B — one of the paper's own evaluation models (Rubick Table 2).

48L d_model=1600 25H d_ff=6400 vocab=50257. [Radford et al. 2019]
Used by the Rubick benchmarks (perf-model validation, sensitivity curves).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gpt2-1.5b",
    family="dense",
    n_layers=48,
    d_model=1600,
    n_heads=25,
    n_kv_heads=25,
    d_ff=6400,
    vocab_size=50257,
    act="gelu",
    qkv_bias=True,
    tie_embeddings=True,
    source="Radford et al. 2019 (paper Table 2)",
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        attn_chunk_q=16,
        attn_chunk_k=32,
        max_seq=128,
    )
