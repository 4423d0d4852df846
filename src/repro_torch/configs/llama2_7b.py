"""LLaMA-2-7B — one of the paper's own evaluation models (Rubick Table 2,
Fig 7 reconfiguration micro-benchmark).

32L d_model=4096 32H d_ff=11008 vocab=32000. [arXiv:2307.09288]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama2-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=32000,
    act="swiglu",
    source="arXiv:2307.09288 (paper Table 2 / Fig 7)",
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
