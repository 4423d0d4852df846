"""Phi-3-vision-4.2B [vlm] — phi3-mini backbone + CLIP frontend (STUB).

32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.
[hf:microsoft/Phi-3-vision-128k-instruct; hf]

Per the assignment, the modality frontend is a stub: ``input_specs()``
provides precomputed patch embeddings of shape (batch, n_patches, d_model)
which are prepended to the token embeddings.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    act="swiglu",
    frontend="vision",
    n_patches=576,                 # 24x24 CLIP-L/14 @ 336px
    source="hf:microsoft/Phi-3-vision-128k-instruct; hf",
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        n_patches=8,
        attn_chunk_q=16,
        attn_chunk_k=32,
        max_seq=128,
    )
