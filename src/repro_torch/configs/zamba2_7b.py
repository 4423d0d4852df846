"""Zamba2-7B [hybrid] — Mamba2 backbone + shared attention blocks.

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
[arXiv:2411.15242; unverified]

Zamba2 interleaves a *shared* (parameter-tied) attention+MLP block into a
Mamba-2 backbone.  The shared block applies after every ``attn_every``-th
SSM layer; Zamba2's per-application LoRA deltas are omitted, as in the
reference's config.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    attn_every=6,
    act="gelu",
    source="arXiv:2411.15242; unverified",
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        n_layers=5,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_chunk=16,
        attn_every=2,
        attn_chunk_q=16,
        attn_chunk_k=32,
        max_seq=128,
    )
