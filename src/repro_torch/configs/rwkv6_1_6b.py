"""RWKV6-1.6B (Finch) [ssm] — attention-free, data-dependent decay.

24L d_model=2048 d_ff=7168 vocab=65536. [arXiv:2404.05892; unverified]

Time-mix with data-dependent decay (LoRA-produced per-token w), token-shift
interpolation, and squared-ReLU channel-mix.  n_heads below is the number of
WKV heads (d_model / rwkv_head_dim).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,                    # wkv heads = d_model / rwkv_head_dim
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    rwkv=True,
    rwkv_head_dim=64,
    rwkv_lora_decay=64,
    rwkv_lora_mix=32,
    source="arXiv:2404.05892; unverified",
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        rwkv_head_dim=16,
        rwkv_lora_decay=16,
        rwkv_lora_mix=8,
        max_seq=128,
    )
