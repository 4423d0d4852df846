"""SeamlessM4T-large-v2 [audio] — encoder-decoder, multimodal.

24L (enc) + 24L (dec) d_model=1024 16H d_ff=8192 vocab=256206.
[arXiv:2308.11596; hf]

Per the assignment, only the transformer BACKBONE is modeled; the speech
frontend is a STUB — ``input_specs()`` provides precomputed frame embeddings
of shape (batch, n_frames, d_model) consumed by the encoder.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,                   # decoder layers
    enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    act="gelu",
    frontend="audio",
    n_frames=1024,
    source="arXiv:2308.11596; hf",
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        n_layers=2,
        enc_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        n_frames=16,
        attn_chunk_q=16,
        attn_chunk_k=32,
        max_seq=128,
    )
