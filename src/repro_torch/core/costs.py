"""Analytic parameter / FLOP accounting for every supported family: a copy
of ``repro.core.costs`` over the port's ``configs.base.ModelConfig`` (which
keeps the reference's MoE, MLA and encoder-decoder fields, so every branch
reads the same values).

Used by: the roofline report (MODEL_FLOPS and useful-compute ratio), the
Rubick performance model (P in Table 1), and the memory estimator
(AllocMem / minRes feasibility in Algorithm 1).
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _ffn_params(cfg: ModelConfig, d_ff: int) -> int:
    mult = 3 if cfg.act in ("swiglu", "geglu") else 2
    return mult * cfg.d_model * d_ff


def _attn_params(cfg: ModelConfig) -> int:
    hd = cfg.resolved_head_dim
    if cfg.mla:
        H, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        return (cfg.d_model * cfg.q_lora_rank
                + cfg.q_lora_rank * H * (dn + dr)
                + cfg.d_model * (cfg.kv_lora_rank + dr)
                + cfg.kv_lora_rank * H * (dn + dv)
                + H * dv * cfg.d_model)
    return cfg.d_model * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)


def _moe_layer_params(cfg: ModelConfig, active: bool) -> int:
    e = (cfg.top_k + cfg.n_shared_experts) if active else \
        (cfg.n_experts + cfg.n_shared_experts)
    return (cfg.d_model * cfg.n_experts            # router (always dense)
            + e * _ffn_params(cfg, cfg.moe_d_ff))


def _mamba_layer_params(cfg: ModelConfig) -> int:
    di = cfg.ssm_expand * cfg.d_model
    N = cfg.ssm_state
    H = di // cfg.ssm_head_dim
    return (cfg.d_model * (2 * di + 2 * N + H)     # in_proj
            + cfg.ssm_conv * (di + 2 * N)          # conv
            + di * cfg.d_model)                    # out_proj


def _rwkv_layer_params(cfg: ModelConfig) -> int:
    D, F = cfg.d_model, cfg.d_ff
    lora = D * 5 * cfg.rwkv_lora_mix + 5 * cfg.rwkv_lora_mix * D \
        + D * cfg.rwkv_lora_decay + cfg.rwkv_lora_decay * D
    return 5 * D * D + lora + (D * F + F * D + D * D)


def _backbone_params(cfg: ModelConfig, active: bool) -> int:
    """Per-model non-embedding params (active=True collapses MoE to top-k)."""
    if cfg.family == "ssm" and cfg.rwkv:
        return cfg.n_layers * _rwkv_layer_params(cfg)
    if cfg.family == "hybrid":
        shared = _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff)
        return cfg.n_layers * _mamba_layer_params(cfg) + shared
    if cfg.is_encdec:
        enc = cfg.enc_layers * (_attn_params(cfg) + _ffn_params(cfg, cfg.d_ff))
        dec = cfg.n_layers * (2 * _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff))
        return enc + dec
    dense_l = cfg.n_dense_layers if cfg.n_experts else cfg.n_layers
    total = dense_l * (_attn_params(cfg) + _ffn_params(cfg, cfg.d_ff))
    if cfg.n_experts:
        total += cfg.n_moe_layers * (_attn_params(cfg)
                                     + _moe_layer_params(cfg, active))
    if cfg.mtp_depth:
        total += _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff) \
            + 2 * cfg.d_model * cfg.d_model
    return total


def param_count(cfg: ModelConfig) -> int:
    emb = cfg.vocab_size * cfg.d_model
    head = 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model
    return emb + head + _backbone_params(cfg, active=False)


def active_param_count(cfg: ModelConfig) -> int:
    emb = cfg.vocab_size * cfg.d_model
    head = 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model
    return emb + head + _backbone_params(cfg, active=True)


def flops_param_count(cfg: ModelConfig) -> int:
    """Params touched by matmuls per token (incl. repeated shared blocks and
    the LM head; excluding the embedding gather)."""
    base = _backbone_params(cfg, active=True)
    if cfg.family == "hybrid":
        napp = cfg.n_layers // cfg.attn_every
        shared = _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff)
        base += (napp - 1) * shared                 # counted once already
    return base + cfg.vocab_size * cfg.d_model      # lm head matmul


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Assignment §Roofline MODEL_FLOPS: 6·N·D for training (N = active
    matmul params, D = tokens); 2·N·B for single-token decode."""
    n = flops_param_count(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch             # decode: one token


def attention_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Quadratic-attention matmul FLOPs (not in 6·N·D) — reported alongside
    the useful-compute ratio so remat/masking waste can be separated."""
    if cfg.attention_free:
        return 0.0
    S, B = shape.seq_len, shape.global_batch
    hd = cfg.resolved_head_dim
    if cfg.mla:
        hd = cfg.qk_nope_dim + cfg.qk_rope_dim
    n_attn = cfg.n_layers if cfg.family != "hybrid" else \
        cfg.n_layers // cfg.attn_every
    if cfg.is_encdec:
        n_attn = cfg.enc_layers + 2 * cfg.n_layers
    window = cfg.sliding_window or S
    eff = min(S, window)
    per_pass = 2 * 2 * B * S * eff * cfg.n_heads * hd / 2   # qk + pv, causal/2
    mult = {"train": 3.0, "prefill": 1.0, "decode": 0.0}[shape.kind]
    if shape.kind == "decode":
        return 2 * 2 * B * eff * cfg.n_heads * hd * n_attn
    return per_pass * n_attn * mult
