"""Decoder-only transformer LM: the torch twin of ``repro.models.transformer``
for training (forward + loss) and serving (prefill + decode), for the dense
branch and the MoE / MLA branches of the reference.

Parameters live in ``nn.Module``s with the reference's names and (in, out)
layouts; where the reference stacks layers on a leading axis and scans,
the port keeps an ``nn.ModuleList`` and loops (``repro_torch.convert``
unstacks).  A dense model has one group, ``layers``.  A MoE model
(``cfg.n_experts``) has ``dense_layers`` (its first ``n_dense_layers``,
with the dense FFN) and ``moe_layers`` (with :class:`~repro_torch.models.moe.MoE`
in place of the FFN), walked in that order; under ``cfg.mla`` every block's
attention is :class:`~repro_torch.models.mla.MLA`.  The multi-token
prediction block ``mtp`` (``cfg.mtp_depth``) adds its loss in training and
is, as in the reference, unused when serving.  A MoE model's loss adds the
Switch load-balancing loss of its MoE layers.  A vision model
(``cfg.frontend == "vision"``, phi-3-vision-4.2b) has ``patch_proj``: its
prompt is the projected patch embeddings (the frontend is a stub, as in the
reference) followed by the token embeddings (:func:`embed_inputs`), in
training as in serving; its loss is taken over the text positions only.

The KV cache is ``{"pos": int, <group>: {"k": (L,B,S,Hkv,hd), "v": ...}}``
for each layer group (under MLA ``{"c": (L,B,S,kv_lora_rank), "pe":
(L,B,S,qk_rope_dim)}``: only the latents), allocated once by
:func:`decoder_init_cache` and written IN PLACE by prefill and decode (the
reference donates the cache buffer to its jitted step and gets a new one
back; here the same buffer is updated and returned).  Sliding-window models
keep a ring buffer of at most ``window`` slots.

Training runs through the modules (``Decoder.forward`` is the loss, each
``Block.forward`` a layer), so that hooks on them (FSDP2's, under ZeRO-3)
run.  Under tensor parallelism (``Decoder.tp``, set by
``repro_torch.parallel.layout``) each rank holds its heads' columns of
``wq``/``wk``/``wv``, its rows of ``wo``, its columns of both halves of
``wi`` and its rows of the FFN's ``wo``, and its vocabulary slice of
``emb``/``head``; the layer functions take the local head count from the
weights and the f/g all-reduces from ``models.nn``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn as tnn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import nn
from repro_torch.models.attention import attention, decode_attention
from repro_torch.models.mla import MLA, mla_attention, mla_decode, mla_prefill
from repro_torch.models.moe import MoE, moe_apply, remat_contexts


@dataclass(frozen=True)
class ModelOpts:
    """Runtime knobs (not architecture): those of the reference's that act
    in the port.  ``remat`` is "none" or "full" (each block's activations
    are recomputed in the backward, by ``torch.utils.checkpoint``);
    ``loss_chunk`` is the sequence chunk of the cross-entropy (0: one piece);
    ``moe_token_chunk`` is the MoE dispatch chunk in tokens; ``mtp`` turns
    the multi-token-prediction loss on, weighted by ``mtp_loss_weight``;
    ``aux_loss_weight`` weights the MoE load-balancing loss.  The
    reference's ``attn_schedule`` has no twin: the attention kernels visit
    only the tiles of the causal/window band, which is what its "triangle"
    schedule buys."""
    remat: str = "none"              # none | full
    loss_chunk: int = 2048
    moe_token_chunk: int = 65536
    mtp: bool = True
    aux_loss_weight: float = 0.01
    mtp_loss_weight: float = 0.3


class Attention(tnn.Module):
    """GQA projections: wq (D, Hq*hd), wk/wv (D, Hkv*hd), wo (Hq*hd, D),
    and bq/bk/bv when ``cfg.qkv_bias``."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        D, hd = cfg.d_model, cfg.resolved_head_dim
        Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
        kw = dict(device=device, dtype=dtype)
        self.wq = nn.param(D, Hq * hd, **kw)
        self.wk = nn.param(D, Hkv * hd, **kw)
        self.wv = nn.param(D, Hkv * hd, **kw)
        self.wo = nn.param(Hq * hd, D, **kw)
        if cfg.qkv_bias:
            self.bq = nn.param(Hq * hd, **kw)
            self.bk = nn.param(Hkv * hd, **kw)
            self.bv = nn.param(Hkv * hd, **kw)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            nn.dense_init_(w, gen)
        for name in ("bq", "bk", "bv"):
            if hasattr(self, name):
                getattr(self, name).zero_()


class FFN(tnn.Module):
    """wi (D, d_ff or 2 d_ff when gated), wo (d_ff, D); ``d_ff`` defaults to
    the config's (the MoE's shared experts pass their own)."""

    def __init__(self, cfg: ModelConfig, device, dtype, d_ff: int | None = None):
        super().__init__()
        d_ff = d_ff or cfg.d_ff
        in_w = 2 * d_ff if cfg.act in ("swiglu", "geglu") else d_ff
        self.wi = nn.param(cfg.d_model, in_w, device=device, dtype=dtype)
        self.wo = nn.param(d_ff, cfg.d_model, device=device, dtype=dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.dense_init_(self.wi, gen)
        nn.dense_init_(self.wo, gen)


class Block(tnn.Module):
    """Pre-norm residual block: x + attn(rmsnorm(x)), then x + mlp(rmsnorm(x))
    (``moe`` in place of ``mlp`` when ``kind == "moe"``; ``attn`` is MLA
    under ``cfg.mla``)."""

    def __init__(self, cfg: ModelConfig, device, dtype, kind: str = "dense"):
        super().__init__()
        self.ln1 = nn.param(cfg.d_model, device=device, dtype=dtype)
        self.ln2 = nn.param(cfg.d_model, device=device, dtype=dtype)
        self.attn = (MLA if cfg.mla else Attention)(cfg, device, dtype)
        if kind == "moe":
            self.moe = MoE(cfg, device, dtype)
        else:
            self.mlp = FFN(cfg, device, dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.ln1.zero_()
        self.ln2.zero_()
        self.attn.reset_parameters(gen)
        (self.moe if hasattr(self, "moe") else self.mlp).reset_parameters(gen)

    def forward(self, x, cfg: ModelConfig, positions, opts: ModelOpts,
                tp: nn.TP | None = None):
        """(x, aux) of the block over a full sequence; under ``remat="full"``
        its activations are recomputed in the backward, a MoE block's under
        the picks of its forward (``moe.remat_contexts``)."""
        if opts.remat == "full":
            return checkpoint(block_apply, self, x, cfg, positions, opts, tp,
                              use_reentrant=False, context_fn=remat_contexts)
        return block_apply(self, x, cfg, positions, opts, tp)


class MTP(tnn.Module):
    """The multi-token-prediction block: proj (2D, D), ln_h, ln_e (D,) and
    one dense block.  Training adds its loss (:func:`decoder_loss`);
    serving does not run it."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        D = cfg.d_model
        self.proj = nn.param(2 * D, D, device=device, dtype=dtype)
        self.ln_h = nn.param(D, device=device, dtype=dtype)
        self.ln_e = nn.param(D, device=device, dtype=dtype)
        self.layer = Block(cfg, device, dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.dense_init_(self.proj, gen)
        self.ln_h.zero_()
        self.ln_e.zero_()
        self.layer.reset_parameters(gen)


def layer_groups(cfg: ModelConfig) -> list[tuple[str, int]]:
    """(name, number of layers) of each stacked layer group, in the order
    the reference walks them."""
    if not cfg.n_experts:
        return [("layers", cfg.n_layers)]
    dense = [("dense_layers", cfg.n_dense_layers)] if cfg.n_dense_layers else []
    return dense + [("moe_layers", cfg.n_moe_layers)]


class Decoder(tnn.Module):
    """emb (V, D), ln_f (D,), head (D, V) unless tied, and the layer groups
    of :func:`layer_groups`: layers[0..L), or dense_layers and moe_layers;
    mtp when ``cfg.mtp_depth``; patch_proj (D, D) for the vision frontend."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        self.cfg = cfg
        self.emb = nn.param(cfg.vocab_size, cfg.d_model, device=device, dtype=dtype)
        self.ln_f = nn.param(cfg.d_model, device=device, dtype=dtype)
        if not cfg.tie_embeddings:
            self.head = nn.param(cfg.d_model, cfg.vocab_size, device=device, dtype=dtype)
        for name, n in layer_groups(cfg):
            kind = "moe" if name == "moe_layers" else "dense"
            setattr(self, name, tnn.ModuleList(Block(cfg, device, dtype, kind)
                                               for _ in range(n)))
        if cfg.mtp_depth:
            self.mtp = MTP(cfg, device, dtype)
        if cfg.frontend == "vision":
            self.patch_proj = nn.param(cfg.d_model, cfg.d_model, device=device, dtype=dtype)
        self.tp: nn.TP | None = None          # tensor-parallel group, if split

    def forward(self, batch: dict, opts: ModelOpts):
        """(loss, metrics) of a batch: :func:`decoder_loss`."""
        return decoder_loss(self, batch, self.cfg, opts)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.embed_init_(self.emb, gen)
        self.ln_f.zero_()
        if hasattr(self, "head"):
            nn.dense_init_(self.head, gen)
        for name, _ in layer_groups(self.cfg):
            for layer in getattr(self, name):
                layer.reset_parameters(gen)
        if hasattr(self, "mtp"):
            self.mtp.reset_parameters(gen)
        if hasattr(self, "patch_proj"):
            nn.dense_init_(self.patch_proj, gen)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        w = self.emb.T if self.cfg.tie_embeddings else self.head
        return h @ w


# ---------------------------------------------------------------------------
# Attention pieces
# ---------------------------------------------------------------------------

def qkv(p: Attention, x, cfg: ModelConfig, positions, tp: nn.TP | None = None):
    """q (B,S,Hq,hd), k, v (B,S,Hkv,hd): the heads of this rank's columns
    (all of them without ``tp``)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if cfg.qkv_bias:
        q = q + nn.tp_slice(p.bq, q.shape[-1], tp)
        k = k + nn.tp_slice(p.bk, k.shape[-1], tp)
        v = v + nn.tp_slice(p.bv, v.shape[-1], tp)
    q = nn.apply_rope(q.view(B, S, -1, hd), positions, cfg.rope_theta)
    k = nn.apply_rope(k.view(B, S, -1, hd), positions, cfg.rope_theta)
    return q, k, v.view(B, S, -1, hd)


def attn_decode(p: Attention, x, cfg: ModelConfig, k_cache, v_cache, length: int):
    """One-token step.  x: (B,1,D); caches (B,Smax,Hkv,hd), written in place.
    Sliding-window models use a ring buffer of size <= window."""
    B = x.shape[0]
    Smax = k_cache.shape[1]
    if not cfg.sliding_window and length >= Smax:
        raise ValueError(f"KV cache full: position {length} >= cache length {Smax}")
    positions = torch.full((B, 1), length, dtype=torch.long, device=x.device)
    q, k, v = qkv(p, x, cfg, positions)
    slot = length % Smax if cfg.sliding_window else length
    k_cache[:, slot] = k[:, 0]
    v_cache[:, slot] = v[:, 0]
    o = decode_attention(q[:, 0], k_cache, v_cache, min(length + 1, Smax))
    return o.reshape(B, 1, -1) @ p.wo


# ---------------------------------------------------------------------------
# Training forward and loss
# ---------------------------------------------------------------------------

def block_apply(lp: Block, x, cfg: ModelConfig, positions, opts: ModelOpts | None = None,
                tp: nn.TP | None = None):
    """Pre-norm residual block over a full sequence.  Returns (x, aux): the
    MoE's load-balancing loss in a MoE block, 0.0 in a dense one."""
    B, S, _ = x.shape
    h = nn.tp_copy(nn.rmsnorm(x, lp.ln1, cfg.norm_eps), tp)
    if cfg.mla:
        a = mla_attention(lp.attn, h, cfg, positions)
    else:
        q, k, v = qkv(lp.attn, h, cfg, positions, tp)
        a = attention(q, k, v, causal=True, window=cfg.sliding_window).reshape(B, S, -1) \
            @ lp.attn.wo
    x = x + nn.tp_reduce(a, tp)
    h = nn.tp_copy(nn.rmsnorm(x, lp.ln2, cfg.norm_eps), tp)
    if hasattr(lp, "moe"):
        f, aux = moe_apply(lp.moe, h, cfg, (opts or ModelOpts()).moe_token_chunk)
        return x + f, aux
    return x + nn.tp_reduce(nn.ffn_apply(lp.mlp.wi, lp.mlp.wo, h, cfg.act), tp), 0.0


def decoder_forward(params: Decoder, batch: dict, cfg: ModelConfig, opts: ModelOpts):
    """(hidden states (B, S_total, D) after the final norm, aux, text
    offset): the layer groups of :func:`layer_groups` in order over
    :func:`embed_inputs` (a vision model's patches first), aux the sum of
    their MoE layers' load-balancing losses (0.0 without MoE layers).  Under
    ``remat="full"`` each block is recomputed in the backward (the port's
    form of the reference's ``jax.checkpoint`` around the scanned block), so
    the attention forward runs twice per layer."""
    if opts.remat not in ("none", "full"):
        raise NotImplementedError(f"remat={opts.remat!r}: the port takes 'none' or 'full'")
    tp = params.tp
    x, off = embed_inputs(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = 0.0
    for name, _ in layer_groups(cfg):
        for lp in getattr(params, name):
            x, a = lp(x, cfg, positions, opts, tp)
            aux = aux + a
    return nn.rmsnorm(x, params.ln_f, cfg.norm_eps), aux, off


def decoder_loss(params: Decoder, batch: dict, cfg: ModelConfig, opts: ModelOpts):
    """Next-token CE over the text positions (a vision model's patches are
    sliced off the hidden states first): labels are the tokens rolled left
    by one, the last position masked; a MoE model adds ``aux_loss_weight`` x its
    load-balancing loss, and with ``cfg.mtp_depth`` and ``opts.mtp`` the MTP
    block predicts the token after next (labels rolled by two, the last two
    masked) from the final hidden state and the next token's embedding,
    weighted by ``mtp_loss_weight``; the MTP block is not rematerialised, as
    the reference applies it outside its checkpointed scan.  Returns (loss,
    {"ce"[, "aux"][, "mtp"]})."""
    tokens = batch["tokens"]
    h, aux, off = decoder_forward(params, batch, cfg, opts)
    if off:
        h = h[:, off:]
    labels = torch.roll(tokens, -1, dims=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    tp = params.tp

    def logits(hh):
        return params.logits(nn.tp_copy(hh, tp))

    loss = nn.cross_entropy_loss(logits, h, labels, mask, chunk=opts.loss_chunk, tp=tp)
    metrics = {"ce": loss}
    if cfg.n_experts:
        aux = torch.as_tensor(aux, dtype=torch.float32, device=h.device)
        loss = loss + opts.aux_loss_weight * aux
        metrics["aux"] = aux
    if cfg.mtp_depth and opts.mtp:
        mtp = params.mtp
        e_next = nn.embed_lookup(params.emb, torch.roll(tokens, -1, dims=1), tp)
        hin = torch.cat([nn.rmsnorm(h, mtp.ln_h, cfg.norm_eps),
                         nn.rmsnorm(e_next, mtp.ln_e, cfg.norm_eps)], dim=-1)
        positions = torch.arange(h.shape[1], device=h.device)[None, :]
        hm, _ = block_apply(mtp.layer, hin @ mtp.proj, cfg, positions, opts, tp)
        labels2 = torch.roll(tokens, -2, dims=1)
        mask2 = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
        mask2[:, -2:] = 0.0
        mtp_loss = nn.cross_entropy_loss(logits, hm, labels2, mask2, chunk=opts.loss_chunk,
                                         tp=tp)
        loss = loss + opts.mtp_loss_weight * mtp_loss
        metrics["mtp"] = mtp_loss
    return loss, metrics


# ---------------------------------------------------------------------------
# Cache, prefill, decode
# ---------------------------------------------------------------------------

def cache_len(cfg: ModelConfig, max_len: int) -> int:
    return min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len


def decoder_init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
                       dtype) -> dict:
    S = cache_len(cfg, max_len)

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    cache: dict = {"pos": 0}
    for name, n in layer_groups(cfg):
        if cfg.mla:
            cache[name] = {"c": zeros(n, batch, S, cfg.kv_lora_rank),
                           "pe": zeros(n, batch, S, cfg.qk_rope_dim)}
        else:
            shape = (n, batch, S, cfg.n_kv_heads, cfg.resolved_head_dim)
            cache[name] = {"k": zeros(*shape), "v": zeros(*shape)}
    return cache


def ring_write(cache_arr, kv, window: int) -> None:
    """Write full-sequence kv (B,S,...) into cache (B,W,...) in place; with a
    window and S > W, the last W positions land at slot pos % W."""
    S, W = kv.shape[1], cache_arr.shape[1]
    if not window or S <= W:
        if S > W:
            raise ValueError(f"prompt of {S} tokens exceeds the KV cache length {W}")
        cache_arr[:, :S] = kv
        return
    idx = torch.arange(S - W, S, device=kv.device) % W
    cache_arr[:, idx] = kv[:, S - W:]


def ffn_part(lp: Block, h, cfg: ModelConfig, opts: ModelOpts):
    """The block's FFN: the MoE (its aux loss dropped, as the reference's
    serving steps drop it) or the dense FFN."""
    if hasattr(lp, "moe"):
        return moe_apply(lp.moe, h, cfg, opts.moe_token_chunk)[0]
    return nn.ffn_apply(lp.mlp.wi, lp.mlp.wo, h, cfg.act)


def embed_inputs(params: Decoder, batch: dict, cfg: ModelConfig):
    """Token (+ modality stub) embedding: (x (B, S_total, D), text offset).
    A vision model's ``batch["patches"]`` (B, n_patches, D) is projected by
    ``patch_proj`` and put before the token embeddings; the offset is the
    number of patches (0 without them).  The token embedding is
    vocab-parallel under ``params.tp``."""
    x = nn.embed_lookup(params.emb, batch["tokens"], params.tp)
    if cfg.frontend == "vision" and "patches" in batch:
        pe = batch["patches"].to(x.dtype) @ params.patch_proj
        return torch.cat([pe, x], dim=1), pe.shape[1]
    return x, 0


def decoder_prefill(params: Decoder, cache: dict, batch: dict, cfg: ModelConfig,
                    opts: ModelOpts | None = None):
    """Prefill the cache from a full prompt, ``batch`` {"tokens": (B, S)[,
    "patches": (B, n_patches, D)]}: the patches take the first positions
    and the cache slots before the tokens', and ``cache["pos"]`` counts
    them.  Returns (cache, logits of the last position (B, V))."""
    opts = opts or ModelOpts()
    x, _ = embed_inputs(params, batch, cfg)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    for name, _ in layer_groups(cfg):
        c = cache[name]
        for i, lp in enumerate(getattr(params, name)):
            h = nn.rmsnorm(x, lp.ln1, cfg.norm_eps)
            if cfg.mla:
                a, c_kv, k_pe = mla_prefill(lp.attn, h, cfg, positions)
                ring_write(c["c"][i], c_kv, 0)
                ring_write(c["pe"][i], k_pe, 0)
            else:
                q, k, v = qkv(lp.attn, h, cfg, positions)
                o = attention(q, k, v, causal=True, window=cfg.sliding_window)
                a = o.reshape(B, S, -1) @ lp.attn.wo
                ring_write(c["k"][i], k, cfg.sliding_window)
                ring_write(c["v"][i], v, cfg.sliding_window)
            x = x + a
            x = x + ffn_part(lp, nn.rmsnorm(x, lp.ln2, cfg.norm_eps), cfg, opts)
    cache["pos"] = S
    h = nn.rmsnorm(x[:, -1], params.ln_f, cfg.norm_eps)
    return cache, params.logits(h)


def decoder_decode_step(params: Decoder, cache: dict, tokens, cfg: ModelConfig,
                        opts: ModelOpts | None = None):
    """tokens: (B,) current token ids.  Returns (cache, logits (B,V))."""
    opts = opts or ModelOpts()
    pos = cache["pos"]
    x = nn.embed_lookup(params.emb, tokens[:, None])
    for name, _ in layer_groups(cfg):
        c = cache[name]
        for i, lp in enumerate(getattr(params, name)):
            h = nn.rmsnorm(x, lp.ln1, cfg.norm_eps)
            if cfg.mla:
                x = x + mla_decode(lp.attn, h, cfg, c["c"][i], c["pe"][i], pos)
            else:
                x = x + attn_decode(lp.attn, h, cfg, c["k"][i], c["v"][i], pos)
            x = x + ffn_part(lp, nn.rmsnorm(x, lp.ln2, cfg.norm_eps), cfg, opts)
    cache["pos"] = pos + 1
    h = nn.rmsnorm(x[:, 0], params.ln_f, cfg.norm_eps)
    return cache, params.logits(h)
