"""Mixture-of-Experts FFN with sort-based (dropped-token) dispatch: the torch
twin of ``repro.models.moe``.

The dispatch is the reference's, step for step, because which tokens are
dropped depends on it: the router in f32, softmax, top-k with the gates
renormalised; a fixed capacity per expert (the reference's expression,
rounded up to 8); a stable sort of the (token, choice) pairs by expert, each
pair's rank within its expert found by ``searchsorted(side="left")``, and
the pairs ranked at or past the capacity dropped (the reference sends them
to a trash slot at index ``capacity``).  The kept tokens are written into
a zeroed (E, capacity, D) buffer, the experts run as two batched products
over it (``torch.bmm``: plain large matrix products, which the reference
computes outside any Pallas kernel), and each token's kept slots are
combined in f32 and cast to x's dtype, then the shared experts are added.
``moe_apply`` also returns the Switch load-balancing loss, E * sum(mean
probability x share of tokens routed) over each chunk, meaned over chunks;
it and the output carry gradients to x, the router and the experts.

Three places differ from the literal reference and give the same function:

  * top-k is a stable descending sort of the probabilities, so ties go to
    the lower expert index as in ``jax.lax.top_k`` (``torch.topk`` does not
    promise that order on CUDA), and the gates are the probabilities
    gathered at the picks;
  * the combine gathers each token's K gated slot outputs (a zero row for a
    dropped pick) and sums them, a fixed-order reduction, where the
    reference scatter-adds slot outputs into their tokens; an
    ``index_add_`` would add with float atomics on CUDA, in no fixed order.
    So the combine is bit-repeatable on the card, and greedy decoding is
    too.  The f32 sums of K terms differ from the reference's order by
    rounding only (~1e-7 relative);
  * the dispatch (:class:`Dispatch`) is an autograd function whose backward
    gathers each token's K slot gradients and sums them in the same fixed
    order, where autograd's backward of ``xc[tok_of]`` would add them by
    an accumulating index-put.  So a train step is bit-repeatable too.

Under ``remat="full"`` a block's forward runs again in the backward
(``torch.utils.checkpoint``); :func:`remat_contexts` makes the recompute
take the picks the first pass made (the reference's recompute finds them
again from the same inputs), without touching ``ROUTE_LOG``.

A pick is a discontinuous function of the router's input: two runs whose
hidden states differ by bf16 rounding (the card and the CPU, or the port
and the JAX package) can pick different experts for a token whose top-k
margin is below that noise, and then differ by O(1) there.  ``ROUTE_LOG``
lets a check record every dispatch chunk's input and picks, or replay the
picks of another run, so that it can hold the routers to each other on the
same inputs and the rest of the model to the other run under one routing.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn as tnn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import nn


class MoE(tnn.Module):
    """router (D, E) f32, we_in (E, D, fin), we_out (E, F, D), and ``shared``
    (an FFN of width moe_d_ff * n_shared_experts) when the config has shared
    experts; fin is 2F for the gated activations, else F."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        E, D, F_ = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
        fin = 2 * F_ if cfg.act in ("swiglu", "geglu") else F_
        self.router = nn.param(D, E, device=device, dtype=torch.float32)
        self.we_in = nn.param(E, D, fin, device=device, dtype=dtype)
        self.we_out = nn.param(E, F_, D, device=device, dtype=dtype)
        if cfg.n_shared_experts:
            from repro_torch.models.transformer import FFN

            self.shared = FFN(cfg, device, dtype, d_ff=F_ * cfg.n_shared_experts)

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.normal_(self.router, 0.02, gen)
        # One expert at a time: an f32 draw of deepseek-v3's whole we_in
        # (256 x 7168 x 4096) would take 30 GB of the card.
        for w in (self.we_in, self.we_out):
            for e in range(w.shape[0]):
                nn.normal_(w[e], w.shape[1] ** -0.5, gen)
        if hasattr(self, "shared"):
            self.shared.reset_parameters(gen)


def capacity_of(cfg: ModelConfig, chunk: int) -> int:
    """Slots per expert for a dispatch chunk of ``chunk`` tokens: the
    reference's expression, at least 8, rounded up to a multiple of 8."""
    capacity = max(8, int(cfg.capacity_factor * chunk * cfg.top_k / cfg.n_experts))
    return -(-capacity // 8) * 8


class RouteLog:
    """Every routed chunk's (input, probs, picks) in call order, in
    ``seen``; with ``replay`` (picks of another run, in the same order) each
    call takes the next replayed picks in place of its own top k, and gates
    them with its own probabilities.  Set ``moe.ROUTE_LOG`` to one to use it;
    ``None`` (the default) costs nothing."""

    def __init__(self, replay=None):
        self.seen: list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = []
        self.replay = list(replay or [])


ROUTE_LOG: RouteLog | None = None

# The picks of the checkpointed block running now: a list its forward
# appends to, or an iterator its recompute takes them from (remat_contexts).
_RECORD: list | None = None
_REPLAY = None


@contextlib.contextmanager
def _remat_picks(record: list | None = None, replay: list | None = None):
    global _RECORD, _REPLAY
    saved = _RECORD, _REPLAY
    _RECORD, _REPLAY = record, (iter(replay) if replay is not None else None)
    try:
        yield
    finally:
        _RECORD, _REPLAY = saved


def remat_contexts():
    """``context_fn`` of ``torch.utils.checkpoint`` around one block: (the
    forward's context, which records the block's picks, the recompute's,
    which replays them), so the recompute routes every token as the forward
    did.  Either pass computes the same tensors for the backward: the gates
    are gathered at the picks in both."""
    picks: list[torch.Tensor] = []
    return _remat_picks(record=picks), _remat_picks(replay=picks)


def route(router: torch.Tensor, xc: torch.Tensor, top_k: int):
    """(probs (T, E) f32, gates (T, K) f32 renormalised, eidx (T, K)): the
    router in f32, softmax, and the top k with ties to the lower index
    (a checkpointed block's recompute takes its forward's picks instead)."""
    probs = torch.softmax(xc.float() @ router.float(), dim=-1)
    if _REPLAY is not None:
        eidx = next(_REPLAY)
    else:
        eidx = torch.sort(probs.detach(), dim=-1, descending=True,
                          stable=True).indices[:, :top_k]
        log = ROUTE_LOG
        if log is not None:
            if log.replay:
                eidx = log.replay.pop(0).to(eidx.device)
            log.seen.append((xc, probs, eidx))
        if _RECORD is not None:
            _RECORD.append(eidx)
    gates = probs.gather(1, eidx)
    return probs, gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), eidx


class Dispatch(torch.autograd.Function):
    """The experts' capacity buffer (n_rows, D) from the chunk's tokens xc
    (T, D): row ``slot[t, k]`` holds token t for each kept pick; a dropped
    pick points at row n_rows, which is cut off.  The gradient of token t is
    the sum of its K rows' gradients, gathered and summed in a fixed order
    (a dropped pick adds a zero row), so it is the same bits from run to
    run on the card."""

    @staticmethod
    def forward(ctx, xc: torch.Tensor, slot: torch.Tensor, n_rows: int):
        T, K = slot.shape
        buf = xc.new_zeros((n_rows + 1, xc.shape[1]))
        buf[slot.reshape(-1)] = xc.repeat_interleave(K, dim=0)
        ctx.save_for_backward(slot)
        return buf[:n_rows]

    @staticmethod
    def backward(ctx, grad_buf: torch.Tensor):
        (slot,) = ctx.saved_tensors
        g = F.pad(grad_buf, (0, 0, 0, 1))                       # row n_rows: zeros
        return g[slot].float().sum(1).to(grad_buf.dtype), None, None


def expert_ffn(p: MoE, buf: torch.Tensor, act: str) -> torch.Tensor:
    """The experts over their capacity buffer: (E, C, D) -> (E, C, D)."""
    h = torch.bmm(buf, p.we_in)
    if act in ("swiglu", "geglu"):
        u, g = h.chunk(2, dim=-1)
        h = u * (F.silu(g) if act == "swiglu" else nn.gelu(g))
    else:
        h = nn.act_fn(act)(h)
    return torch.bmm(h, p.we_out)


def _one_chunk(p: MoE, xc: torch.Tensor, cfg: ModelConfig, capacity: int):
    """(y (chunk, D) in x's dtype, aux) of one dispatch chunk."""
    T, D = xc.shape
    E, K = cfg.n_experts, cfg.top_k
    probs, gates, eidx = route(p.router, xc, K)

    # Load-balancing aux loss (Switch-style) over this chunk.
    me = probs.mean(0)
    ce = (F.one_hot(eidx, E).sum(1) > 0).float().mean(0)
    aux = E * (me * ce).sum()

    flat_e = eidx.reshape(-1)                                   # (T*K,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    pos = torch.arange(T * K, device=xc.device) - torch.searchsorted(
        sorted_e, sorted_e, side="left")                        # rank within its expert
    keep = pos < capacity

    # Each (token, choice) pair's slot, E*capacity (the trash row) if dropped.
    slot = torch.empty_like(flat_e)
    slot[order] = torch.where(keep, sorted_e * capacity + pos, E * capacity)
    slot = slot.view(T, K)

    # Zeroed, as the reference's: a slot no pick fills runs its expert on
    # zeros, so every output row is finite.
    buf = Dispatch.apply(xc, slot, E * capacity).view(E, capacity, D)
    out = expert_ffn(p, buf, cfg.act).reshape(E * capacity, D)
    out = F.pad(out, (0, 0, 0, 1))                              # row E*capacity: zeros

    # Each pair's slot output (the zero row if it was dropped), gated.
    y = (out[slot].float() * gates[..., None]).sum(1)
    return y.to(xc.dtype), aux


def moe_apply(p: MoE, x: torch.Tensor, cfg: ModelConfig, token_chunk: int = 65536):
    """x: (B, S, D) -> (out (B, S, D), aux loss).  Tokens are dispatched in
    chunks of ``token_chunk`` (one chunk of all T tokens when it does not
    divide T); aux is the mean over chunks."""
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    chunk = min(token_chunk, T)
    if T % chunk:
        chunk = T
    capacity = capacity_of(cfg, chunk)
    parts = [_one_chunk(p, xf[c:c + chunk], cfg, capacity) for c in range(0, T, chunk)]
    y = torch.cat([yc for yc, _ in parts])
    aux = torch.stack([a for _, a in parts]).mean()
    if hasattr(p, "shared"):
        y = y + nn.ffn_apply(p.shared.wi, p.shared.wo, xf, cfg.act)
    return y.reshape(B, S, D), aux
