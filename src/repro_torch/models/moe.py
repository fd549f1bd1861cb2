"""Mixture-of-Experts layer (port of ``repro.models.moe``): top-k routing
with grouped, capacity-bounded, gather-only dispatch.

Step for step the reference's ``moe_apply``:

* tokens split into G groups of ``Tg`` (about ``tokens_per_group``); routing,
  the sort and capacity are per group;
* capacity ``C = ceil(Tg * k / E * capacity_factor)``, and dropless
  ``C = Tg`` for groups of at most 256 tokens (every decode step), so a
  longer prompt can drop pairs past an expert's capacity, as the reference
  does;
* routing in float32 (the router weight stays float32 whatever the
  param dtype): softmax, top-k, renormalised by the clamped sum, and the
  Switch/OLMoE load-balance aux loss;
* a *stable* sort of the (token, choice) pairs by expert gives each pair its
  rank in its expert, and dispatch and combine are gathers;
* the expert SwiGLU runs through the grouped-matmul kernel, three launches
  per layer (gate, up, down); the shared experts (qwen2-moe) are plain
  products with a float32 sigmoid gate.

The reference's sharding hooks (``expert_specs``, ``sharder``) are not
ported: the port runs on one device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import MoEConfig
from repro_torch.models.layers import _cast

#: dropless threshold: groups of at most this many tokens take C = Tg
DROPLESS_TOKENS = 256


def moe_init(d_model: int, cfg: MoEConfig, dtype, *, device, generator: torch.Generator):
    """One layer's MoE params with the reference's shapes and scales, drawn
    from ``generator`` straight into ``dtype`` on ``device``; the router is
    float32 whatever ``dtype`` is."""
    E, f = cfg.num_experts, cfg.d_ff_expert
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(f)

    def normal(shape, scale, dt=dtype):
        t = torch.empty(shape, dtype=dt, device=device)
        return t.normal_(generator=generator).mul_(scale)

    p = {
        "router": normal((d_model, E), s_in, torch.float32),
        "w_gate": normal((E, d_model, f), s_in),
        "w_up": normal((E, d_model, f), s_in),
        "w_down": normal((E, f, d_model), s_out),
    }
    if cfg.num_shared_experts:
        fs = cfg.num_shared_experts * f
        p["shared"] = {
            "w_gate": normal((d_model, fs), s_in),
            "w_up": normal((d_model, fs), s_in),
            "w_down": normal((fs, d_model), s_out),
            "gate": torch.zeros((d_model, 1), dtype=dtype, device=device),
        }
    return p


def _group_count(num_tokens: int, tokens_per_group: int) -> int:
    g = max(1, num_tokens // max(tokens_per_group, 1))
    while num_tokens % g:
        g -= 1
    return g


def capacity(num_tokens: int, cfg: MoEConfig, tokens_per_group: int = 4096):
    """(G, Tg, C) of a call over ``num_tokens`` tokens."""
    G = _group_count(num_tokens, tokens_per_group)
    Tg = num_tokens // G
    C = math.ceil(Tg * cfg.top_k / cfg.num_experts * cfg.capacity_factor)
    if Tg <= DROPLESS_TOKENS:
        # decode-sized groups go dropless: each token adds at most one pair
        # to an expert, so C = Tg never overflows
        C = Tg
    return G, Tg, C


def route(x, router, cfg: MoEConfig, tokens_per_group: int = 4096):
    """Routing of x (B, T, d) in float32: returns (probs, top_w, top_e), each
    (G, Tg, .), and the aux loss."""
    B, T, d = x.shape
    G, Tg, _ = capacity(B * T, cfg, tokens_per_group)
    logits = x.reshape(G, Tg, d).float() @ router.float()      # (G, Tg, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, cfg.top_k, dim=-1)        # (G, Tg, k)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)
    # load-balance aux loss (Switch/OLMoE form)
    density = F.one_hot(top_e[..., 0], cfg.num_experts).float().mean(dim=(0, 1))
    aux = cfg.num_experts * (density * probs.mean(dim=(0, 1))).sum()
    return probs, top_w, top_e, aux


def moe_apply(p, x, cfg: MoEConfig, dtype, *, tokens_per_group: int = 4096):
    """x: (B, T, d) -> (y, aux_loss)."""
    B, T, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    G, Tg, C = capacity(B * T, cfg, tokens_per_group)
    xf = x.reshape(G, Tg, d)
    _, top_w, top_e, aux = route(x, p["router"], cfg, tokens_per_group)

    # --- sort pairs by expert within each group --------------------------------
    P = Tg * k
    pair_e = top_e.reshape(G, P)
    pair_w = top_w.reshape(G, P)
    order = torch.argsort(pair_e, dim=-1, stable=True)         # pair ids by expert
    ranks = torch.argsort(order, dim=-1)                       # rank of each pair
    counts = torch.zeros((G, E), dtype=torch.int64, device=x.device)
    counts.scatter_add_(1, pair_e, torch.ones_like(pair_e))
    offsets = counts.cumsum(-1) - counts                       # (G, E) exclusive
    pos_in_e = ranks - offsets.gather(1, pair_e)               # (G, P)
    keep = pos_in_e < C

    # --- dispatch: slot (g, e, c) <- token of sorted pair offsets[g, e] + c ----
    cs = torch.arange(C, device=x.device)
    slot = (offsets[:, :, None] + cs).clamp(0, P - 1)          # (G, E, C)
    slot_valid = cs < counts.clamp(max=C)[:, :, None]
    pair_id = order.gather(1, slot.reshape(G, E * C))
    rows = torch.arange(G, device=x.device)[:, None]
    xe = xf[rows, pair_id // k].reshape(G, E, C, d)
    xe = _cast(xe.masked_fill(~slot_valid[..., None], 0), dtype)

    # --- grouped expert SwiGLU: the grouped-matmul kernel, three launches ------
    wg, wu, wd = (_cast(p[n], dtype) for n in ("w_gate", "w_up", "w_down"))
    h = F.silu(ops.grouped_matmul(xe, wg)) * ops.grouped_matmul(xe, wu)
    ye = ops.grouped_matmul(h, wd)                             # (G, E, C, d)

    # --- combine: gather each pair's slot, weight, sum over k ------------------
    pair_slot = (pair_e * C + pos_in_e).clamp(0, E * C - 1)
    y_pair = ye.reshape(G, E * C, d)[rows, pair_slot]          # (G, P, d)
    y_pair = y_pair * _cast(keep * pair_w, dtype)[..., None]
    y = y_pair.reshape(G, Tg, k, d).sum(dim=2).reshape(B, T, d)

    # --- shared experts (qwen2-moe) ---------------------------------------------
    if "shared" in p:
        ps = p["shared"]
        hs = F.silu(x @ _cast(ps["w_gate"], dtype)) * (x @ _cast(ps["w_up"], dtype))
        ys = hs @ _cast(ps["w_down"], dtype)
        gate = torch.sigmoid((x @ _cast(ps["gate"], dtype)).float())
        y = y + ys * gate.to(dtype)
    return y, aux
