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

Under a ``sharder`` the groups split over the batch axes and each rank
routes, sorts and gathers its own groups (the reference's per-group design
keeps that local); the dispatched tokens then split their experts over the
model axis (EP, ``expert_specs``) or the expert weights their ``f``
(TP-in-expert), the grouped matmul runs on the local shards, and the
combine gathers the experts back (EP) or sums the partial down
projections (TP).  FSDP-split expert weights are gathered explicitly
before the kernel, which never contracts over a split it was not given.
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


def expert_specs(sharder, cfg: MoEConfig):
    """Sharding rules for the expert stacks (EP or TP-in-expert)."""
    if cfg.expert_parallel:
        return {
            "router": [None, None],
            "w_gate": ["model", ["fsdp"], None],
            "w_up": ["model", ["fsdp"], None],
            "w_down": ["model", None, ["fsdp"]],
        }
    return {
        "router": [None, None],
        "w_gate": [None, ["fsdp"], "model"],
        "w_up": [None, ["fsdp"], "model"],
        "w_down": [None, "model", ["fsdp"]],
    }


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
    probs, top_w, top_e = _route_groups(x.reshape(G, Tg, d), router, cfg)
    # load-balance aux loss (Switch/OLMoE form)
    density = F.one_hot(top_e[..., 0], cfg.num_experts).float().mean(dim=(0, 1))
    aux = cfg.num_experts * (density * probs.mean(dim=(0, 1))).sum()
    return probs, top_w, top_e, aux


def _route_groups(xf, router, cfg: MoEConfig):
    """(probs, top_w, top_e) of grouped tokens xf (G, Tg, d), float32."""
    logits = xf.float() @ router.float()                       # (G, Tg, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, cfg.top_k, dim=-1)        # (G, Tg, k)
    return probs, top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9), top_e


def moe_apply(p, x, cfg: MoEConfig, dtype, *, tokens_per_group: int = 4096, sharder=None):
    """x: (B, T, d) -> (y, aux_loss)."""
    if sharder is not None:
        return _moe_apply_sharded(p, x, cfg, dtype, tokens_per_group, sharder)
    B, T, d = x.shape
    G, Tg, C = capacity(B * T, cfg, tokens_per_group)
    xf = x.reshape(G, Tg, d)
    _, top_w, top_e, aux = route(x, p["router"], cfg, tokens_per_group)
    xe, combine = _dispatch(xf, top_w, top_e, cfg, C, dtype)

    # --- grouped expert SwiGLU: the grouped-matmul kernel, three launches ------
    wg, wu, wd = (_cast(p[n], dtype) for n in ("w_gate", "w_up", "w_down"))
    h = F.silu(ops.grouped_matmul(xe, wg)) * ops.grouped_matmul(xe, wu)
    y = combine(ops.grouped_matmul(h, wd)).reshape(B, T, d)
    if "shared" in p:
        y = y + _shared(p["shared"], x, dtype)
    return y, aux


def _shared(ps, x, dtype, sharder=None):
    """The shared experts (qwen2-moe): a SwiGLU with a float32 sigmoid gate."""
    hs = F.silu(x @ _cast(ps["w_gate"], dtype)) * (x @ _cast(ps["w_up"], dtype))
    if sharder is not None:
        hs = sharder.constrain(hs, ["batch", None, "model"])   # as layers.mlp_apply
    ys = hs @ _cast(ps["w_down"], dtype)
    gate = torch.sigmoid((x @ _cast(ps["gate"], dtype)).float())
    return ys * gate.to(dtype)


def _dispatch(xf, top_w, top_e, cfg: MoEConfig, C: int, dtype):
    """Gather each group's tokens into their experts' slots: returns xe (G,
    E, C, d) and ``combine(ye)``, which gathers each (token, choice) pair's
    slot of ye (G, E, C, d), weights it and sums over the choices -> (G,
    Tg, d)."""
    G, Tg, d = xf.shape
    E, k = cfg.num_experts, cfg.top_k

    # --- sort pairs by expert within each group --------------------------------
    P = Tg * k
    pair_e = top_e.reshape(G, P)
    pair_w = top_w.reshape(G, P)
    order = torch.argsort(pair_e, dim=-1, stable=True)         # pair ids by expert
    ranks = torch.argsort(order, dim=-1)                       # rank of each pair
    counts = torch.zeros((G, E), dtype=torch.int64, device=xf.device)
    counts.scatter_add_(1, pair_e, torch.ones_like(pair_e))
    offsets = counts.cumsum(-1) - counts                       # (G, E) exclusive
    pos_in_e = ranks - offsets.gather(1, pair_e)               # (G, P)
    keep = pos_in_e < C

    # --- dispatch: slot (g, e, c) <- token of sorted pair offsets[g, e] + c ----
    cs = torch.arange(C, device=xf.device)
    slot = (offsets[:, :, None] + cs).clamp(0, P - 1)          # (G, E, C)
    slot_valid = cs < counts.clamp(max=C)[:, :, None]
    pair_id = order.gather(1, slot.reshape(G, E * C))
    rows = torch.arange(G, device=xf.device)[:, None]
    xe = xf[rows, pair_id // k].reshape(G, E, C, d)
    xe = _cast(xe.masked_fill(~slot_valid[..., None], 0), dtype)

    def combine(ye):
        # gather each pair's slot, weight, sum over k
        pair_slot = (pair_e * C + pos_in_e).clamp(0, E * C - 1)
        y_pair = ye.reshape(G, E * C, d)[rows, pair_slot]      # (G, P, d)
        y_pair = y_pair * _cast(keep * pair_w, dtype)[..., None]
        return y_pair.reshape(G, Tg, k, d).sum(dim=2)

    return xe, combine


def _moe_apply_sharded(p, x, cfg: MoEConfig, dtype, tokens_per_group, sharder):
    """:func:`moe_apply` on DTensors: each rank routes and dispatches its
    own groups; the experts (EP) or their ``f`` (TP-in-expert) split over
    the model axis for the grouped matmul (see the module notes)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    B, T, d = x.shape
    E = cfg.num_experts
    G, Tg, C = capacity(B * T, cfg, tokens_per_group)
    xf = _regroup(sharder.constrain(x, ["batch", None, None]), (G, Tg, d))
    xf = sharder.constrain(xf, ["batch", None, None])
    mesh, pl = xf.device_mesh, xf.placements
    # a rank's routing reads only its own groups: the replicated router's
    # gradient there is a partial sum over the split groups
    summed = [Partial() if q.is_shard() else Replicate() for q in pl]
    router = p["router"].to_local(grad_placements=summed)
    probs, top_w, top_e = _route_groups(xf.to_local(), router, cfg)
    density = DTensor.from_local(F.one_hot(top_e[..., 0], E).float().sum(dim=(0, 1)),
                                 mesh, summed)
    prob_sum = DTensor.from_local(probs.sum(dim=(0, 1)), mesh, summed)
    aux = E * (density * prob_sum).sum() / float(G * Tg) ** 2
    xe, combine = _dispatch(xf.to_local(), top_w, top_e, cfg, C, dtype)

    ep = cfg.expert_parallel
    act = ["batch", "model", None, None] if ep else ["batch", None, None, None]
    hidden = ["batch", "model", None, None] if ep else ["batch", None, None, "model"]
    w_in = ["model", None, None] if ep else [None, None, "model"]
    w_out = ["model", None, None] if ep else [None, "model", None]
    xe = sharder.constrain(DTensor.from_local(xe, mesh, pl, run_check=False), act)
    wg, wu = (sharder.constrain(_cast(p[n], dtype), w_in) for n in ("w_gate", "w_up"))
    h = F.silu(ops.grouped_matmul(xe, wg)) * ops.grouped_matmul(xe, wu)
    h = sharder.constrain(h, hidden)
    ye = ops.grouped_matmul(h, sharder.constrain(_cast(p["w_down"], dtype), w_out))
    # EP: gather the experts back; TP-in-expert: sum the partial products
    ye = sharder.constrain(ye, ["batch", None, None, None])
    if tuple(ye.placements) != tuple(pl):
        ye = ye.redistribute(mesh, pl)
    y = _regroup(DTensor.from_local(combine(ye.to_local()), mesh, pl, run_check=False),
                 (B, T, d))
    if "shared" in p:
        y = y + _shared(p["shared"], x, dtype, sharder)
    return sharder.act_btd(y), aux


def _regroup(t, shape):
    """Reshape the DTensor ``t``, split (if at all) only along dim 0, to
    ``shape`` keeping its rows' order (tokens to groups and back).  Each
    rank reshapes its own rows where they form whole rows of ``shape``
    (the split's ranks divide both leading dims), else the rows are
    gathered first."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh, pl = t.device_mesh, t.placements
    if any(q.is_partial() or (q.is_shard() and q.dim != 0) for q in pl):
        raise NotImplementedError(f"_regroup: {tuple(pl)} splits another dim than the rows")
    n = math.prod(mesh.size(j) for j, q in enumerate(pl) if q.is_shard())
    if t.shape[0] % n == 0 and shape[0] % n == 0:
        local = t.to_local().reshape(shape[0] // n, *shape[1:])
        return DTensor.from_local(local, mesh, pl, run_check=False)
    return t.redistribute(mesh, [Replicate()] * len(pl)).reshape(shape)
