"""Plain reference of the decoder family (dense GQA and top-k MoE), in
float32, and the weights both sides get.

The weights are made here from the seed, one (leaf, layer) slice at a
time, each from a generator of its own, so that any slice can be made again
alone: the harness hands the stacked tree to the program, and this module
makes each layer again when it computes the reference.  The layout is the
one the program reads (``embed.table`` (V, d); per layer ``attn.wq`` (d, H,
hd), ``wk``/``wv`` (d, Hkv, hd), ``wo`` (H, hd, d); ``mlp.w_gate``/``w_up``
(d, f), ``w_down`` (f, d); or ``moe.router`` (d, E) float32 and the expert
stacks (E, d, f), (E, f, d); ``head.w`` (d, V)).

The reference follows the published architecture: pre-norm RMSNorm blocks,
rotary embedding (half-split), causal grouped-query attention, a SwiGLU MLP
or a mixture of SwiGLU experts with top-k routing, a final RMSNorm and an
untied head.  Departures that the program makes and the configuration file
records (``departures``) are followed here, so that both compute one model:
top-k weights renormalised, capacity-bounded expert groups.

Routing is a discrete choice, and near-tied experts swap under any change
of rounding.  So a comparison can hand this model the experts that the
program chose (``routes``; a training step's, or a served sequence's in
the program's forward pass), as a served model's tokens are handed to it:
each choice is judged against this model's own router (``route_gap``, the
widest gap by which a chosen expert's router logit lies below the k-th
best), and the logits and gradients are then those of one routing.

Every matrix product goes through ``mm``: :func:`matmul` (float32) for the
reference, :func:`fp8_matmul` (operands rounded to float8 e4m3 with one
scale per row or column) for the control.  This module imports only torch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_MIX = 0x9E3779B97F4A7C15
_MASK = (1 << 63) - 1


def dims(conf: dict) -> dict:
    d = conf["hidden_size"]
    H = conf["num_attention_heads"]
    out = {"d": d, "H": H, "Hkv": conf["num_key_value_heads"],
           "hd": conf.get("head_dim") or d // H, "L": conf["num_hidden_layers"],
           "V": conf["vocab_size"], "f": conf["intermediate_size"],
           "eps": conf["rms_norm_eps"], "theta": float(conf["rope_theta"])}
    if "num_experts" in conf:
        out.update(E=conf["num_experts"], k=conf["num_experts_per_tok"],
                   cf=conf["capacity_factor"], group=conf["tokens_per_group"])
    return out


def leaf_specs(conf: dict) -> list:
    """``(path, shape of one slice, scale or "ones", per_layer, float32)`` for
    every leaf, in a fixed order; ``per_layer`` leaves are stacked on a
    leading layer dim, and ``float32`` leaves stay float32 whatever the
    weights' dtype (the router)."""
    m = dims(conf)
    d, H, Hkv, hd, f, V = m["d"], m["H"], m["Hkv"], m["hd"], m["f"], m["V"]
    specs = [
        (("embed", "table"), (V, d), 0.02, False, False),
        (("layers", "ln_attn", "scale"), (d,), "ones", True, False),
        (("layers", "attn", "wq"), (d, H, hd), d ** -0.5, True, False),
        (("layers", "attn", "wk"), (d, Hkv, hd), d ** -0.5, True, False),
        (("layers", "attn", "wv"), (d, Hkv, hd), d ** -0.5, True, False),
        (("layers", "attn", "wo"), (H, hd, d), (H * hd) ** -0.5, True, False),
        (("layers", "ln_mlp", "scale"), (d,), "ones", True, False),
    ]
    if "num_experts" in conf:
        E = m["E"]
        specs += [
            (("layers", "moe", "router"), (d, E), d ** -0.5, True, True),
            (("layers", "moe", "w_gate"), (E, d, f), d ** -0.5, True, False),
            (("layers", "moe", "w_up"), (E, d, f), d ** -0.5, True, False),
            (("layers", "moe", "w_down"), (E, f, d), f ** -0.5, True, False),
        ]
    else:
        specs += [
            (("layers", "mlp", "w_gate"), (d, f), d ** -0.5, True, False),
            (("layers", "mlp", "w_up"), (d, f), d ** -0.5, True, False),
            (("layers", "mlp", "w_down"), (f, d), f ** -0.5, True, False),
        ]
    specs += [
        (("final_norm", "scale"), (d,), "ones", False, False),
        (("head", "w"), (d, V), d ** -0.5, False, False),
    ]
    return specs


def slice_seed(seed: int, leaf: int, layer: int) -> int:
    return (int(seed) * _MIX + leaf * 1_000_003 + layer * 7_919 + 1) & _MASK


def fill_slice(t: torch.Tensor, scale, seed: int, leaf: int, layer: int) -> torch.Tensor:
    """Fill ``t`` (one leaf's slice of one layer) in place."""
    if scale == "ones":
        return t.fill_(1.0)
    g = torch.Generator(device=t.device)
    g.manual_seed(slice_seed(seed, leaf, layer))
    return t.normal_(generator=g).mul_(scale)


def make_weights(conf: dict, seed: int, device, dtype: torch.dtype) -> dict:
    """The whole stacked tree in the program's layout, in ``dtype``."""
    L = conf["num_hidden_layers"]
    tree: dict = {}
    for i, (path, shape, scale, per_layer, f32) in enumerate(leaf_specs(conf)):
        dt = torch.float32 if f32 else dtype
        if per_layer:
            t = torch.empty((L, *shape), dtype=dt, device=device)
            for layer in range(L):
                fill_slice(t[layer], scale, seed, i, layer)
        else:
            t = fill_slice(torch.empty(shape, dtype=dt, device=device), scale, seed, i, 0)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return tree


def make_slice(conf: dict, seed: int, path: tuple, layer: int, device,
               dtype: torch.dtype) -> torch.Tensor:
    """One leaf's slice of one layer (layer 0 for an unstacked leaf), made
    again exactly as :func:`make_weights` made it."""
    for i, (p, shape, scale, _, f32) in enumerate(leaf_specs(conf)):
        if p == path:
            t = torch.empty(shape, dtype=torch.float32 if f32 else dtype, device=device)
            return fill_slice(t, scale, seed, i, layer)
    raise KeyError(path)


def layer_weights(conf, seed, layer, device, dtype) -> dict:
    """Layer ``layer``'s weights, made in ``dtype`` and widened to float32,
    keyed by the last two parts of their paths (``attn.wq``)."""
    return {".".join(p[1:]): make_slice(conf, seed, p, layer, device, dtype).float()
            for p, *_, per_layer, _f in leaf_specs(conf) if per_layer}


# --------------------------------------------------------------------------
# matrix products
# --------------------------------------------------------------------------


def matmul(a, b):
    return torch.matmul(a, b)


def _fp8(x, dim):
    """x rounded to float8 e4m3 with one scale per vector along ``dim``."""
    scale = x.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _Fp8MatMul(torch.autograd.Function):
    """a @ b with both operands in e4m3 (a per row, b per column), and the
    backward's two products the same way."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(_fp8(a, -1), _fp8(b, -2))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = torch.matmul(_fp8(g, -1), _fp8(b.transpose(-1, -2), -2))
        gb = torch.matmul(_fp8(a.transpose(-1, -2), -1), _fp8(g, -2))
        # broadcast batch dims back to each operand's shape
        while ga.ndim > a.ndim:
            ga = ga.sum(0)
        while gb.ndim > b.ndim:
            gb = gb.sum(0)
        return ga, gb


def fp8_matmul(a, b):
    return _Fp8MatMul.apply(a, b)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, positions, theta):
    """x (B, S, heads, hd); positions (S,) int.  Angles in float64."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                          device=x.device) / hd))
    ang = positions.to(torch.float64)[:, None] * freqs[None, :]
    cos = torch.cos(ang).to(x.dtype)[None, :, None, :]
    sin = torch.sin(ang).to(x.dtype)[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(x, w, m, mm, q_chunk=512):
    """Causal grouped-query attention of x (B, S, d), queries in chunks."""
    B, S, d = x.shape
    H, Hkv, hd = m["H"], m["Hkv"], m["hd"]
    pos = torch.arange(S, device=x.device)
    q = rope(mm(x, w["attn.wq"].reshape(d, H * hd)).view(B, S, H, hd), pos, m["theta"])
    k = rope(mm(x, w["attn.wk"].reshape(d, Hkv * hd)).view(B, S, Hkv, hd), pos, m["theta"])
    v = mm(x, w["attn.wv"].reshape(d, Hkv * hd)).view(B, S, Hkv, hd)
    rep = H // Hkv   # query head h reads kv head h // rep
    k = k.repeat_interleave(rep, dim=2).permute(0, 2, 3, 1)   # (B, H, hd, S)
    v = v.repeat_interleave(rep, dim=2).transpose(1, 2)       # (B, H, S, hd)
    q = q.transpose(1, 2)                                     # (B, H, S, hd)
    outs = []
    for q0 in range(0, S, q_chunk):
        q1 = min(S, q0 + q_chunk)
        s = mm(q[:, :, q0:q1], k[..., :q1]) / math.sqrt(hd)   # (B, H, c, q1)
        mask = torch.arange(q1, device=x.device)[None, :] > \
            torch.arange(q0, q1, device=x.device)[:, None]
        p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
        outs.append(mm(p, v[:, :, :q1]))
    o = torch.cat(outs, dim=2).transpose(1, 2).reshape(B, S, H * hd)
    return mm(o, w["attn.wo"].reshape(H * hd, d))


def swiglu(x, wg, wu, wd, mm):
    return mm(F.silu(mm(x, wg)) * mm(x, wu), wd)


def group_count(tokens: int, per_group: int) -> int:
    g = max(1, tokens // max(per_group, 1))
    while tokens % g:
        g -= 1
    return g


def moe(x, w, m, mm, route=None, seen=None):
    """Top-k mixture of SwiGLU experts of x (B, S, d), tokens in groups of
    about ``tokens_per_group``, each expert taking at most C of a group's
    (token, choice) pairs, earlier pairs first.  Returns (y, aux).

    ``route`` (G, Tg, k) expert ids, where given, are the experts chosen in
    place of this router's top k; ``seen`` (a dict), where given, takes the
    experts used (``route``) and, of a given route, ``route_gap``."""
    B, S, d = x.shape
    E, k = m["E"], m["k"]
    T = B * S
    G = group_count(T, m["group"])
    Tg = T // G
    C = Tg if Tg <= 256 else math.ceil(Tg * k / E * m["cf"])
    xf = x.reshape(G, Tg, d)
    scores = torch.matmul(xf, w["moe.router"])                       # router: float32
    probs = torch.softmax(scores, dim=-1)
    if route is None:
        top_w, top_e = torch.topk(probs, k, dim=-1)
    else:
        top_e = route.to(device=x.device, dtype=torch.long).reshape(G, Tg, k)
        top_w = probs.gather(-1, top_e)
        if seen is not None:
            with torch.no_grad():
                kth = scores.topk(k, dim=-1).values[..., -1]
                gap = float((kth - scores.gather(-1, top_e).min(-1).values).max())
            seen["route_gap"] = max(seen.get("route_gap", 0.0), gap)
    if seen is not None:
        seen["route"] = top_e.detach()
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)
    pair_e = top_e.reshape(G, Tg * k)
    onehot = F.one_hot(pair_e, E)
    rank = (onehot.cumsum(1) * onehot).sum(-1) - 1                     # rank in its expert
    weight = (top_w.reshape(G, Tg * k) * (rank < C)).to(x.dtype)
    ys = []
    for g in range(G):
        y = torch.zeros((Tg, d), dtype=x.dtype, device=x.device)
        for e in range(E):
            pairs = torch.nonzero((pair_e[g] == e) & (rank[g] < C)).flatten()
            if pairs.numel() == 0:
                continue
            tok = pairs // k
            out = swiglu(xf[g, tok], w["moe.w_gate"][e], w["moe.w_up"][e],
                         w["moe.w_down"][e], mm)
            y = y.index_add(0, tok, out * weight[g, pairs][:, None])
        ys.append(y)
    density = F.one_hot(top_e[..., 0], E).float().mean(dim=(0, 1))
    aux = E * (density * probs.mean(dim=(0, 1))).sum()
    return torch.stack(ys).reshape(B, S, d), aux


def block(x, w, m, mm, route=None, seen=None):
    """One pre-norm layer: (x, aux); ``route`` and ``seen`` as :func:`moe`'s."""
    x = x + attention(rmsnorm(x, w["ln_attn.scale"], m["eps"]), w, m, mm)
    h = rmsnorm(x, w["ln_mlp.scale"], m["eps"])
    if "E" in m:
        y, aux = moe(h, w, m, mm, route, seen)
    else:
        y, aux = swiglu(h, w["mlp.w_gate"], w["mlp.w_up"], w["mlp.w_down"], mm), None
    return x + y, aux


@torch.no_grad()
def logits(conf: dict, seed: int, seqs: list, device, dtype, mm=matmul, routes=None,
           seen=None) -> list:
    """float32 logits (S, V) of each token sequence in ``seqs`` (1-D int
    tensors), every sequence whole, no cache; the weights made in ``dtype``
    (as served) and widened, one layer at a time.  A mixture of experts
    takes, where given, ``routes[i]`` (one (G, Tg, k) tensor per layer) as
    sequence i's experts; ``seen`` (a dict), where given, takes the experts
    used (``routes``: per sequence, per layer, on the host) and, of given
    routes, the widest ``route_gap``."""
    m = dims(conf)
    emb = make_slice(conf, seed, ("embed", "table"), 0, device, dtype)
    xs = [emb[s.to(device).long()].float()[None] for s in seqs]
    del emb
    if seen is not None and "E" in m:
        seen["routes"] = [[] for _ in seqs]
    if routes is not None and any(len(r) != m["L"] for r in routes):
        raise ValueError(f"routes of {[len(r) for r in routes]} routing calls for "
                         f"{m['L']} layers")
    for layer in range(m["L"]):
        w = layer_weights(conf, seed, layer, device, dtype)
        for i, x in enumerate(xs):
            s = {} if seen is not None else None
            xs[i] = block(x, w, m, mm, routes[i][layer] if routes is not None else None, s)[0]
            if s:
                seen["routes"][i].append(s["route"].cpu())
                seen["route_gap"] = max(seen.get("route_gap", 0.0), s.get("route_gap", 0.0))
        del w
    fn = make_slice(conf, seed, ("final_norm", "scale"), 0, device, dtype).float()
    head = make_slice(conf, seed, ("head", "w"), 0, device, dtype).float()
    return [mm(rmsnorm(x, fn, m["eps"]), head)[0] for x in xs]


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------


def _walk(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def train_loss(params: dict, batch: dict, conf: dict, mm=matmul, aux_weight=0.01,
               routes=None, seen=None):
    """Mean token cross-entropy (+ ``aux_weight`` x the layers' mean MoE
    aux loss) of float32 ``params`` on ``batch`` {tokens, labels} (B, S),
    each layer recomputed in the backward pass.  ``routes`` (one per layer)
    and ``seen`` (a dict: ``routes``, one per layer, and ``route_gap``) as
    :func:`moe`'s."""
    from torch.utils.checkpoint import checkpoint

    m = dims(conf)
    x = params["embed"]["table"][batch["tokens"].long()]
    layer_paths = [p for p, *_, per_layer, _f in leaf_specs(conf) if per_layer]
    aux_sum = torch.zeros((), device=x.device)
    for layer in range(m["L"]):
        w = {".".join(p[1:]): _walk(params, p)[layer] for p in layer_paths}
        r = routes[layer] if routes is not None else None
        s = {} if seen is not None else None

        def run(x, w=w, r=r, s=s):
            y, aux = block(x, w, m, mm, r, s)
            return y, (aux if aux is not None else torch.zeros((), device=x.device))

        x, aux = checkpoint(run, x, use_reentrant=False)
        aux_sum = aux_sum + aux
        if s:
            seen.setdefault("routes", []).append(s["route"])
            seen["route_gap"] = max(seen.get("route_gap", 0.0), s.get("route_gap", 0.0))
    x = rmsnorm(x, params["final_norm"]["scale"], m["eps"])
    lg = mm(x, params["head"]["w"])
    ce = (torch.logsumexp(lg, -1)
          - torch.gather(lg, -1, batch["labels"].long()[..., None])[..., 0]).mean()
    if "E" in m:
        return ce + aux_weight * aux_sum / m["L"]
    return ce


def leaf_paths(conf: dict) -> list:
    return [p for p, *_ in leaf_specs(conf)]


def train(conf: dict, seed: int, batches: list, opt: dict, device, mm=matmul,
          loss_fn=train_loss, keep_grads: bool = False, routes=None) -> dict:
    """AdamW with global-norm clipping over ``len(batches)`` steps from the
    weights of ``seed`` (float32).  Returns the losses, the per-leaf norms
    of the first step's clipped gradient and of the parameters' change
    over all the steps (leaves in :func:`leaf_paths` order), and with
    ``keep_grads`` that gradient itself, leaf by leaf on the host.  A
    mixture of experts also returns the experts it used (``routes``: per
    step, per layer, on the host); given ``routes``, it takes those, and
    returns the widest ``route_gap`` of them."""
    paths = leaf_paths(conf)
    params = make_weights(conf, seed, device, torch.float32)
    leaves = [_walk(params, p) for p in paths]
    for t in leaves:
        t.requires_grad_(True)
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    losses, grad_norms = [], None
    b1, b2 = opt["b1"], opt["b2"]
    used, gap = [], 0.0
    for step, batch in enumerate(batches, start=1):
        seen: dict = {}
        loss = loss_fn(params, batch, conf, mm, seen=seen,
                       routes=routes[step - 1] if routes is not None else None)
        used.append([r.cpu() for r in seen.get("routes", ())])
        gap = max(gap, seen.get("route_gap", 0.0))
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            gnorm = torch.sqrt(sum(g.double().square().sum() for g in grads))
            scale = min(opt["grad_clip"] / (float(gnorm) + 1e-9), 1.0)
            lr = opt["lr"] * min(step / max(opt["warmup_steps"], 1), 1.0)
            c1, c2 = 1 - b1 ** step, 1 - b2 ** step
            if grad_norms is None:
                grad_norms = [float(g.double().norm()) * scale for g in grads]
                if keep_grads:
                    first = [(g * scale).cpu() for g in grads]
            for p, m_, v_, g in zip(leaves, mu, nu, grads):
                g = g * scale
                m_.mul_(b1).add_(g, alpha=1 - b1)
                v_.mul_(b2).add_(g.square(), alpha=1 - b2)
                upd = (m_ / c1) / ((v_ / c2).sqrt() + opt["eps"]) + opt["weight_decay"] * p
                p.sub_(lr * upd)
        del grads
    changes = []
    with torch.no_grad():
        for i, (p, t) in enumerate(zip(paths, leaves)):
            changes.append(change_norm(conf, seed, p, t))
    out = {"losses": losses, "grad_norms": grad_norms, "change_norms": changes}
    if "E" in dims(conf):
        out["routes"] = used
        if routes is not None:
            out["route_gap"] = gap
    if keep_grads:
        out["first_grads"] = first
    return out


@torch.no_grad()
def relative_diffs(got: list, want: list, device) -> list:
    """Per leaf ||got - want|| / ||want|| of two lists of host tensors,
    computed on ``device`` one leaf at a time."""
    out = []
    for a, b in zip(got, want):
        a, b = a.to(device), b.to(device)
        out.append(float((a - b).double().norm() / b.double().norm().clamp(min=1e-30)))
    return out


@torch.no_grad()
def change_norm(conf: dict, seed: int, path: tuple, now: torch.Tensor) -> float:
    """Norm of ``now`` (a float32 leaf, stacked or not) minus the leaf as
    :func:`make_weights` made it, made again one layer at a time."""
    per_layer = path[0] == "layers"
    total = 0.0
    for layer in range(now.shape[0] if per_layer else 1):
        cur = now[layer] if per_layer else now
        first = make_slice(conf, seed, path, layer, now.device, torch.float32)
        total += float((cur.detach().float() - first).double().square().sum())
    return math.sqrt(total)
