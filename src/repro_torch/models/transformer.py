"""Decoder-only transformer LM, dense, MoE and VLM families (port of
``repro.models.transformer``).

Parameters keep the reference's layer-stacked layout (a leading
``num_layers`` dim on every layer leaf), so a reference param tree converts
leaf by leaf with no transposes.  The stack is consumed by a Python loop
(the reference uses ``lax.scan``); PyTorch runs it eagerly.  A VLM's patch
embeddings pass through ``patch_proj`` into a prefix before the token
embeddings; ``window`` selects sliding-window attention over a ring cache;
``cfg.kv_quant`` an int8 cache with one float32 scale per vector.
"""

from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import expert_specs, moe_apply, moe_init
from repro_torch.core.dtensor import is_dtensor, lead


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked param (or cache) tree, as views."""
    return {k: _layer(v, i) if isinstance(v, dict) else lead(v, i) for k, v in tree.items()}


def remat(fn, cfg: ModelConfig, x):
    """``fn`` under ``torch.utils.checkpoint`` (its activations recomputed
    in the backward pass) when ``cfg.remat`` asks for it and autograd
    records ``x``: the reference's ``jax.checkpoint`` of each layer
    (``_remat_wrap``; every policy but "none" saves nothing inside the
    layer here).  Serving, under no grad, calls ``fn`` as it is."""
    if cfg.remat == "none" or not (torch.is_grad_enabled() and x.requires_grad):
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False)


def layer_apply(p, x, cfg: ModelConfig, *, positions, cache=None,
                cache_pos=None, causal=True, window=None, sharder=None):
    """Pre-norm block: x + attn(ln(x)); x + mlp(ln(x)), the MLP being the
    MoE layer when ``cfg.moe`` is set.  Returns (x, new_cache, aux), aux the
    MoE load-balance loss (0 without MoE)."""
    dt = torch_dtype(cfg.dtype)
    h = _gathered(L.rmsnorm(p["ln_attn"], x, cfg.norm_eps), sharder)
    attn_out, new_cache = L.attention_apply(
        p["attn"], h, dtype=dt,
        rope_theta=cfg.rope_theta, positions=positions, causal=causal,
        window=window, cache=cache, cache_pos=cache_pos, sharder=sharder,
    )
    x = x + attn_out
    h = _gathered(L.rmsnorm(p["ln_mlp"], x, cfg.norm_eps), sharder)
    if cfg.moe is not None:
        mlp_out, aux = moe_apply(p["moe"], h, cfg.moe, dt, sharder=sharder)
    else:
        mlp_out = L.mlp_apply(p["mlp"], h, cfg.mlp, dt, sharder=sharder)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = x + mlp_out
    if sharder is not None:
        x = sharder.act_btd(x)
    return x, new_cache, aux


# --------------------------------------------------------------------------
# full model
# --------------------------------------------------------------------------


def lm_init(cfg: ModelConfig, *, device, generator: torch.Generator):
    """Random parameters with the reference's shapes and scales, drawn from
    ``generator`` (a generator on ``device``) straight into ``param_dtype``
    tensors on the device, one layer at a time: no float32 copy of a
    bfloat16 model is ever built."""
    dt = torch_dtype(cfg.param_dtype)
    d, V = cfg.d_model, cfg.vocab_size

    def normal_(t, scale):
        return t.normal_(generator=generator).mul_(scale)

    layers = layers_init(cfg, cfg.num_layers, device=device, generator=generator)
    p = {
        "embed": {"table": normal_(torch.empty((V, d), dtype=dt, device=device), 0.02)},
        "layers": layers,
        "final_norm": {"scale": torch.ones(d, dtype=dt, device=device)},
    }
    if not cfg.tie_embeddings:
        p["head"] = {"w": normal_(torch.empty((d, V), dtype=dt, device=device), d**-0.5)}
    if cfg.vlm is not None:
        p["patch_proj"] = {"w": normal_(torch.empty((d, d), dtype=dt, device=device), d**-0.5)}
    return p


def layers_init(cfg: ModelConfig, n: int, *, device, generator: torch.Generator):
    """``n`` transformer layers' params stacked on a leading dim, drawn as
    :func:`lm_init` draws them (one layer at a time, in ``param_dtype``)."""
    dt = torch_dtype(cfg.param_dtype)
    d = cfg.d_model
    H, Hk, hd, f = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_ff

    def empty(*shape):
        return torch.empty(shape, dtype=dt, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    def normal_(t, scale):
        return t.normal_(generator=generator).mul_(scale)

    attn = {"wq": empty(n, d, H, hd), "wk": empty(n, d, Hk, hd),
            "wv": empty(n, d, Hk, hd), "wo": empty(n, H, hd, d)}
    scales = {"wq": d**-0.5, "wk": d**-0.5, "wv": d**-0.5,
              "wo": 1.0 / math.sqrt(H * hd)}
    if cfg.qkv_bias:
        attn["bq"] = torch.zeros((n, H, hd), dtype=dt, device=device)
        attn["bk"] = torch.zeros((n, Hk, hd), dtype=dt, device=device)
        attn["bv"] = torch.zeros((n, Hk, hd), dtype=dt, device=device)
    mlp = {}
    if cfg.moe is None:
        mlp = {"w_up": empty(n, d, f), "w_down": empty(n, f, d)}
        scales.update(w_up=d**-0.5, w_down=f**-0.5)
        if cfg.mlp == "swiglu":
            mlp["w_gate"] = empty(n, d, f)
            scales["w_gate"] = d**-0.5
    for i in range(n):
        for name, scale in scales.items():
            normal_((attn if name in attn else mlp)[name][i], scale)
    layers = {"ln_attn": {"scale": ones(n, d)}, "attn": attn,
              "ln_mlp": {"scale": ones(n, d)}}
    if cfg.moe is None:
        layers["mlp"] = mlp
    else:
        layers["moe"] = _stack(n, lambda: moe_init(d, cfg.moe, dt, device=device,
                                                   generator=generator))
    return layers


def _stack(n: int, make):
    """Stack ``n`` draws of a layer's param tree (``make()``), one layer at a
    time into preallocated (n, ...) tensors: one layer is the only
    temporary."""
    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return t.new_empty((n, *t.shape))

    def fill(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                fill(dst[k], v, i)
            else:
                dst[k][i].copy_(v)

    first = make()
    out = alloc(first)
    fill(out, first, 0)
    for i in range(1, n):
        fill(out, make(), i)
    return out


def _gathered(h, sharder):
    """A normed residual stream (B, S, d) with its sequence whole, as the
    projections read it: under sequence parallelism (``plan.seq_shard``)
    the stream between blocks is split over the model axis, and the
    projections gather it (the reference's GSPMD does the same); without
    it this changes nothing."""
    return sharder.constrain(h, ["batch", None, None]) if sharder is not None else h


def _logits(p, x, cfg: ModelConfig, dt, sharder=None):
    x = _gathered(L.rmsnorm(p["final_norm"], x, cfg.norm_eps), sharder)
    head = p["head"] if "head" in p else {"w": p["embed"]["table"].T}
    logits = L.unembed(head, x, dt)
    return sharder.logits(logits) if sharder is not None else logits


def _embed_inputs(p, batch, cfg: ModelConfig, dt, sharder=None):
    """tokens (+ patch_embeds for VLM) -> (B, S, d) embeddings."""
    x = L.embed(p["embed"], batch["tokens"], dt)
    if cfg.vlm is not None:
        patches = L.dense(p["patch_proj"], batch["patch_embeds"].to(dt), dt)
        x = torch.cat([patches, x], dim=1)   # vision prefix
    return sharder.act_btd(x) if sharder is not None else x


def lm_forward(p, batch, cfg: ModelConfig, *, window=None, return_cache=False,
               sharder=None):
    """Train/prefill forward: full-sequence causal attention (keys j > i -
    window too when ``window``), over the vision prefix and the tokens for
    a VLM.

    Returns (logits, caches, aux_mean); ``caches`` are stacked (L, B, S,
    Hkv, hd) ``{k, v}`` when ``return_cache`` (prefill), else None; aux is
    the MoE load-balance loss averaged over the layers.  Each layer runs
    under :func:`remat` when training asks for it.
    """
    dt = torch_dtype(cfg.dtype)
    x = _embed_inputs(p, batch, cfg, dt, sharder)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    caches = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.num_layers):
        x, cache, a = remat(layer_apply, cfg, x)(_layer(p["layers"], i), x, cfg,
                                                 positions=positions, window=window,
                                                 sharder=sharder)
        aux = aux + a
        if return_cache:
            caches.append(cache)
    stacked = None
    if return_cache:
        stacked = {n: torch.stack([c[n] for c in caches]) for n in ("k", "v")}
    return _logits(p, x, cfg, dt, sharder), stacked, aux / cfg.num_layers


def lm_loss(p, batch, cfg: ModelConfig, *, aux_weight=0.01, sharder=None):
    """Mean token cross-entropy plus ``aux_weight`` times the MoE aux loss;
    a VLM's vision prefix carries no labels (-100).  Returns (loss,
    {"ce", "aux"})."""
    logits, _, aux = lm_forward(p, batch, cfg, sharder=sharder)
    labels = batch["labels"]
    if cfg.vlm is not None:
        pad = torch.full((labels.shape[0], cfg.vlm.num_patches), -100,
                         dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    loss = L.cross_entropy(logits, labels)
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


def lm_init_cache(cfg: ModelConfig, batch_size: int, max_len: int, *, device,
                  window=None):
    """Zero-filled KV cache ``{k, v}`` of shape (L, B, S, Hkv, hd) in the
    compute dtype, S = max_len, or a ring of S = min(max_len, window) slots
    when windowed.  With ``cfg.kv_quant``: int8 ``k``/``v`` and float32
    ``k_scale``/``v_scale`` (L, B, S, Hkv, 1)."""
    S = min(max_len, window) if window is not None else max_len
    shape = (cfg.num_layers, batch_size, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    if cfg.kv_quant:
        sshape = shape[:-1] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
                "v_scale": torch.zeros(sshape, dtype=torch.float32, device=device)}
    dt = torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def decode_positions(pos, device):
    """A decode batch's ``pos`` (a scalar or (B,), a DTensor on a mesh) as a
    plain tensor on ``device``."""
    return torch.as_tensor(pos.full_tensor() if is_dtensor(pos) else pos, device=device)


def query_positions(pos):
    """(t=1,) positions of a synchronous step, (B, t=1) of a per-slot one."""
    if pos.ndim == 0:
        return pos.reshape(1).to(torch.int32)
    return pos[:, None].to(torch.int32)


def lm_decode_step(p, cache, batch, cfg: ModelConfig, *, window=None, sharder=None):
    """One decode step: ``batch = {tokens: (B, 1), pos: scalar or (B,)}``;
    ``window`` for a ring cache (:func:`lm_init_cache` with the same
    window).

    The new token's K/V are written into ``cache`` in place (the reference
    donates the cache buffers to the same effect).  Returns
    (logits (B, 1, V), cache).
    """
    dt = torch_dtype(cfg.dtype)
    x = L.embed(p["embed"], batch["tokens"], dt)
    if sharder is not None:
        x = sharder.act_btd(x)
    pos = decode_positions(batch["pos"], x.device)
    positions = query_positions(pos)
    for i in range(cfg.num_layers):
        x, _, _ = layer_apply(
            _layer(p["layers"], i), x, cfg, positions=positions,
            cache=_layer(cache, i), cache_pos=pos, window=window, sharder=sharder,
        )
    return _logits(p, x, cfg, dt, sharder), cache


# --------------------------------------------------------------------------
# sharding rules for the param tree (mirrors lm_init's structure)
# --------------------------------------------------------------------------


def lm_param_rules(cfg: ModelConfig):
    """Rules tree (same structure as params) for ``Sharder.spec``.

    Leading dim of every stacked layer leaf is the layer dim (never
    sharded); weights shard output-column over "model" and, under FSDP,
    input-row over the data axes.
    """
    attn = {
        "wq": [None, ["fsdp"], "model", None],
        "wk": [None, ["fsdp"], "model", None],
        "wv": [None, ["fsdp"], "model", None],
        "wo": [None, "model", None, ["fsdp"]],
    }
    if cfg.qkv_bias:
        attn.update({
            "bq": [None, "model", None],
            "bk": [None, "model", None],
            "bv": [None, "model", None],
        })
    layer = {
        "ln_attn": {"scale": [None, None]},
        "ln_mlp": {"scale": [None, None]},
        "attn": attn,
    }
    if cfg.moe is not None:
        moe_rules = {k: [None] + v for k, v in expert_specs(None, cfg.moe).items()}
        if cfg.moe.num_shared_experts:
            moe_rules["shared"] = {
                "w_gate": [None, ["fsdp"], "model"],
                "w_up": [None, ["fsdp"], "model"],
                "w_down": [None, "model", ["fsdp"]],
                "gate": [None, None, None],
            }
        layer["moe"] = moe_rules
    else:
        mlp = {
            "w_up": [None, ["fsdp"], "model"],
            "w_down": [None, "model", ["fsdp"]],
        }
        if cfg.mlp == "swiglu":
            mlp["w_gate"] = [None, ["fsdp"], "model"]
        layer["mlp"] = mlp
    rules = {
        "embed": {"table": [["fsdp"], "model"]},
        "layers": layer,
        "final_norm": {"scale": [None]},
    }
    if not cfg.tie_embeddings:
        rules["head"] = {"w": [["fsdp"], "model"]}
    if cfg.vlm is not None:
        rules["patch_proj"] = {"w": [["fsdp"], "model"]}
    return rules


def lm_cache_rules(cfg: ModelConfig | None = None, model_axis_size: int = 16):
    """KV-cache sharding: heads over the model axis when they divide it
    (zamba 32, olmoe/qwen2moe 16); otherwise the cache *sequence* dim is
    sharded (flash-decode-style: each shard attends its positions and the
    shards' softmax states merge by their rows' log-sum-exp,
    ``kernels.ops``).  kv=8/20 archs take the seq path."""
    if cfg is not None and cfg.num_kv_heads % model_axis_size == 0:
        rule = [None, "batch", None, "model", None]
    else:
        rule = [None, "batch", "model", None, None]
    rules = {"k": list(rule), "v": list(rule)}
    if cfg is not None and cfg.kv_quant:
        srule = rule[:-1] + [None]
        rules["k_scale"] = list(srule)
        rules["v_scale"] = list(srule)
    return rules
