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

import math

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import moe_apply, moe_init


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked param (or cache) tree, as views."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def layer_apply(p, x, cfg: ModelConfig, *, positions, cache=None,
                cache_pos=None, causal=True, window=None):
    """Pre-norm block: x + attn(ln(x)); x + mlp(ln(x)), the MLP being the
    MoE layer when ``cfg.moe`` is set.  Returns (x, new_cache).  (The
    reference also returns the MoE aux loss; ``moe_apply`` returns it, and
    the port has no training step to use it yet.)"""
    dt = torch_dtype(cfg.dtype)
    h = L.rmsnorm(p["ln_attn"], x, cfg.norm_eps)
    attn_out, new_cache = L.attention_apply(
        p["attn"], h, dtype=dt,
        rope_theta=cfg.rope_theta, positions=positions, causal=causal,
        window=window, cache=cache, cache_pos=cache_pos,
    )
    x = x + attn_out
    h = L.rmsnorm(p["ln_mlp"], x, cfg.norm_eps)
    if cfg.moe is not None:
        mlp_out, _ = moe_apply(p["moe"], h, cfg.moe, dt)
    else:
        mlp_out = L.mlp_apply(p["mlp"], h, cfg.mlp, dt)
    return x + mlp_out, new_cache


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


def _logits(p, x, cfg: ModelConfig, dt):
    x = L.rmsnorm(p["final_norm"], x, cfg.norm_eps)
    head = p["head"] if "head" in p else {"w": p["embed"]["table"].T}
    return L.unembed(head, x, dt)


def _embed_inputs(p, batch, cfg: ModelConfig, dt):
    """tokens (+ patch_embeds for VLM) -> (B, S, d) embeddings."""
    x = L.embed(p["embed"], batch["tokens"], dt)
    if cfg.vlm is not None:
        patches = L.dense(p["patch_proj"], batch["patch_embeds"].to(dt), dt)
        x = torch.cat([patches, x], dim=1)   # vision prefix
    return x


def lm_forward(p, batch, cfg: ModelConfig, *, window=None, return_cache=False):
    """Train/prefill forward: full-sequence causal attention (keys j > i -
    window too when ``window``), over the vision prefix and the tokens for
    a VLM.

    Returns (logits, caches); ``caches`` are stacked (L, B, S, Hkv, hd)
    ``{k, v}`` when ``return_cache`` (prefill), else None.  (The reference
    also returns the mean MoE aux loss, which serving does not read.)
    """
    dt = torch_dtype(cfg.dtype)
    x = _embed_inputs(p, batch, cfg, dt)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    caches = []
    for i in range(cfg.num_layers):
        x, cache = layer_apply(_layer(p["layers"], i), x, cfg, positions=positions,
                               window=window)
        if return_cache:
            caches.append(cache)
    stacked = None
    if return_cache:
        stacked = {n: torch.stack([c[n] for c in caches]) for n in ("k", "v")}
    return _logits(p, x, cfg, dt), stacked


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


def lm_decode_step(p, cache, batch, cfg: ModelConfig, *, window=None):
    """One decode step: ``batch = {tokens: (B, 1), pos: scalar or (B,)}``;
    ``window`` for a ring cache (:func:`lm_init_cache` with the same
    window).

    The new token's K/V are written into ``cache`` in place (the reference
    donates the cache buffers to the same effect).  Returns
    (logits (B, 1, V), cache).
    """
    dt = torch_dtype(cfg.dtype)
    x = L.embed(p["embed"], batch["tokens"], dt)
    pos = torch.as_tensor(batch["pos"], device=x.device)
    if pos.ndim == 0:
        positions = pos.reshape(1).to(torch.int32)      # (t=1,) synchronous
    else:
        positions = pos[:, None].to(torch.int32)        # (B, t=1) per-slot
    for i in range(cfg.num_layers):
        x, _ = layer_apply(
            _layer(p["layers"], i), x, cfg, positions=positions,
            cache=_layer(cache, i), cache_pos=pos, window=window,
        )
    return _logits(p, x, cfg, dt), cache
