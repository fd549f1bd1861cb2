"""Whisper-style encoder-decoder, the audio backbone (port of
``repro.models.whisper``).

The conv/log-mel frontend is a stub, as in the reference: the batch carries
precomputed encoder frame embeddings (B, frames, d_model).  The backbone:
LayerNorm blocks, non-causal encoder self-attention over sinusoidal
positions, a decoder with causal self-attention, cross-attention over the
encoder output and GELU MLPs.  The reference's documented deviation is kept:
decoder positions use RoPE instead of a learned table.

Params keep the reference's stacked layout (``enc_layers`` and
``dec_layers`` with a leading layer dim), consumed by Python loops.  The
cache is ``{"self": {k, v}, "cross": {k, v}}``: decode writes its one new
position into the self cache in place and reads the cross cache (the
encoder's K/V from prefill) as a static cache.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def sinusoids(length: int, channels: int) -> torch.Tensor:
    """(length, channels) float32 sinusoidal positions, computed in float64
    numpy and rounded once, as the reference computes them."""
    log_timescale = np.log(10000) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return torch.from_numpy(np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32))


def whisper_init(cfg: ModelConfig, *, device, generator: torch.Generator):
    """Random parameters with the reference's tree, shapes and scales, drawn
    from ``generator`` (a generator on ``device``) into ``param_dtype``
    tensors on the device."""
    dt = T.torch_dtype(cfg.param_dtype)
    d, V, f = cfg.d_model, cfg.vocab_size, cfg.d_ff
    H, Hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

    def normal(shape, scale):
        return torch.empty(shape, dtype=dt, device=device).normal_(generator=generator).mul_(scale)

    def ln(*lead):
        return {"scale": torch.ones((*lead, d), dtype=dt, device=device),
                "bias": torch.zeros((*lead, d), dtype=dt, device=device)}

    def attn(n):
        p = {"wq": normal((n, d, H, hd), d**-0.5), "wk": normal((n, d, Hk, hd), d**-0.5),
             "wv": normal((n, d, Hk, hd), d**-0.5),
             "wo": normal((n, H, hd, d), 1.0 / math.sqrt(H * hd))}
        if cfg.qkv_bias:
            for name, heads in (("bq", H), ("bk", Hk), ("bv", Hk)):
                p[name] = torch.zeros((n, heads, hd), dtype=dt, device=device)
        return p

    def mlp(n):
        return {"w_up": normal((n, d, f), d**-0.5), "w_down": normal((n, f, d), f**-0.5)}

    ne, nd = cfg.encdec.encoder_layers, cfg.num_layers
    return {
        "embed": {"table": normal((V, d), 0.02)},
        "enc_layers": {"ln_attn": ln(ne), "attn": attn(ne), "ln_mlp": ln(ne), "mlp": mlp(ne)},
        "enc_norm": ln(),
        "dec_layers": {"ln_self": ln(nd), "self_attn": attn(nd), "ln_cross": ln(nd),
                       "cross_attn": attn(nd), "ln_mlp": ln(nd), "mlp": mlp(nd)},
        "dec_norm": ln(),
        "head": {"w": normal((d, V), 1.0 / math.sqrt(d))},
    }


def encode(p, frames, cfg: ModelConfig, *, sharder=None):
    """Frame embeddings (B, F, d) -> encoder output (B, F, d)."""
    dt = T.torch_dtype(cfg.dtype)
    F = frames.shape[1]
    x = frames.to(dt) + sinusoids(F, cfg.d_model).to(frames.device, dt)[None]
    if sharder is not None:
        x = sharder.act_btd(x)
    positions = torch.arange(F, dtype=torch.int32, device=x.device)
    for i in range(cfg.encdec.encoder_layers):
        lp = T._layer(p["enc_layers"], i)
        h = L.layernorm(lp["ln_attn"], x, cfg.norm_eps)
        a, _ = L.attention_apply(lp["attn"], h, dtype=dt, rope_theta=None,
                                 positions=positions, causal=False, sharder=sharder)
        x = x + a
        h = L.layernorm(lp["ln_mlp"], x, cfg.norm_eps)
        x = x + L.mlp_apply(lp["mlp"], h, "gelu", dt, sharder=sharder)
    return L.layernorm(p["enc_norm"], x, cfg.norm_eps)


def _dec_layer(lp, x, enc_out, cfg: ModelConfig, *, positions, dt, self_cache=None,
               cache_pos=None, cross_cache=None, sharder=None):
    """One decoder block.  Prefill (``cross_cache`` None) attends the
    encoder output ``enc_out``; decode reads ``cross_cache``.  Returns (x,
    (self cache, cross cache))."""
    h = L.layernorm(lp["ln_self"], x, cfg.norm_eps)
    a, new_self = L.attention_apply(
        lp["self_attn"], h, dtype=dt, rope_theta=cfg.rope_theta, positions=positions,
        causal=True, cache=self_cache, cache_pos=cache_pos, sharder=sharder,
    )
    x = x + a
    h = L.layernorm(lp["ln_cross"], x, cfg.norm_eps)
    if cross_cache is not None:
        a, new_cross = L.attention_apply(
            lp["cross_attn"], h, dtype=dt, rope_theta=None, positions=positions,
            cache=cross_cache, static_cache=True, sharder=sharder,
        )
    else:
        enc_positions = torch.arange(enc_out.shape[1], dtype=torch.int32, device=x.device)
        a, new_cross = L.attention_apply(
            lp["cross_attn"], h, dtype=dt, rope_theta=None, positions=enc_positions,
            causal=False, x_kv=enc_out, sharder=sharder,
        )
    x = x + a
    h = L.layernorm(lp["ln_mlp"], x, cfg.norm_eps)
    return x + L.mlp_apply(lp["mlp"], h, "gelu", dt, sharder=sharder), (new_self, new_cross)


def _logits(p, x, cfg: ModelConfig, dt, sharder=None):
    logits = L.unembed(p["head"], L.layernorm(p["dec_norm"], x, cfg.norm_eps), dt)
    return sharder.logits(logits) if sharder is not None else logits


def whisper_forward(p, batch, cfg: ModelConfig, *, return_cache=False, sharder=None):
    """batch: {frames (B, F, d), tokens (B, S)}.  Returns (logits, cache):
    ``{"self": {k, v} (L, B, S, Hkv, hd), "cross": {k, v} (L, B, F, Hkv,
    hd)}`` when ``return_cache`` (prefill), else None."""
    dt = T.torch_dtype(cfg.dtype)
    enc_out = encode(p, batch["frames"], cfg, sharder=sharder)
    x = L.embed(p["embed"], batch["tokens"], dt)
    if sharder is not None:
        x = sharder.act_btd(x)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    selfs, crosses = [], []
    for i in range(cfg.num_layers):
        x, (self_c, cross_c) = _dec_layer(T._layer(p["dec_layers"], i), x, enc_out, cfg,
                                          positions=positions, dt=dt, sharder=sharder)
        if return_cache:
            selfs.append(self_c)
            crosses.append(cross_c)
    cache = None
    if return_cache:
        cache = {name: {n: torch.stack([c[n] for c in cs]) for n in ("k", "v")}
                 for name, cs in (("self", selfs), ("cross", crosses))}
    return _logits(p, x, cfg, dt, sharder), cache


def whisper_init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device):
    """Zero self cache (L, B, max_len, Hkv, hd) and cross cache (L, B,
    encoder_frames, Hkv, hd) in the compute dtype."""
    dt = T.torch_dtype(cfg.dtype)
    hk, hd, Lr = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_layers
    F = cfg.encdec.encoder_frames

    def kv(S):
        return {n: torch.zeros((Lr, batch, S, hk, hd), dtype=dt, device=device)
                for n in ("k", "v")}

    return {"self": kv(max_len), "cross": kv(F)}


def whisper_decode_step(p, cache, batch, cfg: ModelConfig, *, sharder=None):
    """batch: {tokens (B, 1), pos scalar or (B,)}; the cross cache holds the
    encoder's K/V (from prefill).  The self cache is updated in place.
    Returns (logits (B, 1, V), cache)."""
    dt = T.torch_dtype(cfg.dtype)
    x = L.embed(p["embed"], batch["tokens"], dt)
    if sharder is not None:
        x = sharder.act_btd(x)
    pos = T.decode_positions(batch["pos"], x.device)
    positions = T.query_positions(pos)
    for i in range(cfg.num_layers):
        x, _ = _dec_layer(T._layer(p["dec_layers"], i), x, None, cfg, positions=positions,
                          dt=dt, self_cache=T._layer(cache["self"], i), cache_pos=pos,
                          cross_cache=T._layer(cache["cross"], i), sharder=sharder)
    return _logits(p, x, cfg, dt, sharder), cache


def whisper_param_rules(cfg: ModelConfig):
    ln = {"scale": [None, None], "bias": [None, None]}
    attn = {
        "wq": [None, ["fsdp"], "model", None],
        "wk": [None, ["fsdp"], "model", None],
        "wv": [None, ["fsdp"], "model", None],
        "wo": [None, "model", None, ["fsdp"]],
    }
    mlp = {"w_up": [None, ["fsdp"], "model"], "w_down": [None, "model", ["fsdp"]]}
    return {
        "embed": {"table": [["fsdp"], "model"]},
        "enc_layers": {"ln_attn": ln, "attn": attn, "ln_mlp": ln, "mlp": mlp},
        "enc_norm": {"scale": [None], "bias": [None]},
        "dec_layers": {
            "ln_self": ln, "self_attn": attn,
            "ln_cross": ln, "cross_attn": attn,
            "ln_mlp": ln, "mlp": mlp,
        },
        "dec_norm": {"scale": [None], "bias": [None]},
        "head": {"w": [["fsdp"], "model"]},
    }
