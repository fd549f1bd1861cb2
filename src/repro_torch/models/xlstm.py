"""xLSTM (port of ``repro.models.xlstm``): mLSTM blocks (matrix memory,
chunkwise-parallel prefill) and sLSTM blocks (scalar memory, sequential),
arranged mLSTM:sLSTM = 7:1 per group (xLSTM[7:1]).

The mLSTM recurrence, with q scaled by 1/sqrt(dk)::

    m_t = max(f~_t + m_{t-1}, i~_t)
    C_t = exp(f~_t + m_{t-1} - m_t) C_{t-1} + exp(i~_t - m_t) k_t v_t^T
    n_t = exp(f~_t + m_{t-1} - m_t) n_{t-1} + exp(i~_t - m_t) k_t
    h_t = (q_t^T C_t) / max(|q_t^T n_t|, exp(-m_t))

Prefill runs it chunkwise through ``kernels.ops.mlstm_chunked`` (the CUDA
kernel on the card, :func:`mlstm_chunked` on the CPU); decode runs the exact
recurrent step :func:`mlstm_step`, plain tensor algebra as in the reference.

Differences from the reference, all forced by PyTorch or chosen for memory:

* params keep the reference's stacked layout, leaves ``(G, M, ...)`` for the
  mLSTM blocks and ``(G, Sl, ...)`` for the sLSTM blocks, consumed by Python
  loops (the reference scans them);
* the decode step updates the cache in place: :func:`mlstm_step` rewrites
  the float32 (C, n, m) it is given, and the other leaves are copied into
  their cache lanes (the reference returns a new cache);
* the prefill's mLSTM chunk is ``min(chunk_size, S)``: the CUDA kernel masks
  a ragged last chunk, and the CPU path keeps the reference's rule of
  shrinking the chunk until it divides S.

The sharding hooks (``sharder``, ``xlstm_param_rules``) are not ported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _cast

#: the stabiliser of an empty state (``mlstm_state_init``/``slstm_state_init``)
M_INIT = -1e30


def _dt(name: str) -> torch.dtype:
    return getattr(torch, name)


def _dims(cfg: ModelConfig):
    """(d_inner, dqk, heads, dv per head, dk per head) of an mLSTM block."""
    xl = cfg.xlstm
    di = int(xl.proj_factor * cfg.d_model)
    dqk = int(xl.qk_factor * di)
    H = cfg.num_heads
    return di, dqk, H, di // H, dqk // H


# --------------------------------------------------------------------------
# causal conv1d (width-w depthwise), with streaming state for decode
# --------------------------------------------------------------------------


def causal_conv(p, x, dtype):
    """x: (B, S, C) -> same shape; causal depthwise conv, taps summed in the
    reference's order."""
    w = _cast(p["w"], dtype)
    width, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    return sum(xp[:, i:i + S, :] * w[i] for i in range(width))


def causal_conv_step(p, x_t, conv_state, dtype):
    """x_t: (B, 1, C); conv_state: (B, width-1, C) past inputs.  Returns
    (out (B, 1, C), new conv_state)."""
    w = _cast(p["w"], dtype)
    window = torch.cat([conv_state, x_t], dim=1)  # (B, width, C)
    out = torch.einsum("bwc,wc->bc", window, w)[:, None, :]
    return out, window[:, 1:, :]


# --------------------------------------------------------------------------
# mLSTM cell
# --------------------------------------------------------------------------


def mlstm_chunked(q, k, v, i_pre, f_pre, state=None, *, chunk: int):
    """Chunkwise-parallel mLSTM, the plain version of the ``mlstm`` kernel.

    q, k: (B, S, H, dk); v: (B, S, H, dv); i_pre/f_pre: (B, S, H) raw gate
    pre-activations; state: optional (C (B,H,dk,dv), n (B,H,dk), m (B,H)).
    ``chunk`` must divide S.  Returns (h (B,S,H,dv) in v's dtype, final
    state in float32).  q is scaled in its own dtype before the float32
    upcast, and m starts at -inf without a state, as in the reference.
    """
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    if S % chunk:
        raise ValueError(f"sequence length {S} is no multiple of the chunk {chunk}")
    q = q / math.sqrt(dk)
    nc = S // chunk

    def heads(a):  # (B, S, H, ...) -> (B, H, nc, L, ...) float32
        a = a.reshape(B, nc, chunk, H, *a.shape[3:]).float()
        return a.permute(0, 3, 1, 2, *range(4, a.ndim))

    qc, kc, vc, ic = heads(q), heads(k), heads(v), heads(i_pre)
    Fc = F.logsigmoid(heads(f_pre)).cumsum(-1)       # (B,H,nc,L)
    a = ic - Fc                                       # log source weights
    a_cmax = a.cummax(-1).values

    if state is None:
        C = q.new_zeros((B, H, dk, dv), dtype=torch.float32)
        n = q.new_zeros((B, H, dk), dtype=torch.float32)
        m = q.new_full((B, H), -math.inf, dtype=torch.float32)
    else:
        C, n, m = (s.float() for s in state)

    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=q.device).tril()
    hs = []
    for c in range(nc):
        qi, ki, vi, Fi, ai = qc[:, :, c], kc[:, :, c], vc[:, :, c], Fc[:, :, c], a[:, :, c]
        g = torch.maximum(m[..., None], a_cmax[:, :, c])      # (B,H,L)
        # intra-chunk: exp(a_s - g_t)-weighted scores
        w_ts = torch.exp(ai[..., None, :] - g[..., :, None])
        scores = qi @ ki.transpose(-1, -2)
        smat = torch.where(tri, scores * w_ts, 0.0)
        num = smat @ vi
        den = smat.sum(-1)
        # inter-chunk
        scale = torch.exp(m[..., None] - g)
        num = num + scale[..., None] * (qi @ C)
        den = den + scale * (qi @ n[..., None])[..., 0]
        m_t = Fi + g
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None])
        # state update (end of chunk)
        gL, FL = g[..., -1], Fi[..., -1]
        decay_src = torch.exp(ai - gL[..., None])              # (B,H,L)
        kd = ki * decay_src[..., None]
        C = torch.exp(m - gL)[..., None, None] * C + kd.transpose(-1, -2) @ vi
        n = torch.exp(m - gL)[..., None] * n + kd.sum(-2)
        m = FL + gL
    h = torch.stack(hs, dim=2).permute(0, 2, 3, 1, 4).reshape(B, S, H, dv)
    return h.to(v.dtype), (C, n, m)


def mlstm_step(q, k, v, i_pre, f_pre, state):
    """Exact recurrent step.  q, k, v: (B, 1, H, d*); gates (B, 1, H);
    state (C, n, m) in float32.

    The state is updated **in place** (the reference returns new arrays), so
    a decode step reads and writes each C once more than it must and
    allocates no copy of it.  Returns (h (B, 1, H, dv), state).
    """
    dk = q.shape[-1]
    out_dtype = v.dtype
    q = (q[:, 0] / math.sqrt(dk)).float()
    k = k[:, 0].float()
    v = v[:, 0].float()
    i_t = i_pre[:, 0].float()
    f_t = F.logsigmoid(f_pre[:, 0].float())
    C, n, m = state
    m_new = torch.maximum(f_t + m, i_t)
    fp = torch.exp(f_t + m - m_new)
    ip = torch.exp(i_t - m_new)
    C.mul_(fp[..., None, None]).addcmul_((ip[..., None] * k)[..., :, None], v[..., None, :])
    n.mul_(fp[..., None]).add_(ip[..., None] * k)
    m.copy_(m_new)
    num = (q[..., None, :] @ C)[..., 0, :]                     # (B,H,dv)
    den = (q * n).sum(-1)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h[:, None].to(out_dtype), state


def mlstm_recurrent(q, k, v, i_pre, f_pre, state=None):
    """Oracle: the full recurrence, one :func:`mlstm_step` per position, on
    a copy of ``state``.  Returns (h (B,S,H,dv), final state)."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    if state is None:
        state = (q.new_zeros((B, H, dk, dv), dtype=torch.float32),
                 q.new_zeros((B, H, dk), dtype=torch.float32),
                 q.new_full((B, H), -math.inf, dtype=torch.float32))
    state = tuple(s.float().clone() for s in state)
    hs = [mlstm_step(q[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1],
                     i_pre[:, t:t + 1], f_pre[:, t:t + 1], state)[0]
          for t in range(S)]
    return torch.cat(hs, dim=1), state


# --------------------------------------------------------------------------
# mLSTM block
# --------------------------------------------------------------------------


def mlstm_block_apply(p, x, cfg: ModelConfig, *, state=None, decode=False):
    """Returns (y, new_state); state = (C, n, m, conv_state).  In decode the
    (C, n, m) given are updated in place and returned."""
    xl = cfg.xlstm
    dt = _dt(cfg.dtype)
    di, _, H, dh, dk = _dims(cfg)
    B, S, _ = x.shape

    h = L.rmsnorm(p["ln"], x, cfg.norm_eps)
    up = h @ _cast(p["w_up"], dt)
    xi, z = up.chunk(2, dim=-1)

    if decode:
        C, n, m, conv_state = state
        xc, conv_state = causal_conv_step(p["conv"], xi, conv_state, dt)
    else:
        cell_state = None if state is None else tuple(state[:3])
        xc = causal_conv(p["conv"], xi, dt)
    xc = F.silu(xc)

    q = (xc @ _cast(p["wq"], dt)).reshape(B, S, H, dk)
    k = (xc @ _cast(p["wk"], dt)).reshape(B, S, H, dk)
    v = (xi @ _cast(p["wv"], dt)).reshape(B, S, H, dh)
    gates = xc @ _cast(p["w_if"], dt) + _cast(p["b_if"], dt)
    i_pre, f_pre = gates.reshape(B, S, 2 * H).chunk(2, dim=-1)

    if decode:
        hcell, (C, n, m) = mlstm_step(q, k, v, i_pre, f_pre, (C, n, m))
    else:
        hcell, (C, n, m) = ops.mlstm_chunked(q, k, v, i_pre, f_pre, cell_state,
                                             chunk=min(xl.chunk_size, S))

    hflat = L.rmsnorm(p["out_norm"], hcell.reshape(B, S, di), cfg.norm_eps)
    y = (hflat * F.silu(z)) @ _cast(p["w_down"], dt)
    if not decode:
        conv_state = _conv_tail(xi, xl.conv_width)
    return x + y, (C, n, m, conv_state)


def _conv_tail(x, width):
    """The prefill's conv state: the last ``width - 1`` inputs, left-padded
    with zeros for a sequence shorter than that."""
    B, S, ch = x.shape
    pad = x.new_zeros((B, max(0, width - 1 - S), ch))
    return torch.cat([pad, x[:, -(width - 1):, :]], dim=1)


def mlstm_state_init(cfg: ModelConfig, batch: int, *, device):
    di, _, H, dh, dk = _dims(cfg)
    return (
        torch.zeros((batch, H, dk, dh), dtype=torch.float32, device=device),
        torch.zeros((batch, H, dk), dtype=torch.float32, device=device),
        torch.full((batch, H), M_INIT, dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.xlstm.conv_width - 1, di), dtype=_dt(cfg.dtype),
                    device=device),
    )


# --------------------------------------------------------------------------
# sLSTM block (sequential scan; block-diagonal per-head recurrence)
# --------------------------------------------------------------------------


def _slstm_cell(gates_x, hcnm, r_gates):
    """One timestep.  gates_x: (B, 4d) input contribution; state
    (h, c, n, m): each (B, d), h in the compute dtype, c/n/m float32."""
    h, c, n, m = hcnm
    B, d4 = gates_x.shape
    d = d4 // 4
    H, dh = r_gates.shape[1], r_gates.shape[2]
    hh = h.reshape(B, H, dh)
    rec = torch.einsum("bhk,ghkl->bghl", _cast(hh, r_gates.dtype), r_gates)
    pre = (gates_x + rec.reshape(B, 4 * d)).float()
    i_p, f_p, z_p, o_p = pre.chunk(4, dim=-1)
    f_log = F.logsigmoid(f_p)
    m_new = torch.maximum(f_log + m, i_p)
    i_g = torch.exp(i_p - m_new)
    f_g = torch.exp(f_log + m - m_new)
    c_new = f_g * c + i_g * torch.tanh(z_p)
    n_new = f_g * n + i_g
    h_new = torch.sigmoid(o_p) * c_new / torch.clamp(n_new, min=1e-6)
    return (h_new.to(h.dtype), c_new, n_new, m_new)


def slstm_block_apply(p, x, cfg: ModelConfig, *, state=None, decode=False):
    """Returns (y, new_state); state = (h, c, n, m, conv_state)."""
    dt = _dt(cfg.dtype)
    B, S, d = x.shape
    hin = L.rmsnorm(p["ln"], x, cfg.norm_eps)
    if decode:
        h0, c0, n0, m0, conv_state = state
        xc, conv_state = causal_conv_step(p["conv"], hin, conv_state, dt)
    else:
        if state is None:
            h0, c0, n0, m0, _ = slstm_state_init(cfg, B, device=x.device)
        else:
            h0, c0, n0, m0, _ = state
        xc = causal_conv(p["conv"], hin, dt)
    xc = F.silu(xc)
    gates_x = xc @ _cast(p["w_gates"], dt) + _cast(p["b_gates"], dt)

    st = (h0, c0, n0, m0)
    hs = []
    for t in range(S):
        st = _slstm_cell(gates_x[:, t], st, p["r_gates"])
        hs.append(st[0])
    hs = torch.stack(hs, dim=1)

    hs = L.rmsnorm(p["out_norm"], hs, cfg.norm_eps)
    a, b = (hs @ _cast(p["w_up"], dt)).chunk(2, dim=-1)
    y = (F.gelu(a, approximate="tanh") * b) @ _cast(p["w_down"], dt)  # jax.nn.gelu default
    if not decode:
        conv_state = _conv_tail(hin, cfg.xlstm.conv_width)
    return x + y, (*st, conv_state)


def slstm_state_init(cfg: ModelConfig, batch: int, *, device):
    d, dt = cfg.d_model, _dt(cfg.dtype)
    return (
        torch.zeros((batch, d), dtype=dt, device=device),
        torch.zeros((batch, d), dtype=torch.float32, device=device),
        torch.zeros((batch, d), dtype=torch.float32, device=device),
        torch.full((batch, d), M_INIT, dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.xlstm.conv_width - 1, d), dtype=dt, device=device),
    )


# --------------------------------------------------------------------------
# full xLSTM model: groups of (mlstm_per_group mLSTM + slstm_per_group sLSTM)
# --------------------------------------------------------------------------


def _group_counts(cfg: ModelConfig):
    xl = cfg.xlstm
    per = xl.mlstm_per_group + xl.slstm_per_group
    if cfg.num_layers % per:
        raise ValueError(f"num_layers {cfg.num_layers} is no multiple of the group size {per}")
    return cfg.num_layers // per, xl.mlstm_per_group, xl.slstm_per_group


def _at(tree, g: int, j: int):
    """Block ``(g, j)`` of a stacked param dict, as views."""
    return {k: _at(v, g, j) if isinstance(v, dict) else v[g, j] for k, v in tree.items()}


def xlstm_init(cfg: ModelConfig, *, device, generator: torch.Generator):
    """Random parameters with the reference's shapes and scales, drawn from
    ``generator`` (a generator on ``device``) straight into ``param_dtype``
    tensors on the device."""
    G, M, Sl = _group_counts(cfg)
    dt = _dt(cfg.param_dtype)
    d, V, H = cfg.d_model, cfg.vocab_size, cfg.num_heads
    di, dqk, _, _, _ = _dims(cfg)
    width = cfg.xlstm.conv_width
    dh, ffs = d // H, int(4 * d / 3)

    def normal(shape, scale):
        t = torch.empty(shape, dtype=dt, device=device)
        return t.normal_(generator=generator).mul_(scale)

    def const(shape, fill):
        return torch.full(shape, fill, dtype=dt, device=device)

    gm, gs = (G, M), (G, Sl)
    s, si = 1.0 / math.sqrt(d), 1.0 / math.sqrt(di)
    b_if = torch.cat([torch.zeros(H, device=device),
                      torch.linspace(3.0, 6.0, H, device=device)]).to(dt)
    b_gates = torch.cat([torch.zeros(d, device=device), torch.full((d,), 3.0, device=device),
                         torch.zeros(2 * d, device=device)]).to(dt)   # forget bias 3
    return {
        "embed": {"table": normal((V, d), 0.02)},
        "mlstm": {
            "ln": {"scale": const((*gm, d), 1.0)},
            "w_up": normal((*gm, d, 2 * di), s),
            "conv": {"w": normal((*gm, width, di), 1.0 / math.sqrt(width))},
            "wq": normal((*gm, di, dqk), si),
            "wk": normal((*gm, di, dqk), si),
            "wv": normal((*gm, di, di), si),
            "w_if": normal((*gm, di, 2 * H), si),
            "b_if": b_if.expand(*gm, 2 * H).clone(),
            "out_norm": {"scale": const((*gm, di), 1.0)},
            "w_down": normal((*gm, di, d), si),
        },
        "slstm": {
            "ln": {"scale": const((*gs, d), 1.0)},
            "conv": {"w": normal((*gs, width, d), 1.0 / math.sqrt(width))},
            "w_gates": normal((*gs, d, 4 * d), s),
            "r_gates": normal((*gs, 4, H, dh, dh), 1.0 / math.sqrt(dh)),
            "b_gates": b_gates.expand(*gs, 4 * d).clone(),
            "out_norm": {"scale": const((*gs, d), 1.0)},
            "w_up": normal((*gs, d, 2 * ffs), s),
            "w_down": normal((*gs, ffs, d), 1.0 / math.sqrt(ffs)),
        },
        "final_norm": {"scale": const((d,), 1.0)},
        "head": {"w": normal((d, V), 1.0 / math.sqrt(d))},
    }


def _stack_states(states):
    """``states[g][j]`` tuples of per-block leaves -> one tuple of stacked
    ``(G, J, B, ...)`` leaves (the reference's scanned cache layout)."""
    return tuple(torch.stack([torch.stack([st[i] for st in row]) for row in states])
                 for i in range(len(states[0][0])))


def xlstm_forward(p, batch, cfg: ModelConfig, *, return_cache=False):
    """Train/prefill forward.  Returns (logits, cache): the cache is
    ``{"mlstm": (C, n, m, conv), "slstm": (h, c, n, m, conv)}`` with leaves
    ``(G, M|Sl, B, ...)`` when ``return_cache``, else None."""
    G, M, Sl = _group_counts(cfg)
    dt = _dt(cfg.dtype)
    x = L.embed(p["embed"], batch["tokens"], dt)
    mst, sst = [], []
    for g in range(G):
        mst.append([])
        for j in range(M):
            x, st = T.remat(mlstm_block_apply, cfg, x)(_at(p["mlstm"], g, j), x, cfg)
            mst[-1].append(st)
        sst.append([])
        for j in range(Sl):
            x, st = T.remat(slstm_block_apply, cfg, x)(_at(p["slstm"], g, j), x, cfg)
            sst[-1].append(st)
    x = L.rmsnorm(p["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(p["head"], x, dt)
    if not return_cache:
        return logits, None
    return logits, {"mlstm": _stack_states(mst), "slstm": _stack_states(sst)}


def xlstm_init_cache(cfg: ModelConfig, batch: int, max_len: int = 0, *, device):
    """The recurrent state of ``batch`` sequences, leaves ``(G, M|Sl, B,
    ...)``; ``max_len`` is unused (the state does not grow)."""
    G, M, Sl = _group_counts(cfg)

    def rep(state, j):
        return tuple(a.expand(G, j, *a.shape).clone() for a in state)

    return {"mlstm": rep(mlstm_state_init(cfg, batch, device=device), M),
            "slstm": rep(slstm_state_init(cfg, batch, device=device), Sl)}


def xlstm_decode_step(p, cache, batch, cfg: ModelConfig):
    """One decode step: ``batch = {tokens: (B, 1), ...}`` (positions are not
    read).  Every state leaf of ``cache`` is updated in place.  Returns
    (logits (B, 1, V), cache)."""
    G, M, Sl = _group_counts(cfg)
    dt = _dt(cfg.dtype)
    x = L.embed(p["embed"], batch["tokens"], dt)
    for g in range(G):
        for kind, count, apply in (("mlstm", M, mlstm_block_apply),
                                   ("slstm", Sl, slstm_block_apply)):
            for j in range(count):
                lanes = tuple(leaf[g, j] for leaf in cache[kind])
                x, new = apply(_at(p[kind], g, j), x, cfg, state=lanes, decode=True)
                for dst, src in zip(lanes, new):
                    if src is not dst:
                        dst.copy_(src)
    x = L.rmsnorm(p["final_norm"], x, cfg.norm_eps)
    return L.unembed(p["head"], x, dt), cache
