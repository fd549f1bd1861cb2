"""Mamba2 blocks via the state-space dual (SSD) chunked algorithm (port of
``repro.models.mamba2``).

Per head: scalar decay lambda_t = exp(A dt_t) (A < 0), state h in R^{N x P}::

    h_t = lambda_t h_{t-1} + dt_t (B_t outer x_t)      (B_t in R^N, x_t in R^P)
    y_t = C_t . h_t + D x_t                              (contract over N)

Chunked (Lc_t = sum of log lambda within the chunk): the intra-chunk part is
a masked product S(t, s) = (C_t . B_s) exp(Lc_t - Lc_s) dt_s for s <= t, the
inter-chunk part a short scan carrying h.  B/C are shared by the heads of a
group (G groups).

Prefill runs it through ``kernels.ops.ssd_chunked`` (the CUDA kernel on the
card, :func:`ssd_chunked` on the CPU); decode runs the exact recurrent step
:func:`ssd_step`, plain tensor algebra as in the reference.

Differences from the reference, all forced by PyTorch or chosen for memory:

* the decode step updates the float32 state h in place (``mul_``,
  ``addcmul_``, then one batched product to read it); the reference returns
  a new state;
* the prefill's chunk is ``min(chunk_size, S)``: the CUDA kernel masks a
  ragged last chunk, and the CPU path keeps the reference's rule of
  shrinking the chunk until it divides S;
* ``conv_in`` is a view of the input projection (the reference concatenates
  the same three slices, which lie side by side).
* the intra-chunk decay is masked before ``exp`` (the reference masks after
  it: where an exponent above the diagonal overflows, its gradient is
  0 * inf = NaN, which a zamba2-2.7b chunk of 128 positions already reaches).

Under a ``sharder`` the block's inner width splits over the model axis
(the reference's constraints on ``z`` and the conv input), and the SSD's x,
dt, B and C take the heads layout the kernel runs on locally.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _cast
from repro_torch.models.xlstm import _conv_tail, causal_conv, causal_conv_step


def ssd_chunked(x, dt, A, Bm, Cm, D, state=None, *, chunk: int):
    """The plain version of the ``ssd`` kernel.

    x: (B, S, H, P); dt: (B, S, H); A: (H,); Bm/Cm: (B, S, G, N); D: (H,);
    state: optional h (B, H, N, P).  ``chunk`` must divide S.  Returns
    (y (B, S, H, P) in x's dtype, final h float32); D x is added in float32
    and y rounded once, as in the reference.
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if S % chunk:
        raise ValueError(f"sequence length {S} is no multiple of the chunk {chunk}")
    nc = S // chunk
    xf, dtf = x.float(), dt.float()
    loglam = A.float()[None, None, :] * dtf                       # (B,S,H) negative

    def c4(a):  # (B, S, K, last) -> (B, K, nc, L, last) float32
        return a.float().reshape(Bsz, nc, chunk, *a.shape[2:]).permute(0, 3, 1, 2, 4)

    xc = c4(xf)
    dtc = dtf.reshape(Bsz, nc, chunk, H).permute(0, 3, 1, 2)      # (B,H,nc,L)
    Lc = loglam.reshape(Bsz, nc, chunk, H).permute(0, 3, 1, 2).cumsum(-1)
    Bh = c4(Bm).repeat_interleave(H // G, dim=1)                  # (B,H,nc,L,N)
    Ch = c4(Cm).repeat_interleave(H // G, dim=1)
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()

    h = (x.new_zeros((Bsz, H, N, P), dtype=torch.float32) if state is None
         else state.float().clone())
    ys = []
    for c in range(nc):
        xi, dti, Li, Bi, Ci = xc[:, :, c], dtc[:, :, c], Lc[:, :, c], Bh[:, :, c], Ch[:, :, c]
        cb = Ci @ Bi.transpose(-1, -2)                              # (B,H,t,s)
        # masked before exp: above the diagonal the exponent is positive and
        # may overflow, and autograd of exp there would be 0 * inf = NaN
        decay = torch.exp(torch.where(tri, Li[..., :, None] - Li[..., None, :], -math.inf))
        smat = torch.where(tri, cb * decay * dti[..., None, :], 0.0)
        y = smat @ xi
        y = y + torch.exp(Li)[..., None] * (Ci @ h)
        LL = Li[..., -1:]                                           # (B,H,1)
        w = torch.exp(LL - Li) * dti                                # (B,H,L)
        h = torch.exp(LL)[..., None] * h + (Bi * w[..., None]).transpose(-1, -2) @ xi
        ys.append(y)
    y = torch.stack(ys, dim=2).permute(0, 2, 3, 1, 4).reshape(Bsz, S, H, P)
    y = y + xf * D.float()[None, None, :, None]
    return y.to(x.dtype), h


def ssd_step(x, dt, A, Bm, Cm, D, state):
    """One decode step.  x: (B, 1, H, P); dt: (B, 1, H); Bm/Cm: (B, 1, G, N);
    state h (B, H, N, P) float32.

    The state is updated **in place** (the reference returns a new array):
    ``mul_`` and ``addcmul_`` rewrite it, one batched product reads it.
    Returns (y (B, 1, H, P) in x's dtype, state).
    """
    Bsz, _, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    xf = x[:, 0].float()                                          # (B,H,P)
    dtf = dt[:, 0].float()                                        # (B,H)
    lam = torch.exp(A.float()[None, :] * dtf)
    Bh = Bm[:, 0].float().repeat_interleave(H // G, dim=1)        # (B,H,N)
    Ch = Cm[:, 0].float().repeat_interleave(H // G, dim=1)
    h = state
    h.mul_(lam[..., None, None]).addcmul_((dtf[..., None] * Bh)[..., :, None], xf[..., None, :])
    y = torch.bmm(Ch.reshape(Bsz * H, 1, N), h.reshape(Bsz * H, N, P)).reshape(Bsz, H, P)
    y = y + xf * D.float()[None, :, None]
    return y[:, None].to(x.dtype), state


def ssd_recurrent(x, dt, A, Bm, Cm, D, state=None):
    """Oracle: the stepwise recurrence, one :func:`ssd_step` per position,
    on a copy of ``state``.  Returns (y (B, S, H, P), final h)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[3]
    h = (x.new_zeros((Bsz, H, N, P), dtype=torch.float32) if state is None
         else state.float().clone())
    ys = [ssd_step(x[:, t:t + 1], dt[:, t:t + 1], A, Bm[:, t:t + 1], Cm[:, t:t + 1], D, h)[0]
          for t in range(S)]
    return torch.cat(ys, dim=1), h


# --------------------------------------------------------------------------
# Mamba2 block
# --------------------------------------------------------------------------


def mamba2_dims(cfg: ModelConfig):
    """(d_inner, heads H, groups G, state N, head_dim P)."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    return di, di // s.head_dim, s.num_groups, s.state_dim, s.head_dim


def mamba2_block_init(cfg: ModelConfig, lead: tuple, *, device, generator: torch.Generator):
    """Params of ``prod(lead)`` Mamba2 blocks stacked on the dims ``lead``,
    with the reference's shapes and scales, drawn from ``generator`` into
    ``param_dtype`` tensors on ``device``; ``A_log``, ``dt_bias`` and ``D``
    are float32 whatever ``param_dtype`` is, as in the reference."""
    s, d = cfg.ssm, cfg.d_model
    di, H, G, N, P = mamba2_dims(cfg)
    dt = getattr(torch, cfg.param_dtype)
    conv_ch = di + 2 * G * N
    f32 = dict(dtype=torch.float32, device=device)

    def normal(shape, scale):
        t = torch.empty((*lead, *shape), dtype=dt, device=device)
        return t.normal_(generator=generator).mul_(scale)

    def ones(shape):
        return torch.ones((*lead, *shape), dtype=dt, device=device)

    # dt_bias = softplus^-1(dt0), dt0 log-uniform in [1e-3, 1e-1]
    u = torch.rand((*lead, H), generator=generator, **f32)
    dt0 = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    return {
        "ln": {"scale": ones((d,))},
        # in_proj emits [z, x, B, C, dt]
        "w_in": normal((d, 2 * di + 2 * G * N + H), 1.0 / math.sqrt(d)),
        "conv": {"w": normal((s.conv_width, conv_ch), 1.0 / math.sqrt(s.conv_width))},
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)).expand(*lead, H).clone(),
        "dt_bias": torch.log(torch.expm1(dt0)),
        "D": torch.ones((*lead, H), **f32),
        "out_norm": {"scale": ones((di,))},
        "w_out": normal((di, d), 1.0 / math.sqrt(di)),
    }


def mamba2_block_apply(p, x, cfg: ModelConfig, *, state=None, decode=False, sharder=None):
    """Returns (x + block(x), new_state); state = (h (B, H, N, P) float32,
    conv_state (B, w-1, conv_ch)).  In decode the h given is updated in
    place and returned."""
    s = cfg.ssm
    dt_ = getattr(torch, cfg.dtype)
    di, H, G, N, P = mamba2_dims(cfg)
    B_, S, _ = x.shape

    hin = L.rmsnorm(p["ln"], x, cfg.norm_eps)
    proj = hin @ _cast(p["w_in"], dt_)
    z, dt_pre = proj[..., :di], proj[..., 2 * di + 2 * G * N:]
    conv_in = proj[..., di:2 * di + 2 * G * N]      # [x, B, C]
    if sharder is not None:
        z = sharder.constrain(z, ["batch", None, "model"])
        conv_in = sharder.constrain(conv_in, ["batch", None, "model"])

    if decode:
        h0, conv_state = state
        conv_out, conv_state = causal_conv_step(p["conv"], conv_in, conv_state, dt_)
    else:
        h0 = None if state is None else state[0]
        conv_out = causal_conv(p["conv"], conv_in, dt_)
    conv_out = F.silu(conv_out)
    xc = conv_out[..., :di].unflatten(-1, (H, P))
    Bc = conv_out[..., di:di + G * N].unflatten(-1, (G, N))
    Cc = conv_out[..., di + G * N:].unflatten(-1, (G, N))
    dt_v = F.softplus(dt_pre.float() + p["dt_bias"])               # (B,S,H) float32
    A = -torch.exp(p["A_log"])
    if sharder is not None:
        xc = sharder.constrain(xc, ["batch", None, "model", None])
        dt_v = sharder.constrain(dt_v, ["batch", None, "model"])
        Bc, Cc = (sharder.constrain(t, ["batch", None, None, None]) for t in (Bc, Cc))

    if decode:
        y, h_new = ssd_step(xc, dt_v, A, Bc, Cc, p["D"], h0)
    else:
        y, h_new = ops.ssd_chunked(xc, dt_v, A, Bc, Cc, p["D"], h0,
                                   chunk=min(s.chunk_size, S))

    yflat = L.rmsnorm(p["out_norm"], y.reshape(B_, S, di), cfg.norm_eps) * F.silu(z)
    out = yflat @ _cast(p["w_out"], dt_)
    if sharder is not None:
        out = sharder.act_btd(out)
    if not decode:
        conv_state = _conv_tail(conv_in, s.conv_width)
    return x + out, (h_new, conv_state)


def mamba2_param_rules(prefix_dims: int = 1):
    """Rules for one (possibly stacked) mamba2 block; ``prefix_dims`` layer
    dims lead each leaf."""
    pre = [None] * prefix_dims
    return {
        "ln": {"scale": pre + [None]},
        "w_in": pre + [["fsdp"], "model"],
        "conv": {"w": pre + [None, "model"]},
        "A_log": pre + [None],
        "dt_bias": pre + [None],
        "D": pre + [None],
        "out_norm": {"scale": pre + [None]},
        "w_out": pre + ["model", ["fsdp"]],
    }


def mamba2_state_init(cfg: ModelConfig, batch: int, *, device):
    di, H, G, N, P = mamba2_dims(cfg)
    return (
        torch.zeros((batch, H, N, P), dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.ssm.conv_width - 1, di + 2 * G * N),
                    dtype=getattr(torch, cfg.dtype), device=device),
    )
