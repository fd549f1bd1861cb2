#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of HAM (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together);
3. hold each kernel against its plain PyTorch version on the card at the
   serving shapes of internlm2-20b, olmoe-1b-7b, xlstm-1.3b and zamba2-2.7b
   (and qwen2-moe's expert width), float32 and bfloat16 (decode attention
   also at each cluster size it splits the cache into, with splits left
   empty), and time kernel, plain version and, where one exists, the
   one-call PyTorch yardstick (``scaled_dot_product_attention``,
   ``torch.bmm``; none computes mLSTM or SSD); each grouped-matmul, mLSTM
   and SSD line names the route it took, and the mLSTM and SSD kernels are
   also timed by pass and beside the CUDA-core route they replaced;
4. model checks: internlm2-20b, olmoe-1b-7b and qwen2-moe-a2.7b at full
   width cut to 2 layers, xlstm-1.3b cut to one group of 8 layers and
   zamba2-2.7b cut to 2 groups (12 Mamba2 blocks, 2 shared-block
   applications), float32 weights (xlstm-1.3b and zamba2-2.7b also in
   bfloat16, the tensor-core routes of their mLSTM and SSD kernels),
   prefill + 4 decode steps with the kernels on the card against the plain
   path on the CPU (MoE routing near-ties between the two are reported, not
   hidden; the recurrent states are compared too; the first mLSTM and
   Mamba2 layers' states are also held against the plain mLSTM and SSD on
   the card, on the same activations);
5. serve internlm2-20b, olmoe-1b-7b, xlstm-1.3b and zamba2-2.7b, each at its
   full published config in bfloat16 (seeded random weights): 16 greedy requests
   through ``run()``, a profiled window of decode steps, a ``step_many(16)``
   block against 16 ``step()`` calls from the same state, a profiled window
   of 1024-token admissions (one for xlstm-1.3b, whose sLSTM prefill is a
   host loop of ~150 k small launches), and one sampled request, with the
   kernels' launch counters zeroed before and checked after each model;
6. cluster serving through the port's HAM runtime: internlm2-20b at full
   config in bfloat16 through ``ClusterServingEngine`` (2 thread workers x 4
   slots, ``max_len`` 2048), worker-driven (decode blocks of 16), lockstep
   and worker-driven on one 4-slot worker, on 16 requests of 64 new
   tokens, each token-identical to one 4-slot ``ServingEngine`` on the same
   requests; exact decode and flash launch counts, tokens/s, TTFT and host
   RPCs per emitted token (below 0.1 worker-driven);
7. print the kernel line, one serving line per model and the cluster
   serving line (JSON);
8. last line: ``{"ok": true, "device": {...}}``.

Needs CUDA; imports nothing of JAX or of the reference package ``repro``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of bytes / memory rate and operations / peak for the type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # as tests/test_kernels.py
# grouped matmul: |kernel - plain| <= atol + rtol * |plain|.  float32 keeps
# 2e-5; a bfloat16 output is one rounding of an O(1) float32 sum, and one
# bf16 step above |4| is already 3.1e-2, hence the relative term
GMM_TOL = {"float32": (2e-5, 0.0), "bfloat16": (2e-2, 1e-2)}
LOGIT_ATOL = 1e-3  # float32 logits, card vs CPU: sums over d=6144/16384 in another order
# a token whose k-th and (k+1)-th router probabilities are closer than the
# card/CPU rounding may take another expert on each side; such a token must
# have a margin below this, and the positions it reaches are left out of
# the logit comparison
NEAR_TIE = 1e-5
DEVICE = "cuda"  # where every phase runs; a CPU rehearsal of the phases may set "cpu"

# (E, C, d, f, view, what): view "pad" reads x and w as strided views of
# tensors whose rows are padded to a multiple of 8 elements, with ragged
# rows (d, f no multiples of 8: TMA reads zeros past the edge; an odd f
# stores single elements); "layer" reads w as one layer's up half of stacked
# (layers, E, d, 2f) expert weights
GMM_CASES = [
    (64, 8, 2048, 1024, "", "olmoe decode gate/up"),
    (64, 8, 1024, 2048, "", "olmoe decode down"),
    (64, 160, 2048, 1024, "", "olmoe 1024-token prefill gate/up"),
    (64, 37, 2048, 1024, "", "olmoe prefill, C = 37"),
    (64, 200, 2048, 1024, "", "olmoe prefill, C = 200"),
    (64, 160, 2048, 1024, "layer", "olmoe prefill on a layer slice of stacked weights"),
    (64, 8, 2048, 1024, "layer", "olmoe decode on a layer slice of stacked weights"),
    (60, 8, 2048, 1408, "", "qwen2-moe decode gate/up"),
    (60, 160, 2048, 1408, "", "qwen2-moe prefill gate/up, f = 1408"),
    (3, 5, 40, 24, "", "small ragged"),
    (3, 5, 38, 22, "pad", "ragged strided views, decode"),
    (3, 37, 38, 22, "pad", "ragged strided views, prefill"),
    (3, 5, 38, 21, "pad", "ragged strided views, odd f, decode"),
    (3, 37, 38, 21, "pad", "ragged strided views, odd f, prefill"),
]
# timed shapes (E, C, d, f): olmoe's decode gate (the main path's regime: 48
# calls per step) and down projection, and prefills of 64, 160 and 256 slots
# (TTFT mixes them) at the gate and, at 160, the down projection
GMM_TIMED = {"decode": (64, 8, 2048, 1024), "decode_down": (64, 8, 1024, 2048),
             "prefill": (64, 160, 2048, 1024), "prefill_c64": (64, 64, 2048, 1024),
             "prefill_c256": (64, 256, 2048, 1024), "prefill_down": (64, 160, 1024, 2048)}
# arch -> (B, T, per-slot decode positions); MoE prompts keep B*T <= 256
# tokens, one dropless group, so a routing near-tie cannot move other
# tokens' capacity drops
MODEL_CHECKS = {
    "internlm2-20b": (2, 200, [200, 150]),
    "olmoe-1b-7b": (2, 128, [128, 100]),
    "qwen2-moe-a2.7b": (2, 128, [128, 100]),
}
SERVED = ("internlm2-20b", "olmoe-1b-7b", "xlstm-1.3b", "zamba2-2.7b")
# phase 6: internlm2-20b through the port's ClusterServingEngine (thread
# workers x slots each, against one engine of as many slots)
CLUSTER = {"workers": 2, "slots": 4, "requests": 16, "new_tokens": 64}

# mLSTM: |kernel - plain| <= atol + rtol |plain| for h and for the final
# state.  float32 takes tests/test_kernels.py's tolerances for a kernel held
# against another chunking (the plain version shrinks the chunk to divide S,
# the kernel masks a ragged tail); a bfloat16 h is one rounding of an O(1)
# float32 value, one bf16 step above |2| being 1.6e-2, hence the GMM_TOL
# terms; the state is float32 from the same bf16 inputs on both sides.
MLSTM_TOL = {"h": {"float32": (5e-4, 1e-3), "bfloat16": (2e-2, 1e-2)},
             "state": {"float32": (5e-3, 1e-2), "bfloat16": (5e-3, 1e-2)}}
# (B, H, S, dk, dv, chunk, initial state, what); q and k are |N(0, 1)|, so
# every score is positive and h is a weighted mean of v rows (with signed
# scores a position whose denominator cancels to ~0 amplifies any rounding
# without bound); a state comes from the plain version on a 64-token prefix
MLSTM_CASES = [
    (1, 4, 1024, 512, 1024, 256, False, "xlstm-1.3b 1024-token admission"),
    (1, 4, 300, 512, 1024, 256, True, "ragged second chunk (256 + 44)"),
    (1, 4, 509, 512, 1024, 256, True, "prime length (256 + 253)"),
    (1, 4, 512, 512, 1024, 256, False, "xlstm-1.3b 512-token admission"),
    (2, 2, 200, 256, 256, 64, True, "B = 2, dk = dv = 256, chunks 3 x 64 + 8"),
    (3, 1, 37, 16, 32, 8, True, "small, BH = 3"),
]
XLSTM_CHECK = (8, 2, 300)   # layers (one 7:1 group), batch, prompt: 256 + 44 on the card
# xLSTM logits, float32 against a float64 run of the same model on the CPU.
# At full width the model's float32 logits lie a few 1e-3 from float64 and
# move by as much with the order of sums alone (the chunking), so 1e-3 card
# vs CPU would test rounding, not the kernel: the card is held within 1e-2
# of float64 and within 3x the float32 CPU run's own distance from it
XLSTM_LOGIT_ATOL, XLSTM_VS_CPU = 1e-2, 3.0

# SSD: |kernel - plain| <= atol + rtol |plain|, y as mLSTM's h (the plain
# version shrinks the chunk to divide S, the kernel masks a ragged tail; a
# bf16 y is one rounding of an O(1) float32 sum), the float32 state h
SSD_TOL = {"y": {"float32": (5e-4, 1e-3), "bfloat16": (2e-2, 1e-2)},
           "state": {"float32": (5e-3, 1e-2), "bfloat16": (5e-3, 1e-2)}}
# (B, S, H, G, chunk, initial state, views, what): N = P = 64; with views x,
# B and C are strided views of one (B, S, H*P + 2*G*N) conv output, as the
# Mamba2 block passes them; a state comes from the plain version on a
# 64-token prefix
SSD_CASES = [
    (1, 1024, 80, 1, 256, False, True, "zamba2-2.7b 1024-token admission"),
    (1, 300, 80, 1, 256, True, True, "ragged second chunk (256 + 44)"),
    (1, 509, 80, 1, 256, True, False, "prime length (256 + 253)"),
    (2, 200, 8, 2, 64, True, True, "B = 2, G = 2 (4 heads a group), chunks 3 x 64 + 8"),
    (1, 7, 8, 1, 256, False, False, "short prompt, one masked tile"),
]
ZAMBA2_CHECK = (12, 2, 300)   # layers (2 groups of 6), batch, prompt: 256 + 44 on the card

# how phase 3 names each grouped-matmul route (kernels/grouped_matmul.py `route`)
GMM_ROUTES = {"wgmma": "TMA/wgmma", "stream": "TMA stream/mma.sync",
              "skinny": "skinny (CUDA cores)", "tiled": "tiled (CUDA cores)"}

KERNELS = {
    "decode_attention": {
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:32",
    },
    "flash_attention": {
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:32",
    },
    "grouped_matmul": {
        "source": "src/repro_torch/kernels/csrc/grouped_matmul.cu",
        "replaces": "src/repro/kernels/grouped_matmul.py:27",
    },
    "mlstm": {
        "source": "src/repro_torch/kernels/csrc/mlstm.cu",
        "replaces": "src/repro/kernels/mlstm.py:34",
    },
    "mamba2_ssd": {
        "source": "src/repro_torch/kernels/csrc/mamba2_ssd.cu",
        "replaces": "src/repro/kernels/mamba2_ssd.py:29",
    },
}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA events).

    The device first spins (``torch.cuda._sleep``) for 1.5x as long as the
    host took to run the ``reps`` calls once, at up to 2 GHz, so the host has
    enqueued them all before the start event: the events bracket the device's
    work alone.  Without the spin, a kernel that takes less time than its
    Python wrapper (the attention kernels at their serving shapes) would be
    timed at the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(1.5 * host_s * 2e9))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us(torch, fn, n: int = 200) -> float:
    """Host time of one call of ``fn`` (microseconds, the mean over ``n``
    calls enqueued back to back): what a call costs a host-bound step."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / n


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def causal_chunk_flops(S: int, chunk: int, dk: int, dv: int) -> int:
    """Operations of one (sequence, head) of a chunked causal scan over S
    positions in chunks of ``chunk`` (the last one ragged), as the function
    needs them: per chunk of n positions the score and score-times-value
    products on and below the diagonal, n(n+1)/2 x 2(dk + dv), and the
    state's read and update, 2n dk dv each."""
    ns = [min(chunk, S - c0) for c0 in range(0, S, chunk)]
    return sum(n * (n + 1) * (dk + dv) + 4 * n * dk * dv for n in ns)


def max_err(torch, a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def ptxas_summary(log: str) -> list[tuple[str, str, str]]:
    """(kernel, registers line, spill line) for each kernel of an ``nvcc
    -Xptxas -v`` log, the kernel names demangled where ``c++filt`` exists."""
    rows, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            rows.append((name, line.split("Used", 1)[1].strip(), spill))
            name, spill = None, ""
    try:
        demangled = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                                   capture_output=True, text=True, timeout=60).stdout.split("\n")
        rows = [(d.replace("(anonymous namespace)::", "").split("(")[0], r, s)
                for d, (_, r, s) in zip(demangled, rows)]
    except (OSError, subprocess.SubprocessError):
        pass
    return rows



# -- phase 3: kernels against their plain versions ---------------------------


def decode_case(torch, B, Hkv, qpk, S, d, dtype, lengths, seed):
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_plain

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn(B, 1, Hkv * qpk, d, generator=g, device=DEVICE).to(dt)
    k = torch.randn(B, S, Hkv, d, generator=g, device=DEVICE).to(dt)   # model cache layout
    v = torch.randn(B, S, Hkv, d, generator=g, device=DEVICE).to(dt)
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
    got = ops.decode_attention_bhsd(q, k, v, lens)
    want = decode_attention_plain(
        q.reshape(B, Hkv, qpk, d), k.transpose(1, 2), v.transpose(1, 2), lens
    ).reshape(B, 1, Hkv * qpk, d)
    torch.cuda.synchronize()
    return (q, k, v, lens), got, want


def flash_case(torch, B, H, Hkv, S, d, dtype, causal, seed):
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_heads_plain

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn(B, S, H, d, generator=g, device=DEVICE).to(dt)     # model layout
    k = torch.randn(B, S, Hkv, d, generator=g, device=DEVICE).to(dt)
    v = torch.randn(B, S, Hkv, d, generator=g, device=DEVICE).to(dt)
    got = ops.flash_attention_bhsd(q, k, v, causal=causal)
    want = flash_attention_heads_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal
    ).transpose(1, 2)
    torch.cuda.synchronize()
    return (q, k, v), got, want


def gmm_case(torch, E, C, d, f, dtype, seed, view=""):
    """x ~ N(0, 1) and w ~ N(0, 1) / sqrt(d), as ``moe_init`` scales them,
    so outputs are O(1); ``view`` as in GMM_CASES.  Returns ((x, w), kernel
    result, plain result)."""
    from repro_torch.kernels.grouped_matmul import grouped_matmul, grouped_matmul_plain

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    dt = getattr(torch, dtype)
    dp, fp = (-(-d // 8) * 8, -(-f // 8) * 8) if view == "pad" else (d, f)
    x = torch.randn(E, C, dp, generator=g, device=DEVICE).to(dt)[..., :d]
    if view == "layer":
        w = (torch.randn(2, E, d, 2 * f, generator=g, device=DEVICE) / d**0.5).to(dt)[1, :, :, f:]
    else:
        w = (torch.randn(E, dp, fp, generator=g, device=DEVICE) / d**0.5).to(dt)[:, :d, :f]
    got = grouped_matmul(x, w)
    want = grouped_matmul_plain(x, w)
    torch.cuda.synchronize()
    return (x, w), got, want


def mlstm_case(torch, B, H, S, dk, dv, chunk, with_state, dtype, seed):
    """Model-layout inputs, as the xLSTM block hands them to the kernel: q,
    k (B, S, H, dk) and v (B, S, H, dv) in ``dtype``, the gates strided
    views of one (B, S, 2H) tensor.  Returns (inputs, state, kernel result,
    plain result), each result (h (B, S, H, dv), (C, n, m))."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.mlstm import mlstm_chunked_heads_plain

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    dt = getattr(torch, dtype)

    def inputs(T):
        q = torch.randn(B, T, H, dk, generator=g, device=DEVICE).abs().to(dt)
        k = torch.randn(B, T, H, dk, generator=g, device=DEVICE).abs().to(dt)
        v = torch.randn(B, T, H, dv, generator=g, device=DEVICE).to(dt)
        gates = torch.randn(B, T, 2 * H, generator=g, device=DEVICE)
        gates[..., H:] += 2.0   # forget gates near 1, as test_kernels draws them
        return (q, k, v, *gates.to(dt).chunk(2, dim=-1))

    def plain(xs, state):
        h, st = mlstm_chunked_heads_plain(*(x.transpose(1, 2) for x in xs), state, chunk=chunk)
        return h.transpose(1, 2), st

    state = plain(inputs(64), None)[1] if with_state else None
    xs = inputs(S)
    got = ops.mlstm_chunked(*xs, state, chunk=chunk)
    want = plain(xs, state)
    torch.cuda.synchronize()
    return xs, state, got, want


def ssd_inputs(torch, B, S, H, G, N, P, dtype, g, views):
    """x (B, S, H, P), Bm/Cm (B, S, G, N) in ``dtype``, ~ silu of N(0, 1) as
    the conv output is; dt (B, S, H) float32 = softplus(N(0, 1) + dt_bias)
    with dt_bias drawn as ``mamba2_block_init`` draws it, so decays are the
    model's; A = -linspace(1, 16, H) as the model's A_log gives; D ~ N(0, 1)."""
    import torch.nn.functional as F

    di = H * P
    if views:
        conv = F.silu(torch.randn(B, S, di + 2 * G * N, generator=g, device=DEVICE)).to(dtype)
        x = conv[..., :di].unflatten(-1, (H, P))
        Bm = conv[..., di:di + G * N].unflatten(-1, (G, N))
        Cm = conv[..., di + G * N:].unflatten(-1, (G, N))
    else:
        x, Bm, Cm = (F.silu(torch.randn(B, S, K, W, generator=g, device=DEVICE)).to(dtype)
                     for K, W in ((H, P), (G, N), (G, N)))
    u = torch.rand(H, generator=g, device=DEVICE)
    dt_bias = torch.log(torch.expm1(torch.exp(np.log(1e-3) + u * np.log(100.0))))
    dt = F.softplus(torch.randn(B, S, H, generator=g, device=DEVICE) + dt_bias)
    A = -torch.linspace(1.0, 16.0, H, device=DEVICE)
    D = torch.randn(H, generator=g, device=DEVICE)
    return x, dt, A, Bm, Cm, D


def ssd_case(torch, B, S, H, G, chunk, with_state, views, dtype, seed):
    """Returns (inputs, state, kernel result, plain result), each result
    (y (B, S, H, P), h (B, H, N, P))."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.mamba2_ssd import ssd_chunked_plain

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    tdt = getattr(torch, dtype)
    state = None
    if with_state:
        prefix = ssd_inputs(torch, B, 64, H, G, 64, 64, tdt, g, False)
        state = ssd_chunked_plain(*prefix, chunk=chunk)[1]
    xs = ssd_inputs(torch, B, S, H, G, 64, 64, tdt, g, views)
    got = ops.ssd_chunked(*xs, state, chunk=chunk)
    want = ssd_chunked_plain(*xs, state, chunk=chunk)
    torch.cuda.synchronize()
    return xs, state, got, want


def passes_ms(torch, fn, passes) -> dict:
    """Device ms per call of ``fn`` in each of its kernels whose names
    contain one of ``passes`` (torch.profiler over 10 calls; a window that
    recorded no device time, seen once on the card, is run again)."""
    top = profile_window(torch, fn, 10, windows=3)["top_kernels_ms_per_call"]
    return {p: sum(ms for k, ms in top.items() if p in k) for p in passes}


MLSTM_PASSES = ("gates_kernel", "state_tc", "output_tc")
SSD_PASSES = ("chunk_state_tc", "combine_states", "output_tc")


def within(torch, got, want, tol) -> tuple[float, bool]:
    """(max |got - want|, whether every element is within (atol, rtol))."""
    atol, rtol = tol
    diff = (got.float() - want.float()).abs()
    return diff.max().item(), bool((diff <= atol + rtol * want.float().abs()).all())


def check_kernels(torch) -> dict:
    """Phase 3.  Returns the timed record of each kernel at its serving shape."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import mlstm
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention_heads_plain
    from repro_torch.kernels.grouped_matmul import grouped_matmul, grouped_matmul_plain

    print(f"tolerances: attention max |kernel - plain| <= {TOL} (float32 / bfloat16); "
          f"grouped_matmul |kernel - plain| <= atol + rtol |plain|, (atol, rtol) = {GMM_TOL}")
    full_lengths = [1, 2, 127, 128, 129, 2047, 2048, 5000]  # 1, S and >= S
    olmoe_lengths = [1, 129, 2048, 5000] * 2
    zamba2_lengths = [1, 2, 79, 80, 700, 2047, 2048, 5000]
    decode_cases = [
        (8, 8, 6, 2048, 128, dt, full_lengths) for dt in ("bfloat16", "float32")
    ] + [
        (8, 16, 1, 2048, 128, dt, olmoe_lengths) for dt in ("bfloat16", "float32")
    ] + [
        (3, 2, 4, 300, 64, dt, [1, 150, 300]) for dt in ("bfloat16", "float32")
    ] + [(2, 1, 8, 100, 32, "float32", [37, 100])] + [
        (8, 32, 1, 2048, 80, dt, zamba2_lengths) for dt in ("bfloat16", "float32")  # zamba2
    ] + [(2, 2, 3, 300, 80, "float32", [1, 300]), (2, 1, 8, 100, 32, "bfloat16", [37, 100])]
    # one case per cluster size: B * Hkv picked so that num_splits gives it,
    # lengths leaving some splits empty (1, 37, just under S / splits) and >= S
    for splits in dec.SPLITS:
        Hkv = max(1, dec.TARGET_BLOCKS // splits // 4)
        check(dec.num_splits(4 * Hkv) == splits, f"no B * Hkv gives {splits} splits")
        decode_cases += [(4, Hkv, 4, 1024, 128, dt, [1, 37, 1024 // splits - 1, 5000])
                         for dt in ("bfloat16", "float32")]
    # phase 6's replica shape (internlm2-20b, 4 slots): 4 splits at qpk 6,
    # lengths over its range (prompt 64..448 + 64 new tokens) and beyond
    decode_cases += [(4, 8, 6, 2048, 128, dt, lens) for dt in ("bfloat16", "float32")
                     for lens in ([1, 64, 449, 512], [513, 2047, 2048, 5000])]
    for i, (B, Hkv, qpk, S, d, dt, lens) in enumerate(decode_cases):
        _, got, want = decode_case(torch, B, Hkv, qpk, S, d, dt, lens, seed=i)
        err = max_err(torch, got, want)
        print(f"decode_attention B={B} Hkv={Hkv} qpk={qpk} S={S} d={d} {dt} "
              f"lengths={lens} splits={dec.num_splits(B * Hkv)}: max_abs_err={err:.3g}")
        check(err <= TOL[dt], f"decode_attention disagrees with its plain version: {err}")

    flash_cases = [
        (2, 48, 8, S, 128, dt, True) for S in (512, 1024) for dt in ("bfloat16", "float32")
    ] + [
        (1, 16, 16, 1024, 128, dt, True) for dt in ("bfloat16", "float32")  # olmoe, qpk=1
    ] + [
        (2, 48, 8, 512, 128, "bfloat16", False),
        (1, 48, 8, 333, 128, "bfloat16", True),   # a ragged prompt length
        (1, 48, 8, 333, 128, "float32", True),
        (2, 8, 2, 200, 64, "float32", True),
        (1, 4, 4, 96, 32, "float32", False),
    ] + [
        (1, 32, 32, S, 80, dt, True) for S in (1024, 333) for dt in ("bfloat16", "float32")
    ] + [  # zamba2's shared attention, d = 80; then bf16 at d = 64, 32 and d = 80 non-causal
        (2, 8, 2, 200, 64, "bfloat16", True),
        (1, 4, 4, 96, 32, "bfloat16", False),
        (1, 4, 4, 96, 32, "bfloat16", True),
        (1, 32, 32, 333, 80, "bfloat16", False),
    ]
    for i, (B, H, Hkv, S, d, dt, causal) in enumerate(flash_cases):
        _, got, want = flash_case(torch, B, H, Hkv, S, d, dt, causal, seed=100 + i)
        err = max_err(torch, got, want)
        print(f"flash_attention B={B} H={H} Hkv={Hkv} S={S} d={d} {dt} "
              f"causal={causal}: max_abs_err={err:.3g}")
        check(err <= TOL[dt], f"flash_attention disagrees with its plain version: {err}")

    for i, (E, C, d, f, view, what) in enumerate(GMM_CASES):
        for dt in ("bfloat16", "float32"):
            (x, w), got, want = gmm_case(torch, E, C, d, f, dt, seed=200 + i, view=view)
            err, ok = within(torch, got, want, GMM_TOL[dt])
            print(f"grouped_matmul ({E},{C},{d})x({E},{d},{f}) {dt} {what}: route "
                  f"{GMM_ROUTES[gmm.route(x, w)]}, max_abs_err={err:.3g}, "
                  f"within (atol, rtol)={GMM_TOL[dt]}: {ok}")
            check(ok, f"grouped_matmul disagrees with its plain version: {err}")

    print(f"mlstm |kernel - plain| <= atol + rtol |plain|, (atol, rtol) = {MLSTM_TOL}")
    for i, (B, H, S, dk, dv, chunk, with_state, what) in enumerate(MLSTM_CASES):
        for dt in ("bfloat16", "float32"):
            xs, _, (h, st), (hp, stp) = mlstm_case(torch, B, H, S, dk, dv, chunk, with_state,
                                                   dt, seed=300 + i)
            err_h, ok_h = within(torch, h, hp, MLSTM_TOL["h"][dt])
            errs = [within(torch, a, b, MLSTM_TOL["state"][dt]) for a, b in zip(st, stp)]
            print(f"mlstm B={B} H={H} S={S} dk={dk} dv={dv} chunk={chunk} {dt} {what}, route "
                  f"{mlstm.route(xs[0], xs[2]).replace('_', ' ')}"
                  f"{', initial state' if with_state else ''}: max_abs_err h={err_h:.3g} "
                  f"C={errs[0][0]:.3g} n={errs[1][0]:.3g} m={errs[2][0]:.3g}, within: "
                  f"{ok_h and all(ok for _, ok in errs)}")
            check(ok_h and all(ok for _, ok in errs),
                  f"mlstm disagrees with its plain version: h {err_h}, state {errs}")

    print(f"mamba2_ssd |kernel - plain| <= atol + rtol |plain|, (atol, rtol) = {SSD_TOL}")
    for i, (B, S, H, G, chunk, with_state, views, what) in enumerate(SSD_CASES):
        for dt in ("bfloat16", "float32"):
            xs, _, (y, h), (yp, hp) = ssd_case(torch, B, S, H, G, chunk, with_state, views, dt,
                                               seed=400 + i)
            err_y, ok_y = within(torch, y, yp, SSD_TOL["y"][dt])
            err_h, ok_h = within(torch, h, hp, SSD_TOL["state"][dt])
            print(f"mamba2_ssd B={B} S={S} H={H} G={G} N=P=64 chunk={chunk} {dt} {what}, route "
                  f"{ssd.route(xs[0]).replace('_', ' ')}"
                  f"{', initial state' if with_state else ''}"
                  f"{', conv-output views' if views else ''}: max_abs_err y={err_y:.3g} "
                  f"h={err_h:.3g}, within: {ok_y and ok_h}")
            check(ok_y and ok_h, f"mamba2_ssd disagrees with its plain version: y {err_y}, "
                                 f"h {err_h}")

    records = {}
    # decode at the serving shapes, whole cache valid (the 2048-position
    # bound): internlm2-20b, olmoe-1b-7b, and zamba2-2.7b's shared block at d = 80
    for key, (B, Hkv, qpk, S, d) in (("decode_attention", (8, 8, 6, 2048, 128)),
                                     ("decode_attention_olmoe", (8, 16, 1, 2048, 128)),
                                     ("decode_attention_zamba2", (8, 32, 1, 2048, 80))):
        (q, k, v, lens), got, want = decode_case(
            torch, B, Hkv, qpk, S, d, "bfloat16", [S] * B, seed=7)
        H, es = Hkv * qpk, 2
        nbytes = 2 * q.numel() * es + 2 * int(lens.sum()) * Hkv * d * es + lens.numel() * 4
        flops = 4 * int(lens.sum()) * H * d
        q4, kt, vt = q.reshape(B, Hkv, qpk, d), k.transpose(1, 2), v.transpose(1, 2)
        mask = (torch.arange(S, device=DEVICE)[None, :] < lens[:, None])[:, None, None, :]
        qs = q.transpose(1, 2)   # (B, H, 1, d)
        records[key] = dict(
            max_abs_err=max_err(torch, got, want),
            ms=time_ms(torch, lambda: ops.decode_attention_bhsd(q, k, v, lens), 50),
            plain_ms=time_ms(torch, lambda: decode_attention_plain(q4, kt, vt, lens), 20),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, kt, vt, attn_mask=mask, enable_gqa=True), 50),
            shape=f"B={B} Hkv={Hkv} qpk={qpk} S={S} d={d} bfloat16, lengths={S}, "
                  f"splits={dec.num_splits(B * Hkv)}",
            library="sdpa",
            # the evidence for num_splits: the kernel at every cluster size
            ms_by_splits={s: time_ms(torch, lambda s=s: dec._launch(q4, kt, vt, lens, splits=s),
                                     50) for s in dec.SPLITS},
        )
        records[key]["bound_ms"], records[key]["bound_by"] = bound(nbytes, flops, "bfloat16")

    # flash at the largest admission prefill, one prompt of 1024 tokens:
    # internlm2-20b, olmoe-1b-7b, and zamba2-2.7b's shared block at d = 80
    for key, (B, H, Hkv, S, d) in (("flash_attention", (1, 48, 8, 1024, 128)),
                                   ("flash_attention_olmoe", (1, 16, 16, 1024, 128)),
                                   ("flash_attention_zamba2", (1, 32, 32, 1024, 80))):
        (q, k, v), got, want = flash_case(torch, B, H, Hkv, S, d, "bfloat16", True, seed=8)
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        flops = 4 * B * H * d * (S * (S + 1) // 2)
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        records[key] = dict(
            max_abs_err=max_err(torch, got, want),
            ms=time_ms(torch, lambda: ops.flash_attention_bhsd(q, k, v, causal=True), 20),
            plain_ms=time_ms(torch, lambda: flash_attention_heads_plain(qh, kh, vh, causal=True),
                             10),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True, enable_gqa=True), 20),
            shape=f"B={B} H={H} Hkv={Hkv} S={S} d={d} bfloat16 causal",
            library="sdpa",
        )
        records[key]["bound_ms"], records[key]["bound_by"] = bound(nbytes, flops, "bfloat16")

    # grouped matmul at GMM_TIMED's shapes; a call streams 134-268 MB of
    # weights, more than the 50 MB L2, so every call finds w cold
    for regime, (E, C, d, f) in GMM_TIMED.items():
        (x, w), got, want = gmm_case(torch, E, C, d, f, "bfloat16", seed=9)
        nbytes = 2 * (x.numel() + w.numel() + E * C * f)
        flops = 2 * E * C * d * f
        rec = dict(
            max_abs_err=max_err(torch, got, want),
            ms=time_ms(torch, lambda: grouped_matmul(x, w), 20),
            plain_ms=time_ms(torch, lambda: grouped_matmul_plain(x, w), 10),
            library_ms=time_ms(torch, lambda: torch.bmm(x, w), 20),
            shape=f"({E},{C},{d})x({E},{d},{f}) bfloat16, route {GMM_ROUTES[gmm.route(x, w)]}",
            library="torch.bmm",
        )
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, "bfloat16")
        # the host time of a call (a decode step is host-bound; the prefill
        # route encodes x's tensor map on every call)
        rec["host_us"] = host_us(torch, lambda: grouped_matmul(x, w))
        records["grouped_matmul" if regime == "decode" else f"grouped_matmul_{regime}"] = rec

    # mLSTM at xlstm-1.3b admissions of 1024 and 512 tokens, empty state; the
    # work is what the function needs per (sequence*head, chunk of n
    # positions): q.k^T and scores.v on and below the diagonal, n(n+1)/2 x
    # 2(dk + dv), q.C 2n dk dv and the C update 2n dk dv
    from repro_torch.kernels.mlstm import mlstm_chunked_heads_plain

    for key, case in (("mlstm", MLSTM_CASES[0]), ("mlstm_s512", MLSTM_CASES[3])):
        B, H, S, dk, dv, chunk, _, _ = case
        xs, _, (h, _), (hp, _) = mlstm_case(torch, B, H, S, dk, dv, chunk, False, "bfloat16",
                                            seed=10)
        flops = B * H * causal_chunk_flops(S, chunk, dk, dv)
        nbytes = 2 * (2 * B * S * H * dk + 2 * B * S * H * dv + 2 * B * S * H) + 4 * B * H * (
            dk * dv + dk + 1)
        heads = [x.transpose(1, 2) for x in xs]
        records[key] = dict(
            max_abs_err=max_err(torch, h, hp),
            ms=time_ms(torch, lambda: ops.mlstm_chunked(*xs, chunk=chunk), 20),
            plain_ms=time_ms(torch, lambda: mlstm_chunked_heads_plain(*heads, chunk=chunk), 5),
            library_ms=None,
            shape=f"B={B} H={H} S={S} dk={dk} dv={dv} chunk={chunk} bfloat16, empty state, "
                  f"route {mlstm.route(xs[0], xs[2]).replace('_', ' ')}",
            library="none: no single PyTorch call computes mLSTM",
        )
        records[key]["bound_ms"], records[key]["bound_by"] = bound(nbytes, flops, "bfloat16")
        records[key]["previous"] = {"route": "cuda cores", "ms": time_ms(   # same inputs
            torch, lambda: mlstm._launch(*heads, None, chunk, None, kernel="cuda_cores"), 20)}
        records[key]["passes_ms"] = passes_ms(
            torch, lambda: ops.mlstm_chunked(*xs, chunk=chunk), MLSTM_PASSES)
    # the evidence for the state pass's walk: at B 1, H 4, S 1024 it runs
    # 128 blocks (one per 128 x 128 tile of C, B*H = 4) that each walk the 4
    # chunks in order; a chunk-parallel grid (one block per tile and chunk)
    # would run 512 blocks of one chunk each, the grid B 4, H 4, S 256 gives,
    # plus an in-order combine pass over the 4 chunks' float32 updates
    xs = mlstm_case(torch, 4, 4, 256, 512, 1024, 256, False, "bfloat16", seed=12)[0]
    records["mlstm"]["passes_ms"]["state_tc, 512 blocks of one chunk (B 4, H 4, S 256)"] = (
        passes_ms(torch, lambda: ops.mlstm_chunked(*xs, chunk=256), MLSTM_PASSES)["state_tc"])

    # SSD at zamba2-2.7b admissions of 512, 1024 and 2048 tokens (the served
    # prompt range up to max_len), empty state, x/B/C views of one conv
    # output as the block passes them; the work is what the function needs
    # per (sequence*head, chunk of n positions): C.B^T and scores.x on and
    # below the diagonal, n(n+1)/2 x 2(N + P), C.h 2n N P and the h update
    # 2n N P; the bytes are x, B, C, dt, A and D read once, y and the final h
    # written once
    B, _, H, G, chunk, _, _, _ = SSD_CASES[0]
    N = P = 64
    for key, S in (("mamba2_ssd", 1024), ("mamba2_ssd_s512", 512), ("mamba2_ssd_s2048", 2048)):
        xs, _, (y, _), (yp, _) = ssd_case(torch, B, S, H, G, chunk, False, True, "bfloat16",
                                          seed=11)
        flops = B * H * causal_chunk_flops(S, chunk, N, P)
        nbytes = 2 * (2 * B * S * H * P + 2 * B * S * G * N) + 4 * (
            B * S * H + 2 * H + B * H * N * P)
        rec = dict(
            max_abs_err=max_err(torch, y, yp),
            ms=time_ms(torch, lambda: ops.ssd_chunked(*xs, chunk=chunk), 20),
            plain_ms=time_ms(torch, lambda: ssd.ssd_chunked_plain(*xs, chunk=chunk), 5),
            library_ms=None,
            shape=f"B={B} S={S} H={H} G={G} N=P=64 chunk={chunk} bfloat16, empty state, "
                  f"route {ssd.route(xs[0]).replace('_', ' ')}",
            library="none: no single PyTorch call computes SSD",
        )
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, "bfloat16")

        def previous(xs=xs):   # the replaced route on the same inputs
            return ssd._launch(*xs, None, chunk, kernel="cuda_cores")

        rec["previous"] = {"route": "cuda cores", "ms": time_ms(torch, previous, 20)}
        rec["passes_ms"] = passes_ms(torch, lambda: ops.ssd_chunked(*xs, chunk=chunk),
                                     SSD_PASSES)
        # the host time of a call (a zamba2 admission makes 54), beside the
        # replaced route's single launch without scratch
        rec["host_us"] = host_us(torch, lambda: ops.ssd_chunked(*xs, chunk=chunk))
        rec["previous"]["host_us"] = host_us(torch, previous)
        records[key] = rec
    for name, rec in records.items():
        lib = "n/a" if rec["library_ms"] is None else f"{rec['library_ms']:.4f} ms"
        print(f"{name} timed at {rec['shape']}: kernel {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f} ms, {rec['library']} {lib}, "
              f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
        if "ms_by_splits" in rec:
            print(f"{name} ms by cluster size (splits): " + ", ".join(
                f"{s}: {ms:.4f}" for s, ms in rec["ms_by_splits"].items()))
        if "host_us" in rec:
            print(f"{name} host per call {rec['host_us']:.1f} us")
        if "passes_ms" in rec:
            print(f"{name} device ms per call by pass: " + ", ".join(
                f"{p}: {ms:.4f}" for p, ms in rec["passes_ms"].items()))
        if "previous" in rec:
            prev = rec["previous"]
            print(f"{name} previous route {prev['route']}: {prev['ms']:.4f} ms"
                  + (f", host per call {prev['host_us']:.1f} us" if "host_us" in prev else ""))
    return records


# -- phase 4: model checks against the plain path on the CPU -----------------


class RouteLog:
    """Records each MoE layer's routing (CPU copies of the float32 probs
    and the chosen experts) into ``self.calls`` while installed."""

    def __init__(self):
        self.calls = None

    def __enter__(self):
        from repro_torch.models import moe

        self._moe, self._route = moe, moe.route

        def route(x, router, cfg, tokens_per_group=4096):
            out = self._route(x, router, cfg, tokens_per_group)
            if self.calls is not None:
                self.calls.append((out[0].detach().cpu(), out[2].detach().cpu()))
            return out

        moe.route = route
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route


def routing_diff(calls_card, calls_cpu, k, T):
    """Compare the card's and the CPU's routing call by call.  Returns the
    smallest top-k margin (CPU probs), the (sequence, position) of every
    token whose expert set differs, and the margins of those tokens."""
    check(len(calls_card) == len(calls_cpu), "card and CPU made different MoE calls")
    min_margin, flipped, margins = float("inf"), [], []
    for (_, e_card), (probs, e_cpu) in zip(calls_card, calls_cpu):
        p = probs.reshape(-1, probs.shape[-1]).sort(dim=-1, descending=True).values
        margin = p[:, k - 1] - p[:, k]
        min_margin = min(min_margin, margin.min().item())
        differ = (e_card.reshape(-1, k).sort(-1).values
                  != e_cpu.reshape(-1, k).sort(-1).values).any(-1)
        for n in differ.nonzero().flatten().tolist():
            flipped.append(divmod(n, T))
            margins.append(margin[n].item())
    return min_margin, flipped, margins


def check_model(torch, arch: str) -> None:
    """Phase 4: one config at full width cut to 2 layers, float32, prefill +
    4 per-slot decode steps on the card against the plain path on the CPU.
    MoE tokens routed differently on the two sides must be near-ties; the
    positions they reach (later positions of the same sequence, and that
    lane's decode steps) are left out of the logit comparison."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products on both sides
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch), num_layers=2,
                              param_dtype="float32", dtype="float32")
    k = cfg.moe.top_k if cfg.moe else 0
    gpu, cpu = build_model(cfg, device=DEVICE), build_model(cfg, device="cpu")
    p_gpu = gpu.init(seed=0)
    p_cpu = tree_map(lambda t: t.cpu(), p_gpu)
    rng = np.random.default_rng(0)
    B, T, pos0 = MODEL_CHECKS[arch]
    max_len = T + 56
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T)))
    taint = torch.zeros(B, T, dtype=torch.bool)   # positions a routing flip reaches
    lane_taint = torch.zeros(B, dtype=torch.bool)
    min_margin, flips, flip_margins = float("inf"), [], []
    log = RouteLog()

    def both(run_card, run_cpu, t):
        """Run one call on each side; returns both results and the
        (sequence, position) of every token routed differently."""
        nonlocal min_margin
        with log:
            log.calls = []
            out_card = run_card()
            calls_card, log.calls = log.calls, []
            out_cpu = run_cpu()
        if not cfg.moe:
            return out_card, out_cpu, []
        m, fl, mg = routing_diff(calls_card, log.calls, k, t)
        min_margin = min(min_margin, m)
        flips.extend(fl)
        flip_margins.extend(mg)
        return out_card, out_cpu, fl

    (lg, cg), (lc, cc), fl = both(lambda: gpu.prefill(p_gpu, {"tokens": tokens.to(DEVICE)}),
                                  lambda: cpu.prefill(p_cpu, {"tokens": tokens}), T)
    for b, t in fl:
        taint[b, t:] = True
        lane_taint[b] = True
    keep = ~taint
    errs = [max_err(torch, lg.cpu()[keep], lc[keep]),
            max_err(torch, cg["k"].cpu()[:, keep], cc["k"][:, keep])]
    cache_g, cache_c = gpu.init_cache(B, max_len), cpu.init_cache(B, max_len)
    for name in ("k", "v"):
        cache_g[name][:, :, :T] = cg[name]
        cache_c[name][:, :, :T] = cc[name]
    pos = np.array(pos0)  # lane 1 decodes as if its prompt were shorter
    for _ in range(4):
        step = rng.integers(0, cfg.vocab_size, (B, 1))
        (lg, _), (lc, _), fl = both(
            lambda: gpu.decode_step(p_gpu, cache_g, {"tokens": torch.from_numpy(step).to(DEVICE),
                                                     "pos": torch.from_numpy(pos).to(DEVICE)}),
            lambda: cpu.decode_step(p_cpu, cache_c, {"tokens": torch.from_numpy(step),
                                                     "pos": torch.from_numpy(pos)}), 1)
        for b, _ in fl:
            lane_taint[b] = True
        if (~lane_taint).any():
            errs.append(max_err(torch, lg.cpu()[~lane_taint], lc[~lane_taint]))
        pos = pos + 1
    if (~lane_taint).any():
        errs.append(max_err(torch, cache_g["v"].cpu()[:, ~lane_taint],
                            cache_c["v"][:, ~lane_taint]))
    routing = ""
    if cfg.moe:
        routing = (f"; routing: smallest top-{k} margin {min_margin:.3g}, tokens whose "
                   f"experts differ card vs CPU {len(flips)} (margins "
                   f"{[f'{m:.3g}' for m in flip_margins]}), positions left out "
                   f"{int(taint.sum())}, lanes left out of decode {int(lane_taint.sum())}")
    print(f"model check {arch} (2 layers, float32, prefill {B}x{T} + 4 decode steps): "
          f"max |logits card - CPU| per call {[f'{e:.3g}' for e in errs]}, "
          f"tolerance {LOGIT_ATOL}{routing}")
    check(all(m < NEAR_TIE for m in flip_margins),
          f"model check {arch}: a token routed differently with margin >= {NEAR_TIE}: "
          f"{flip_margins}")
    check(max(errs) <= LOGIT_ATOL,
          f"model check {arch}: card and CPU logits differ by {max(errs)}")


def check_xlstm(torch, dtype: str = "float32") -> None:
    """Phase 4 for xlstm-1.3b: full width cut to one 7:1 group, prefill of
    2 x 300 tokens (the card's kernel runs chunks of 256 + 44, the CPU's
    plain path two chunks of 150) and 4 decode steps.  The card and the CPU,
    both in ``dtype``, are each held against a float64 run of the same
    weights on the CPU.  float32: logits within XLSTM_LOGIT_ATOL and
    XLSTM_VS_CPU x the CPU's distance, and every state leaf; bfloat16 (the
    mLSTM kernel's tensor-core route): logits within XLSTM_VS_CPU x the bf16
    CPU's distance, the state leaves' distances printed.  Both dtypes: the
    first mLSTM layer's state after the prefill, card against the card's
    own prefill with the plain mLSTM in place of the kernel (the layer's
    inputs are then the same bits, so the kernel is held at MLSTM_TOL on
    the model's activations, where deeper layers and the logits would carry
    the model's own rounding noise: ~2 logits at 8 layers in bf16)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import mlstm
    from repro_torch.models.api import build_model, tree_map

    def plain_heads(q, k, v, i_pre, f_pre, state=None, *, chunk, out=None):
        h, st = mlstm.mlstm_chunked_heads_plain(q, k, v, i_pre, f_pre, state, chunk=chunk)
        return (h if out is None else out.copy_(h)), st

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    layers, B, T = XLSTM_CHECK
    cfg = dataclasses.replace(get_config("xlstm-1.3b"), num_layers=layers,
                              param_dtype=dtype, dtype=dtype)
    cfg64 = dataclasses.replace(cfg, param_dtype="float64", dtype="float64")
    p_gpu = build_model(cfg, device=DEVICE).init(seed=0)
    p_cpu = tree_map(lambda t: t.cpu(), p_gpu)
    sides = {"card": (build_model(cfg, device=DEVICE), p_gpu, DEVICE),
             "card_plain": (build_model(cfg, device=DEVICE), p_gpu, DEVICE),
             "cpu": (build_model(cfg, device="cpu"), p_cpu, "cpu"),
             "cpu64": (build_model(cfg64, device="cpu"), tree_map(torch.Tensor.double, p_cpu),
                       "cpu")}
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T)))
    steps = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1))) for _ in range(4)]
    logits, caches, first = {}, {}, {}
    xl = cfg.xlstm
    n_mlstm = layers // (xl.mlstm_per_group + xl.slstm_per_group) * xl.mlstm_per_group
    kernel_heads = mlstm.mlstm_chunked_heads
    for name, (model, params, dev) in sides.items():
        before = mlstm.launches
        if name == "card_plain":
            mlstm.mlstm_chunked_heads = plain_heads
        try:
            lg, cache = model.prefill(params, {"tokens": tokens.to(dev)})
        finally:
            mlstm.mlstm_chunked_heads = kernel_heads
        if dev != "cpu":
            want = n_mlstm if name == "card" else 0
            check(mlstm.launches - before == want,
                  f"xlstm {name} prefill launched the mlstm kernel {mlstm.launches - before} "
                  f"times, not {want}")
        # (C, n, m) of the first mLSTM layer, copied before decode updates it
        first[name] = [leaf[0, 0].to("cpu", torch.float64, copy=True)
                       for leaf in cache["mlstm"][:3]]
        logits[name] = [lg.cpu().double()]
        if name == "card_plain":
            continue
        for step in steps:
            lg, _ = model.decode_step(params, cache, {"tokens": step.to(dev), "pos": T})
            logits[name].append(lg.cpu().double())
        caches[name] = tree_map(lambda t: t.cpu().double(), cache)

    def errs(a, b):
        return [(x - y).abs().max().item() for x, y in zip(logits[a], logits[b])]

    e_card, e_cpu, e_pair = errs("card", "cpu64"), errs("cpu", "cpu64"), errs("card", "cpu")
    state = []
    tree_map(lambda a, b: state.append(within(torch, a, b, MLSTM_TOL["state"]["float32"])),
             caches["card"], caches["cpu64"])
    f32 = dtype == "float32"
    layer0 = [within(torch, a, b, MLSTM_TOL["state"][dtype])
              for a, b in zip(first["card"], first["card_plain"])]
    print(f"model check xlstm-1.3b ({layers} layers, {dtype}): first mLSTM layer's state "
          f"after the prefill, kernel vs plain mLSTM on the card, max |diff| (C, n, m) "
          f"{[f'{e:.3g}' for e, _ in layer0]}, within {MLSTM_TOL['state'][dtype]}: "
          f"{all(ok for _, ok in layer0)}; prefill logits kernel vs plain mLSTM "
          f"{errs('card', 'card_plain')[0]:.3g}")
    print(f"model check xlstm-1.3b ({layers} layers, {dtype}, prefill {B}x{T} + 4 decode "
          f"steps), max |logits - float64 CPU| per call: card {[f'{e:.3g}' for e in e_card]}, "
          f"{dtype} CPU {[f'{e:.3g}' for e in e_cpu]}; card vs {dtype} CPU "
          f"{[f'{e:.3g}' for e in e_pair]}; tolerance "
          f"{str(XLSTM_LOGIT_ATOL) + ' and ' if f32 else ''}{XLSTM_VS_CPU}x the {dtype} CPU's; "
          f"state leaves max |card - float64| {[f'{e:.3g}' for e, _ in state]}"
          + (f", within {MLSTM_TOL['state']['float32']}: {all(ok for _, ok in state)}"
             if f32 else ""))
    check(max(e_card) <= XLSTM_VS_CPU * max(e_cpu) and (not f32 or max(e_card) <= XLSTM_LOGIT_ATOL),
          f"model check xlstm-1.3b {dtype}: card logits {max(e_card)} from float64")
    check(not f32 or all(ok for _, ok in state), "model check xlstm-1.3b: states differ")
    check(all(ok for _, ok in layer0),
          f"model check xlstm-1.3b {dtype}: the first mLSTM layer's state differs from the "
          f"plain mLSTM's on the card: {[e for e, _ in layer0]}")


def check_zamba2(torch) -> None:
    """Phase 4 for zamba2-2.7b: full width cut to 2 groups (12 Mamba2
    blocks, 2 applications of the shared block), float32, prefill of 2 x
    300 tokens (the card's SSD kernel runs chunks of 256 + 44, the CPU's
    plain path two chunks of 150) and 4 per-slot decode steps.  Logits and
    every cache leaf, card against CPU."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fla
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.models.api import build_model, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    layers, B, T = ZAMBA2_CHECK
    cfg = dataclasses.replace(get_config("zamba2-2.7b"), num_layers=layers,
                              param_dtype="float32", dtype="float32")
    apps = layers // cfg.ssm.attn_every
    gpu, cpu = build_model(cfg, device=DEVICE), build_model(cfg, device="cpu")
    p_gpu = gpu.init(seed=0)
    p_cpu = tree_map(lambda t: t.cpu(), p_gpu)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T)))
    max_len = T + 8
    before = (ssd.launches, fla.launches)
    lg, cg = gpu.prefill(p_gpu, {"tokens": tokens.to(DEVICE)})
    check((ssd.launches - before[0], fla.launches - before[1]) == (layers, apps),
          f"zamba2 prefill launched ssd {ssd.launches - before[0]}, flash "
          f"{fla.launches - before[1]} times")
    lc, cc = cpu.prefill(p_cpu, {"tokens": tokens})
    errs = [max_err(torch, lg.cpu(), lc)]
    state = {}

    def leaf_errs(card, cpu_tree):
        for name, a, b in (("h", card["mamba"][0], cpu_tree["mamba"][0]),
                           ("conv", card["mamba"][1], cpu_tree["mamba"][1]),
                           ("k", card["attn_kv"]["k"], cpu_tree["attn_kv"]["k"]),
                           ("v", card["attn_kv"]["v"], cpu_tree["attn_kv"]["v"])):
            tol = SSD_TOL["state"]["float32"] if name == "h" else (LOGIT_ATOL, 0.0)
            err, ok = within(torch, a.cpu(), b, tol)
            prev = state.get(name, (0.0, True))
            state[name] = (max(prev[0], err), prev[1] and ok)

    leaf_errs(cg, cc)
    cache_g, cache_c = gpu.init_cache(B, max_len), cpu.init_cache(B, max_len)
    for full, part in ((cache_g, cg), (cache_c, cc)):
        for i in range(2):
            full["mamba"][i].copy_(part["mamba"][i])
        for name in ("k", "v"):
            full["attn_kv"][name][:, :, :T] = part["attn_kv"][name]
    pos = np.array([T, T - 50])   # lane 1 decodes as if its prompt were shorter
    for _ in range(4):
        step = rng.integers(0, cfg.vocab_size, (B, 1))
        before = dec.launches
        lg, _ = gpu.decode_step(p_gpu, cache_g, {"tokens": torch.from_numpy(step).to(DEVICE),
                                                 "pos": torch.from_numpy(pos).to(DEVICE)})
        check(dec.launches - before == apps,
              f"zamba2 decode launched decode_attention {dec.launches - before} times")
        lc, _ = cpu.decode_step(p_cpu, cache_c, {"tokens": torch.from_numpy(step),
                                                 "pos": torch.from_numpy(pos)})
        errs.append(max_err(torch, lg.cpu(), lc))
        pos = pos + 1
    leaf_errs(cache_g, cache_c)
    print(f"model check zamba2-2.7b ({layers} Mamba2 blocks, {apps} shared-block applications, "
          f"float32, prefill {B}x{T} + 4 decode steps): max |logits card - CPU| per call "
          f"{[f'{e:.3g}' for e in errs]}, tolerance {LOGIT_ATOL}; cache leaves max "
          f"|card - CPU| {({k: f'{e:.3g}' for k, (e, _) in state.items()})}, h within "
          f"{SSD_TOL['state']['float32']}, conv/k/v within {LOGIT_ATOL}: "
          f"{all(ok for _, ok in state.values())}")
    check(max(errs) <= LOGIT_ATOL, f"model check zamba2-2.7b: card and CPU logits differ by "
                                   f"{max(errs)}")
    check(all(ok for _, ok in state.values()), f"model check zamba2-2.7b: caches differ {state}")


def check_zamba2_bf16(torch) -> None:
    """Phase 4 for zamba2-2.7b in bfloat16, the SSD kernel's tensor-core
    route that phase 5 serves: full width cut to 2 groups, prefill of 2 x
    300 tokens (the card's kernel runs chunks of 256 + 44, the CPU's plain
    path two chunks of 150) and 4 decode steps, on the card and in bfloat16
    on the CPU, each held against a float64 run of the same weights on the
    CPU: the card's logits within XLSTM_VS_CPU x the bf16 CPU's distance
    (bf16 logits carry the model's own rounding noise, as xLSTM's do).  The
    first Mamba2 layer's h after the prefill, card against the card's own
    prefill with the plain SSD in place of the kernel (the layer's inputs
    are then the same bits), within SSD_TOL["state"]["bfloat16"]."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.models.api import build_model, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    layers, B, T = ZAMBA2_CHECK
    cfg = dataclasses.replace(get_config("zamba2-2.7b"), num_layers=layers,
                              param_dtype="bfloat16", dtype="bfloat16")
    cfg64 = dataclasses.replace(cfg, param_dtype="float64", dtype="float64")
    p_gpu = build_model(cfg, device=DEVICE).init(seed=0)
    p_cpu = tree_map(lambda t: t.cpu(), p_gpu)
    sides = {"card": (cfg, p_gpu, DEVICE), "card_plain": (cfg, p_gpu, DEVICE),
             "cpu": (cfg, p_cpu, "cpu"),
             "cpu64": (cfg64, tree_map(torch.Tensor.double, p_cpu), "cpu")}
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T)))
    steps = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1))) for _ in range(4)]
    logits, first = {}, {}
    kernel = ssd.ssd_chunked
    for name, (c, params, dev) in sides.items():
        model = build_model(c, device=dev)
        before = ssd.launches
        if name == "card_plain":
            ssd.ssd_chunked = ssd.ssd_chunked_plain
        try:
            lg, part = model.prefill(params, {"tokens": tokens.to(dev)})
        finally:
            ssd.ssd_chunked = kernel
        if dev != "cpu":
            want = layers if name == "card" else 0
            check(ssd.launches - before == want,
                  f"zamba2 bf16 {name} prefill launched the ssd kernel "
                  f"{ssd.launches - before} times, not {want}")
        first[name] = part["mamba"][0][0, 0].to("cpu", torch.float64, copy=True)
        logits[name] = [lg.cpu().double()]
        if name == "card_plain":
            continue
        cache = model.init_cache(B, T + len(steps))
        for i in range(2):
            cache["mamba"][i].copy_(part["mamba"][i])
        for n in ("k", "v"):
            cache["attn_kv"][n][:, :, :T] = part["attn_kv"][n]
        for i, step in enumerate(steps):
            lg, _ = model.decode_step(params, cache, {"tokens": step.to(dev), "pos": T + i})
            logits[name].append(lg.cpu().double())

    def errs(a, b):
        return [(x - y).abs().max().item() for x, y in zip(logits[a], logits[b])]

    e_card, e_cpu, e_pair = errs("card", "cpu64"), errs("cpu", "cpu64"), errs("card", "cpu")
    tol = SSD_TOL["state"]["bfloat16"]
    err_h, ok_h = within(torch, first["card"], first["card_plain"], tol)
    used = ((first["card"] - first["card_plain"]).abs()
            / (tol[0] + tol[1] * first["card_plain"].abs())).max().item()
    print(f"model check zamba2-2.7b ({layers} Mamba2 blocks, bfloat16): first Mamba2 layer's h "
          f"after the prefill, kernel vs plain SSD on the card, max |diff| {err_h:.3g}, within "
          f"{tol}: {ok_h} (largest share of its tolerance {used:.3g}); prefill logits kernel "
          f"vs plain SSD {errs('card', 'card_plain')[0]:.3g}")
    print(f"model check zamba2-2.7b ({layers} Mamba2 blocks, bfloat16, prefill {B}x{T} + "
          f"{len(steps)} decode steps), max |logits - float64 CPU| per call: card "
          f"{[f'{e:.3g}' for e in e_card]}, bfloat16 CPU {[f'{e:.3g}' for e in e_cpu]}; card vs "
          f"bfloat16 CPU {[f'{e:.3g}' for e in e_pair]}; tolerance {XLSTM_VS_CPU}x the "
          f"bfloat16 CPU's")
    check(max(e_card) <= XLSTM_VS_CPU * max(e_cpu),
          f"model check zamba2-2.7b bfloat16: card logits {max(e_card)} from float64")
    check(ok_h, f"model check zamba2-2.7b bfloat16: the first Mamba2 layer's h differs from the "
                f"plain SSD's on the card by {err_h}")


# -- phase 5: serve the full configs -----------------------------------------


def serve(torch, arch: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fla
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import mlstm
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import Request, ServingEngine

    cfg = dataclasses.replace(get_config(arch), param_dtype="bfloat16")
    xlstm = cfg.family == "ssm"
    hybrid = cfg.family == "hybrid"
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    eng = ServingEngine(model, params, num_slots=8, max_len=2048)
    cache_bytes = sum(t.numel() * t.element_size() for t in _leaves(eng.payload["cache"]))
    ttft, step_s = [], []
    admit, step = eng.admit, eng.step

    def timed_admit(req, slot):
        t = time.perf_counter()
        admit(req, slot)          # ends on the first token's host transfer
        ttft.append(time.perf_counter() - t)

    def timed_step(key=None):
        t = time.perf_counter()
        out = step(key)           # ends on the step's host transfer
        if out:
            step_s.append((time.perf_counter() - t, len(out)))
        return out

    eng.admit, eng.step = timed_admit, timed_step
    rng = np.random.default_rng(0)
    lengths = rng.integers(64, 1025, 16)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n), max_new_tokens=64)
            for n in lengths]

    # this model's run starts here
    dec.launches = fla.launches = gmm.launches = mlstm.launches = ssd.launches = 0
    t0 = time.perf_counter()
    out = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(sorted(out) == list(range(16)), f"run() served {sorted(out)}")
    check(all(len(out[i]) == 64 for i in range(16)), "a request got the wrong token count")
    check(all(0 <= t < cfg.vocab_size for ts in out.values() for t in ts), "token out of vocab")
    n_tokens = sum(len(ts) for ts in out.values())

    # a profiled window of decode steps with all 8 slots busy, then one
    # step_many(16) block against 16 step() calls from the same state
    block = [Request(prompt=rng.integers(0, cfg.vocab_size, n), max_new_tokens=m, rid=100 + i)
             for i, (n, m) in enumerate(zip(rng.integers(64, 1025, 8), [40] * 6 + [14, 9]))]
    for slot, r in enumerate(block):
        eng.admit(r, slot)
    profile = profile_window(torch, eng.step, 4)
    snap = _snapshot(eng)
    blk = eng.step_many(16)
    got = {r.rid: list(eng.outputs[r.rid]) for r in block}
    _restore(eng, snap)
    seq = []
    for _ in range(16):
        seq.extend(eng.step())
    want = {r.rid: list(eng.outputs[r.rid]) for r in block}
    check(blk == seq and got == want, "step_many(16) differs from 16 step() calls")
    while any(r is not None for r in eng.slot_req):
        eng.step()

    # a profiled window of admissions of one 1024-token prompt (the largest
    # of the run), each evicted again: where TTFT goes.  Three, or one for
    # xLSTM, whose sLSTM prefill loop makes ~150 k launches per admission
    long_prompt = rng.integers(0, cfg.vocab_size, 1024)
    n_long = 1 if xlstm else 3

    def admit_long():
        eng.admit(Request(prompt=long_prompt, max_new_tokens=2, rid=300), 0)
        eng.evict(300)

    admit_profile = profile_window(torch, admit_long, n_long)

    sampled = eng.run([Request(prompt=rng.integers(0, cfg.vocab_size, 100),
                               max_new_tokens=8, temperature=0.8, rid=200)])[200]
    check(len(sampled) == 8 and all(0 <= t < cfg.vocab_size for t in sampled),
          f"sampled request: {sampled}")
    torch.cuda.synchronize()
    launches = {"decode_attention": dec.launches, "flash_attention": fla.launches,
                "grouped_matmul": gmm.launches, "mlstm": mlstm.launches,
                "mamba2_ssd": ssd.launches}
    admissions = 16 + len(block) + n_long + 1
    steps = eng.steps_dispatched
    # attention layers (zamba2: applications of the shared block)
    L_attn = (0 if xlstm else cfg.num_layers // cfg.ssm.attn_every if hybrid
              else cfg.num_layers)
    per = (cfg.xlstm.mlstm_per_group + cfg.xlstm.slstm_per_group) if xlstm else 1
    L_mlstm = cfg.num_layers // per * cfg.xlstm.mlstm_per_group if xlstm else 0
    L_ssd = cfg.num_layers if hybrid else 0
    expected = {"decode_attention": L_attn * steps, "flash_attention": L_attn * admissions,
                "grouped_matmul": 3 * L_attn * (steps + admissions) if cfg.moe else 0,
                "mlstm": L_mlstm * admissions, "mamba2_ssd": L_ssd * admissions}
    check(launches == expected,
          f"{arch} launches {launches} != {expected} ({cfg.num_layers} layers, {steps} steps, "
          f"{admissions} admissions)")

    full = [t for t, n in step_s if n == 8]
    stats = {
        "model": cfg.name, "layers": cfg.num_layers, "params": n_params,
        "param_bytes": n_bytes, "cache_bytes": cache_bytes,
        "dtype": "bfloat16", "num_slots": 8, "max_len": 2048,
        "init_s": init_s,
        "run_wall_s": wall, "run_tokens": n_tokens, "tokens_per_s": n_tokens / wall,
        "ttft_ms_p50": 1e3 * float(np.median(ttft[:16])),
        "ttft_ms_max": 1e3 * float(np.max(ttft[:16])),
        "ttft_n": 16,
        "prompt_tokens": int(lengths.sum()),
        "decode_step_ms_p50_8_active": 1e3 * float(np.median(full)),
        "decode_step_ms_p90_8_active": 1e3 * float(np.percentile(full, 90)),
        "decode_step_n_8_active": len(full),
        "steps_dispatched": steps, "admissions": admissions,
        "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profile_decode_step": profile,
        "profile_admission_1024": admit_profile,
    }
    print(f"served {cfg.name}: {n_params / 1e9:.2f} B params, {stats}")
    return stats


def profile_window(torch, fn, n: int, windows: int = 1) -> dict:
    """Device time of ``n`` calls of ``fn`` (decode steps, admissions) under
    ``torch.profiler``: wall time per call, device busy time per call
    (kernel time summed over the window), device operations (kernels and
    copies) per call, the idle share, and the kernels that take the most
    time.  A window in which the profiler recorded no device time is run
    again, up to ``windows`` in all (only where repeating ``fn`` changes no
    count that is checked)."""
    from torch.profiler import ProfilerActivity, profile

    for window in range(windows):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        busy_us = sum(e.self_device_time_total for e in kernels)
        if busy_us > 0:
            break
        print(f"profiler window {window + 1} of {windows} recorded no device time")
    check(busy_us > 0, "the profiler saw no device time in the window")
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    return {
        "calls": n,
        "wall_ms_per_call": 1e3 * wall / n,
        "device_busy_ms_per_call": busy_us / 1e3 / n,
        "device_ops_per_call": sum(e.count for e in kernels) / n,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "top_kernels_ms_per_call": {
            e.key[:80]: e.self_device_time_total / 1e3 / n for e in top},
    }


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _snapshot(eng):
    from repro_torch.models.api import tree_map

    p = eng.payload
    return (tree_map(lambda t: t.clone(), p["cache"]), p["tokens"].clone(),
            p["pos"].clone(), list(eng.slot_req), eng.slot_remaining.copy(),
            {r: list(t) for r, t in eng.outputs.items()})


def _restore(eng, snap):
    from repro_torch.models.api import tree_map

    cache, tokens, pos, slot_req, remaining, outputs = snap
    tree_map(lambda dst, src: dst.copy_(src), eng.payload["cache"], cache)
    eng.payload["tokens"].copy_(tokens)
    eng.payload["pos"].copy_(pos)
    eng.slot_req, eng.slot_remaining, eng.outputs = list(slot_req), remaining.copy(), outputs


def release(torch) -> None:
    """Free what a finished phase left on the card (the engine's timing
    wrappers form a reference cycle, so collect before emptying the cache)."""
    gc.collect()
    torch.cuda.empty_cache()


# -- phase 6: cluster serving through the HAM runtime ------------------------


def cluster_serve(torch) -> dict:
    """internlm2-20b at full config in bf16 through the port's
    ``ClusterServingEngine`` (2 thread workers x 4 slots, ``max_len`` 2048),
    worker-driven (decode blocks of 16), lockstep, and worker-driven on one
    worker of 4 slots, against one 4-slot ``ServingEngine`` on the same 16
    requests: token-identical transcripts, exact launch counts, tokens/s,
    TTFT and host RPCs per emitted token for each."""
    from repro_torch.configs import get_config
    from repro_torch.core import migratable as mig
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fla
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import mlstm
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import ClusterServingEngine, Request, ServingEngine
    from repro_torch.serve.handlers import _NODE_ENGINES, MAX_PROMPT

    # a CUDA tensor travels as the bytes of its host copy (pinned staging)
    t = torch.arange(48, dtype=torch.float32, device=DEVICE).reshape(6, 8)
    check(mig.pack_dynamic([t, {"t": t}]) == mig.pack_dynamic([t.cpu(), {"t": t.cpu()}]),
          "a CUDA tensor packs to other bytes than its CPU copy")

    w, slots, max_len, block = CLUSTER["workers"], CLUSTER["slots"], 2048, 16
    n_req, new = CLUSTER["requests"], CLUSTER["new_tokens"]
    cfg = dataclasses.replace(get_config("internlm2-20b"), param_dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(seed=0)
    rng = np.random.default_rng(0)
    # prompt + budget within the wire bound on an admission prompt: a
    # worker-driven continuation re-admits prompt + every emitted token
    lengths = rng.integers(64, MAX_PROMPT - new + 1, n_req)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lengths]

    def requests(rid0=0, k=n_req, budget=new):
        return [Request(prompt=prompts[i % n_req], max_new_tokens=budget, rid=rid0 + i)
                for i in range(k)]

    # TTFT is read on the host for every leg: when a request's first token
    # is in the host's hands, from the start of the drive
    def single_first(eng):
        """The single engine's admission ends on its first token's host
        transfer, on the driving thread."""
        first: dict[int, float] = {}
        admit = eng.admit

        def timed_admit(req, slot):
            admit(req, slot)
            first[req.rid] = time.monotonic()
        eng.admit = timed_admit
        return lambda: first

    def lockstep_first(sched):
        """Lockstep: the admit's reply carries the first token; its future
        resolves when the reply is dispatched on the host (admits are the
        only calls routed by session)."""
        first: dict[int, float] = {}
        submit = sched.submit

        def timed_submit(fn, *args, session=None, **kw):
            fut = submit(fn, *args, session=session, **kw)
            if session is not None:
                rid = int(session.split("/")[1])
                fut.add_done_callback(lambda f: first.setdefault(rid, time.monotonic()))
            return fut
        sched.submit = timed_submit
        return lambda: first

    def streamed_first(eng):
        """Worker-driven: the host's stream handler stamps ``t_first`` when
        the first token lands in the request's host transcript."""
        return lambda: {rid: ev["t_first"] for rid, ev in eng._events.items()
                        if rid < n_req and "t_first" in ev}

    def counts():
        return {"decode_attention": dec.launches, "flash_attention": fla.launches,
                "grouped_matmul": gmm.launches, "mlstm": mlstm.launches,
                "mamba2_ssd": ssd.launches}

    def drive(name, engines, run, first_tokens, sched=None):
        steps0 = sum(e.steps_dispatched for e in engines)
        rpc0 = 0 if sched is None else sched.stats["submitted"] + sched.stats["oneways"]
        routed0 = {} if sched is None else dict(sched.stats["routed"])
        dec.launches = fla.launches = gmm.launches = mlstm.launches = ssd.launches = 0
        t0 = time.monotonic()
        out = run(requests())
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        first = first_tokens()
        launches = counts()
        steps = sum(e.steps_dispatched for e in engines) - steps0
        tokens = sum(len(v) for v in out.values())
        check(sorted(out) == list(range(n_req)) and all(len(v) == new for v in out.values()),
              f"{name}: served {sorted(out)} with {sorted(len(v) for v in out.values())} tokens")
        check(sorted(first) == list(range(n_req)),
              f"{name}: first tokens of {sorted(first)} reached the host")
        L = cfg.num_layers
        expected = {"decode_attention": L * steps, "flash_attention": L * n_req,
                    "grouped_matmul": 0, "mlstm": 0, "mamba2_ssd": 0}
        check(launches == expected, f"{name}: launches {launches} != {expected} "
              f"({steps} decode steps, {n_req} admissions)")
        ttft = sorted(1e3 * (first[r] - t0) for r in range(n_req))
        stats = {"tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
                 "ttft_ms_p50": float(np.median(ttft)), "ttft_ms_max": ttft[-1],
                 "decode_steps": steps, "admissions": n_req, "launches": launches}
        if sched is not None:
            rpcs = sched.stats["submitted"] + sched.stats["oneways"] - rpc0
            stats.update(host_rpcs=rpcs, host_rpcs_per_token=rpcs / tokens,
                         routed={n: c - routed0.get(n, 0)
                                 for n, c in sched.stats["routed"].items()})
        return out, stats

    def margin(rid, pos, a, b):
        """Logit of token a minus token b at the first differing position,
        from one prefill of the prompt and the common prefix."""
        prefix = np.concatenate([prompts[rid], np.asarray(single_out[rid][:pos])])
        tokens = torch.from_numpy(prefix[None, :].astype(np.int64)).to(DEVICE)
        logits, _ = model.prefill(params, {"tokens": tokens})
        last = logits[0, -1].float()
        return float(last[a] - last[b])

    def same(name, out):
        for rid in range(n_req):
            got, want = out[rid], single_out[rid]
            if got != want:
                pos = next(i for i, (g, x) in enumerate(zip(got, want)) if g != x)
                check(False, f"{name}: request {rid} (prompt {len(prompts[rid])} tokens) "
                      f"differs from the single engine at token {pos}: {got[pos]} against "
                      f"{want[pos]}, logit margin {margin(rid, pos, got[pos], want[pos]):.4g}")

    # the single engine, on this (the main) thread, as phase 5 drives it
    eng = ServingEngine(model, params, num_slots=slots, max_len=max_len)
    eng.run(requests(1000, 2, block + 1))                 # warm-up
    eng.outputs.clear()
    single_out, single = drive("single engine", [eng], eng.run, single_first(eng))
    del eng
    release(torch)
    stats = {"model": cfg.name, "layers": cfg.num_layers, "dtype": "bfloat16",
             "workers": w, "slots_per_worker": slots, "max_len": max_len,
             "requests": n_req, "new_tokens": new, "prompt_tokens": int(lengths.sum()),
             "decode_block": block, "single_engine": single}
    # the third leg, one worker of as many slots as the single engine, tells
    # the runtime's own cost from the two replicas' contention
    for mode, worker_driven, workers in (("worker_driven", True, w), ("lockstep", False, w),
                                         ("worker_driven_1_worker", True, 1)):
        eng = ClusterServingEngine(model, params, num_workers=workers, slots_per_worker=slots,
                                   max_len=max_len, worker_driven=worker_driven,
                                   decode_block=block)
        try:
            replicas = [_NODE_ENGINES[k] for k in eng._engine_keys.values()]
            check(len(replicas) == workers and all(r.params is params for r in replicas),
                  f"{mode}: replicas do not share one copy of the params")
            # warm-up: workers x slots requests fill every replica (a thread's
            # first cuBLAS call sets up its handle)
            eng.run(requests(1000, workers * slots, block + 1), timeout=600)
            first = streamed_first(eng) if worker_driven else lockstep_first(eng.sched)
            out, st = drive(mode, replicas, lambda r: eng.run(r, timeout=900), first,
                            eng.sched)
        finally:
            eng.close()
        del replicas, eng
        check(len(st["routed"]) == workers and all(n > 0 for n in st["routed"].values()),
              f"{mode}: not every worker served ({st['routed']})")
        same(mode, out)
        stats[mode] = st
        release(torch)
    check(stats["worker_driven"]["host_rpcs_per_token"] < 0.1,
          f"worker-driven host RPCs per token {stats['worker_driven']['host_rpcs_per_token']}")
    print(f"cluster serving {cfg.name}: " + ", ".join(
        f"{m} {stats[m]['tokens_per_s']:.1f} tokens/s, TTFT p50 {stats[m]['ttft_ms_p50']:.1f} ms"
        + (f", {stats[m]['host_rpcs_per_token']:.4f} host RPCs/token"
           if "host_rpcs" in stats[m] else "")
        for m in ("single_engine", "worker_driven", "lockstep", "worker_driven_1_worker")))
    return stats


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build  # fails outside a checkout of the repo

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(smi[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.build(list(KERNELS))
    print(f"built {list(KERNELS)} in {time.perf_counter() - t0:.1f} s")
    for name, log in _build.build_logs.items():
        for kernel, regs, spill in ptxas_summary(log):
            print(f"  nvcc {name}: {kernel}: {regs}; {spill}")

    t0 = time.perf_counter()
    records = check_kernels(torch)
    print(f"phase 3 took {time.perf_counter() - t0:.1f} s")
    for arch in MODEL_CHECKS:
        t0 = time.perf_counter()
        check_model(torch, arch)
        release(torch)
        print(f"model check {arch} took {time.perf_counter() - t0:.1f} s")
    for arch, run in (("xlstm-1.3b", check_xlstm),
                      ("xlstm-1.3b bfloat16", lambda t: check_xlstm(t, "bfloat16")),
                      ("zamba2-2.7b", check_zamba2),
                      ("zamba2-2.7b bfloat16", check_zamba2_bf16)):
        t0 = time.perf_counter()
        run(torch)
        release(torch)
        print(f"model check {arch} took {time.perf_counter() - t0:.1f} s")
    served = {}
    for arch in SERVED:
        t0 = time.perf_counter()
        served[arch] = serve(torch, arch)
        release(torch)
        print(f"serve {arch} took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cluster = cluster_serve(torch)
    cluster["card"] = smi[0]
    release(torch)
    print(f"cluster serving took {time.perf_counter() - t0:.1f} s")
    runs = [s["launches"] for s in served.values()] + [
        cluster[m]["launches"]
        for m in ("single_engine", "worker_driven", "lockstep", "worker_driven_1_worker")]

    kernels = []
    for name, meta in KERNELS.items():
        rec = records[name]
        entry = {
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"],
            "launches": sum(run[name] for run in runs),
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
        }
        if rec["library_ms"] is None:
            entry["library"] = rec["library"]
        entry["shape"] = rec["shape"]
        entry.update({k: rec[k] for k in ("ms_by_splits", "previous", "host_us", "passes_ms")
                      if k in rec})
        for key, rec in records.items():   # the same kernel at other timed shapes
            if key.startswith(f"{name}_"):
                entry[key[len(name) + 1:]] = {k: rec[k] for k in (
                    "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "ms_by_splits", "previous", "host_us", "passes_ms")
                    if k in rec}
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    for stats in served.values():
        print(json.dumps({"serve": stats}))
    print(json.dumps({"cluster_serve": cluster}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
