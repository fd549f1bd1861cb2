#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of HAM (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. hold each kernel against its plain PyTorch version on the card at the
   serving shapes, float32 and bfloat16, and time kernel, plain version and
   the ``scaled_dot_product_attention`` yardstick;
4. model check: internlm2-20b at full width cut to 2 layers, float32
   weights, prefill + 4 per-slot decode steps with the kernels on the card
   against the plain path on the CPU;
5. serve internlm2-20b at its full published config in bfloat16 (48
   layers, seeded random weights): 16 greedy requests through ``run()``, a
   ``step_many(16)`` block against 16 ``step()`` calls from the same state,
   and one sampled request, with the kernels' launch counters checked;
6. print the kernel line and the serving line (JSON);
7. last line: ``{"ok": true, "device": {...}}``.

Needs CUDA; imports nothing of JAX or of the reference package ``repro``.
"""

from __future__ import annotations

import dataclasses
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
LOGIT_ATOL = 1e-3  # float32 logits, card vs CPU: sums over d=6144/16384 in another order

KERNELS = {
    "decode_attention": {
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:32",
    },
    "flash_attention": {
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:32",
    },
}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(torch, a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


# -- phase 3: kernels against their plain versions ---------------------------


def decode_case(torch, B, Hkv, qpk, S, d, dtype, lengths, seed):
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_plain

    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn(B, 1, Hkv * qpk, d, generator=g, device="cuda").to(dt)
    k = torch.randn(B, S, Hkv, d, generator=g, device="cuda").to(dt)   # model cache layout
    v = torch.randn(B, S, Hkv, d, generator=g, device="cuda").to(dt)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    got = ops.decode_attention_bhsd(q, k, v, lens)
    want = decode_attention_plain(
        q.reshape(B, Hkv, qpk, d), k.transpose(1, 2), v.transpose(1, 2), lens
    ).reshape(B, 1, Hkv * qpk, d)
    torch.cuda.synchronize()
    return (q, k, v, lens), got, want


def flash_case(torch, B, H, Hkv, S, d, dtype, causal, seed):
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_heads_plain

    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn(B, S, H, d, generator=g, device="cuda").to(dt)     # model layout
    k = torch.randn(B, S, Hkv, d, generator=g, device="cuda").to(dt)
    v = torch.randn(B, S, Hkv, d, generator=g, device="cuda").to(dt)
    got = ops.flash_attention_bhsd(q, k, v, causal=causal)
    want = flash_attention_heads_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal
    ).transpose(1, 2)
    torch.cuda.synchronize()
    return (q, k, v), got, want


def check_kernels(torch) -> dict:
    """Phase 3.  Returns the timed record of each kernel at its serving shape."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention_heads_plain

    print(f"tolerances: max |kernel - plain| <= {TOL} (float32 / bfloat16)")
    full_lengths = [1, 2, 127, 128, 129, 2047, 2048, 5000]  # 1, S and >= S
    decode_cases = [
        (8, 8, 6, 2048, 128, dt, full_lengths) for dt in ("bfloat16", "float32")
    ] + [
        (3, 2, 4, 300, 64, dt, [1, 150, 300]) for dt in ("bfloat16", "float32")
    ] + [(2, 1, 8, 100, 32, "float32", [37, 100])]
    for i, (B, Hkv, qpk, S, d, dt, lens) in enumerate(decode_cases):
        _, got, want = decode_case(torch, B, Hkv, qpk, S, d, dt, lens, seed=i)
        err = max_err(torch, got, want)
        print(f"decode_attention B={B} Hkv={Hkv} qpk={qpk} S={S} d={d} {dt} "
              f"lengths={lens}: max_abs_err={err:.3g}")
        check(err <= TOL[dt], f"decode_attention disagrees with its plain version: {err}")

    flash_cases = [
        (2, 48, 8, S, 128, dt, True) for S in (512, 1024) for dt in ("bfloat16", "float32")
    ] + [
        (2, 48, 8, 512, 128, "bfloat16", False),
        (1, 48, 8, 333, 128, "bfloat16", True),   # a ragged prompt length
        (1, 48, 8, 333, 128, "float32", True),
        (2, 8, 2, 200, 64, "float32", True),
        (1, 4, 4, 96, 32, "float32", False),
    ]
    for i, (B, H, Hkv, S, d, dt, causal) in enumerate(flash_cases):
        _, got, want = flash_case(torch, B, H, Hkv, S, d, dt, causal, seed=100 + i)
        err = max_err(torch, got, want)
        print(f"flash_attention B={B} H={H} Hkv={Hkv} S={S} d={d} {dt} "
              f"causal={causal}: max_abs_err={err:.3g}")
        check(err <= TOL[dt], f"flash_attention disagrees with its plain version: {err}")

    records = {}
    # decode at the serving shape, whole cache valid (the 2048-position bound)
    B, Hkv, qpk, S, d = 8, 8, 6, 2048, 128
    (q, k, v, lens), got, want = decode_case(
        torch, B, Hkv, qpk, S, d, "bfloat16", [S] * B, seed=7)
    H, es = Hkv * qpk, 2
    nbytes = 2 * q.numel() * es + 2 * int(lens.sum()) * Hkv * d * es + lens.numel() * 4
    flops = 4 * int(lens.sum()) * H * d
    q4, kt, vt = q.reshape(B, Hkv, qpk, d), k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    qs = q.transpose(1, 2)   # (B, H, 1, d)
    records["decode_attention"] = dict(
        max_abs_err=max_err(torch, got, want),
        ms=time_ms(torch, lambda: ops.decode_attention_bhsd(q, k, v, lens), 50),
        plain_ms=time_ms(torch, lambda: decode_attention_plain(q4, kt, vt, lens), 20),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, kt, vt, attn_mask=mask, enable_gqa=True), 50),
        shape=f"B={B} Hkv={Hkv} qpk={qpk} S={S} d={d} bfloat16, lengths={S}",
    )
    records["decode_attention"]["bound_ms"], records["decode_attention"]["bound_by"] = \
        bound(nbytes, flops, "bfloat16")

    # flash at the largest admission prefill: one prompt of 1024 tokens
    B, H, Hkv, S, d = 1, 48, 8, 1024, 128
    (q, k, v), got, want = flash_case(torch, B, H, Hkv, S, d, "bfloat16", True, seed=8)
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    flops = 4 * B * H * d * (S * (S + 1) // 2)
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    records["flash_attention"] = dict(
        max_abs_err=max_err(torch, got, want),
        ms=time_ms(torch, lambda: ops.flash_attention_bhsd(q, k, v, causal=True), 20),
        plain_ms=time_ms(torch, lambda: flash_attention_heads_plain(qh, kh, vh, causal=True), 10),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, enable_gqa=True), 20),
        shape=f"B={B} H={H} Hkv={Hkv} S={S} d={d} bfloat16 causal",
    )
    records["flash_attention"]["bound_ms"], records["flash_attention"]["bound_by"] = \
        bound(nbytes, flops, "bfloat16")
    for name, rec in records.items():
        print(f"{name} timed at {rec['shape']}: kernel {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f} ms, sdpa {rec['library_ms']:.4f} ms, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    return records


# -- phase 4: model check against the plain path on the CPU ------------------


def check_model(torch) -> None:
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model

    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products on both sides
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("internlm2-20b"), num_layers=2,
                              param_dtype="float32", dtype="float32")
    gpu, cpu = build_model(cfg), build_model(cfg, device="cpu")
    p_gpu = gpu.init(seed=0)
    p_cpu = _tree_to(p_gpu, "cpu")
    rng = np.random.default_rng(0)
    B, T, max_len = 2, 200, 256
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T)))
    lg, cg = gpu.prefill(p_gpu, {"tokens": tokens.cuda()})
    lc, cc = cpu.prefill(p_cpu, {"tokens": tokens})
    errs = [max_err(torch, lg.cpu(), lc), max_err(torch, cg["k"].cpu(), cc["k"])]
    cache_g, cache_c = gpu.init_cache(B, max_len), cpu.init_cache(B, max_len)
    for name in ("k", "v"):
        cache_g[name][:, :, :T] = cg[name]
        cache_c[name][:, :, :T] = cc[name]
    pos = np.array([T, 150])  # lane 1 decodes as if its prompt were shorter
    for _ in range(4):
        step = rng.integers(0, cfg.vocab_size, (B, 1))
        lg, _ = gpu.decode_step(p_gpu, cache_g, {"tokens": torch.from_numpy(step).cuda(),
                                                 "pos": torch.from_numpy(pos).cuda()})
        lc, _ = cpu.decode_step(p_cpu, cache_c, {"tokens": torch.from_numpy(step),
                                                 "pos": torch.from_numpy(pos)})
        errs.append(max_err(torch, lg.cpu(), lc))
        pos = pos + 1
    errs.append(max_err(torch, cache_g["v"].cpu(), cache_c["v"]))
    print(f"model check internlm2-20b (2 layers, float32, prefill {B}x{T} + 4 decode "
          f"steps): max |logits card - CPU| per call {[f'{e:.3g}' for e in errs]}, "
          f"tolerance {LOGIT_ATOL}")
    check(max(errs) <= LOGIT_ATOL, f"model check: card and CPU logits differ by {max(errs)}")


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


# -- phase 5: serve the full config ------------------------------------------


def serve(torch) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fla
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import Request, ServingEngine

    cfg = dataclasses.replace(get_config("internlm2-20b"), param_dtype="bfloat16")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    eng = ServingEngine(model, params, num_slots=8, max_len=2048)
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

    dec.launches = fla.launches = 0          # the main path's run starts here
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
    profile = profile_steps(torch, eng, 4)
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

    sampled = eng.run([Request(prompt=rng.integers(0, cfg.vocab_size, 100),
                               max_new_tokens=8, temperature=0.8, rid=200)])[200]
    check(len(sampled) == 8 and all(0 <= t < cfg.vocab_size for t in sampled),
          f"sampled request: {sampled}")
    torch.cuda.synchronize()
    launches = {"decode_attention": dec.launches, "flash_attention": fla.launches}
    admissions = 16 + len(block) + 1
    check(launches["decode_attention"] == cfg.num_layers * eng.steps_dispatched,
          f"decode launches {launches['decode_attention']} != 48 x {eng.steps_dispatched} steps")
    check(launches["flash_attention"] == cfg.num_layers * admissions,
          f"flash launches {launches['flash_attention']} != 48 x {admissions} admissions")

    full = [t for t, n in step_s if n == 8]
    stats = {
        "model": cfg.name, "layers": cfg.num_layers, "params": n_params,
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
        "steps_dispatched": eng.steps_dispatched, "admissions": admissions,
        "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profile": profile,
    }
    print(f"served {cfg.name}: {n_params / 1e9:.2f} B params, {stats}")
    return stats


def profile_steps(torch, eng, n: int) -> dict:
    """Device time of ``n`` greedy decode steps under ``torch.profiler``:
    wall time per step, device busy time per step (kernel time summed over
    the window), the idle share, and the kernels that take the most time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_us = sum(e.self_device_time_total for e in kernels)
    check(busy_us > 0, "the profiler saw no device time in the decode window")
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    return {
        "steps": n,
        "wall_ms_per_step": 1e3 * wall / n,
        "device_busy_ms_per_step": busy_us / 1e3 / n,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "top_kernels_ms_per_step": {
            e.key[:80]: e.self_device_time_total / 1e3 / n for e in top},
    }


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _snapshot(eng):
    p = eng.payload
    return ({k: p["cache"][k].clone() for k in ("k", "v")}, p["tokens"].clone(),
            p["pos"].clone(), list(eng.slot_req), eng.slot_remaining.copy(),
            {r: list(t) for r, t in eng.outputs.items()})


def _restore(eng, snap):
    cache, tokens, pos, slot_req, remaining, outputs = snap
    for k in ("k", "v"):
        eng.payload["cache"][k].copy_(cache[k])
    eng.payload["tokens"].copy_(tokens)
    eng.payload["pos"].copy_(pos)
    eng.slot_req, eng.slot_remaining, eng.outputs = list(slot_req), remaining.copy(), outputs


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
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  nvcc {name}: {line.strip()}")

    records = check_kernels(torch)
    check_model(torch)
    torch.cuda.empty_cache()
    stats = serve(torch)

    kernels = []
    for name, meta in KERNELS.items():
        rec = records[name]
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": stats["launches"][name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"serve": stats}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
