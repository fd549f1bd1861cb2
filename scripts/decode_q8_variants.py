#!/usr/bin/env python3
"""Where the int8-cache decode kernel's time goes, on the card.

Builds ``csrc/decode_attention.cu`` as the repository has it and edited
copies of it under ``build/decode_q8_variants/`` (the edits are text
replacements in :data:`VARIANTS`, each checked to change the source), loads
each with ctypes in place of the repository's library, and times the
int8 decode (``ops.decode_attention_q8_bhsd``) at internlm2-20b's serving
shape (B 8, Hkv 8, qpk 6, S 2048, d 128, bf16 q) with ragged lengths, the
whole cache valid and one key a sequence, in turns (two rounds), beside
the bf16 kernel and SDPA on the dequantized cache, each cycling through 4
copies of its cache as ``chip_smoke.py`` phase 3 does:

* ``by-pass`` variants take one step out and show what it costs: no int8
  -> bf16 conversion, no products, no K/V loads, none of the key loop's
  work (the skeleton: launch, prologue, merge), the skeleton without the
  merge;
* design variants change one constant: the cluster merge on rank 0 alone,
  warps a block, keys a stage, ring stages;
* ``--parent FILE`` adds an earlier ``decode_attention.cu`` (for example
  ``git show HEAD~1:src/repro_torch/kernels/csrc/decode_attention.cu``).

Every variant that computes is also held against the plain version (the
by-pass variants compute garbage, reported and not checked).  Run from the
repository root on a machine with a card::

    python3 scripts/decode_q8_variants.py [--parent FILE] [--out FILE]
"""

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SRC = ROOT / "src/repro_torch/kernels/csrc/decode_attention.cu"
LOOP_BODY = ("    if (kw0 >= k_hi) continue;   // warp-uniform: none of this warp's keys "
             "is valid\n")
KV_LOADS = ("      cp_async16(ks + r * R8 + col, ok ? kb + (key0 + r) * k_ss + col : kb, "
            "ok ? 16 : 0);\n      cp_async16(vs + r * R8 + col, ok ? vb + (key0 + r) * v_ss "
            "+ col : vb, ok ? 16 : 0);\n")
SCALE_LOADS = ("      cp_async4(ss + r, ok ? src : kscale, ok ? 4 : 0);\n    }\n  };\n"
               "#pragma unroll\n  for (int i = 0; i < kStages8 - 1; ++i) {\n")
NO_SCALE_LOADS = ("      ss[r] = 0.f;\n    }\n  };\n"
                  "#pragma unroll\n  for (int i = 0; i < kStages8 - 1; ++i) {\n")
CONVERT = ("  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u | sel)) - "
           "8388736.f;\n")
PACK = "  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);\n"
QK_MMA = ("        mma_bf16(s[j], qf[kk], pack_exact(i8_float(u, 0), i8_float(u, 1)),\n"
          "                 pack_exact(i8_float(u, 2), i8_float(u, 3)));\n")
PV_MMA = ("        mma_bf16(acc[n], a, pack_exact(i8_float(r[0][x], sel), "
          "i8_float(r[1][x], sel)),\n                 pack_exact(i8_float(r[2][x], sel), "
          "i8_float(r[3][x], sel)));\n")
MERGE = ("  merge_store<T, D, kWarps8, CV>(pool, qpk, b, h, out + b * o_sb + h * o_sh, o_sg, "
         "lse);\n")

# name -> [(old, new), ...] applied to the source; "computes" False for a
# by-pass that leaves the output meaningless
VARIANTS = {
    "no_convert": ([(CONVERT, "  return __uint_as_float(u << (8 * sel));\n"),
                    (PACK, "  return __float_as_uint(lo) ^ __float_as_uint(hi);\n")], False),
    "no_mma": ([(QK_MMA, "        s[j][kk & 3] += __uint_as_float(pack_exact(i8_float(u, 0), "
                         "i8_float(u, 1)) ^ pack_exact(i8_float(u, 2), i8_float(u, 3)) ^ "
                         "qf[kk][0]);\n"),
                (PV_MMA, "        acc[n][sel] += __uint_as_float(pack_exact(i8_float(r[0][x], "
                         "sel), i8_float(r[1][x], sel)) ^ pack_exact(i8_float(r[2][x], sel), "
                         "i8_float(r[3][x], sel)) ^ a[sel]);\n")], False),
    "no_kv_loads": ([(KV_LOADS, "")], False),
    "skeleton": ([(LOOP_BODY, "    if (kw0 >= k_hi || kw0 >= 0) continue;\n"),
                  (KV_LOADS, ""), (SCALE_LOADS, NO_SCALE_LOADS)], False),
    "skeleton_no_merge": ([(LOOP_BODY, "    if (kw0 >= k_hi || kw0 >= 0) continue;\n"),
                           (KV_LOADS, ""), (SCALE_LOADS, NO_SCALE_LOADS),
                           (MERGE, "  if (tid == 0 && qpk < 0) out[0] = "
                                   "__float2bfloat16_rn(pool[0]);\n")], False),
    "rank0_merge": ([("  const int per = (qpk * D + splits - 1) / splits;\n"
                      "  const int lo = rank * per, hi = min(qpk * D, lo + per);\n",
                      "  const int per = rank == 0 ? qpk * D : 0;\n"
                      "  const int lo = 0, hi = per;\n")], True),
    "warps4": ([("constexpr int kWarps8 = 8;", "constexpr int kWarps8 = 4;")], True),
    "keys128_stages4": ([("constexpr int kKeys8 = 256;", "constexpr int kKeys8 = 128;"),
                         ("constexpr int kStages8 = 2;", "constexpr int kStages8 = 4;")], True),
    "keys128_stages2": ([("constexpr int kKeys8 = 256;", "constexpr int kKeys8 = 128;")], True),
}


def edited(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"variant edit not found once in the source: {old!r}")
        src = src.replace(old, new)
    return src


def load(path: Path, signatures):
    lib = ctypes.CDLL(str(path))
    lib.ham_error_string.argtypes = [ctypes.c_int]
    lib.ham_error_string.restype = ctypes.c_char_p
    for symbol, argtypes in signatures.items():
        if hasattr(lib, symbol):
            getattr(lib, symbol).argtypes = argtypes
            getattr(lib, symbol).restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="an earlier decode_attention.cu to time too")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "decode_q8_variants.json")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels.ref import dequantize_kv

    if not torch.cuda.is_available():
        print("decode_q8_variants.py needs a CUDA device", file=sys.stderr)
        return 1
    src = SRC.read_text()
    sources = {name: edited(src, edits) for name, (edits, _) in VARIANTS.items()}
    computes = {name: ok for name, (_, ok) in VARIANTS.items()}
    if args.parent:
        sources["parent"], computes["parent"] = args.parent.read_text(), True
    vdir = ROOT / "build" / "decode_q8_variants"
    vdir.mkdir(parents=True, exist_ok=True)
    for header in SRC.parent.glob("*.cuh"):
        (vdir / header.name).write_text(header.read_text())
    nvcc, t0 = _build._nvcc(), time.perf_counter()
    jobs = {}
    for name, text in sources.items():
        (vdir / f"{name}.cu").write_text(text)
        jobs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(vdir / f"lib{name}.so"), str(vdir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.build(["decode_attention"])
    libs, ptxas = {"kernel": _build.library("decode_attention", dec._SIGNATURES)}, {}
    logs = {"kernel": _build.build_logs.get("decode_attention", "")}
    for name, job in jobs.items():
        logs[name], _ = job.communicate()
        if job.returncode:
            raise SystemExit(f"variant {name} did not build:\n{logs[name][-4000:]}")
        libs[name] = load(vdir / f"lib{name}.so", dec._SIGNATURES)
    for name, log in logs.items():
        ptxas[name] = [f"{k}: {r}; {sp}" for k, r, sp in cs.ptxas_summary(log)
                       if "decode_q8_bf16<128>" in k or "bfloat16, 128, true>" in k]
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")
    mine = libs["kernel"]

    B, Hkv, qpk, S, d = 8, 8, 6, 2048, 128
    cases = {"ragged": [1, 2, 127, 128, 129, 2047, 2048, 5000], "full": [S] * B,
             "one_key": [1] * B}
    out = {"shape": f"B={B} Hkv={Hkv} qpk={qpk} S={S} d={d} bfloat16 q, int8 K/V",
           "ptxas": ptxas, "cases": {}}
    for case, lengths in cases.items():
        (q, kq, vq, ks, vs, lens), _, want = cs.q8_case(torch, B, Hkv, qpk, S, d, "bfloat16",
                                                         lengths, seed=16)
        kd, vd = dequantize_kv(kq, ks, q.dtype), dequantize_kv(vq, vs, q.dtype)
        t = lambda a: a.transpose(1, 2)
        mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        q8s = [(kq, vq, ks, vs)] + [tuple(x.clone() for x in (kq, vq, ks, vs)) for _ in range(3)]
        bf16s = [(kd, vd)] + [(kd.clone(), vd.clone()) for _ in range(3)]
        valid = int(lens.clamp(max=S).sum())
        rec = {"lengths": lengths, "bound_ms": cs.bound(
            2 * q.numel() * 2 + 2 * valid * Hkv * (d + 4) + B * 4, 4 * valid * Hkv * qpk * d,
            "bfloat16")[0], "ms": {}, "max_abs_err": {}}
        for _ in range(2):   # two rounds in turns
            for name, lib in libs.items():
                _build._LIBS["decode_attention"] = lib
                call = lambda c: ops.decode_attention_q8_bhsd(q, *c, lens)
                rec["ms"].setdefault(name, []).append(cs.time_ms(torch, cs.rotating(call, q8s), 48))
                err = cs.max_err(torch, call(q8s[0]), want)
                rec["max_abs_err"][name] = err
                if computes.get(name, True):
                    cs.check(err <= cs.TOL["bfloat16"], f"{name} disagrees with plain: {err}")
            _build._LIBS["decode_attention"] = mine
            rec["ms"].setdefault("bf16_kernel_dequantized", []).append(cs.time_ms(
                torch, cs.rotating(lambda c: ops.decode_attention_bhsd(q, *c, lens), bf16s), 48))
            rec["ms"].setdefault("sdpa_dequantized", []).append(cs.time_ms(
                torch, cs.rotating(lambda c: F.scaled_dot_product_attention(
                    q.transpose(1, 2), t(c[0]), t(c[1]), attn_mask=mask, enable_gqa=True),
                    bf16s), 48))
        out["cases"][case] = rec
        print(case, json.dumps({k: [round(x, 5) for x in v] for k, v in rec["ms"].items()}))
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(out["card"])
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
