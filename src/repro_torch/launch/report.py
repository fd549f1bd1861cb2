"""Render the roofline tables from the dry-run's JSON reports (port of
``repro.launch.report``), on the H100 terms of ``launch.roofline``."""

from __future__ import annotations

import json
import os

from repro_torch.launch.roofline import EXPERIMENT_DIR

ARCH_ORDER = [
    "xlstm-1.3b", "internlm2-20b", "qwen1.5-4b", "llama3-405b",
    "nemotron-4-340b", "olmoe-1b-7b", "qwen2-moe-a2.7b", "internvl2-76b",
    "zamba2-2.7b", "whisper-large-v3",
]
CELL_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
SKIPS = {(a, "long_500k") for a in ARCH_ORDER if a not in ("xlstm-1.3b", "zamba2-2.7b")}


def load_reports(tag: str = "baseline") -> dict:
    d = os.path.join(EXPERIMENT_DIR, "dryrun_h100")
    out = {}
    for name in os.listdir(d) if os.path.isdir(d) else ():
        if not name.endswith(f"_{tag}.json"):
            continue
        with open(os.path.join(d, name)) as f:
            r = json.load(f)
        out[(r["arch"], r["cell"], r["mesh"])] = r
    return out


def _fmt_ms(s: float) -> str:
    return f"{s*1e3:.2f}"


def roofline_table(tag: str = "baseline", mesh: str = "pod16x16") -> str:
    reports = load_reports(tag)
    lines = [
        "| arch | cell | comp (ms) | mem (ms) | coll (ms) | bound | "
        "MODEL_FLOPS | useful | roofline |",
        "|---|---|---:|---:|---:|---|---:|---:|---:|",
    ]
    for arch in ARCH_ORDER:
        for cell in CELL_ORDER:
            if (arch, cell) in SKIPS:
                lines.append(f"| {arch} | {cell} | — | — | — | SKIP (full attention "
                             f"at 524k) | — | — | — |")
                continue
            r = reports.get((arch, cell, mesh))
            if r is None:
                lines.append(f"| {arch} | {cell} | MISSING | | | | | | |")
                continue
            lines.append(
                f"| {arch} | {cell} | {_fmt_ms(r['t_compute'])} | "
                f"{_fmt_ms(r['t_memory'])} | {_fmt_ms(r['t_collective'])} | "
                f"{r['bottleneck']} | {r['model_flops']:.2e} | "
                f"{r['useful_ratio']*100:.1f}% | {r['roofline_fraction']*100:.1f}% |")
    return "\n".join(lines)


def dryrun_table(tag: str = "baseline") -> str:
    reports = load_reports(tag)
    lines = [
        "| arch | cell | mesh | per-GPU bytes (args+temp) | flops/GPU | "
        "collective B/GPU | dominant collective |",
        "|---|---|---|---:|---:|---:|---|",
    ]
    for arch in ARCH_ORDER:
        for cell in CELL_ORDER:
            for mesh in ("pod16x16", "pod2x16x16"):
                r = reports.get((arch, cell, mesh))
                if r is None:
                    continue
                mem = r["memory_stats"]
                dom = max(r["collective_by_op"].items(),
                          key=lambda kv: kv[1])[0] if r["collective_by_op"] else "-"
                lines.append(
                    f"| {arch} | {cell} | {mesh} | {mem['per_gpu_bytes']/1e9:.2f} GB | "
                    f"{r['flops_per_chip']:.2e} | {r['collective_bytes_per_chip']:.2e} | "
                    f"{dom} |")
    return "\n".join(lines)


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--table", default="roofline", choices=["roofline", "dryrun"])
    ap.add_argument("--mesh", default="pod16x16")
    args = ap.parse_args()
    if args.table == "roofline":
        print(roofline_table(args.tag, args.mesh))
    else:
        print(dryrun_table(args.tag))


if __name__ == "__main__":
    main()
