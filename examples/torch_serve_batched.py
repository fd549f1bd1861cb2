"""Serving example on the PyTorch port: continuous batching through the HAM
device dispatch table (greedy + sampled requests in one fleet).

On the card (the default) it serves the published config at full width in
bfloat16 with seeded random weights; with ``--device cpu`` it serves the
reduced config, as ``examples/serve_batched.py`` does.  Without a card and
without ``--device cpu`` it raises:

    python examples/torch_serve_batched.py [--arch olmoe-1b-7b] [--requests 8] [--device cpu]
"""

import argparse
import dataclasses
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.models.api import build_model, resolve_device
from repro_torch.models.counting import count_params
from repro_torch.serve.engine import Request, ServingEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmoe-1b-7b", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)

    if device.type == "cpu":
        cfg = get_reduced(args.arch)
    else:  # the reduced widths fall outside the attention kernels' head dims
        cfg = dataclasses.replace(get_config(args.arch), param_dtype="bfloat16")
    model = build_model(cfg, device=device)
    params = model.init(seed=0)
    eng = ServingEngine(model, params, num_slots=args.slots, max_len=64, device=device)
    print(f"arch={cfg.name}  {cfg.num_layers} layers, {count_params(cfg) / 1e9:.2f} B params "
          f"({cfg.param_dtype}) on {device.type}")
    print(f"dispatch table: {[h.stable_name for h in eng.table.handlers]}")

    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(3, 12))
        reqs.append(Request(
            prompt=rng.integers(0, cfg.vocab_size, plen),
            max_new_tokens=int(rng.integers(4, args.max_new)),
            temperature=0.0 if i % 2 == 0 else 0.9,
        ))
    t0 = time.perf_counter()
    out = eng.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in out.values())
    for rid in sorted(out):
        mode = "greedy" if reqs[rid].temperature == 0 else "sample"
        print(f"req {rid} [{mode:6s}] -> {out[rid]}")
    print(f"{total} tokens in {dt:.2f}s over {eng.steps_dispatched} batched "
          f"steps and {len(reqs)} admissions ({total/dt:.1f} tok/s, "
          f"{total/eng.steps_dispatched:.2f} tokens/step batching efficiency)")


if __name__ == "__main__":
    main()
