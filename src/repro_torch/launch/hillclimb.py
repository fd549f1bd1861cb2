"""Hillclimb on the H100 roofline: hypothesis -> change -> re-run
the dry-run -> compare (port of ``repro.launch.hillclimb``; the same three
climbs, each a (cfg_override, plan_override) delta against
``plans.tuned_config``/``plans.plan_for``):

1. llama3-405b x train_4k   -- collective-bound (activation reductions)
2. qwen1.5-4b x prefill_32k -- attention's share of the flops
3. llama3-405b x decode_32k -- the serving step, and whether it fits 80 GB

Each iteration's report is saved with its tag beside the baselines.  Run
in a fresh interpreter (``python -m repro_torch.launch.hillclimb [which]``:
the fake process group is process-global).
"""

from __future__ import annotations

import dataclasses
import sys

from repro_torch.launch import plans
from repro_torch.launch.dryrun import lower_cell
from repro_torch.launch.mesh import fake_world
from repro_torch.models.config import shape_cell


def _show(label, r, base=None):
    extra = ""
    if base is not None:
        dom = base.bottleneck
        before = {"compute": base.t_compute, "memory": base.t_memory,
                  "collective": base.t_collective}[dom]
        after = {"compute": r.t_compute, "memory": r.t_memory,
                 "collective": r.t_collective}[dom]
        extra = (f"  [dominant({dom}): {before*1e3:.1f} -> {after*1e3:.1f} ms, "
                 f"{(1 - after/before)*100:+.1f}% | roofline "
                 f"{base.roofline_fraction*100:.1f}% -> {r.roofline_fraction*100:.1f}%]")
    print(f"--- {label}\n{r.summary()}{extra}", flush=True)


def _cell(arch, cell, tag, **kw):
    return lower_cell(arch, cell, multi_pod=False, tag=tag, save=True, verbose=False, **kw)


def climb_llama_train():
    arch, cell = "llama3-405b", "train_4k"
    c = shape_cell(cell)
    base = _cell(arch, cell, "baseline")
    _show("BASELINE (reference sharding, remat=full)", base)
    # it1: no recompute forward (the reference's remat="dots"; the port's
    # remat saves nothing inside a layer or everything), so one sweep of
    # activation reductions fewer, at more saved memory
    cfg1 = dataclasses.replace(plans.tuned_config(arch, c), remat="none", remat_group=1)
    r1 = _cell(arch, cell, "it1_no_remat", cfg_override=cfg1)
    _show("it1 no recompute pass", r1, base)
    # it2: int8 error-feedback gradient compression
    r2 = _cell(arch, cell, "it2_grad_int8", train_variant="compressed")
    _show("it2 int8 EF gradient compression", r2, base)
    r3 = _cell(arch, cell, "it3_combined", cfg_override=cfg1, train_variant="compressed")
    _show("it3 combined", r3, base)
    return base, [r1, r2, r3]


def climb_qwen_prefill():
    arch, cell = "qwen1.5-4b", "prefill_32k"
    c = shape_cell(cell)
    base = _cell(arch, cell, "baseline")
    _show("BASELINE", base)
    # it1: causal skip in the configuration (the port's flash kernel skips
    # the masked tiles whatever the flag says; the plain version on meta
    # counts the whole square)
    cfg1 = dataclasses.replace(plans.tuned_config(arch, c), attn_causal_skip=True)
    r1 = _cell(arch, cell, "it1_causal_skip", cfg_override=cfg1)
    _show("it1 causal-skip", r1, base)
    return base, [r1]


def climb_llama_decode():
    arch, cell = "llama3-405b", "decode_32k"
    c = shape_cell(cell)
    base = _cell(arch, cell, "baseline")
    _show("BASELINE (TP-only weights)", base)
    # it1: serve-FSDP: weights stored split over data too, gathered per
    # layer: fits, at the price of an all-gather sweep each step
    plan1 = dataclasses.replace(plans.plan_for(arch, c, multi_pod=False), fsdp=True)
    r1 = _cell(arch, cell, "it1_serve_fsdp", plan_override=plan1)
    _show("it1 serve-FSDP", r1, base)
    # it2: + int8 KV cache (per-vector scales): half the cache bytes
    cfg2 = dataclasses.replace(plans.tuned_config(arch, c), kv_quant=True)
    r2 = _cell(arch, cell, "it2_kv_int8", cfg_override=cfg2, plan_override=plan1)
    _show("it2 + int8 KV cache", r2, base)
    return base, [r1, r2]


def main(argv):
    which = argv[0] if argv else "all"
    fake_world(256)
    if which in ("all", "llama_train"):
        climb_llama_train()
    if which in ("all", "qwen_prefill"):
        climb_qwen_prefill()
    if which in ("all", "llama_decode"):
        climb_llama_decode()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
