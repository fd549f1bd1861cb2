"""Dry-run of every (arch x cell x mesh) on ``meta`` DTensors, with the H100
roofline (port of ``repro.launch.dryrun``).

For each cell the dry-run:
  1. builds the full-size config (``plans.tuned_config``) on ``meta`` and
     the production mesh over a fake process group (single-pod 16 x 16 =
     256 GPUs, multi-pod 2 x 16 x 16 = 512), the counterpart of the
     reference's forced host device count;
  2. places params, AdamW moments, cache and batch by the divisibility-aware
     rules (``models.sharding.Sharder``);
  3. runs the cell's step (train: forward, backward and the AdamW update;
     prefill; decode) under ``op_analysis``, the kernels' plain versions on
     ``meta``: no array is allocated;
  4. prints the roofline report on the H100 constants, the exact per-GPU
     argument bytes and the peak of the step's own results, and saves the
     report as JSON.

The fake group is process-global: run it in a fresh interpreter::

    python -m repro_torch.launch.dryrun --arch internlm2-20b --cell train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from repro_torch.configs import ARCH_IDS
from repro_torch.launch import plans
from repro_torch.launch.mesh import PRODUCTION, fake_world, make_mesh
from repro_torch.launch.op_analysis import analyze
from repro_torch.launch.roofline import (
    HBM_BYTES,
    analytic_memory_bytes,
    build_report,
    save_report,
    tree_shard_bytes,
)
from repro_torch.models.api import batch_rules, build_model
from repro_torch.models.config import SHAPE_CELLS, shape_cell, supports_cell
from repro_torch.models.counting import model_flops
from repro_torch.models.sharding import Sharder, tree_spec
from repro_torch.optim import adamw
from repro_torch.train.step import build_compressed_train_step, build_train_step


def spec_tree(sharder: Sharder, tree, rules):
    """The PartitionSpec of every leaf of ``tree`` (tensors or anything
    with a ``shape``) under ``rules`` (the reference dry-run's walk)."""
    return tree_spec(sharder, tree, rules)


def meta_params(cfg):
    """The params of ``cfg`` on ``meta`` (nothing allocated)."""
    from repro_torch.models.counting import _shapes_for

    return _shapes_for(cfg)


def shardings_for(model, sharder, cell, opt_dtype):
    """(step arguments as ``meta`` DTensors, donated argument indices) of
    the cell's step: (params, opt state, batch) for train, (params, cache,
    batch) for decode, (params, batch) for prefill."""
    params = sharder.distribute(meta_params(model.cfg), model.param_rules())
    batch = {k: sharder.distribute(v, batch_rules(k))
             for k, v in model.input_specs(cell).items()}
    if cell.kind == "train":
        return (params, adamw.init(params, state_dtype=opt_dtype), batch), (0, 1)
    if cell.kind == "decode":
        return (params, cache_for(model, sharder, cell), batch), (1,)
    return (params, batch), ()


def cache_for(model, sharder, cell):
    window = model.cfg.ssm.attn_window if model.cfg.ssm is not None else None
    cache = model.init_cache(cell.global_batch, cell.seq_len, window=window)
    return sharder.distribute(cache, model.cache_rules())


def step_for(model, sharder, cell, opt_dtype, train_variant="plain"):
    """The cell's step function over the arguments of :func:`shardings_for`."""
    cfg = model.cfg
    if cell.kind == "train":
        opt_cfg = adamw.AdamWConfig(
            state_dtype=opt_dtype,
            reduce_dtype="bfloat16" if cfg.param_dtype == "bfloat16" else None)
        if train_variant == "compressed":
            step = build_compressed_train_step(model, opt_cfg, sharder)
            from repro_torch.optim.compression import ef_init

            return lambda p, o, b: step(p, o, ef_init(p), b)
        return build_train_step(model, opt_cfg, sharder)
    if cell.kind == "decode":
        return lambda p, c, b: model.decode_step(p, c, b, sharder=sharder)
    return lambda p, b: model.prefill(p, b, sharder=sharder)


def lower_cell(arch: str, cell_name: str, *, multi_pod: bool, cfg_override=None,
               plan_override=None, tag="baseline", save=True, verbose=True,
               train_variant="plain"):
    """Run one cell on the production mesh; returns its RooflineReport (or
    ``{"skipped": why}``).  Needs a fake world of at least the mesh's size."""
    cell = shape_cell(cell_name)
    cfg = cfg_override if cfg_override is not None else plans.tuned_config(arch, cell)
    ok, why = supports_cell(cfg, cell)
    if not ok:
        return {"arch": arch, "cell": cell_name, "skipped": why}
    shape, axes = PRODUCTION[multi_pod]
    mesh = make_mesh(shape, axes, device="cpu")
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    chips = mesh.size()
    plan = plan_override if plan_override is not None else plans.plan_for(
        arch, cell, multi_pod=multi_pod)
    sharder = Sharder(mesh, plan)
    model = build_model(cfg, device="meta")
    opt_dtype = plans.opt_state_dtype(arch)

    t0 = time.perf_counter()
    args, _ = shardings_for(model, sharder, cell, opt_dtype)
    step = step_for(model, sharder, cell, opt_dtype, train_variant)
    _, cost = analyze(step, *args)
    seconds = time.perf_counter() - t0

    param_b = tree_shard_bytes(args[0])
    opt_b = tree_shard_bytes(args[1]) if cell.kind == "train" else 0
    cache_b = tree_shard_bytes(args[1]) if cell.kind == "decode" else 0
    if cell.kind == "prefill":
        cache_b = tree_shard_bytes(cache_for(model, sharder, cell))
    arg_b = tree_shard_bytes(args)
    mem = {"argument_bytes": arg_b, "temp_bytes": cost.peak_temp_bytes,
           "per_gpu_bytes": arg_b + cost.peak_temp_bytes, "hbm_bytes": HBM_BYTES}
    analytic = analytic_memory_bytes(cfg, cell, mesh, plan, param_bytes=param_b,
                                     opt_bytes=opt_b, cache_bytes=cache_b)
    report = build_report(arch, cell_name, mesh_name, chips, cost, model_flops(cfg, cell),
                          mem, analytic_bytes=analytic)
    report.memory_stats.update(seconds=seconds, loops=cost.loops, ops=cost.ops)
    if verbose:
        print(report.summary(), flush=True)
        print(f"  per GPU: args={arg_b / 1e9:.2f}GB temp={cost.peak_temp_bytes / 1e9:.2f}GB "
              f"total={mem['per_gpu_bytes'] / 1e9:.2f}GB of {HBM_BYTES / 1e9:.0f}GB "
              f"flops={cost.flops:.3e} coll={cost.collective_bytes:.3e}B "
              f"loops={cost.loops} ops={cost.ops} {seconds:.1f}s", flush=True)
    if save:
        save_report(report, tag=tag)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS) + [None])
    ap.add_argument("--cell", default=None, choices=[c.name for c in SHAPE_CELLS] + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--json", action="store_true",
                    help="print one JSON line of every cell's report last")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    cells = [args.cell] if args.cell else [c.name for c in SHAPE_CELLS]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    fake_world(max(torch.Size(PRODUCTION[mp][0]).numel() for mp in meshes))

    failures, reports = [], []
    for arch in archs:
        for cell in cells:
            for mp in meshes:
                name = "pod2x16x16" if mp else "pod16x16"
                try:
                    r = lower_cell(arch, cell, multi_pod=mp, tag=args.tag)
                    if isinstance(r, dict):
                        print(f"{arch:18s} {cell:12s} {name:10s} SKIP: {r['skipped']}",
                              flush=True)
                    else:
                        reports.append(r.to_dict())
                except Exception as e:  # noqa: BLE001 - report every cell
                    failures.append((arch, cell, mp, repr(e)[:500]))
                    print(f"{arch:18s} {cell:12s} {name:10s} FAIL: {e!r}"[:300], flush=True)
    print(f"\n{len(failures)} FAILURES" if failures else "\nALL CELLS RAN")
    if args.json:
        print(json.dumps({"dryrun": reports, "failures": len(failures)}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
