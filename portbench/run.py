"""Run one cell of the benchmark once:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's configuration, traffic mix and
metrics are found by name in ``BENCHMARK.json`` and under ``portbench/``.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``,
``breakdown`` (traced runs) and, last, ``checks``: each number that decided
``correct`` with its limit, which also end standard error.

Without a CUDA device, or with fewer than the cell asks for, the run exits
with code 3 and prints no result; so it does if the JAX package or JAX was
loaded, or if the program cannot be imported.
"""

from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """``time.monotonic()`` at this process's start (its age from
    ``/proc/self/stat`` on the boot clock), or now where that is unknown."""
    now = time.monotonic()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
        return now - max(0.0, age)
    except (OSError, ValueError, IndexError, AttributeError):
        return now


T_START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
os.environ["USE_FLAX"] = "0"

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402

from portbench import common  # noqa: E402


@dataclasses.dataclass
class Context:
    workload: str
    conf: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    limits: dict
    t_start: float
    control: bool = False
    extra: dict = dataclasses.field(default_factory=dict)


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def metrics_of(bench: dict, workload: str, kind: str) -> list:
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def context(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
            device: str, t_start: float, **kw) -> Context:
    from portbench import traffic

    w = cell(bench, workload)
    conf_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    conf = common.load_json(conf_entry["file"])
    return Context(workload=workload, conf=conf, mix=traffic.load(w["traffic"]), seed=seed,
                   seconds=seconds, trace=trace, device=device,
                   limits=common.limits(workload), t_start=t_start, **kw)


def execute(bench: dict, ctx: Context) -> dict:
    """Run the cell and assemble its result line (without ``device``)."""
    from portbench import serve, train

    driver = {"serve": serve, "train": train}[ctx.mix["kind"]]
    res = driver.run(ctx)
    result = {"correct": common.correct(res["checks"]), "attempted": res["attempted"],
              "failed": res["failed"]}
    if ctx.trace:
        rec = res["record"]
        if rec is None:
            raise RuntimeError("the traced slice did not complete inside the window")
        metrics = {}
        for m in metrics_of(bench, ctx.workload, "per_layer"):
            value = common.reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        result["busy_s"], result["window_s"] = rec["busy_s"], rec["window_s"]
        result["breakdown"] = {
            "device_ops": common.top_ops(rec["device_events"]),
            "idle_gaps": common.idle_gaps(rec["gap_device_events"], rec["host_events"]),
        }
    else:
        result["metrics"] = {m["name"]: {"value": res["metrics"][m["name"]], "unit": m["unit"]}
                             for m in metrics_of(bench, ctx.workload, "end_to_end")}
    result["memory_peak_bytes"] = res["memory_peak_bytes"]
    result["extra"] = {k: v for k, v in res["metrics"].items()
                       if k not in result["metrics"]} | ctx.extra
    result["checks"] = res["checks"]
    return result


def finite(obj):
    """``obj`` with every float that is not finite (a missing request's
    latency, a failed comparison) written as a string, so that the line
    stays JSON."""
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    return obj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = common.benchmark()
    chips = cell(bench, args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    ctx = context(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                  T_START)
    result = execute(bench, ctx)
    found = common.jax_modules(sys.modules)
    if found:
        print(f"portbench: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": int(result.pop("memory_peak_bytes"))}
    if ctx.trace:
        device["busy_s"] = result.pop("busy_s")
        device["window_s"] = result.pop("window_s")
    checks = result.pop("checks")
    bad = [k for k, v in result["metrics"].items() if not math.isfinite(v["value"])]
    if bad:
        print(f"portbench: no finite value for {bad}", file=sys.stderr)
        return 3
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": result["metrics"], "device": device}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["extra"] = result["extra"]
    line["checks"] = checks   # last: each number that decided ``correct``, with its limit
    line = finite(line)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line, default=float, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
