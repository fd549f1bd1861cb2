"""The yardstick's shared parts: the chip's peaks and the roofline bound,
percentiles, the FLOP and byte counts of the model and its kernels, the
reading of a profiler trace, and the loading of a cell's files.

Origins, frozen here so that the yardstick does not move with the program:

* ``PEAK_FLOPS``, ``HBM_BYTES_PER_S`` and :func:`bound` are ``chip_smoke.py``'s
  (NVIDIA's data sheet for the H100 SXM, dense bf16 and float32 rates);
* :func:`device_events` and the busy time follow ``chip_smoke.py``'s
  ``profile_window``, which sums the device's events from the profiler's
  raw kineto events; busy time here is the union of those events'
  intervals, so that overlapping work is counted once;
* :func:`model_flops` is ``repro_torch/models/counting.py``'s convention (6N
  a trained token, 2N a served one, N the active parameters) with two
  changes: N counts the matrices a token is multiplied by (the input
  embedding, a lookup, is left out), and attention's term that grows with
  the context is added (causal: the pairs a query attends).
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
JAX_NAMES = ("jax", "jaxlib", "flax", "repro")


def bound(nbytes: float, flops: float, dtype: str = "bfloat16") -> tuple[float, str]:
    """The least time (seconds) the chip could take for ``nbytes`` moved and
    ``flops`` computed, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# statistics
# --------------------------------------------------------------------------


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default); ``inf`` stands for a missing value."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if math.isinf(xs[hi]):
        return math.inf
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def delivered(arrivals, t0: float, t_close: float) -> tuple[int, float]:
    """(tokens, window end) of a window opened at ``t0`` whose close at
    ``t_close`` moves to the first delivery at or after it (tokens arrive a
    block at a time): every token that arrived from ``t0`` to that
    delivery, inclusive.  With no delivery after ``t_close`` the window
    ends at the last one."""
    xs = sorted(t for t in arrivals if t >= t0)
    if not xs:
        return 0, t_close
    after = [t for t in xs if t >= t_close]
    end = after[0] if after else xs[-1]
    return sum(1 for t in xs if t <= end), end


def tpot(first: float, last: float, tokens: int) -> float:
    """Seconds per output token after the first: (last - first) / (n - 1)."""
    if tokens < 2:
        raise ValueError("time per output token needs two tokens")
    return (last - first) / (tokens - 1)


# --------------------------------------------------------------------------
# FLOP and byte counts
# --------------------------------------------------------------------------


def matmul_params(conf: dict) -> float:
    """Weights a token is multiplied by: each layer's attention projections
    and its MLP (the top-k experts of an MoE layer, and its router), and the
    head.  The input embedding, a lookup, is not counted."""
    d, H = conf["hidden_size"], conf["num_attention_heads"]
    Hkv = conf["num_key_value_heads"]
    hd = conf.get("head_dim") or d // H
    f = conf["intermediate_size"]
    attn = d * hd * (2 * H + 2 * Hkv)
    if "num_experts" in conf:
        mlp = 3 * d * f * conf["num_experts_per_tok"] + d * conf["num_experts"]
    else:
        mlp = 3 * d * f
    return conf["num_hidden_layers"] * (attn + mlp) + d * conf["vocab_size"]


def attention_flops(conf: dict, pairs: float) -> float:
    """Forward FLOPs of attention's scores and weighted values over
    ``pairs`` (query, key) pairs, summed over the layers: 4 d_head a pair
    and head."""
    d, H = conf["hidden_size"], conf["num_attention_heads"]
    hd = conf.get("head_dim") or d // H
    return 4.0 * H * hd * pairs * conf["num_hidden_layers"]


def causal_pairs(n: int) -> int:
    """(query, key) pairs of causal attention over n positions."""
    return n * (n + 1) // 2


def model_flops_forward(conf: dict, tokens: float, pairs: float) -> float:
    """2N per token plus attention, for one forward pass."""
    return 2.0 * matmul_params(conf) * tokens + attention_flops(conf, pairs)


def model_flops_train(conf: dict, batch: int, seq: int) -> float:
    """One training step: 3x the forward (6N per token plus attention);
    recomputation is not counted."""
    return 3.0 * model_flops_forward(conf, batch * seq, batch * causal_pairs(seq))


def flash_flops(conf: dict, batch: int, seq: int, backward: bool) -> float:
    """One flash-attention launch (one layer, every head of the batch): the
    forward needs 4 d_head a causal pair and head, the backward 10 d_head
    (its scores again from the saved LSE, and dV, dP, dQ, dK)."""
    d, H = conf["hidden_size"], conf["num_attention_heads"]
    hd = conf.get("head_dim") or d // H
    return (10.0 if backward else 4.0) * H * hd * batch * causal_pairs(seq)


def flash_bytes(conf: dict, batch: int, seq: int, backward: bool, elem: int = 2) -> float:
    """Bytes a flash launch must move: q, k, v read and o written (the
    backward also reads o, do and the LSE and writes dq, dk, dv)."""
    d, H = conf["hidden_size"], conf["num_attention_heads"]
    Hkv = conf["num_key_value_heads"]
    hd = conf.get("head_dim") or d // H
    q = batch * seq * H * hd * elem
    kv = batch * seq * Hkv * hd * elem
    if not backward:
        return 2 * q + 2 * kv
    return 4 * q + 4 * kv + batch * seq * H * 4


def gmm_flops(conf: dict, tokens: int, backward: bool) -> float:
    """One grouped-matmul launch of an MoE layer, gate/up (d -> f) or down
    (f -> d) alike: 2 d f a routed row (tokens x top-k rows; the capacity
    padding is not counted), twice that for a backward launch (dx and dw)."""
    rows = tokens * conf["num_experts_per_tok"]
    return (4.0 if backward else 2.0) * rows * conf["hidden_size"] * conf["intermediate_size"]


def gmm_bytes(conf: dict, tokens: int, elem: int = 2) -> float:
    """Bytes one forward grouped-matmul launch of an MoE layer must move:
    every expert's weights (E d f), and each routed row's input and output
    (tokens x top-k rows of d + f)."""
    d, f = conf["hidden_size"], conf["intermediate_size"]
    rows = tokens * conf["num_experts_per_tok"]
    return elem * (conf["num_experts"] * d * f + rows * (d + f))


def decode_bytes(conf: dict, lengths, elem: int = 2) -> float:
    """Bytes one layer's decode-attention launch needs: the keys and values
    of each active sequence's cached length, its query read and its output
    written."""
    d, H = conf["hidden_size"], conf["num_attention_heads"]
    Hkv = conf["num_key_value_heads"]
    hd = conf.get("head_dim") or d // H
    kv = sum(lengths) * 2 * Hkv * hd * elem
    return kv + len(lengths) * 2 * H * hd * elem


def decode_flops(conf: dict, lengths) -> float:
    d, H = conf["hidden_size"], conf["num_attention_heads"]
    hd = conf.get("head_dim") or d // H
    return 4.0 * H * hd * sum(lengths)


# --------------------------------------------------------------------------
# the profiler's trace
# --------------------------------------------------------------------------


def device_events(prof) -> tuple[list, list]:
    """(device, host) events of a stopped ``torch.profiler.profile``, each
    (name, start_s, end_s), from the profiler's raw kineto events: device
    events are kernels, copies and sets; host events are the operators and
    runtime calls of the thread that ran the profiler."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        kind = e.device_type().name
        start = e.start_ns() / 1e9
        end = start + e.duration_ns() / 1e9
        if kind == "CUDA":
            if not e.is_hidden_event():
                dev.append((e.name(), start, end))
        elif kind == "CPU":
            host.append((e.name(), start, end))
    dev.sort(key=lambda t: t[1])
    host.sort(key=lambda t: t[1])
    return dev, host


def busy_seconds(dev: list) -> float:
    """The union of the device events' intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for _, s, e in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def kernel_seconds(dev: list, match) -> float:
    """Summed duration of the device events whose name ``match(name)``."""
    return sum(e - s for n, s, e in dev if match(n))


def top_ops(dev: list, n: int = 10) -> list:
    by: dict[str, float] = {}
    for name, s, e in dev:
        by[name] = by.get(name, 0.0) + (e - s)
    return [[k[:120], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(dev: list, host: list, n: int = 10, reach: int = 64) -> list:
    """The device's idle gaps summed by what the host was doing: each gap
    (from the end of all device work so far to the next device event) is
    named by the latest-starting host event, among the ``reach`` that start
    last before its middle, that spans the middle (with nested host events
    the innermost), or "(no host event)"."""
    import numpy as np

    starts, mids, lengths = [], [], []
    end = None
    for _, s, e in dev:
        if end is not None and s > end:
            mids.append((s + end) / 2)
            lengths.append(s - end)
        end = e if end is None else max(end, e)
    if not mids:
        return []
    mids, lengths = np.asarray(mids), np.asarray(lengths)
    host = sorted(host, key=lambda h: h[1])
    names = [h[0] for h in host]
    hs = np.asarray([h[1] for h in host]) if host else np.zeros(0)
    he = np.asarray([h[2] for h in host]) if host else np.zeros(0)
    by: dict[str, float] = {}
    if len(hs):
        last = np.searchsorted(hs, mids, side="right") - 1              # (gaps,)
        idx = last[:, None] - np.arange(reach)[None, :]                 # latest first
        ok = (idx >= 0) & (he[np.clip(idx, 0, None)] >= mids[:, None])
        has = ok.any(axis=1)
        pick = idx[np.arange(len(mids)), ok.argmax(axis=1)]
        for i in np.nonzero(has)[0]:
            key = names[pick[i]][:120]
            by[key] = by.get(key, 0.0) + float(lengths[i])
        rest = float(lengths[~has].sum())
    else:
        rest = float(lengths.sum())
    if rest:
        by["(no host event)"] = by.get("(no host event)", 0.0) + rest
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


# --------------------------------------------------------------------------
# the cell's files
# --------------------------------------------------------------------------


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_json(relpath: str) -> dict:
    """A JSON file named relative to the checkout's root."""
    return json.loads((ROOT / relpath).read_text())


def limits(workload: str) -> dict:
    return json.loads((HERE / "limits" / f"{workload}.json").read_text())


#: what the drivers call of a reference module (its contract:
#: ``portbench/README.md``)
REFERENCE_FUNCTIONS = ("make_weights", "logits", "fp8_matmul", "leaf_paths", "train",
                       "train_loss", "change_norm", "relative_diffs")
_REFERENCES: dict = {}


def reference(conf: dict):
    """The plain reference module of a configuration: the file its
    ``reference`` key names, relative to the checkout's root, loaded once.
    A module that lacks a function of ``REFERENCE_FUNCTIONS`` is refused
    here, by name."""
    path = (ROOT / conf["reference"]).resolve()
    mod = _REFERENCES.get(path)
    if mod is None:
        name = "portbench_reference_" + "".join(c if c.isalnum() else "_"
                                                for c in str(path))
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        missing = [f for f in REFERENCE_FUNCTIONS if not callable(getattr(mod, f, None))]
        if missing:
            del sys.modules[name]
            raise ImportError(f"reference {conf['reference']}: no function "
                              f"{', '.join(missing)} (portbench/README.md)")
        _REFERENCES[path] = mod
    return mod


def correct(checks: dict) -> bool:
    """Every number within its limit: a ``compared_*`` count at least its
    limit, every other number at most its limit."""
    ok = True
    for name, c in checks.items():
        if name.startswith("compared_"):
            ok = ok and c["value"] >= c["limit"]
        else:
            ok = ok and c["value"] <= c["limit"]
    return bool(ok)


def reader(metric: str):
    """The ``read(record)`` function of a per-layer metric, from
    ``portbench/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def jax_modules(modules) -> list:
    """Loaded modules whose top-level name is one of ``JAX_NAMES``, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({m for m in modules if m.split(".")[0] in JAX_NAMES})
