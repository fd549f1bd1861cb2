"""The one generator of every traffic mix: it reads the mix's parameters
from ``portbench/traffic/<name>.json`` and makes the requests or batches of
a run from ``--seed``.

Serving mixes (``"kind": "serve"``): prompt and output lengths come from
their distributions as a fixed set of quantiles (the same lengths for every
seed); the seed orders them (interleaved by strata, so that every stretch
of the queue holds the whole mix), draws the token ids, and shuffles the
gaps between arrivals, which are the quantiles of the arrival process's
gap distribution.  So every seed offers the same work in another order, and
the spread between runs is the system's and not the draw's.

* ``arrivals.process``: ``backlog`` (every request due at t = 0, a queue
  deeper than the window drains) or ``poisson`` (``rate_per_s``).
* ``prompt_tokens`` / ``output_tokens``: ``lognormal`` with ``median`` and
  ``sigma``, clipped to [``min``, ``max``]; an output is also clipped to
  ``max_total`` minus its prompt.

Training mixes (``"kind": "train"``): ``batch`` rows of ``seq_len`` token
ids drawn uniformly from the vocabulary, a new draw for every step, so no
two rows of a run are alike.
"""

from __future__ import annotations

import json
import math
import statistics
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def load(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent stream of ``seed`` (any size of whole number)."""
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), stream])


def quantiles(spec: dict, n: int) -> np.ndarray:
    """The n quantiles at (i + 1/2) / n of a length distribution, as floats."""
    ps = (np.arange(n) + 0.5) / n
    if spec["dist"] == "lognormal":
        z = np.array([statistics.NormalDist().inv_cdf(p) for p in ps])
        return spec["median"] * np.exp(spec["sigma"] * z)
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def interleave(ascending: np.ndarray, r: np.random.Generator, strata: int = 16) -> np.ndarray:
    """The values in an order drawn from ``r`` in which every run of
    ``strata`` consecutive requests holds one value of each of ``strata``
    equal strata: any stretch of the queue that a window serves has nearly
    the same mix, whatever the seed."""
    groups = [r.permutation(g) for g in np.array_split(ascending, max(1, min(strata,
                                                                             len(ascending))))]
    order = []
    for j in range(max(len(g) for g in groups)):
        order.extend(r.permutation([g[j] for g in groups if j < len(g)]))
    return np.asarray(order, dtype=ascending.dtype)


def gaps(spec: dict, n: int) -> np.ndarray:
    """n gaps between arrivals (seconds) as quantiles of their distribution."""
    ps = (np.arange(n) + 0.5) / n
    rate = spec["rate_per_s"]
    if spec["process"] == "poisson":
        return -np.log1p(-ps) / rate
    raise ValueError(f"unknown arrival process {spec['process']!r}")


def request_count(mix: dict, seconds: float) -> int:
    arr = mix["arrivals"]
    if arr["process"] == "backlog":
        return int(mix["requests"])
    return max(1, int(math.floor(arr["rate_per_s"] * seconds)))


def serve_requests(mix: dict, vocab: int, seed: int, seconds: float) -> list:
    """The requests of one run: dicts {rid, prompt (int32), max_new, due}
    in order of ``due`` (seconds after the window opens)."""
    n = request_count(mix, seconds)
    r = rng(seed, 1)
    pspec, ospec = mix["prompt_tokens"], mix["output_tokens"]
    plen = np.clip(np.rint(quantiles(pspec, n)), pspec["min"], pspec["max"]).astype(int)
    olen = np.rint(quantiles(ospec, n)).astype(int)
    plen, olen = interleave(np.sort(plen), r), interleave(np.sort(olen), r)
    olen = np.clip(olen, ospec["min"], np.minimum(ospec["max"], ospec["max_total"] - plen))
    arr = mix["arrivals"]
    if arr["process"] == "backlog":
        due = np.zeros(n)
    else:
        due = np.cumsum(r.permutation(gaps(arr, n)))
    ids = rng(seed, 2)
    out = []
    for i in range(n):
        if due[i] >= seconds and arr["process"] != "backlog":
            break
        out.append({"rid": i, "prompt": ids.integers(0, vocab, int(plen[i]), dtype=np.int32),
                    "max_new": int(olen[i]), "due": float(due[i])})
    return out


def warmup_requests(mix: dict, vocab: int, seed: int) -> list:
    """Set-up's requests: the mix's shortest and longest prompt and a few
    between, each long enough to run one whole decode block."""
    w = mix["warmup"]
    pspec = mix["prompt_tokens"]
    lens = np.linspace(pspec["min"], pspec["max"], w["requests"]).round().astype(int)
    ids = rng(seed, 3)
    return [{"rid": i, "prompt": ids.integers(0, vocab, int(n), dtype=np.int32),
             "max_new": int(w["max_new"]), "due": 0.0} for i, n in enumerate(lens)]


class TrainBatches:
    """Step ``s``'s rows {tokens, labels} (batch, seq_len) int32 of a run:
    the same for the same (seed, s), different for every step."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.batch_size, self.seq_len = mix["batch"], mix["seq_len"]
        self.vocab, self.seed = vocab, seed

    def batch(self, step: int) -> dict:
        r = np.random.default_rng([int(self.seed) & ((1 << 64) - 1), 100, int(step)])
        seq = r.integers(0, self.vocab, (self.batch_size, self.seq_len + 1), dtype=np.int32)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
