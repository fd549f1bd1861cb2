"""Tiny configurations and mixes for the CPU tests of the harness: the
same drivers, the program's plain kernel paths, sizes a test run holds."""

from __future__ import annotations

import contextlib
import copy
import time

from portbench import common, traffic


def tiny_conf(moe: bool = False, dtype: str = "float32", train: bool = False) -> dict:
    conf = {"name": "tiny", "hidden_size": 64, "intermediate_size": 96,
            "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
            "vocab_size": 256, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
            "tie_word_embeddings": False, "param_dtype": "float32" if train else dtype,
            "compute_dtype": dtype, "remat": "full" if train else "none",
            "reference": "portbench/reference/decoder.py"}
    if moe:
        conf.update(num_experts=8, num_experts_per_tok=2, capacity_factor=1.25,
                    tokens_per_group=4096)   # the program's fixed group
    return conf


def tiny_mix(kind: str) -> dict:
    """``serve`` (a backlog), ``poisson`` or ``train``, from the cells' own
    mixes with their sizes cut."""
    if kind == "train":
        mix = copy.deepcopy(traffic.load("train-4k"))
        mix.update(batch=2, seq_len=64, profile={"after_steps": 1, "steps": 2})
        return mix
    mix = copy.deepcopy(traffic.load("chat-batch"))
    mix.update(requests=600, fill_s=0.3,
               prompt_tokens={"dist": "lognormal", "median": 16, "sigma": 0.5, "min": 4,
                              "max": 40},
               output_tokens={"dist": "lognormal", "median": 8, "sigma": 0.6, "min": 2,
                              "max": 20, "max_total": 64},
               engine={"workers": 1, "slots_per_worker": 4, "max_len": 64, "decode_block": 4},
               warmup={"requests": 2, "max_new": 5}, follow_s=30,
               check={"min_tokens": 400, "max_requests": 60, "min_requests": 4},
               profile={"start_share": 0.2, "blocks": 2})
    if kind == "poisson":
        mix["arrivals"] = {"process": "poisson", "rate_per_s": 8.0}
    return mix


def run_cpu(conf: dict, mix: dict, cell: str, *, limits: dict | None = None,
            seed: int = 2**33 + 5, seconds: float = 2.0, trace: bool = False,
            control: bool = False) -> dict:
    """One run of the drivers on the CPU, the chip's look skipped, as the
    cell named ``cell`` (its metrics and, by default, its limits)."""
    from portbench import run

    if limits is None:
        limits = common.limits(cell)
    ctx = run.Context(workload=cell, conf=conf, mix=mix, seed=seed, seconds=seconds,
                      trace=trace, device="cpu", limits=limits, t_start=time.monotonic(),
                      control=control)
    return run.execute(common.benchmark(), ctx)


@contextlib.contextmanager
def grouped_matmul_dw_scaled(factor: float = 2.0):
    """A fault planted in the program while entered: the grouped matmul's
    gradient of its weights (every expert's dw) scaled by ``factor``."""
    import torch

    from repro_torch.kernels import ops

    class Scaled(torch.autograd.Function):
        @staticmethod
        def forward(ctx, w):
            return w.clone()

        @staticmethod
        def backward(ctx, g):
            return g * factor

    orig = ops.grouped_matmul
    ops.grouped_matmul = lambda x, w: orig(x, Scaled.apply(w))
    try:
        yield
    finally:
        ops.grouped_matmul = orig
