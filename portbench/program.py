"""What the harness takes from the program (``repro_torch``): the model
configuration it is given, its kernel launch counters, and the scheduler's
counts.  Everything else of the program is reached through its public
entry points in the drivers."""

from __future__ import annotations

COUNTERS = {
    "decode_attention": ("repro_torch.kernels.decode_attention", "launches"),
    "flash_attention": ("repro_torch.kernels.flash_attention", "launches"),
    "flash_attention_backward": ("repro_torch.kernels.flash_attention", "launches_backward"),
    "grouped_matmul": ("repro_torch.kernels.grouped_matmul", "launches"),
    "grouped_matmul_backward": ("repro_torch.kernels.grouped_matmul", "launches_backward"),
}


def model_config(conf: dict):
    """The program's ``ModelConfig`` of a configuration file: the decoder
    family's keys mapped onto its fields, then the file's ``"program"``
    object applied over them, key by key (``moe``, ``ssm``, ``xlstm``,
    ``encdec`` and ``vlm`` are objects of their own dataclass, applied over
    the mapped one where there is one).  A key the dataclass lacks raises."""
    import dataclasses

    from repro_torch.models import config as C

    moe = None
    if "num_experts" in conf:
        moe = C.MoEConfig(num_experts=conf["num_experts"], top_k=conf["num_experts_per_tok"],
                          d_ff_expert=conf["intermediate_size"],
                          capacity_factor=conf["capacity_factor"], expert_parallel=True)
    fields = dict(
        name=conf["name"], family="moe" if moe else "dense",
        num_layers=conf["num_hidden_layers"], d_model=conf["hidden_size"],
        num_heads=conf["num_attention_heads"], num_kv_heads=conf["num_key_value_heads"],
        d_ff=conf["intermediate_size"], vocab_size=conf["vocab_size"],
        head_dim=conf.get("head_dim"), mlp="swiglu", rope_theta=float(conf["rope_theta"]),
        norm_eps=conf["rms_norm_eps"], tie_embeddings=conf["tie_word_embeddings"], moe=moe,
        dtype=conf["compute_dtype"], param_dtype=conf["param_dtype"], remat=conf["remat"],
    )
    nested = {"moe": C.MoEConfig, "ssm": C.SSMConfig, "xlstm": C.XLSTMConfig,
              "encdec": C.EncDecConfig, "vlm": C.VLMConfig}
    for key, value in conf.get("program", {}).items():
        _known(C.ModelConfig, key, "program")
        if key in nested and value is not None:
            for sub in value:
                _known(nested[key], sub, f"program.{key}")
            base = fields.get(key)
            value = (dataclasses.replace(base, **value) if base is not None
                     else nested[key](**value))
        fields[key] = value
    return C.ModelConfig(**fields)


def _known(cls, key: str, where: str) -> None:
    import dataclasses

    if key not in {f.name for f in dataclasses.fields(cls)}:
        raise ValueError(f"{where}.{key}: {cls.__name__} has no field {key!r}")


def counters(sched=None, loops=()) -> dict:
    """Kernel launches so far; with ``sched`` the scheduler's submitted
    calls and oneways, with ``loops`` the frames the worker decode loops
    sent the host."""
    import importlib

    out = {name: getattr(importlib.import_module(mod), attr)
           for name, (mod, attr) in COUNTERS.items()}
    if sched is not None:
        out["submitted"] = sched.stats["submitted"]
        out["oneways"] = sched.stats["oneways"]
    if loops:
        out["stream_frames"] = sum(loop.stats["frames"] for loop in loops)
    return out


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}
