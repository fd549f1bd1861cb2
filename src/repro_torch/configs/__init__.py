"""Assigned-architecture configs: ``--arch <id>`` resolves here."""

from repro_torch.configs import (
    internlm2_20b,
    internvl2_76b,
    llama3_405b,
    nemotron4_340b,
    olmoe_1b_7b,
    qwen15_4b,
    qwen2_moe_a2p7b,
    whisper_large_v3,
    xlstm_1p3b,
    zamba2_2p7b,
)

_MODULES = {
    "xlstm-1.3b": xlstm_1p3b,
    "internlm2-20b": internlm2_20b,
    "qwen1.5-4b": qwen15_4b,
    "llama3-405b": llama3_405b,
    "nemotron-4-340b": nemotron4_340b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "qwen2-moe-a2.7b": qwen2_moe_a2p7b,
    "internvl2-76b": internvl2_76b,
    "zamba2-2.7b": zamba2_2p7b,
    "whisper-large-v3": whisper_large_v3,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str):
    return _MODULES[arch_id].CONFIG


def get_reduced(arch_id: str):
    return _MODULES[arch_id].REDUCED
