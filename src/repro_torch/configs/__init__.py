"""The paper's workload profiles (copied from ``repro.configs.paper``) and
the assigned architecture configs (exact public dims, copied from
``repro.configs``) with their smoke-scale variants.

Importing this package populates the model registry.  ``smoke_config(name)``
returns the same family at test scale (few layers, narrow width, tiny
vocab).
"""
from repro_torch.configs import (gemma3_27b, llava_next_34b, mamba2_780m,
                                 qwen2_7b, qwen3_4b, qwen3_32b,
                                 qwen3_moe_30b_a3b, qwen3_moe_235b_a22b,
                                 recurrentgemma_2b, whisper_large_v3)
from repro_torch.configs.paper import PROFILES, WORKER_SETUP, DatasetProfile
from repro_torch.models.registry import get_config

_SMOKE = {
    "recurrentgemma-2b": recurrentgemma_2b.SMOKE,
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b.SMOKE,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b.SMOKE,
    "whisper-large-v3": whisper_large_v3.SMOKE,
    "gemma3-27b": gemma3_27b.SMOKE,
    "qwen3-32b": qwen3_32b.SMOKE,
    "qwen3-4b": qwen3_4b.SMOKE,
    "qwen2-7b": qwen2_7b.SMOKE,
    "mamba2-780m": mamba2_780m.SMOKE,
    "llava-next-34b": llava_next_34b.SMOKE,
}

ASSIGNED_ARCHS = tuple(sorted(_SMOKE))


def smoke_config(name: str):
    return get_config(name).scaled(**_SMOKE[name])


__all__ = ["PROFILES", "WORKER_SETUP", "DatasetProfile", "ASSIGNED_ARCHS",
           "smoke_config"]
