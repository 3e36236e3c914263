"""Architecture config registry (``--arch <id>``)."""
from __future__ import annotations

import importlib

ARCHS = [
    "zamba2_1p2b",
    "granite_3_2b",
    "gemma3_27b",
    "gemma_7b",
    "h2o_danube_3_4b",
    "qwen3_moe_235b_a22b",
    "kimi_k2_1t_a32b",
    "whisper_small",
    "rwkv6_3b",
    "paligemma_3b",
]

ALIASES = {
    "zamba2-1.2b": "zamba2_1p2b",
    "granite-3-2b": "granite_3_2b",
    "gemma3-27b": "gemma3_27b",
    "gemma-7b": "gemma_7b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "whisper-small": "whisper_small",
    "rwkv6-3b": "rwkv6_3b",
    "paligemma-3b": "paligemma_3b",
}


def get_config(name: str):
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs() -> dict:
    return {a: get_config(a) for a in ARCHS}
