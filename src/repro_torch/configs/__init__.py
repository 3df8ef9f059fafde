"""Assigned architecture registry: ``get_config(arch_id)``.

Every module defines ``CONFIG`` (the exact assigned full config, source
cited) — selectable via ``--arch <id>`` in the launchers.

Port of ``src/repro/configs/__init__.py``: the same ids, aliases and data.
Families the port cannot run yet raise when run (models/transformer.py).
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ArchConfig

ARCH_IDS: List[str] = [
    "mixtral_8x7b",
    "internvl2_76b",
    "kimi_k2_1t_a32b",
    "deepseek_67b",
    "starcoder2_15b",
    "whisper_medium",
    "mamba2_1p3b",
    "zamba2_1p2b",
    "qwen2_72b",
    "glm4_9b",
]

#: CLI spellings (hyphenated, as assigned) -> module names
ALIASES: Dict[str, str] = {
    "mixtral-8x7b": "mixtral_8x7b",
    "internvl2-76b": "internvl2_76b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "deepseek-67b": "deepseek_67b",
    "starcoder2-15b": "starcoder2_15b",
    "whisper-medium": "whisper_medium",
    "mamba2-1.3b": "mamba2_1p3b",
    "zamba2-1.2b": "zamba2_1p2b",
    "qwen2-72b": "qwen2_72b",
    "glm4-9b": "glm4_9b",
}


def get_config(arch: str) -> ArchConfig:
    mod = ALIASES.get(arch, arch).replace("-", "_").replace(".", "p")
    m = importlib.import_module(f"repro_torch.configs.{mod}")
    cfg = m.CONFIG
    cfg.validate()
    return cfg


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
