"""Architecture registry: ``--arch <id>`` resolves here.

Each ``configs/<id>.py`` exports FULL (the published configuration) and
SMOKE (a reduced same-family config for CPU tests).  This slice of the
port knows qwen3-4b; the reference's other architectures are later
slices.
"""
from __future__ import annotations

import importlib

ARCH_IDS = ["qwen3_4b"]

# public names (hyphenated) -> module names
ALIASES = {"qwen3-4b": "qwen3_4b"}


def get_config(arch: str, smoke: bool = False):
    name = ALIASES.get(arch, arch)
    if name not in ARCH_IDS:
        raise NotImplementedError(
            f"architecture {arch!r} is a later slice of the PyTorch port "
            f"(ported: {', '.join(sorted(ALIASES))})")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.SMOKE if smoke else mod.FULL
