"""Architecture registry: ``--arch <id>`` resolves here.

Each ``configs/<id>.py`` exports FULL (the published configuration) and
SMOKE (a reduced same-family config for CPU tests), copied field for
field from the reference's, less its training-only fields.  The port
knows every decoder LM of the reference: the dense family (qwen3-4b,
qwen3-8b, minitron-4b, nemotron-4-340b) and the MoE family (phi3.5-moe,
grok-1-314b).  The reference's VLM, encoder-decoder and recurrent
architectures are later slices.
"""
from __future__ import annotations

import importlib

ARCH_IDS = ["grok1_314b", "phi35_moe", "qwen3_4b", "nemotron4_340b",
            "minitron_4b", "qwen3_8b"]

# public names (hyphenated) -> module names
ALIASES = {
    "grok-1-314b": "grok1_314b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "phi3.5-moe": "phi35_moe",
    "qwen3-4b": "qwen3_4b",
    "nemotron-4-340b": "nemotron4_340b",
    "minitron-4b": "minitron_4b",
    "qwen3-8b": "qwen3_8b",
}


def get_config(arch: str, smoke: bool = False):
    name = ALIASES.get(arch, arch)
    if name not in ARCH_IDS:
        raise NotImplementedError(
            f"architecture {arch!r} is a later slice of the PyTorch port "
            f"(ported: {', '.join(sorted(ALIASES))})")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.SMOKE if smoke else mod.FULL
