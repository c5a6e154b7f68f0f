"""Architecture registry: ``--arch <id>`` resolves here.

Each ``configs/<id>.py`` exports FULL (the published configuration) and
SMOKE (a reduced same-family config for CPU tests), copied field for
field from the reference's, less its JAX-only fields.
The port knows all ten architectures of the reference: dense (qwen3-4b,
qwen3-8b, minitron-4b, nemotron-4-340b), MoE (phi3.5-moe, grok-1-314b),
VLM (qwen2-vl-72b), encoder-decoder (whisper-base) and recurrent
(rwkv6-3b, zamba2-1.2b).  Shapes are the reference's four dry-run
input-shape cells; ``long_500k`` only applies to the sub-quadratic
architectures.
"""
from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = [
    "whisper_base", "rwkv6_3b", "grok1_314b", "phi35_moe", "qwen2_vl_72b",
    "qwen3_4b", "nemotron4_340b", "minitron_4b", "qwen3_8b", "zamba2_1p2b",
]

# public names (hyphenated) -> module names
ALIASES = {
    "whisper-base": "whisper_base",
    "rwkv6-3b": "rwkv6_3b",
    "grok-1-314b": "grok1_314b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "phi3.5-moe": "phi35_moe",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "qwen3-4b": "qwen3_4b",
    "nemotron-4-340b": "nemotron4_340b",
    "minitron-4b": "minitron_4b",
    "qwen3-8b": "qwen3_8b",
    "zamba2-1.2b": "zamba2_1p2b",
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# sub-quadratic archs that run the 500k cell (the others skip it)
LONG_CONTEXT_OK = {"rwkv6_3b", "zamba2_1p2b"}


def get_config(arch: str, smoke: bool = False):
    name = ALIASES.get(arch, arch).replace("-", "_")
    if name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch!r} (known: "
                         f"{', '.join(sorted(ALIASES))})")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.SMOKE if smoke else mod.FULL


def shape_applicable(arch: str, shape: str) -> bool:
    name = ALIASES.get(arch, arch).replace("-", "_")
    if shape == "long_500k":
        return name in LONG_CONTEXT_OK
    return True


def all_cells():
    """Every applicable (arch, shape) dry-run cell."""
    for arch in ARCH_IDS:
        for shape in SHAPES:
            if shape_applicable(arch, shape):
                yield arch, shape
