"""Architecture registry of the port: ``--arch <id>`` -> ArchSpec.

The port's own copy of ``src/repro/configs/__init__.py``.  ``ARCHS``
maps the reference's ten arch ids to their ``ArchSpec``: the five dense
LMs, granite-moe, deepseek-v2-lite, mamba2, hymba and the
encoder-decoder whisper; ``get_arch`` raises ``KeyError`` for any other
id.  ``all_cells`` yields every (arch, shape) cell.
The paper's Table I image models are in ``paper_models``.
"""

from __future__ import annotations

from repro_torch.configs import (deepseek_v2_lite, gemma3_12b, glm4_9b,
                                 granite_moe_1b, hymba_1_5b, internvl2_26b,
                                 mamba2_370m, qwen2_5_32b, qwen3_8b,
                                 whisper_large_v3)
from repro_torch.configs.base import SHAPES, ArchSpec, Shape

# the reference's ids in the reference's order
ARCHS = {
    "qwen3-8b": qwen3_8b.ARCH,
    "qwen2.5-32b": qwen2_5_32b.ARCH,
    "glm4-9b": glm4_9b.ARCH,
    "gemma3-12b": gemma3_12b.ARCH,
    "whisper-large-v3": whisper_large_v3.ARCH,
    "granite-moe-1b-a400m": granite_moe_1b.ARCH,
    "deepseek-v2-lite-16b": deepseek_v2_lite.ARCH,
    "mamba2-370m": mamba2_370m.ARCH,
    "hymba-1.5b": hymba_1_5b.ARCH,
    "internvl2-26b": internvl2_26b.ARCH,
}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def all_cells():
    """Every (arch, shape) pair."""
    for arch in ARCHS.values():
        for shape in SHAPES.values():
            yield arch, shape


__all__ = ["ARCHS", "SHAPES", "ArchSpec", "Shape", "get_arch", "all_cells"]
