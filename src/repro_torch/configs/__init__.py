"""Architecture registry of the port: ``--arch <id>`` -> ArchSpec.

The port's own copy of ``src/repro/configs/__init__.py``.  ``ARCHS``
has the reference's ten arch ids as keys.  The five dense LMs,
granite-moe, deepseek-v2-lite, mamba2 and hymba map to their
``ArchSpec``; an arch whose model is not ported yet (whisper) maps to an
``Unported`` entry that names the ROADMAP queue 1 item porting it, and
``get_arch`` raises ``NotImplementedError`` for it (never a stand-in).
``all_cells`` yields the (arch, shape) cells of the ported archs.
The paper's Table I image models are in ``paper_models``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import (deepseek_v2_lite, gemma3_12b, glm4_9b,
                                 granite_moe_1b, hymba_1_5b, internvl2_26b,
                                 mamba2_370m, qwen2_5_32b, qwen3_8b)
from repro_torch.configs.base import SHAPES, ArchSpec, Shape


@dataclasses.dataclass(frozen=True)
class Unported:
    arch_id: str
    item: str        # the ROADMAP queue 1 item that ports it


# the reference's ids in the reference's order
ARCHS = {
    "qwen3-8b": qwen3_8b.ARCH,
    "qwen2.5-32b": qwen2_5_32b.ARCH,
    "glm4-9b": glm4_9b.ARCH,
    "gemma3-12b": gemma3_12b.ARCH,
    "whisper-large-v3": Unported("whisper-large-v3",
                                 "item 6 (encoder-decoder)"),
    "granite-moe-1b-a400m": granite_moe_1b.ARCH,
    "deepseek-v2-lite-16b": deepseek_v2_lite.ARCH,
    "mamba2-370m": mamba2_370m.ARCH,
    "hymba-1.5b": hymba_1_5b.ARCH,
    "internvl2-26b": internvl2_26b.ARCH,
}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    arch = ARCHS[arch_id]
    if isinstance(arch, Unported):
        raise NotImplementedError(
            f"{arch_id} is not ported yet: ROADMAP queue 1, {arch.item}")
    return arch


def all_cells():
    """Every (arch, shape) pair of the ported archs."""
    for arch in ARCHS.values():
        if isinstance(arch, ArchSpec):
            for shape in SHAPES.values():
                yield arch, shape


__all__ = ["ARCHS", "SHAPES", "ArchSpec", "Shape", "Unported", "get_arch",
           "all_cells"]
