"""Architecture specs and the input-shape table (the dry-run's cells).

The port's own copy of ``src/repro/configs/base.py``: ``Shape``,
``SHAPES`` and ``ArchSpec`` with the same fields and values.  The
reference's ``lm_input_specs`` (``jax.ShapeDtypeStruct`` stand-ins for
its dry-run) waits for the dry-run's port (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Shape:
    shape_id: str
    seq: int
    batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                  # "lm" | "encdec"
    kind: str                    # dense | moe | ssm | hybrid | vlm | audio
    full: object                 # the published widths (an LMConfig or an
                                 # EncDecConfig)
    smoke: object                # the CPU-test size
    source: str                  # provenance tag, as the reference has it
    sub_quadratic: bool = False  # may run long_500k
    prefix_len: int = 0          # stub-frontend prefix tokens (vlm)

    def supports(self, shape_id: str) -> bool:
        return shape_id != "long_500k" or self.sub_quadratic

    def skip_reason(self, shape_id: str) -> str:
        if not self.supports(shape_id):
            return ("pure full-attention arch; 500k decode requires "
                    "sub-quadratic attention")
        return ""

