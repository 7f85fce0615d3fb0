"""glm4-9b [dense]: 40L d=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.

The port's own copy of ``src/repro/configs/glm4_9b.py`` (``FULL``,
``SMOKE`` and ``ARCH``, same values: RoPE, GQA with 2 KV heads, untied
lm_head), plus ``TRAIN``.  [hf:THUDM/glm-4-9b; hf]
"""

import dataclasses

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer_lm import LMConfig

FULL = LMConfig(
    name="glm4-9b", vocab=151552, d_model=4096, n_layers=40,
    n_heads=32, n_kv=2, head_dim=128, d_ff=13696,
    rope_theta=1e4, tie_embed=False,
)

SMOKE = LMConfig(
    name="glm4-9b-smoke", vocab=512, d_model=64, n_layers=2,
    n_heads=4, n_kv=1, head_dim=16, d_ff=128, tie_embed=False,
)

ARCH = ArchSpec(
    arch_id="glm4-9b", family="lm", kind="dense", full=FULL, smoke=SMOKE,
    source="hf:THUDM/glm-4-9b; hf", sub_quadratic=False,
)

# FULL at every published width with the depth cut to 8 of 40 layers:
# 204.0 M prunable parameters a layer at 13.75 B (configs/qwen3_8b.py)
# and the untied 151552 x 4096 tables at 12 B a parameter: 22.4 + 14.9
# = 37.3 GB plus activations.  Depth is the only cut.
TRAIN = dataclasses.replace(FULL, n_layers=8)
