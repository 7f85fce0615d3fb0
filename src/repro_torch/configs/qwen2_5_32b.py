"""qwen2.5-32b [dense]: 64L d=5120 40H (GQA kv=8) d_ff=27648 vocab=152064.

The port's own copy of ``src/repro/configs/qwen2_5_32b.py`` (``FULL``,
``SMOKE`` and ``ARCH``, same values: GQA, QKV bias, untied lm_head),
plus ``TRAIN``.  [hf:Qwen/Qwen2.5-0.5B; hf]
"""

import dataclasses

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer_lm import LMConfig

FULL = LMConfig(
    name="qwen2.5-32b", vocab=152064, d_model=5120, n_layers=64,
    n_heads=40, n_kv=8, head_dim=128, d_ff=27648,
    rope_theta=1e6, qkv_bias=True, tie_embed=False,
)

SMOKE = LMConfig(
    name="qwen2.5-32b-smoke", vocab=512, d_model=64, n_layers=2,
    n_heads=4, n_kv=2, head_dim=16, d_ff=160,
    rope_theta=1e6, qkv_bias=True, tie_embed=False,
)

ARCH = ArchSpec(
    arch_id="qwen2.5-32b", family="lm", kind="dense", full=FULL, smoke=SMOKE,
    source="hf:Qwen/Qwen2.5-0.5B; hf", sub_quadratic=False,
)

# FULL at every published width with the depth cut to 4 of 64 layers,
# so that BDWP training fits one 80 GB card.  At the port's reckoning
# (configs/qwen3_8b.py: 13.75 B per prunable parameter, 12 B per
# parameter of the untied 152064 x 5120 embed and lm_head tables) a
# layer's 487.6 M prunable parameters take 6.7 GB, the two tables 18.7
# GB: 4 layers 26.8 + 18.7 = 45.5 GB plus activations.  Depth is the
# only cut.
TRAIN = dataclasses.replace(FULL, n_layers=4)
