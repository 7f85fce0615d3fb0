"""qwen3-8b [dense]: 36L d=4096 32H (GQA kv=8) d_ff=12288 vocab=151936.

The port's own copy of ``src/repro/configs/qwen3_8b.py`` (``FULL`` and
``SMOKE`` and ``ARCH``, same values; qk_norm, untied lm_head), built on
the port's ``LMConfig``, plus ``TRAIN`` and ``TRAIN_SYNC``.
[hf:Qwen/Qwen3-8B; hf]
"""

import dataclasses

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer_lm import LMConfig

FULL = LMConfig(
    name="qwen3-8b", vocab=151936, d_model=4096, n_layers=36,
    n_heads=32, n_kv=8, head_dim=128, d_ff=12288,
    rope_theta=1e6, qk_norm=True, tie_embed=False,
)

SMOKE = LMConfig(
    name="qwen3-8b-smoke", vocab=512, d_model=64, n_layers=2,
    n_heads=4, n_kv=2, head_dim=16, d_ff=128,
    rope_theta=1e6, qk_norm=True, tie_embed=False,
)

ARCH = ArchSpec(
    arch_id="qwen3-8b", family="lm", kind="dense", full=FULL, smoke=SMOKE,
    source="hf:Qwen/Qwen3-8B; hf", sub_quadratic=False,
)

# FULL at every published width with the depth cut to 8 of 36 layers,
# so that BDWP training fits one 80 GB card.  Training state is about
# 13.75 B per prunable parameter (fp32 master 4 + fp32 momentum 4; the
# pre-generated bf16 ``bp`` 2, packed bf16 vals 0.5 and u8 idx 0.25, bool
# decay mask 1; the bf16 WU gradient 2) and 12 B per parameter of the
# untied 152064 x 4096 embed and lm_head tables.  At 36 layers that is
# 36 x 192.9 M x 13.75 B + 1.246 G x 12 B = 95.5 + 15.0 = 110 GB; at 8
# layers 21.2 + 15.0 = 36 GB plus activations.  Depth is the only cut.
TRAIN = dataclasses.replace(FULL, n_layers=8)

# FULL at every published width with the depth cut to 4 of 36 layers,
# for BDWP training with the compressed cross-pod gradient sync of P = 2
# pods on one card (the reference's production mesh has pod = 2).  The
# error-feedback residual is one fp32 row per pod over every compressible
# element, embed and lm_head included: 8 B per parameter at P = 2, and
# each pod's bf16 gradient another 2 B.  At 8 layers (TRAIN, peak 54.85
# GiB on an H100 80GB HBM3 at 700 W without the sync) the residual adds
# 22.3 GB (2 x 2.79 G x 4 B) and the second pod's gradients 5.6 GB,
# which does not fit 80 GB.  At 4 layers T = 4 x 192.9 M + 1.246 G =
# 2.017 G compressible elements: master and momentum 16.1 GB, residual
# 16.1 GB, two pods of gradients 8.1 GB, their mean 4.0 GB, the compute
# tree about 5.4 GB.  Depth is the only cut.
TRAIN_SYNC = dataclasses.replace(FULL, n_layers=4)
