"""mamba2-370m [ssm]: 48L d=1024 (attention-free) vocab=50280,
ssm_state=128.

The port's own copy of ``src/repro/configs/mamba2_370m.py`` (``FULL``,
``SMOKE`` and ``ARCH``, same values: every layer a Mamba-2 SSD block
(``models.ssm``: d_inner 2048, 32 heads of 64, state 128, a 4-tap conv,
chunks of 128) with no attention and no FFN; the lm_head tied to the
embedding table; the vocab of 50280 padded to 50432), plus ``TRAIN``.
BDWP prunes in_proj (1024 x 4384) and out_proj (2048 x 1024); the conv,
A_log, D, dt_bias and the gate norm are not sites.
[arXiv:2405.21060; unverified]
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer_lm import LMConfig

FULL = LMConfig(
    name="mamba2-370m", vocab=50280, d_model=1024, n_layers=48,
    pattern=("mamba",), ssm_state=128, ssm_head_dim=64, ssm_chunk=128,
    tie_embed=True,
)

SMOKE = LMConfig(
    name="mamba2-370m-smoke", vocab=512, d_model=64, n_layers=2,
    pattern=("mamba",), ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
    tie_embed=True,
)

ARCH = ArchSpec(
    arch_id="mamba2-370m", family="lm", kind="ssm", full=FULL, smoke=SMOKE,
    source="arXiv:2405.21060; unverified", sub_quadratic=True,
)

# FULL itself, nothing cut: 48 layers of 316.1 M prunable parameters
# (in_proj and out_proj) at 13.75 B each (configs/qwen3_8b.py: fp32
# master and momentum, the bf16 BP operand, the packed pair, the decay
# mask, the bf16 WU gradient) = 4.35 GB, the tied 50432 x 1024 table
# (51.6 M at 12 B) 0.62 GB and the 1.1 M small leaves: about 5 GB plus
# activations.
TRAIN = FULL
