"""hymba-1.5b [hybrid]: 32L d=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16.

The port's own copy of ``src/repro/configs/hymba_1_5b.py`` (``FULL``,
``SMOKE`` and ``ARCH``, same values: every layer runs sliding-window
attention (window 1024) and a Mamba-2 SSD block (d_inner 3200, 50 heads
of 64, state 16) on the same input and takes their mean, then a dense
SwiGLU FFN; the lm_head tied to the embedding table; the vocab of 32001
padded to 32256), plus ``TRAIN``.  As in the reference, every layer's
attention is windowed (Hymba keeps 3 global layers).  BDWP prunes the
attention projections, the FFN and the SSD block's out_proj; its
in_proj (1600 x 6482) is no site, since 6482 is not a multiple of 8,
and trains and serves dense.  [arXiv:2411.13676; hf]
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer_lm import LMConfig

FULL = LMConfig(
    name="hymba-1.5b", vocab=32001, d_model=1600, n_layers=32,
    n_heads=25, n_kv=5, head_dim=64, d_ff=5504,
    pattern=("hybrid",), window=1024,
    ssm_state=16, ssm_head_dim=64, ssm_chunk=128,
    tie_embed=True,
)

SMOKE = LMConfig(
    name="hymba-1.5b-smoke", vocab=512, d_model=64, n_layers=2,
    n_heads=4, n_kv=2, head_dim=16, d_ff=128,
    pattern=("hybrid",), window=16,
    ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
    tie_embed=True,
)

ARCH = ArchSpec(
    arch_id="hymba-1.5b", family="lm", kind="hybrid", full=FULL, smoke=SMOKE,
    source="arXiv:2411.13676; hf", sub_quadratic=True,
)

# FULL itself, nothing cut: 32 layers of 1.206 G prunable parameters
# (attention, FFN, out_proj) at 13.75 B each = 16.6 GB, the dense
# in_proj (332 M) at 10 B (fp32 master and momentum, its bf16 compute
# copy and gradient) = 3.3 GB, and the tied 32256 x 1600 table (51.6 M
# at 12 B) 0.62 GB: about 21 GB plus activations.
TRAIN = FULL
