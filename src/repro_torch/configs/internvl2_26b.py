"""internvl2-26b [vlm]: 48L d=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.

The port's own copy of ``src/repro/configs/internvl2_26b.py`` (``FULL``,
``SMOKE`` and ``ARCH``, same values), plus ``TRAIN``.  InternViT +
InternLM2; as in the reference, the vision frontend is a stub: a batch
carries precomputed patch embeddings (B, 1024, d) as ``prefix_embeds``,
which the LM backbone reads before the text tokens.  The vocab of 92553
is padded to 92672 (a multiple of 256).  [arXiv:2404.16821; hf]
"""

import dataclasses

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer_lm import LMConfig

FULL = LMConfig(
    name="internvl2-26b", vocab=92553, d_model=6144, n_layers=48,
    n_heads=48, n_kv=8, head_dim=128, d_ff=16384,
    rope_theta=1e6, tie_embed=False,
)

SMOKE = LMConfig(
    name="internvl2-26b-smoke", vocab=512, d_model=64, n_layers=2,
    n_heads=4, n_kv=2, head_dim=16, d_ff=128, tie_embed=False,
)

ARCH = ArchSpec(
    arch_id="internvl2-26b", family="lm", kind="vlm", full=FULL, smoke=SMOKE,
    source="arXiv:2404.16821; hf", sub_quadratic=False, prefix_len=1024,
)

# FULL at every published width with the depth cut to 4 of 48 layers:
# 390.1 M prunable parameters a layer at 13.75 B (configs/qwen3_8b.py)
# and the untied 92672 x 6144 tables at 12 B a parameter: 21.5 + 13.7 =
# 35.2 GB plus activations, at 2 x (1024 prefix + 1024 text) tokens a
# step.  Depth is the only cut.
TRAIN = dataclasses.replace(FULL, n_layers=4)
