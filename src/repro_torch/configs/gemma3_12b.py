"""gemma3-12b [dense]: 48L d=3840 16H (GQA kv=8) d_ff=15360 vocab=262144.

The port's own copy of ``src/repro/configs/gemma3_12b.py`` (``FULL``,
``SMOKE`` and ``ARCH``, same values: qk_norm, head_dim 256, the 5:1
pattern of sliding-window ("swa", window 1024) and global ("attn")
layers, the lm_head tied to the embedding table), plus ``TRAIN``.
As in the reference, the blocks are the dense family's: no sandwich
norms, logit softcapping or per-kind RoPE base.
[hf:google/gemma-3-1b-pt; unverified]
"""

import dataclasses

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer_lm import LMConfig

FULL = LMConfig(
    name="gemma3-12b", vocab=262144, d_model=3840, n_layers=48,
    n_heads=16, n_kv=8, head_dim=256, d_ff=15360,
    rope_theta=1e6, qk_norm=True,
    pattern=("swa", "swa", "swa", "swa", "swa", "attn"), window=1024,
    tie_embed=True,
)

SMOKE = LMConfig(
    name="gemma3-12b-smoke", vocab=512, d_model=64, n_layers=6,
    n_heads=4, n_kv=2, head_dim=16, d_ff=128, qk_norm=True,
    pattern=("swa", "swa", "swa", "swa", "swa", "attn"), window=16,
    tie_embed=True,
)

ARCH = ArchSpec(
    arch_id="gemma3-12b", family="lm", kind="dense", full=FULL, smoke=SMOKE,
    source="hf:google/gemma-3-1b-pt; unverified", sub_quadratic=True,
)

# FULL at every published width with the depth cut to 6 of 48 layers,
# one period of the 5:1 pattern (5 "swa" layers, then 1 "attn"): 224.2
# M prunable parameters a layer at 13.75 B (configs/qwen3_8b.py) and the
# one tied 262144 x 3840 table at 12 B a parameter: 18.5 + 12.1 = 30.6
# GB plus activations.  Trained on sequences of 2048 tokens, so that
# the 1024-token window bites.  Depth is the only cut.
TRAIN = dataclasses.replace(FULL, n_layers=6)
