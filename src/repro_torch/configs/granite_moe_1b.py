"""granite-moe-1b-a400m [moe]: 24L d=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8.

The port's own copy of ``src/repro/configs/granite_moe_1b.py``
(``FULL``, ``SMOKE`` and ``ARCH``, same values: every block's FFN is a
mixture of 32 experts of width 512 with top-8 routing, capacity factor
1.25 over routing groups of 512 tokens, no shared expert; the lm_head
tied to the embedding table; the vocab of 49155 padded to 49408), plus
``TRAIN``.  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer_lm import LMConfig

FULL = LMConfig(
    name="granite-moe-1b-a400m", vocab=49155, d_model=1024, n_layers=24,
    n_heads=16, n_kv=8, head_dim=64, d_ff=0,
    moe=MoEConfig(n_experts=32, top_k=8, d_expert=512),
    tie_embed=True,
)

SMOKE = LMConfig(
    name="granite-moe-1b-smoke", vocab=512, d_model=64, n_layers=2,
    n_heads=4, n_kv=2, head_dim=16, d_ff=0,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32),
    tie_embed=True,
)

ARCH = ArchSpec(
    arch_id="granite-moe-1b-a400m", family="lm", kind="moe",
    full=FULL, smoke=SMOKE,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
    sub_quadratic=False,
)

# FULL itself, nothing cut: 24 layers of 3 x 32 x 1024 x 512 = 50.33 M
# expert and 3.15 M attention parameters make 1.284 G prunable
# parameters at 13.75 B each (configs/qwen3_8b.py: fp32 master and
# momentum, the bf16 BP operand, the packed pair, the decay mask, the
# bf16 WU gradient) = 17.7 GB, and the one tied 49408 x 1024 table
# (50.6 M at 12 B) 0.6 GB: 18.3 GB plus activations.  Trained on 4 x
# 1024 tokens a step: 8 routing groups of 512, capacity 160 slots an
# expert a group, so 1280 rows an expert.
TRAIN = FULL
