"""deepseek-v2-lite-16b [moe]: 27L d=2048 16H (MLA kv_lora=512)
vocab=102400, MoE 64 routed experts (d_expert=1408) top-6 + 2 shared,
dense first layer (d_ff=10944).

The port's own copy of ``src/repro/configs/deepseek_v2_lite.py``
(``FULL``, ``SMOKE`` and ``ARCH``, same values: multi-head latent
attention with a 512-wide compressed KV and 128 + 64 query/key and 128
value dims a head; layer 0 a dense prelude of FFN width 10944, the other
26 mixtures of 64 routed experts of width 1408 with top-6 routing and 2
always-on shared experts; the lm_head tied to the embedding table),
plus ``TRAIN``.  [arXiv:2405.04434; hf]
"""

import dataclasses

from repro_torch.configs.base import ArchSpec
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer_lm import LMConfig

FULL = LMConfig(
    name="deepseek-v2-lite-16b", vocab=102400, d_model=2048, n_layers=27,
    n_heads=16, n_kv=16, head_dim=128, d_ff=0,
    kv_lora=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    first_dense_ff=10944,
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2),
    tie_embed=True,
)

SMOKE = LMConfig(
    name="deepseek-v2-lite-smoke", vocab=512, d_model=64, n_layers=3,
    n_heads=4, n_kv=4, head_dim=16, d_ff=0,
    kv_lora=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    first_dense_ff=128,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=2),
    tie_embed=True,
)

ARCH = ArchSpec(
    arch_id="deepseek-v2-lite-16b", family="lm", kind="moe",
    full=FULL, smoke=SMOKE, source="arXiv:2405.04434; hf",
    sub_quadratic=False,
)

# FULL at every published width with the depth cut to the prelude and 5
# of the 26 MoE layers, so that BDWP training fits one 80 GB card.  At
# 13.75 B per prunable parameter (configs/qwen3_8b.py), an MoE layer's
# 584.7 M (attention 13.8 M, 64 x 3 x 2048 x 1408 = 553.6 M expert and
# 3 x 2048 x 2816 = 17.3 M shared-expert weights) hold 8.04 GB, the
# prelude's 81.0 M (attention and a 2048 x 10944 SwiGLU FFN) 1.11 GB,
# and the one tied 102400 x 2048 table (209.7 M at 12 B) 2.52 GB; all 27
# layers would come to about 215 GB.  The step's peak (chip_smoke.py
# phase 37) read 44.57 GiB with 4 MoE layers and 54.62 GiB with 5 on an
# H100 80GB HBM3 at 700 W: a sixth (about 7.5 GiB more) would pass 60.
# Trained on 4 x 1024 tokens a step: 8 routing groups of 512, capacity
# round(512 x 1.25 x 6 / 64) = 60 slots an expert a group, so 480 rows
# an expert.  Depth is the only cut.
TRAIN = dataclasses.replace(FULL, n_layers=6)
