"""qwen3-8b [dense]: 36L d=4096 32H (GQA kv=8) d_ff=12288 vocab=151936.

The port's own copy of ``src/repro/configs/qwen3_8b.py`` (``FULL`` and
``SMOKE``, same values; qk_norm, untied lm_head), built on the port's
``LMConfig``.  [hf:Qwen/Qwen3-8B]
"""

from repro_torch.models.transformer_lm import LMConfig

FULL = LMConfig(
    name="qwen3-8b", vocab=151936, d_model=4096, n_layers=36,
    n_heads=32, n_kv=8, head_dim=128, d_ff=12288,
    rope_theta=1e6, qk_norm=True,
)

SMOKE = LMConfig(
    name="qwen3-8b-smoke", vocab=512, d_model=64, n_layers=2,
    n_heads=4, n_kv=2, head_dim=16, d_ff=128,
    rope_theta=1e6, qk_norm=True,
)
