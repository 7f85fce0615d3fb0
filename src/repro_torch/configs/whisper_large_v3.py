"""whisper-large-v3 [audio]: 32 + 32L d=1280 20H (kv=20) d_ff=5120
vocab=51866.

The port's own copy of ``src/repro/configs/whisper_large_v3.py``
(``FULL``, ``SMOKE`` and ``ARCH``, same values: an encoder-decoder,
``models.encdec``, with 32 encoder and 32 decoder layers of 20 heads of
64, a GELU FFN of 5120 with biases, learned positions (``max_source``
1500 frames, ``max_target`` 32768 target positions: the reference
stretches Whisper's 448 to its sequence lengths), the head tied to the
embedding table and the vocab of 51866 padded to 51968).  The conv/mel
frontend is a stub: the encoder reads (B, 1500, d) frame embeddings.
BDWP prunes every projection: an encoder layer's q/k/v/o and FFN in and
out (6 sites), a decoder layer's the same and its cross-attention's
q/k/v/o (10): 512 sites, 1,468,006,400 elements.  The embedding table,
the positions, the norms and the biases are not sites.
[arXiv:2212.04356; unverified]
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.encdec import EncDecConfig

FULL = EncDecConfig(
    name="whisper-large-v3", vocab=51866, d_model=1280,
    n_layers=32, n_enc_layers=32, n_heads=20, n_kv=20, head_dim=64,
    d_ff=5120, max_source=1500, max_target=32768,
)

SMOKE = EncDecConfig(
    name="whisper-large-v3-smoke", vocab=512, d_model=64,
    n_layers=2, n_enc_layers=2, n_heads=4, n_kv=4, head_dim=16,
    d_ff=128, max_source=128, max_target=64,
)

ARCH = ArchSpec(
    arch_id="whisper-large-v3", family="encdec", kind="audio",
    full=FULL, smoke=SMOKE, source="arXiv:2212.04356; unverified",
    sub_quadratic=False,
)

# FULL itself, nothing cut: 1,468,006,400 site elements at 13.75 B each
# (configs/qwen3_8b.py: fp32 master and momentum, the bf16 BP operand,
# the packed pair, the decay mask, the bf16 WU gradient) = 20.2 GB, and
# the 111.2 M other parameters (the 51968 x 1280 table, the positions,
# norms and biases) at 12 B = 1.3 GB: about 21.5 GB plus activations.
TRAIN = FULL
