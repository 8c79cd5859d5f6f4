"""xlstm-125m [ssm]: 12L d_model=768 4H d_ff=0 vocab=50304 — the numbers
of ``repro.configs.xlstm_125m``.

sLSTM + mLSTM blocks [arXiv:2405.04517].  d_ff=0: the blocks carry their
own projections and no separate FFN follows; every 4th layer is an
sLSTM.  A recurrent / matrix state makes the backbone sub-quadratic, so
it takes the long_500k shape.
"""
from repro_torch.models.lm import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50_304,
    block_pattern="xlstm", slstm_every=4,
    tie_embeddings=True, sub_quadratic=True,
)
