"""musicgen-medium [audio] — decoder-only over EnCodec tokens.

[arXiv:2306.05284; hf] 48L d1536 24H (kv=24 → MHA, head_dim 64) d_ff 6144,
vocab 2048.  The EnCodec frontend is a stub: the inputs are precomputed
frame embeddings (B, S, d) (``data.pipeline.make_batch`` draws them from
a fixed codebook); the 2048-way head predicts codec tokens.  Non-gated
GELU MLP.  1,362,249,216 params.  The same values as
``repro/configs/musicgen_medium.py``.
"""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144, vocab_size=2048,
    mlp_act="gelu", mlp_gated=False, tie_embeddings=True,
    frontend_stub=True,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=48, n_heads=4, n_kv_heads=4, head_dim=12,
    d_ff=96, vocab_size=67, dtype="float32",
)
