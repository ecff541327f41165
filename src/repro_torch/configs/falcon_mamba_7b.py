"""falcon-mamba-7b [ssm] — pure mamba1, attention-free.

[arXiv:2410.05355; unverified] 64L d4096 (d_inner 8192) ssm_state 16,
vocab 65024, no attention, no MLP (d_ff=0 — the mamba block IS the mixer).
The same values as ``repro/configs/falcon_mamba_7b.py``.
"""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=65024,
    ssm_state=16, ssm_expand=2, mamba_version=1,
    tie_embeddings=True,
)

SMOKE = FULL.replace(
    n_layers=3, d_model=32, vocab_size=89, ssm_state=4, dtype="float32",
)
