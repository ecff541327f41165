"""minicpm-2b [dense] — llama-like (gated SiLU MLP, tied head), MHA.

[arXiv:2404.06395; hf] 40L d2304 36H (kv=36 → MHA, head_dim 64) d_ff 5760,
vocab 122753.  The same values as ``repro/configs/minicpm_2b.py`` (its WSD
schedule is ``optim/schedule.py``'s).
"""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, head_dim=64,
    d_ff=5760, vocab_size=122753,
    mlp_act="silu", mlp_gated=True, tie_embeddings=True,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=48, n_heads=4, n_kv_heads=4, head_dim=12,
    d_ff=96, vocab_size=157, dtype="float32",
)
