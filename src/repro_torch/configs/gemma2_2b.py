"""gemma2-2b [dense] — local/global alternating attention, logit softcaps.

[arXiv:2408.00118; hf] 26L d2304 8H (kv=4, head_dim 256) d_ff 9216,
vocab 256000; sliding window 4096 on local layers; attn softcap 50,
final-logit softcap 30; pre+post RMSNorms; embeddings scaled by sqrt(d).
The same values as ``repro/configs/gemma2_2b.py``.
"""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=9216, vocab_size=256000,
    local_window=4096, local_global_pattern=True,
    attn_softcap=50.0, logit_softcap=30.0, post_norm=True,
    scale_embeddings=True,
    mlp_act="gelu", mlp_gated=True,
)

SMOKE = FULL.replace(
    n_layers=4, d_model=48, n_heads=4, n_kv_heads=2, head_dim=12,
    d_ff=96, vocab_size=199, local_window=8, dtype="float32",
)
