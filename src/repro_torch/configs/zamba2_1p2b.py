"""zamba2-1.2b [hybrid] — a mamba2 backbone and one shared attention block.

[arXiv:2411.15242; hf] 38L d2048 32H (kv=32: MHA, head_dim 64), shared-MLP
d_ff 8192, vocab 32000, ssm_state 64.  The single shared transformer block
(attention + MLP, one weight set) runs after every 6th mamba2 block: 6
applications over 38 layers, each with a KV cache of its own.
1,104,852,736 params, 2.2 GB in bfloat16.  The same values as
``repro/configs/zamba2_1p2b.py``.
"""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_expand=2, mamba_version=2, mamba2_head_dim=64,
    shared_attn_every=6,
    mlp_act="gelu", mlp_gated=True, tie_embeddings=True,
)

SMOKE = FULL.replace(
    n_layers=5, d_model=32, n_heads=4, n_kv_heads=4, head_dim=8,
    d_ff=64, vocab_size=127, ssm_state=8, mamba2_head_dim=16,
    shared_attn_every=2, dtype="float32",
)
