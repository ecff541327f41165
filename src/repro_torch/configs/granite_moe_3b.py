"""granite-moe-3b-a800m [moe] — 40 experts, top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf] 32L d1536 24H (kv=8, head_dim
64, group 3), per-expert d_ff 512, vocab 49155.  The reference implements
the assignment's primary line (40 experts top-8); the params pad the
experts to 48, the router masks the 8 padded ones.  3,298,793,472 params
by ``param_count`` (40 experts), 3,903,555,072 as initialised (48): 7.8 GB
in bfloat16.  The same values as ``repro/configs/granite_moe_3b.py``.
"""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155,
    n_experts=40, top_k=8, moe_dispatch="roomy",
    mlp_act="silu", mlp_gated=True, tie_embeddings=True,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, head_dim=12,
    d_ff=32, vocab_size=211, n_experts=5, top_k=3, dtype="float32",
)
