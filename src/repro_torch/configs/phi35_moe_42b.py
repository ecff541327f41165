"""phi3.5-moe-42b-a6.6b [moe] — 16 experts, top-2, GQA decoder.

[hf:microsoft/Phi-3.5-MoE-instruct; hf] 32L d4096 32H (kv=8, head_dim
128, group 4) d_ff 6400, vocab 32064, untied head.  41,872,527,360 params,
83.7 GB in bfloat16: more than one 80 GB card holds.  Training holds its
params and AdamW state as each rank's shards over a mesh
(``runtime/train_loop.py``), and ``lm.prefill`` / ``decode_step`` on a
mesh take the same shards, so FULL trains and serves on two or more
cards (``launch/serve.py``'s one-card Server keeps them whole).  The same
values as
``repro/configs/phi35_moe_42b.py``.
"""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=6400, vocab_size=32064,
    n_experts=16, top_k=2, moe_dispatch="roomy",
    mlp_act="silu", mlp_gated=True, tie_embeddings=False,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=503, n_experts=4, top_k=2, dtype="float32",
)
