"""granite-34b [dense] — deep MQA code model.

[arXiv:2405.04324; hf] 88L d6144 48H (kv=1 → MQA, head_dim 128)
d_ff 24576, vocab 49152.  46,947,932,160 params, 93.9 GB in bfloat16: more
than one 80 GB card holds.  Training holds its params and AdamW state as
each rank's shards over a mesh (``runtime/train_loop.py``), so FULL
trains on two or more cards; serving it whole needs its params sharded
in serving too (ROADMAP, queued).  The same values as
``repro/configs/granite_34b.py``.
"""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
    d_ff=24576, vocab_size=49152,
    mlp_act="silu", mlp_gated=True, tie_embeddings=True,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=97, dtype="float32",
)
