"""nemotron-4-15b [dense] — GQA + squared-ReLU MLP, 256k vocab.

[arXiv:2402.16819; unverified] 32L d6144 48H (kv=8, head_dim 128)
d_ff 24576, vocab 256000.  Non-gated squared-ReLU MLP; untied embeddings
(the LM head is its own (d, vocab) matrix).  15,628,376,064 params, 31.3 GB
in bfloat16.  The same values as ``repro/configs/nemotron4_15b.py``.
"""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=256000,
    mlp_act="relu2", mlp_gated=False, tie_embeddings=False,
    rope_theta=10_000.0,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, head_dim=12,
    d_ff=192, vocab_size=331, dtype="float32",
)
