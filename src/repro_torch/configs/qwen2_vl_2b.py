"""qwen2-vl-2b [vlm] — M-RoPE backbone; the vision frontend a stub.

[arXiv:2409.12191; hf] 28L d1536 12H (kv=2, head_dim 128) d_ff 8960,
vocab 151936.  M-RoPE: head_dim/2 = 64 rotary pairs split (16, 24, 24)
across the (temporal, height, width) position streams; the inputs are
patch embeddings (B, S, d) and 3-row positions (B, S, 3).
1,543,656,960 params.  The same values as ``repro/configs/qwen2_vl_2b.py``.
"""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151936,
    mrope=True, mrope_sections=(16, 24, 24),
    mlp_act="silu", mlp_gated=True, tie_embeddings=True,
    frontend_stub=True,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=173, mrope_sections=(2, 3, 3), dtype="float32",
)
