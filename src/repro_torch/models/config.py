"""Model configuration: the port's own copy of ``repro/models/config.py``.

It keeps the fields and derived properties that the dense and gemma2
paths read.  The MoE, SSM, hybrid and frontend fields, M-RoPE and the
untied LM head come with the slices that port them (ROADMAP item 9).
Frozen, so a config can be shared and compared.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense (ported) | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                 # query heads
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention variants ---
    local_window: int = 0            # sliding-window size (gemma2 local layers)
    local_global_pattern: bool = False
    logit_softcap: float = 0.0       # final-logit tanh cap (gemma2: 30)
    attn_softcap: float = 0.0        # attention-logit tanh cap (gemma2: 50)
    post_norm: bool = False          # gemma2 post-block RMSNorms
    rope_theta: float = 10_000.0

    # --- MLP ---
    mlp_act: str = "silu"            # silu | gelu | relu2
    mlp_gated: bool = True

    # --- embeddings / head (tied: the LM head is the embedding table) ---
    scale_embeddings: bool = False   # gemma2: multiply embeds by sqrt(d)

    # --- numerics ---
    rms_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: bool = True               # recompute each block in the backward
    kernels: str = "auto"            # auto | cuda | ref (kernels/ops.py)

    # ----------------------------------------------------------- derived
    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 (the reference pads so the
        vocab dim shards over a model axis); ``lm_head`` masks the pad rows
        to -1e30."""
        return -(-self.vocab_size // 256) * 256

    def param_count(self) -> int:
        """Analytic parameter count, as the reference counts it: the tied
        embedding once, two norms per layer, the final norm."""
        if self.family != "dense":
            raise NotImplementedError(
                f"param_count of family {self.family!r}: only dense is "
                "ported (ROADMAP item 9)")
        d, ff, v, hd = self.d_model, self.d_ff, self.vocab_size, self.head_dim
        n = v * d
        attn = self.n_heads * hd * d * 2 + self.n_kv_heads * hd * d * 2
        mlp = d * ff * (3 if self.mlp_gated else 2)
        n += self.n_layers * (attn + mlp + 2 * d)
        return n + d

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
