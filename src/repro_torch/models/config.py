"""Model configuration: the port's own copy of ``repro/models/config.py``.

It keeps the fields and derived properties that the dense (gemma2,
nemotron, minicpm, granite) and mamba1 (falcon-mamba) paths read.  The
MoE, mamba2, hybrid and frontend fields and M-RoPE come with the slices
that port them (ROADMAP item 9).  Frozen, so a config can be shared and
compared.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense, ssm (ported) | moe | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                 # query heads; 0 for attention-free archs
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- SSM (mamba1) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    mamba_version: int = 0           # 0=none, 1=mamba1 (2=mamba2: item 9.5)

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

    # --- embeddings / head ---
    tie_embeddings: bool = True      # False: an own (d, vocab) LM head
    scale_embeddings: bool = False   # gemma2: multiply embeds by sqrt(d)

    # --- numerics ---
    rms_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: bool = True               # recompute each block in the backward
    kernels: str = "auto"            # auto | cuda | ref (kernels/ops.py)

    # ----------------------------------------------------------- derived
    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, math.ceil(self.d_model / 16))

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 (the reference pads so the
        vocab dim shards over a model axis); ``lm_head`` masks the pad rows
        to -1e30."""
        return -(-self.vocab_size // 256) * 256

    def param_count(self) -> int:
        """Analytic parameter count, as the reference counts it
        (``repro/models/config.py:111-160``): the embedding once if tied,
        two norm gains per layer (a mamba block has one, but the reference
        counts two), the final norm."""
        if self.family not in ("dense", "ssm"):
            raise NotImplementedError(
                f"param_count of family {self.family!r}: only dense and ssm "
                "are ported (ROADMAP item 9)")
        d, v = self.d_model, self.vocab_size
        n = v * d if self.tie_embeddings else 2 * v * d
        if self.family == "ssm":
            per_layer = self._mamba1_params()
        else:
            hd, ff = self.head_dim, self.d_ff
            per_layer = (self.n_heads * hd * d * 2
                         + self.n_kv_heads * hd * d * 2
                         + d * ff * (3 if self.mlp_gated else 2))
        n += self.n_layers * (per_layer + 2 * d)
        return n + d

    def _mamba1_params(self) -> int:
        d, di, n, r = self.d_model, self.d_inner, self.ssm_state, self.dt_rank
        return (d * 2 * di                       # in_proj
                + di * self.ssm_conv             # conv
                + di * (r + 2 * n)               # x_proj
                + r * di + di                    # dt_proj
                + di * n + di                    # A, D
                + di * d)                        # out_proj

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
