"""Model configuration: the port's own copy of ``repro/models/config.py``.

It keeps the fields and derived properties that the dense (gemma2,
nemotron, minicpm, granite), mamba1 (falcon-mamba), MoE (granite-moe,
phi3.5-moe), hybrid (zamba2: mamba2 with a shared attention block) and
frontend-stub (musicgen: audio; qwen2-vl: vision, M-RoPE) paths read.
The distribution fields (``embedding_dispatch``,
``attn_activation_shard``) are the reference's, with its defaults; the
mesh paths that read them are ``models/layers.py`` (the roomy embedding)
and ``models/attention.py`` (``_attn_act_spec``).  Frozen, so a config can
be shared and compared.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                 # query heads; 0 for attention-free archs
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_dispatch: str = "roomy"      # roomy (on a mesh) | einsum
    capacity_factor: float = 1.25

    # --- SSM (mamba) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    mamba_version: int = 0           # 0=none, 1=mamba1, 2=mamba2
    mamba2_head_dim: int = 64
    mamba2_use_ssd: bool = True      # chunked matmul (SSD) form, else K9
    ssd_chunk: int = 128

    # --- attention variants ---
    local_window: int = 0            # sliding-window size (gemma2 local layers)
    local_global_pattern: bool = False
    logit_softcap: float = 0.0       # final-logit tanh cap (gemma2: 30)
    attn_softcap: float = 0.0        # attention-logit tanh cap (gemma2: 50)
    post_norm: bool = False          # gemma2 post-block RMSNorms
    rope_theta: float = 10_000.0
    mrope: bool = False              # qwen2-vl M-RoPE (3 position streams)
    mrope_sections: Tuple[int, ...] = (16, 24, 24)

    # --- MLP ---
    mlp_act: str = "silu"            # silu | gelu | relu2
    mlp_gated: bool = True

    # --- hybrid (zamba2) ---
    shared_attn_every: int = 0       # shared attn+mlp block every k layers

    # --- embeddings / head ---
    tie_embeddings: bool = True      # False: an own (d, vocab) LM head
    frontend_stub: bool = False      # audio/vlm: inputs are embeddings
    embedding_dispatch: str = "gspmd"  # gspmd | roomy (on a mesh)
    scale_embeddings: bool = False   # gemma2: multiply embeds by sqrt(d)

    # --- distribution ---
    attn_activation_shard: str = "auto"   # auto | none — when q-heads don't
    # divide the model axis, the reference spreads the attention
    # activations over 'model' (batch or sequence) in place of replicating
    # the compute; the port runs that attention replicated

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
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 (the reference pads so the
        vocab dim shards over a model axis); ``lm_head`` masks the pad rows
        to -1e30."""
        return -(-self.vocab_size // 256) * 256

    @property
    def experts_padded(self) -> int:
        """Experts rounded up to a multiple of 16, as the reference pads
        them to shard over a model axis; the router masks the padded ones
        to -inf, so they are never chosen."""
        if not self.is_moe:
            return 0
        return -(-self.n_experts // 16) * 16

    def param_count(self) -> int:
        """Analytic parameter count, as the reference counts it
        (``repro/models/config.py:111-160``): the embedding once if tied
        or a frontend stub's (its table is the LM head alone), two norm
        gains per layer (a mamba block has one, but the reference
        counts two), the hybrid's one shared block, the final norm.  MoE
        counts ``n_experts``, not the padded experts the params hold."""
        d, v = self.d_model, self.vocab_size
        tied = self.tie_embeddings or self.frontend_stub
        n = v * d if tied else 2 * v * d
        if self.family == "ssm":
            per_layer = self._mamba_params(1)
        elif self.family == "hybrid":
            per_layer = self._mamba_params(2)
        else:
            per_layer = self._attn_params() + self._mlp_params()
        n += self.n_layers * (per_layer + 2 * d)
        if self.family == "hybrid" and self.shared_attn_every:
            n += self._attn_params() + self._mlp_params() + 2 * d
        return n + d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: ``top_k`` experts a layer)."""
        if not self.is_moe:
            return self.param_count()
        return self.param_count() - self.n_layers * (
            self.n_experts - self.top_k) * self._expert_params()

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        return (self.n_heads * hd * d * 2            # q, o
                + self.n_kv_heads * hd * d * 2)      # k, v

    def _expert_params(self) -> int:
        return self.d_model * self.d_ff * (3 if self.mlp_gated else 2)

    def _mlp_params(self) -> int:
        if self.is_moe:
            return (self.n_experts * self._expert_params()
                    + self.d_model * self.n_experts)        # + router
        return self._expert_params()

    def _mamba_params(self, version: int) -> int:
        d, di, n = self.d_model, self.d_inner, self.ssm_state
        if version == 1:
            r = self.dt_rank
            return (d * 2 * di                       # in_proj
                    + di * self.ssm_conv             # conv
                    + di * (r + 2 * n)               # x_proj
                    + r * di + di                    # dt_proj
                    + di * n + di                    # A, D
                    + di * d)                        # out_proj
        heads = di // self.mamba2_head_dim
        return (d * (2 * di + 2 * n + heads)         # in_proj (z, x, B, C, dt)
                + (di + 2 * n) * self.ssm_conv       # conv
                + heads * 2                          # A, D a head
                + di                                 # norm
                + di * d)                            # out_proj

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
