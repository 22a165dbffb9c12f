"""Model configuration: a copy of ``repro.models.config.ModelConfig``.

Every field and default is the JAX package's, so a configuration moves
between the two packages field by field. ``torch_dtype`` takes the place of
``jdtype``. Every family runs in the port: dense, moe (GQA or MLA
attention by ``attention_kind``), ssm, hybrid, vlm and audio.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio

    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0          # 0 -> d_model // n_heads
    d_ff: int = 512
    vocab_size: int = 1024
    vocab_pad_multiple: int = 128
    qkv_bias: bool = False

    attention_kind: str = "gqa"  # gqa | mla
    # MLA (deepseek-v3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 0        # 0 -> head_dim

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0          # 0 -> d_ff
    moe_every: int = 1         # layer i is MoE iff i % moe_every == moe_every-1
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 2048  # tokens per group in group-local MoE dispatch

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_dconv: int = 4
    ssm_chunk: int = 256

    # hybrid (jamba): super-block of `hybrid_period`, attention at position 0
    hybrid_period: int = 0

    # vlm: cross-attention replaces self-attention every N layers
    cross_attn_every: int = 0
    n_image_tokens: int = 0

    # audio: input tokens (B, n_codebooks, S); one output head per codebook.
    n_codebooks: int = 0

    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    # Weight tying: no lm_head; tok_embed.w (V, D) doubles as the head,
    # read transposed.
    tie_embeddings: bool = False
    pos_embed: str = "rope"    # rope | learned  (gpt2-style)
    max_position: int = 4096   # learned-pos table size
    mlp_kind: str = "swiglu"   # swiglu | gelu   (gpt2-style 2-matrix MLP)

    dtype: str = "bfloat16"
    remat: str = "full"        # none | dots | full
    attn_q_block: int = 512
    attn_kv_block: int = 1024
    loss_chunk: int = 2048     # vocab-logit chunking along tokens

    # sharding rule overrides (``models.sharding.Rules``)
    rule_overrides: Tuple = ()

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            self.head_dim = self.d_model // self.n_heads
        if self.v_head_dim == 0:
            self.v_head_dim = self.head_dim
        if self.moe_d_ff == 0:
            self.moe_d_ff = self.d_ff

    # ---- derived ----
    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.ssm_ngroups * self.ssm_state

    @property
    def segments(self) -> Tuple[Tuple[str, int], ...]:
        """(super_block_kind, n_superblocks) pairs, run in order."""
        if self.family == "hybrid":
            assert self.n_layers % self.hybrid_period == 0
            return (("hybrid", self.n_layers // self.hybrid_period),)
        if self.family == "ssm":
            return (("ssm", self.n_layers),)
        if self.family == "vlm":
            assert self.n_layers % self.cross_attn_every == 0
            return (("vlm", self.n_layers // self.cross_attn_every),)
        if self.family == "moe" and self.first_dense_layers:
            return (("dense", self.first_dense_layers),
                    ("moe", self.n_layers - self.first_dense_layers))
        if self.family == "moe":
            return (("moe", self.n_layers),)
        return (("dense", self.n_layers),)

    def num_params(self) -> int:
        """Analytic parameter count."""
        from . import model  # lazy, avoids a cycle
        return model.count_params(model.param_shapes(self))

    def active_params(self) -> int:
        """Parameters a token passes through: each expert leaf counts
        ``top_k / n_experts`` of its size."""
        from . import model
        return model.count_params(model.param_shapes(self), cfg=self,
                                  active_only=True)
