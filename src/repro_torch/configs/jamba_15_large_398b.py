"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 with MoE every 2nd
layer, 16 experts top-2 [arXiv:2403.19887; hf]. Super-block of 8: attention
at position 0, Mamba at 1..7; MoE FFN at odd positions.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    n_experts=16, top_k=2, moe_d_ff=24576, hybrid_period=8,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_chunk=256,
)

SMOKE = ModelConfig(
    name="jamba-1.5-large-398b-smoke", family="hybrid",
    n_layers=8, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=512, n_experts=4, top_k=2, moe_d_ff=128,
    hybrid_period=4, ssm_state=16, ssm_headdim=32, ssm_chunk=16,
    dtype="float32", attn_kv_block=32, attn_q_block=32, loss_chunk=32,
    capacity_factor=2.0,
)
