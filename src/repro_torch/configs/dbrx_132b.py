"""dbrx-132b — fine-grained MoE, 16 experts top-4 [hf:databricks/dbrx-base]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=10752, vocab_size=100352,
    n_experts=16, top_k=4, moe_d_ff=10752,
)

SMOKE = ModelConfig(
    name="dbrx-132b-smoke", family="moe",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=512, n_experts=4, top_k=2, moe_d_ff=128,
    dtype="float32", attn_kv_block=32, attn_q_block=32, loss_chunk=32,
    capacity_factor=2.0,
)
