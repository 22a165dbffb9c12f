"""deepseek-v3-671b — MLA + 1 shared / 256 routed top-8 MoE
[arXiv:2412.19437; hf]. First 3 layers dense (d_ff 18432), rest MoE with
per-expert d_ff 2048. The MTP head is folded into the lm_head group (the
SCALE momentum group), as in the JAX package.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=18432, vocab_size=129280,
    attention_kind="mla", q_lora_rank=1536, kv_lora_rank=512,
    qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128,
    n_experts=256, top_k=8, n_shared_experts=1, moe_d_ff=2048,
    first_dense_layers=3, capacity_factor=1.25,
)

SMOKE = ModelConfig(
    name="deepseek-v3-671b-smoke", family="moe",
    n_layers=3, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab_size=512,
    attention_kind="mla", q_lora_rank=48, kv_lora_rank=32,
    qk_rope_dim=16, qk_nope_dim=32, v_head_dim=32,
    n_experts=8, top_k=2, n_shared_experts=1, moe_d_ff=64,
    first_dense_layers=1, capacity_factor=2.0,
    dtype="float32", attn_kv_block=32, attn_q_block=32, loss_chunk=32,
)
