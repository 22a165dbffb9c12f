"""granite-3-8b — dense GQA [hf:ibm-granite/granite-3.0; hf].

vocab 49155 is not 128-aligned; the embedding/head pad to 49280 and the
loss masks padded logits (production vocab-padding, Megatron-style).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12800, vocab_size=49155,
)

SMOKE = ModelConfig(
    name="granite-3-8b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=387,  # deliberately unaligned -> exercises padding
    dtype="float32", attn_kv_block=32, attn_q_block=32, loss_chunk=32,
)
