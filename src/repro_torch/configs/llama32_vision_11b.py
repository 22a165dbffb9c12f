"""llama-3.2-vision-11b — VLM backbone, cross-attention every 5th layer
[hf:meta-llama/Llama-3.2-11B-Vision]. The vision tower is a stub: the
batch carries precomputed patch embeddings (B, n_image_tokens, d_model).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256, rope_theta=500000.0,
    cross_attn_every=5, n_image_tokens=4096,
)

SMOKE = ModelConfig(
    name="llama-3.2-vision-11b-smoke", family="vlm",
    n_layers=4, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=512, cross_attn_every=2, n_image_tokens=16,
    dtype="float32", attn_kv_block=32, attn_q_block=32, loss_chunk=32,
)
