"""qwen2-7b — dense GQA with QKV bias [arXiv:2407.10671; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
    d_ff=18944, vocab_size=152064, qkv_bias=True, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen2-7b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=512, qkv_bias=True, dtype="float32",
    attn_kv_block=32, attn_q_block=32, loss_chunk=32,
)
