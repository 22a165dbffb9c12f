"""deepseek-67b — dense llama-arch GQA [arXiv:2401.02954; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab_size=102400, rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="deepseek-67b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=512, dtype="float32",
    attn_kv_block=32, attn_q_block=32, loss_chunk=32,
)
