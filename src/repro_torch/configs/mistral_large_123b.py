"""mistral-large-123b — dense GQA [hf:mistralai/Mistral-Large-2407]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=32768,
)

SMOKE = ModelConfig(
    name="mistral-large-123b-smoke", family="dense",
    n_layers=2, d_model=192, n_heads=6, n_kv_heads=2, head_dim=32,
    d_ff=384, vocab_size=512, dtype="float32",
    attn_kv_block=32, attn_q_block=32, loss_chunk=32,
)
