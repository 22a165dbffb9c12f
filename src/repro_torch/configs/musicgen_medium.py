"""musicgen-medium — decoder-only over EnCodec tokens, 4 codebooks
[arXiv:2306.05284; hf]. The EnCodec frontend is a stub: tokens are
(B, n_codebooks, S) int32; the input embeddings sum across codebooks and
the model carries one output head per codebook (all in SCALE's last-layer
momentum group).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144, vocab_size=2048, n_codebooks=4,
)

SMOKE = ModelConfig(
    name="musicgen-medium-smoke", family="audio",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab_size=128, n_codebooks=4,
    dtype="float32", attn_kv_block=32, attn_q_block=32, loss_chunk=32,
)
