"""mamba2-370m — attention-free SSD (state-space duality)
[arXiv:2405.21060]: 48 Mamba2 layers, no FFN, d_model 1024, 32 heads of
64 over a 128-wide state, chunk 256.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50280, ssm_state=128, ssm_expand=2, ssm_headdim=64,
    ssm_ngroups=1, ssm_dconv=4, ssm_chunk=256,
)

SMOKE = ModelConfig(
    name="mamba2-370m-smoke", family="ssm",
    n_layers=2, d_model=128, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=512, ssm_state=16, ssm_headdim=32, ssm_chunk=16,
    dtype="float32", loss_chunk=32,
)
