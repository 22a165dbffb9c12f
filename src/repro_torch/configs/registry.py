"""Architecture registry: the paper's LLaMA sizes and its Appendix F extras.

A copy of the dense part of ``repro.configs.registry``. The architectures
of ``ARCH_IDS`` (MoE, MLA, SSM, VLM, audio and the large dense
configurations) are not ported yet and raise a ``KeyError`` saying so.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "deepseek-67b",
    "qwen2-7b",
    "granite-3-8b",
    "mistral-large-123b",
    "mamba2-370m",
    "llama-3.2-vision-11b",
    "dbrx-132b",
    "deepseek-v3-671b",
    "jamba-1.5-large-398b",
    "musicgen-medium",
)

# Appendix F extra architectures (paper Table 9/10): GPT2-Medium (learned
# positions + GELU MLP), Qwen2-500M (GQA + QKV bias), Gemma-2B (wide-ff GQA).
PAPER_EXTRA = {
    "gpt2-medium": dict(n_layers=24, d_model=1024, n_heads=16,
                        n_kv_heads=16, d_ff=4096, vocab_size=50257,
                        pos_embed="learned", max_position=1024,
                        mlp_kind="gelu"),
    "qwen2-500m": dict(n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
                       head_dim=64, d_ff=4864, vocab_size=151936,
                       qkv_bias=True),
    "gemma-2b": dict(n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
                     head_dim=256, d_ff=16384, vocab_size=256000),
}

# The paper's own LLaMA family (Zhao et al. 2024 GaLore configs).
LLAMA_PAPER = {
    "llama-60m": dict(n_layers=8, d_model=512, n_heads=8, d_ff=1376),
    "llama-130m": dict(n_layers=12, d_model=768, n_heads=12, d_ff=2048),
    "llama-350m": dict(n_layers=24, d_model=1024, n_heads=16, d_ff=2736),
    "llama-1b": dict(n_layers=24, d_model=2048, n_heads=32, d_ff=5461),
    "llama-7b": dict(n_layers=32, d_model=4096, n_heads=32, d_ff=11008),
}


def get_arch(arch_id: str) -> ModelConfig:
    if arch_id in LLAMA_PAPER:
        kw = LLAMA_PAPER[arch_id]
        return ModelConfig(name=arch_id, family="dense", vocab_size=32000,
                           n_kv_heads=kw["n_heads"], **kw)
    if arch_id in PAPER_EXTRA:
        return ModelConfig(name=arch_id, family="dense", **PAPER_EXTRA[arch_id])
    if arch_id in ARCH_IDS:
        raise KeyError(f"arch {arch_id!r} is not yet ported to repro_torch; "
                       f"ported: {tuple(LLAMA_PAPER) + tuple(PAPER_EXTRA)}")
    raise KeyError(f"unknown arch {arch_id!r}; options: "
                   f"{ARCH_IDS + tuple(LLAMA_PAPER) + tuple(PAPER_EXTRA)}")
