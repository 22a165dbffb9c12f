from .registry import ARCH_IDS, LLAMA_PAPER, PAPER_EXTRA, get_arch

__all__ = ["ARCH_IDS", "LLAMA_PAPER", "PAPER_EXTRA", "get_arch"]
